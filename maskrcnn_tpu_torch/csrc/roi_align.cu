// Multi-level FPN ROIAlign, forward and backward, for Hopper (sm_90a).
//
// The forward replaces the TPU kernel
// maskrcnn_tpu/ops/pallas/roi_align_kernel.py (multilevel_roi_align_pallas /
// _kernel, with its jnp prep _precompute and _bin_weights); the backward
// (roi_align_backward, below the forward) replaces its default "roi"
// backward (_roi_align_bwd_roi / _roi_bwd_kernel). Semantics are those of
// the exact gather path
// (maskrcnn_tpu/models/poolers.py:_pool_roi_block, non-adaptive branch),
// the legacy aligned=False ROIAlign:
//   * roi = box * level scale, no half-pixel shift;
//     roi_w = max(x2 - x1, 1), roi_h = max(y2 - y1, 1) (no +1);
//   * S x S samples per bin at origin + bin * i + (k + 0.5) * bin / S;
//   * a sample with y outside [-1, H] or x outside [-1, W] contributes 0;
//     otherwise y, x are clamped at 0 and snapped to the last row/column;
//   * the bin is the mean of its S x S bilinear samples.
// Every ROI samples all it covers: there is no equivalent of the TPU
// kernel's 40-cell patch clamp for oversized ROIs.
//
// Design: one block per (ROI, output row); threads run along the channel
// axis, which is contiguous in the NHWC level maps (channels_last NCHW in
// PyTorch), so each bilinear corner read by a warp is one contiguous run of
// channels. The ROI's level (from assign_levels, computed in PyTorch) picks
// the level's base pointer, H, W and scale from a small by-value struct.
// Sums are kept in fp32 and the bin is written in the features' dtype.
//
// What bounds it on the card: bytes. The box head's call (1000 ROIs, P=7,
// C=256, bf16) writes 25 MB and can read at most the 46 MB of P2-P5 at
// 800x1344; its arithmetic (~0.4 GFLOP) is far below the card's rate. The
// corner reads repeat across neighbouring samples and ROIs, and the whole
// pyramid fits in the 50 MB L2, so most of them are L2 hits. This first
// design does not reach that bound: every thread recomputes the sample
// coordinates and bilinear weights of its row of bins, which are the same
// for all channels; that repeated arithmetic, not the bytes, is the likely
// limit of its measured time (PERF.md). A later design computes them once
// per block.
//
// The backward is the exact adjoint of this forward (the gradient of the
// plain version): every bilinear corner of every sample inside the map gets
// w * dOut / (S*S), accumulated in float32, for each channel. The TPU
// kernel merges each ROI's window of dPatch in VMEM and adds it once into
// the level gradients, the grid running in order. Here blocks run in
// parallel and ROIs overlap, so the design is a scatter:
//   * one block per (ROI, output row), threads along the channels, the
//     sample geometry and the outside / clamp / snap rules of the forward;
//   * each corner's share goes into one zeroed float32 NHWC buffer holding
//     all levels through float32 atomicAdd (at the snapped edge two corners
//     are one cell, and both adds land there);
//   * then one cast to the features' dtype, as the JAX kernel rounds once
//     at its flush; a float32 model's gradient is the buffer itself.
// The order of the atomic adds changes from run to run, so the result does
// too, by float32 rounding (about 1e-6 of max|grad| at the training shapes).
//
// What bounds the backward: bytes. At the box head's training call (4096
// ROIs, P=7, C=256, bf16, B=8 at 800x1344) it must read dOut (103 MB) and
// write the dense gradient of P2-P5 (366 MB in bf16). The design adds the
// zeroing of the 731 MB float32 buffer and the cast's read of it, and its
// atomics go to cells spread over a buffer larger than the 50 MB L2.
//
// Built with -fmad=false so the sample coordinates round as the plain
// version's do.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 5;

struct Levels {
  const void* data[kMaxLevels];
  int h[kMaxLevels];
  int w[kMaxLevels];
  float scale[kMaxLevels];
};

__device__ __forceinline__ float load_f(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// Bilinear corner indices and weights of one sample coordinate along an
// axis of extent `size` (the gather path's clamp and snap rules).
struct Axis {
  int lo, hi;
  float l, h;
};

__device__ __forceinline__ Axis axis_weights(float v, int size) {
  Axis a;
  v = fmaxf(v, 0.f);
  a.lo = min((int)v, size - 1);
  a.hi = min(a.lo + 1, size - 1);
  if (a.lo >= size - 1) v = (float)a.lo;
  a.l = __fsub_rn(v, (float)a.lo);
  a.h = __fsub_rn(1.f, a.l);
  return a;
}

// The ROI's box on its level: corner, bin sizes and sample spacing.
struct RoiGeom {
  float x1, y1, bin_w, bin_h, sub_w, sub_h;
};

__device__ __forceinline__ RoiGeom roi_geom(float4 box, float scale, int p, int s) {
  RoiGeom g;
  g.x1 = __fmul_rn(box.x, scale);
  g.y1 = __fmul_rn(box.y, scale);
  const float x2 = __fmul_rn(box.z, scale);
  const float y2 = __fmul_rn(box.w, scale);
  g.bin_w = __fdiv_rn(fmaxf(__fsub_rn(x2, g.x1), 1.f), (float)p);
  g.bin_h = __fdiv_rn(fmaxf(__fsub_rn(y2, g.y1), 1.f), (float)p);
  g.sub_w = __fdiv_rn(g.bin_w, (float)s);
  g.sub_h = __fdiv_rn(g.bin_h, (float)s);
  return g;
}

template <typename T>
__global__ void roi_align_fwd_kernel(Levels lv, const float4* __restrict__ boxes,
                                     const int* __restrict__ batch_idx,
                                     const int* __restrict__ level, int c,
                                     int p, int s, T* __restrict__ out) {
  const int r = blockIdx.x;
  const int py = blockIdx.y;
  const int l = level[r];
  const int h = lv.h[l];
  const int w = lv.w[l];
  const float scale = lv.scale[l];
  const T* feat = (const T*)lv.data[l] + (size_t)batch_idx[r] * h * w * c;

  const RoiGeom gm = roi_geom(boxes[r], scale, p, s);
  const float y0 = __fadd_rn(gm.y1, __fmul_rn((float)py, gm.bin_h));
  const float count = (float)(s * s);

  T* o = out + ((size_t)r * p + py) * p * c;
  for (int ch = threadIdx.x; ch < c; ch += blockDim.x) {
    const T* f = feat + ch;
    for (int px = 0; px < p; ++px) {
      const float x0 = __fadd_rn(gm.x1, __fmul_rn((float)px, gm.bin_w));
      float acc = 0.f;
      for (int iy = 0; iy < s; ++iy) {
        const float y = __fadd_rn(y0, __fmul_rn((float)iy + 0.5f, gm.sub_h));
        if (y < -1.f || y > (float)h) continue;
        const Axis ay = axis_weights(y, h);
        for (int ix = 0; ix < s; ++ix) {
          const float x = __fadd_rn(x0, __fmul_rn((float)ix + 0.5f, gm.sub_w));
          if (x < -1.f || x > (float)w) continue;
          const Axis ax = axis_weights(x, w);
          const float v00 = load_f(f + ((size_t)ay.lo * w + ax.lo) * c);
          const float v01 = load_f(f + ((size_t)ay.lo * w + ax.hi) * c);
          const float v10 = load_f(f + ((size_t)ay.hi * w + ax.lo) * c);
          const float v11 = load_f(f + ((size_t)ay.hi * w + ax.hi) * c);
          float val = __fmul_rn(__fmul_rn(ay.h, ax.h), v00);
          val = __fadd_rn(val, __fmul_rn(__fmul_rn(ay.h, ax.l), v01));
          val = __fadd_rn(val, __fmul_rn(__fmul_rn(ay.l, ax.h), v10));
          val = __fadd_rn(val, __fmul_rn(__fmul_rn(ay.l, ax.l), v11));
          acc = __fadd_rn(acc, val);
        }
      }
      store_f(o + (size_t)px * c + ch, __fdiv_rn(acc, count));
    }
  }
}

// Level gradients: float32 NHWC accumulation buffers, one per level.
struct GradLevels {
  float* data[kMaxLevels];
  int h[kMaxLevels];
  int w[kMaxLevels];
  float scale[kMaxLevels];
};

template <typename T>
__global__ void roi_align_bwd_kernel(GradLevels lv, const float4* __restrict__ boxes,
                                     const int* __restrict__ batch_idx,
                                     const int* __restrict__ level, int c,
                                     int p, int s, const T* __restrict__ dout) {
  const int r = blockIdx.x;
  const int py = blockIdx.y;
  const int l = level[r];
  const int h = lv.h[l];
  const int w = lv.w[l];
  float* grad = lv.data[l] + (size_t)batch_idx[r] * h * w * c;

  const RoiGeom gm = roi_geom(boxes[r], lv.scale[l], p, s);
  const float y0 = __fadd_rn(gm.y1, __fmul_rn((float)py, gm.bin_h));
  const float count = (float)(s * s);

  const T* d = dout + ((size_t)r * p + py) * p * c;
  for (int ch = threadIdx.x; ch < c; ch += blockDim.x) {
    float* g = grad + ch;
    for (int px = 0; px < p; ++px) {
      const float share = __fdiv_rn(load_f(d + (size_t)px * c + ch), count);
      const float x0 = __fadd_rn(gm.x1, __fmul_rn((float)px, gm.bin_w));
      for (int iy = 0; iy < s; ++iy) {
        const float y = __fadd_rn(y0, __fmul_rn((float)iy + 0.5f, gm.sub_h));
        if (y < -1.f || y > (float)h) continue;
        const Axis ay = axis_weights(y, h);
        for (int ix = 0; ix < s; ++ix) {
          const float x = __fadd_rn(x0, __fmul_rn((float)ix + 0.5f, gm.sub_w));
          if (x < -1.f || x > (float)w) continue;
          const Axis ax = axis_weights(x, w);
          atomicAdd(g + ((size_t)ay.lo * w + ax.lo) * c, __fmul_rn(__fmul_rn(ay.h, ax.h), share));
          atomicAdd(g + ((size_t)ay.lo * w + ax.hi) * c, __fmul_rn(__fmul_rn(ay.h, ax.l), share));
          atomicAdd(g + ((size_t)ay.hi * w + ax.lo) * c, __fmul_rn(__fmul_rn(ay.l, ax.h), share));
          atomicAdd(g + ((size_t)ay.hi * w + ax.hi) * c, __fmul_rn(__fmul_rn(ay.l, ax.l), share));
        }
      }
    }
  }
}

__global__ void cast_to_bf16_kernel(const float* __restrict__ src, size_t n,
                                    __nv_bfloat16* __restrict__ dst) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    dst[i] = __float2bfloat16(src[i]);
  }
}

}  // namespace

extern "C" int roi_align_max_levels() { return kMaxLevels; }

// level_ptrs/hs/ws/scales: host arrays of num_levels entries, each level an
// NHWC-contiguous [B, H, W, c] map of `dtype` (0 = f32, 1 = bf16);
// boxes [r, 4] f32, batch_idx [r] i32, level [r] i32 in [0, num_levels);
// out [r, p, p, c] of `dtype`. Returns cudaGetLastError() after the launch.
extern "C" int roi_align_forward(const void* const* level_ptrs, const int* hs,
                                 const int* ws, const float* scales,
                                 int num_levels, const void* boxes,
                                 const void* batch_idx, const void* level,
                                 int r, int c, int p, int s, int dtype,
                                 void* out, void* stream) {
  if (r <= 0) return 0;
  if (num_levels < 1 || num_levels > kMaxLevels || dtype < 0 || dtype > 1) {
    return (int)cudaErrorInvalidValue;
  }
  Levels lv = {};
  for (int i = 0; i < num_levels; ++i) {
    lv.data[i] = level_ptrs[i];
    lv.h[i] = hs[i];
    lv.w[i] = ws[i];
    lv.scale[i] = scales[i];
  }
  const int threads = c >= 256 ? 256 : (c + 31) / 32 * 32;
  dim3 grid(r, p);
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) {
    roi_align_fwd_kernel<float><<<grid, threads, 0, st>>>(
        lv, (const float4*)boxes, (const int*)batch_idx, (const int*)level, c,
        p, s, (float*)out);
  } else {
    roi_align_fwd_kernel<__nv_bfloat16><<<grid, threads, 0, st>>>(
        lv, (const float4*)boxes, (const int*)batch_idx, (const int*)level, c,
        p, s, (__nv_bfloat16*)out);
  }
  return (int)cudaGetLastError();
}

// acc: float32 buffer of `total` elements holding every level's NHWC
// gradient back to back (level l at acc_offsets[l] elements, [B, H, W, c]);
// zeroed here. dout [r, p, p, c] of `dtype` (0 = f32, 1 = bf16); boxes,
// batch_idx, level as for the forward. For dtype 1 the float32 sums are
// cast once into out (bf16, same layout as acc); for dtype 0 acc is the
// result and out is unused. Returns cudaGetLastError() after the launches.
extern "C" int roi_align_backward(void* acc, const long long* acc_offsets,
                                  long long total, const int* hs, const int* ws,
                                  const float* scales, int num_levels,
                                  const void* boxes, const void* batch_idx,
                                  const void* level, int r, int c, int p, int s,
                                  int dtype, const void* dout, void* out,
                                  void* stream) {
  if (num_levels < 1 || num_levels > kMaxLevels || dtype < 0 || dtype > 1) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(acc, 0, (size_t)total * sizeof(float), st);
  if (e != cudaSuccess) return (int)e;
  GradLevels lv = {};
  for (int i = 0; i < num_levels; ++i) {
    lv.data[i] = (float*)acc + acc_offsets[i];
    lv.h[i] = hs[i];
    lv.w[i] = ws[i];
    lv.scale[i] = scales[i];
  }
  if (r > 0) {
    const int threads = c >= 256 ? 256 : (c + 31) / 32 * 32;
    dim3 grid(r, p);
    if (dtype == 0) {
      roi_align_bwd_kernel<float><<<grid, threads, 0, st>>>(
          lv, (const float4*)boxes, (const int*)batch_idx, (const int*)level,
          c, p, s, (const float*)dout);
    } else {
      roi_align_bwd_kernel<__nv_bfloat16><<<grid, threads, 0, st>>>(
          lv, (const float4*)boxes, (const int*)batch_idx, (const int*)level,
          c, p, s, (const __nv_bfloat16*)dout);
    }
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  if (dtype == 1 && total > 0) {
    const long long blocks = (total + 255) / 256;
    cast_to_bf16_kernel<<<(unsigned)(blocks < 132 * 32 ? blocks : 132 * 32), 256, 0, st>>>(
        (const float*)acc, (size_t)total, (__nv_bfloat16*)out);
  }
  return (int)cudaGetLastError();
}
