// Multi-level FPN ROIAlign, forward and backward, for Hopper (sm_90a).
//
// The forward replaces the TPU kernel
// maskrcnn_tpu/ops/pallas/roi_align_kernel.py (multilevel_roi_align_pallas /
// _kernel, with its jnp prep _precompute and _bin_weights); the backward
// (roi_align_backward, below the forward) replaces its default "roi"
// backward (_roi_align_bwd_roi / _roi_bwd_kernel); roi_align_backward_rmw
// and roi_align_backward_chunk, at the end of the file, replace its "rmw"
// and "chunk" backwards. Semantics are those of
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

// `only`, when given, restricts the scatter to the ROIs it flags (the
// window backwards hand it their oversize ROIs); the others' blocks return.
template <typename T>
__global__ void roi_align_bwd_kernel(GradLevels lv, const float4* __restrict__ boxes,
                                     const int* __restrict__ batch_idx,
                                     const int* __restrict__ level, int c,
                                     int p, int s, const T* __restrict__ dout,
                                     const unsigned char* __restrict__ only) {
  const int r = blockIdx.x;
  if (only != nullptr && !only[r]) return;
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

// ---------------------------------------------------------------------------
// Window-merged backwards ("rmw" and "chunk").
//
// They replace the TPU kernels _roi_align_bwd / _bwd_kernel ("rmw",
// roi_align_kernel.py:594) and _roi_align_bwd_chunk / _chunk_bwd_kernel
// ("chunk", :813). Both compute the same gradient as roi_align_bwd_kernel in
// the separable form: ROIs are sorted by window (level, image, y0/8, x0/8,
// computed in PyTorch by poolers.window_layout), each ROI carries row and
// column weights RowW, ColW [P, 48] over its window's 48 x 48 cells (the
// S x S bilinear samples of a bin summed and / S), and a window's gradient is
//   dPatch = sum over its ROIs of RowW^T . dOut . ColW   [48, 48, C].
// An ROI whose samples reach beyond its window ("oversize") has zero
// weights in the layout and goes through the exact per-sample scatter above
// (`only`), so no ROI is clamped.
//
// Design for the card (CUDA cores, float32 FMA throughout):
//   * one block per window run ("rmw"; blocks stride over the windows) or
//     per 8-row chunk of the chunk layout ("chunk"), times a tile of
//     kCt = 8 channels; 384 threads, thread (x, ch) owning column x of the
//     window at channel ch and all 48 rows of it in registers;
//   * per ROI: its weights and its dOut [P, P, kCt] staged in shared
//     memory; stage 1, T[pi] = sum_q ColW[q, x] dOut[pi, q, ch], is the
//     thread's own (x, ch) entry, so it never leaves registers; stage 2 adds
//     RowW[pi, y] * T[pi] into the 48 row accumulators. Both stages skip
//     exact zeros: a column x meets one or two column bins, a bin's row
//     weights a few rows (found once per ROI), so an ROI costs a few FMAs
//     per bin and thread, not 48;
//   * a window is flushed once from the registers: float32 atomicAdd of its
//     non-zero cells inside the level, in the rows its ROIs reached, into
//     the same zeroed NHWC buffer as the "roi" backward. Windows overlap
//     (origins 8 apart, 48 wide) and blocks run concurrently, so the flush
//     adds; its order, and so the result's last bits, change from run to
//     run;
//   * "chunk": a pure chunk (all rows of one window) flushes once; an
//     impure one flushes at each window start inside it. Padding rows of
//     the layout carry no ROI and are skipped.
// The sums stay float32 to the single cast at the end (the TPU kernel
// rounds each window flush into a bfloat16 buffer).
//
// What bounds them: the same bytes as the "roi" backward (dOut in, the
// dense level gradient out); their arithmetic is small. What this design
// spends beyond that: per ROI and channel tile, three block barriers and a
// staging of its weights and dOut from L2; per window a flush of up to
// 48 * 48 * C atomic adds, fewer than the "roi" backward's
// 4 * S * S * P * P * C per ROI only when ROIs share windows (PERF.md
// measures how many do on the training step).

constexpr int kPatch = 48;
constexpr int kPatch4 = kPatch / 4;
constexpr int kCt = 8;
constexpr int kWindowThreads = kPatch * kCt;

// The thread's 48 row sums, and the groups of 4 rows [lo4, hi4] that any
// ROI added so far reached (the same in every thread of the block).
struct WindowAcc {
  float v[kPatch];
  int lo4, hi4;
};

__device__ __forceinline__ void window_reset(WindowAcc& acc) {
#pragma unroll
  for (int y = 0; y < kPatch; ++y) acc.v[y] = 0.f;
  acc.lo4 = kPatch4;
  acc.hi4 = -1;
}

// Add one ROI's contribution to the thread's accumulators. Every thread of
// the block calls it with the same arguments. Only non-zero weights do
// work: a bin's row weights cover a few of the 48 rows (s_rng), and a
// column meets the weights of one or two column bins (qlo..qhi).
template <typename T>
__device__ __forceinline__ void window_add_roi(WindowAcc& acc, const T* __restrict__ d,
                                               const float* __restrict__ roww,
                                               const float* __restrict__ colw, int p,
                                               int c, int c0, float* s_row, float* s_col,
                                               float* s_d, int2* s_rng, int x, int ch) {
  __syncthreads();  // the previous ROI's stage 2 is done with the staging
  for (int i = threadIdx.x; i < p * kPatch; i += blockDim.x) {
    s_row[i] = roww[i];
    s_col[i] = colw[i];
  }
  for (int i = threadIdx.x; i < p * p * kCt; i += blockDim.x) {
    const int k = i % kCt;
    s_d[i] = c0 + k < c ? load_f(d + (size_t)(i / kCt) * c + c0 + k) : 0.f;
  }
  __syncthreads();
  if (threadIdx.x < p) {  // the groups of 4 rows with a non-zero weight of bin pi
    const float* r = s_row + threadIdx.x * kPatch;
    int lo = kPatch, hi = -1;
    for (int y = 0; y < kPatch; ++y) {
      if (r[y] != 0.f) {
        lo = min(lo, y);
        hi = y;
      }
    }
    s_rng[threadIdx.x] = make_int2(lo / 4, hi < 0 ? -1 : hi / 4);
  }
  __syncthreads();
  for (int pi = 0; pi < p; ++pi) {
    acc.lo4 = min(acc.lo4, s_rng[pi].x);
    acc.hi4 = max(acc.hi4, s_rng[pi].y);
  }
  int qlo = p, qhi = -1;
  for (int q = 0; q < p; ++q) {
    if (s_col[q * kPatch + x] != 0.f) {
      qlo = min(qlo, q);
      qhi = q;
    }
  }
  if (qlo > qhi) return;  // the ROI does not reach column x
  for (int pi = 0; pi < p; ++pi) {
    const int2 rng = s_rng[pi];
    if (rng.x > rng.y) continue;
    float t = 0.f;
    const float* dq = s_d + pi * p * kCt + ch;
    for (int q = qlo; q <= qhi; ++q) t = __fmaf_rn(s_col[q * kPatch + x], dq[q * kCt], t);
    const float4* rr = reinterpret_cast<const float4*>(s_row + pi * kPatch);
#pragma unroll
    for (int y4 = 0; y4 < kPatch4; ++y4) {
      if (y4 < rng.x || y4 > rng.y) continue;
      const float4 w4 = rr[y4];
      acc.v[4 * y4] = __fmaf_rn(w4.x, t, acc.v[4 * y4]);
      acc.v[4 * y4 + 1] = __fmaf_rn(w4.y, t, acc.v[4 * y4 + 1]);
      acc.v[4 * y4 + 2] = __fmaf_rn(w4.z, t, acc.v[4 * y4 + 2]);
      acc.v[4 * y4 + 3] = __fmaf_rn(w4.w, t, acc.v[4 * y4 + 3]);
    }
  }
}

// grad[l][b, y0 + y, x0 + x, c0 + ch] += acc[y] for the non-zero sums of the
// rows the window's ROIs reached, inside the level; then reset.
__device__ __forceinline__ void window_flush(WindowAcc& acc, const GradLevels& lv, int c,
                                             int l, int b, int y0, int x0, int c0, int x,
                                             int ch) {
  const int h = lv.h[l];
  const int w = lv.w[l];
  if (x0 + x < w && c0 + ch < c) {
    float* g = lv.data[l] + (((size_t)b * h + y0) * w + x0 + x) * c + c0 + ch;
#pragma unroll
    for (int y = 0; y < kPatch; ++y) {
      if (y / 4 >= acc.lo4 && y / 4 <= acc.hi4 && y0 + y < h && acc.v[y] != 0.f) {
        atomicAdd(g + (size_t)y * w * c, acc.v[y]);
      }
    }
  }
  window_reset(acc);
}

// rows [5, rp] int32 per sorted row: ROI index (-1: padding or oversize,
// skipped), level, image, y0, x0. weights [2, rp, P, 48] float32: RowW then
// ColW. wstart [rp + 2]: first sorted row of window w for w < the window
// count, rp after it.
template <typename T>
__global__ void __launch_bounds__(kWindowThreads, 2)
roi_align_bwd_rmw_kernel(GradLevels lv, int c, int p, const T* __restrict__ dout, int rp,
                         const int* __restrict__ rows, const float* __restrict__ weights,
                         const int* __restrict__ wstart) {
  extern __shared__ float smem[];
  float* s_row = smem;
  float* s_col = s_row + p * kPatch;
  float* s_d = s_col + p * kPatch;
  int2* s_rng = reinterpret_cast<int2*>(s_d + p * p * kCt);
  const int x = threadIdx.x / kCt;
  const int ch = threadIdx.x % kCt;
  const int c0 = blockIdx.y * kCt;
  const int* roi = rows;
  const int *lvl = rows + rp, *bi = rows + 2 * rp, *wy0 = rows + 3 * rp, *wx0 = rows + 4 * rp;
  const size_t wsize = (size_t)p * kPatch;
  WindowAcc acc;
  window_reset(acc);
  for (int wi = blockIdx.x; wi < rp; wi += gridDim.x) {
    const int start = wstart[wi];
    if (start >= rp) break;
    const int end = wstart[wi + 1];
    for (int i = start; i < end; ++i) {
      const int r = roi[i];
      if (r < 0) continue;
      window_add_roi(acc, dout + (size_t)r * p * p * c, weights + i * wsize,
                     weights + (rp + i) * wsize, p, c, c0, s_row, s_col, s_d, s_rng, x, ch);
    }
    window_flush(acc, lv, c, lvl[start], bi[start], wy0[start], wx0[start], c0, x, ch);
  }
}

// crow [3, n] int32 per chunk-layout row: sorted row (padding rows repeat
// their window's last one), 1 for a real row, 1 where a window starts (in a
// pure chunk, only at its first row). rows and weights as for the rmw
// kernel.
template <typename T>
__global__ void __launch_bounds__(kWindowThreads, 2)
roi_align_bwd_chunk_kernel(GradLevels lv, int c, int p, const T* __restrict__ dout, int rp,
                           const int* __restrict__ rows, const float* __restrict__ weights,
                           int n, int q, const int* __restrict__ crow) {
  extern __shared__ float smem[];
  float* s_row = smem;
  float* s_col = s_row + p * kPatch;
  float* s_d = s_col + p * kPatch;
  int2* s_rng = reinterpret_cast<int2*>(s_d + p * p * kCt);
  const int x = threadIdx.x / kCt;
  const int ch = threadIdx.x % kCt;
  const int c0 = blockIdx.y * kCt;
  const int *src = crow, *real = crow + n, *rnew = crow + 2 * n;
  const int* roi = rows;
  const int *lvl = rows + rp, *bi = rows + 2 * rp, *wy0 = rows + 3 * rp, *wx0 = rows + 4 * rp;
  const size_t wsize = (size_t)p * kPatch;
  const int j0 = blockIdx.x * q;
  WindowAcc acc;
  window_reset(acc);
  int cur = src[j0];  // the sorted row whose window the accumulators hold
  for (int j = j0; j < j0 + q; ++j) {
    const int i = src[j];
    if (j > j0 && rnew[j]) {
      window_flush(acc, lv, c, lvl[cur], bi[cur], wy0[cur], wx0[cur], c0, x, ch);
      cur = i;
    }
    const int r = real[j] ? roi[i] : -1;
    if (r < 0) continue;
    window_add_roi(acc, dout + (size_t)r * p * p * c, weights + i * wsize,
                   weights + (rp + i) * wsize, p, c, c0, s_row, s_col, s_d, s_rng, x, ch);
  }
  window_flush(acc, lv, c, lvl[cur], bi[cur], wy0[cur], wx0[cur], c0, x, ch);
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
namespace {

// Zero acc and describe its levels.
cudaError_t begin_backward(void* acc, const long long* acc_offsets, long long total,
                           const int* hs, const int* ws, const float* scales,
                           int num_levels, int dtype, cudaStream_t st, GradLevels* lv) {
  if (num_levels < 1 || num_levels > kMaxLevels || dtype < 0 || dtype > 1) {
    return cudaErrorInvalidValue;
  }
  for (int i = 0; i < num_levels; ++i) {
    lv->data[i] = (float*)acc + acc_offsets[i];
    lv->h[i] = hs[i];
    lv->w[i] = ws[i];
    lv->scale[i] = scales[i];
  }
  return cudaMemsetAsync(acc, 0, (size_t)total * sizeof(float), st);
}

// The exact per-sample scatter of every ROI, or of those `only` flags.
cudaError_t scatter_exact(const GradLevels& lv, const void* boxes, const void* batch_idx,
                          const void* level, const void* only, int r, int c, int p,
                          int s, int dtype, const void* dout, cudaStream_t st) {
  if (r <= 0) return cudaSuccess;
  const int threads = c >= 256 ? 256 : (c + 31) / 32 * 32;
  dim3 grid(r, p);
  if (dtype == 0) {
    roi_align_bwd_kernel<float><<<grid, threads, 0, st>>>(
        lv, (const float4*)boxes, (const int*)batch_idx, (const int*)level, c, p, s,
        (const float*)dout, (const unsigned char*)only);
  } else {
    roi_align_bwd_kernel<__nv_bfloat16><<<grid, threads, 0, st>>>(
        lv, (const float4*)boxes, (const int*)batch_idx, (const int*)level, c, p, s,
        (const __nv_bfloat16*)dout, (const unsigned char*)only);
  }
  return cudaGetLastError();
}

// For bf16, the one rounding of the float32 sums into out.
cudaError_t finish_backward(const void* acc, long long total, int dtype, void* out,
                            cudaStream_t st) {
  if (dtype == 1 && total > 0) {
    const long long blocks = (total + 255) / 256;
    cast_to_bf16_kernel<<<(unsigned)(blocks < 132 * 32 ? blocks : 132 * 32), 256, 0, st>>>(
        (const float*)acc, (size_t)total, (__nv_bfloat16*)out);
  }
  return cudaGetLastError();
}

size_t window_smem_bytes(int p) {
  return sizeof(float) * (2 * p * kPatch + p * p * kCt) + sizeof(int2) * p;
}

}  // namespace

extern "C" int roi_align_backward(void* acc, const long long* acc_offsets,
                                  long long total, const int* hs, const int* ws,
                                  const float* scales, int num_levels,
                                  const void* boxes, const void* batch_idx,
                                  const void* level, int r, int c, int p, int s,
                                  int dtype, const void* dout, void* out,
                                  void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  GradLevels lv = {};
  cudaError_t e = begin_backward(acc, acc_offsets, total, hs, ws, scales, num_levels,
                                 dtype, st, &lv);
  if (e == cudaSuccess) {
    e = scatter_exact(lv, boxes, batch_idx, level, nullptr, r, c, p, s, dtype, dout, st);
  }
  if (e == cudaSuccess) e = finish_backward(acc, total, dtype, out, st);
  return (int)e;
}

// The largest P the window backwards take (their staging in shared memory
// stays under the default 48 KB).
extern "C" int roi_align_window_max_p() { return 32; }

// The "rmw" backward. The arguments of roi_align_backward, then: oversize
// [r] uint8 (ROIs scattered exactly), rp the padded row count of the window
// layout, rows [5, rp] and weights [2, rp, p, 48] as for
// roi_align_bwd_rmw_kernel, wstart [rp + 2] int32.
extern "C" int roi_align_backward_rmw(void* acc, const long long* acc_offsets,
                                      long long total, const int* hs, const int* ws,
                                      const float* scales, int num_levels,
                                      const void* boxes, const void* batch_idx,
                                      const void* level, int r, int c, int p, int s,
                                      int dtype, const void* dout, void* out,
                                      const void* oversize, int rp, const void* rows,
                                      const void* weights, const void* wstart,
                                      void* stream) {
  if (p < 1 || p > roi_align_window_max_p()) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  GradLevels lv = {};
  cudaError_t e = begin_backward(acc, acc_offsets, total, hs, ws, scales, num_levels,
                                 dtype, st, &lv);
  if (e == cudaSuccess && rp > 0) {
    dim3 grid(rp < 512 ? rp : 512, (c + kCt - 1) / kCt);
    const size_t smem = window_smem_bytes(p);
    if (dtype == 0) {
      roi_align_bwd_rmw_kernel<float><<<grid, kWindowThreads, smem, st>>>(
          lv, c, p, (const float*)dout, rp, (const int*)rows, (const float*)weights,
          (const int*)wstart);
    } else {
      roi_align_bwd_rmw_kernel<__nv_bfloat16><<<grid, kWindowThreads, smem, st>>>(
          lv, c, p, (const __nv_bfloat16*)dout, rp, (const int*)rows,
          (const float*)weights, (const int*)wstart);
    }
    e = cudaGetLastError();
  }
  if (e == cudaSuccess) {
    e = scatter_exact(lv, boxes, batch_idx, level, oversize, r, c, p, s, dtype, dout, st);
  }
  if (e == cudaSuccess) e = finish_backward(acc, total, dtype, out, st);
  return (int)e;
}

// The "chunk" backward. As roi_align_backward_rmw, with the chunk layout in
// place of wstart: n rows of q-row chunks, crow [3, n] int32 as for
// roi_align_bwd_chunk_kernel.
extern "C" int roi_align_backward_chunk(void* acc, const long long* acc_offsets,
                                        long long total, const int* hs, const int* ws,
                                        const float* scales, int num_levels,
                                        const void* boxes, const void* batch_idx,
                                        const void* level, int r, int c, int p, int s,
                                        int dtype, const void* dout, void* out,
                                        const void* oversize, int rp, const void* rows,
                                        const void* weights, int n, int q,
                                        const void* crow, void* stream) {
  if (p < 1 || p > roi_align_window_max_p() || q < 1 || n % q != 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  GradLevels lv = {};
  cudaError_t e = begin_backward(acc, acc_offsets, total, hs, ws, scales, num_levels,
                                 dtype, st, &lv);
  if (e == cudaSuccess && n > 0) {
    dim3 grid(n / q, (c + kCt - 1) / kCt);
    const size_t smem = window_smem_bytes(p);
    if (dtype == 0) {
      roi_align_bwd_chunk_kernel<float><<<grid, kWindowThreads, smem, st>>>(
          lv, c, p, (const float*)dout, rp, (const int*)rows, (const float*)weights, n, q,
          (const int*)crow);
    } else {
      roi_align_bwd_chunk_kernel<__nv_bfloat16><<<grid, kWindowThreads, smem, st>>>(
          lv, c, p, (const __nv_bfloat16*)dout, rp, (const int*)rows,
          (const float*)weights, n, q, (const int*)crow);
    }
    e = cudaGetLastError();
  }
  if (e == cudaSuccess) {
    e = scatter_exact(lv, boxes, batch_idx, level, oversize, r, c, p, s, dtype, dout, st);
  }
  if (e == cudaSuccess) e = finish_backward(acc, total, dtype, out, st);
  return (int)e;
}
