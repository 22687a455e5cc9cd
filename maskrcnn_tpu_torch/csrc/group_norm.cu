// Group norm on channels-last maps, forward and backward, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package computes group norm in plain jnp
// (maskrcnn_tpu/models/layers.py:group_norm) and leaves it to XLA's fusion.
// It is here because the same chain in plain PyTorch
// (models/layers.py:group_norm_plain: x upcast to float32, about a dozen
// elementwise and reduction kernels forward and fifteen backward, float32
// copies of every activation kept for autograd) took ~80% of the GN
// training step on this card (PERF.md).
//
// Semantics are group_norm_plain's. x is [N, HW, C] (channels_last NCHW
// maps, permuted), G groups of Cg = C / G consecutive channels. Per (n, g),
// over (H, W, the group's channels), M = HW * Cg elements: the mean, and the
// variance of the deviations from the mean, in float32; rstd = 1 / sqrt(var
// + eps); y = ((x - mean) * rstd) * scale + bias in float32, rounded once to
// x's dtype. Backward, x^ = (x - mean) * rstd:
//   dbias_c  = sum_n A_nc,               A_nc = sum_hw dy
//   dscale_c = sum_n rstd_ng * B_nc,     B_nc = sum_hw dy * (x - mean)
//   dx = rstd * (scale * dy - s1 / M - x^ * (rstd * s2 / M)),
//   s1_ng = sum_{c in g} scale_c * A_nc, s2_ng = sum_{c in g} scale_c * B_nc,
// autograd's gradient of the forward, summed in float32, dx rounded once.
// Only x (in its dtype) and the per-(n, g) mean and rstd are kept for the
// backward.
//
// What bounds it: bytes. The forward must read x and write y, the backward
// read x and dy and write dx; a few float32 operations an element are far
// below the card's rate. The GN training step (batch 16, 800x1344, bf16)
// moves 40.8 GB that way, 12.2 ms at 3.35 TB/s.
//
// Design. A thread moves 8 channels of a pixel (one 16-byte access in bf16,
// two in float32), a block's 256 threads C / 8 lanes by 256 / (C / 8) pixel
// rows (C % 8 == 0, C <= 2048); a pass over a block's pixels reads 256 x 16
// contiguous bytes at a time. No float atomics: every sum runs in a fixed
// order, so two calls give the same bits. Which path a call takes follows
// from its shape alone (group_norm_plan):
//   * A sample (H * W * C of x, and of dy in the backward) that fits one
//     block's shared memory (the box head's [8192, 256, 7, 7] and the mask
//     head's [1024, 256, 14, 14] ROI batches in bf16) is staged there by one
//     block with cp.async: the forward reads x once and writes y once, the
//     backward reads x and dy once and writes dx once. The statistics are
//     the two passes of the plain version, over shared memory. The
//     backward's A and B go to a [N, 2, C] buffer, reduced over the samples
//     by group_norm_param_grad_kernel.
//   * Larger samples (the body, the FPN) are cut into pixel spans, ~1056
//     blocks in all. Forward: group_norm_stats_kernel reads each span once:
//     every thread takes 4 pixels at a time into registers and folds their
//     per-channel mean and M2 into its running ones by Chan's formula; the
//     block combines its threads' (per channel, rows in order) and then
//     channels into groups (equal counts), one (mean, M2) per (n, span,
//     group); group_norm_combine_kernel folds the spans in order (a warp per
//     (n, g)), so the variance is numerically a two-pass one; then
//     group_norm_apply_kernel reads x and writes y. Three accesses an
//     element. Backward: group_norm_bwd_sums_kernel reads x and dy into per
//     (n, span, c) A and B; group_norm_bwd_group_kernel sums the spans and
//     forms s1, s2; group_norm_bwd_dx_kernel reads x and dy and writes dx;
//     group_norm_param_grad_kernel reduces A and B over n. Five accesses.
//     The second read of x (and dy) walks the spans in reverse, so that it
//     starts on what the first left in L2: all of a map of a few tens of MB
//     (the res4 / res5 norms at batch 16), the last ~50 MB of a larger one.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 8;                   // channels a thread moves
constexpr int kMaxC = kThreads * kVec;    // widest map: one pixel row of a block
constexpr int kChunk = 4;                 // pixels a thread holds at once, forward
constexpr int kChunkBwd = 2;              // and backward (x and dy)
constexpr int kTargetBlocks = 8 * 132;    // blocks of a large-map forward pass, all samples
constexpr int kTargetBlocksBwd = 4 * 132; // and backward,
constexpr int kMinSpanBwd = 64;           // whose per-channel partials want long spans
constexpr int kParamRows = 32;            // sample rows of the parameter-gradient block
constexpr size_t kMaxSmem = 227 * 1024;
constexpr unsigned kFull = 0xffffffffu;

// 8 consecutive channels at a 16-byte aligned address (global or shared), as float32.
__device__ __forceinline__ void load8(const float* p, float v[kVec]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float v[kVec]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    v[2 * k] = f.x;
    v[2 * k + 1] = f.y;
  }
}
__device__ __forceinline__ void store8(float* p, const float v[kVec]) {
  float4* q = reinterpret_cast<float4*>(p);
  q[0] = make_float4(v[0], v[1], v[2], v[3]);
  q[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float v[kVec]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) h[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
}

// A thread's place in a block over C channels: lane (8 channels), pixel row.
struct Place {
  int lanes, rows, lane, row;
  bool active;
};

__device__ __forceinline__ Place place_of(int c) {
  Place q;
  q.lanes = c / kVec;
  q.rows = kThreads / q.lanes;
  q.lane = threadIdx.x % q.lanes;
  q.row = threadIdx.x / q.lanes;
  q.active = q.row < q.rows;
  return q;
}

// Fold (nb, mb, qb) into (na, ma, qa): count, mean, sum of squared deviations.
__device__ __forceinline__ void chan_merge(float& na, float& ma, float& qa, float nb, float mb,
                                           float qb) {
  if (nb == 0.f) return;
  const float nt = na + nb;
  const float d = mb - ma;
  ma += d * (nb / nt);
  qa += qb + d * d * (na * nb / nt);
  na = nt;
}

// scratch[row * c + ch] holds each active thread's 8 values; afterwards
// scratch[ch] holds their sum over the rows, in row order.
__device__ __forceinline__ void sum_rows(float* scratch, int c, int rows) {
  __syncthreads();
  for (int ch = threadIdx.x; ch < c; ch += kThreads) {
    float s = scratch[ch];
    for (int r = 1; r < rows; ++r) s += scratch[r * c + ch];
    scratch[ch] = s;
  }
  __syncthreads();
}

// The per-channel constants of a thread's 8 channels.
struct Affine {
  float mean[kVec], rstd[kVec], scale[kVec], bias[kVec];
};

__device__ __forceinline__ void affine_of(Affine& a, const float* mean, const float* rstd,
                                          const float* scale, const float* bias, int ch0,
                                          int cg) {
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    const int gi = (ch0 + j) / cg;
    a.mean[j] = mean[gi];
    a.rstd[j] = rstd[gi];
    a.scale[j] = scale[ch0 + j];
    a.bias[j] = bias[ch0 + j];
  }
}

// y = ((x - mean) * rstd) * scale + bias, each step rounded in float32
// (built with -fmad=false), as group_norm_plain.
__device__ __forceinline__ void normalize8(const Affine& a, const float v[kVec], float o[kVec]) {
#pragma unroll
  for (int j = 0; j < kVec; ++j) o[j] = ((v[j] - a.mean[j]) * a.rstd[j]) * a.scale[j] + a.bias[j];
}

// dx = rstd * (scale * dy - m1 - x^ * m2), m1 = s1 / M, m2 = rstd * s2 / M.
struct DxCoef {
  float mean[kVec], rstd[kVec], scale[kVec], m1[kVec], m2[kVec];
};

__device__ __forceinline__ void dx8(const DxCoef& k, const float x[kVec], const float dy[kVec],
                                    float o[kVec]) {
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    const float xh = (x[j] - k.mean[j]) * k.rstd[j];
    o[j] = k.rstd[j] * (k.scale[j] * dy[j] - k.m1[j] - xh * k.m2[j]);
  }
}

template <typename T>
__device__ __forceinline__ void stage(T* dst, const T* src, size_t elems) {
  const size_t pieces = elems * sizeof(T) / 16;
  for (size_t i = threadIdx.x; i < pieces; i += kThreads) {
    cp_async16(reinterpret_cast<char*>(dst) + 16 * i, reinterpret_cast<const char*>(src) + 16 * i);
  }
}

__device__ __forceinline__ void stage_wait() {
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();
}

// ---------------------------------------------------------------- ROI path

// One block a sample: x staged in shared memory, two passes for the
// statistics, y written once. Shared memory: x, then kThreads * kVec floats
// of row sums, then mean and rstd of the G groups.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    group_norm_roi_fwd_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                              const float* __restrict__ bias, int hw, int c, int g, float eps,
                              T* __restrict__ y, float* __restrict__ mean_out,
                              float* __restrict__ rstd_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t elems = (size_t)hw * c;
  T* xs = reinterpret_cast<T*>(smem);
  float* scratch = reinterpret_cast<float*>(smem + elems * sizeof(T));
  float* s_mean = scratch + kThreads * kVec;
  float* s_rstd = s_mean + g;
  const int n = blockIdx.x, cg = c / g;
  const float count = (float)hw * (float)cg;
  stage(xs, x + n * elems, elems);
  stage_wait();
  const Place q = place_of(c);
  const int ch0 = kVec * q.lane;
  float acc[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) acc[j] = 0.f;
  if (q.active) {
    for (int p = q.row; p < hw; p += q.rows) {
      float v[kVec];
      load8(xs + (size_t)p * c + ch0, v);
#pragma unroll
      for (int j = 0; j < kVec; ++j) acc[j] += v[j];
    }
#pragma unroll
    for (int j = 0; j < kVec; ++j) scratch[q.row * c + ch0 + j] = acc[j];
  }
  sum_rows(scratch, c, q.rows);
  for (int k = threadIdx.x; k < g; k += kThreads) {
    float s = 0.f;
    for (int ch = k * cg; ch < (k + 1) * cg; ++ch) s += scratch[ch];
    s_mean[k] = s / count;
  }
  __syncthreads();
  float mu[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    mu[j] = s_mean[(ch0 + j) / cg];
    acc[j] = 0.f;
  }
  if (q.active) {
    for (int p = q.row; p < hw; p += q.rows) {
      float v[kVec];
      load8(xs + (size_t)p * c + ch0, v);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const float d = v[j] - mu[j];
        acc[j] += d * d;
      }
    }
#pragma unroll
    for (int j = 0; j < kVec; ++j) scratch[q.row * c + ch0 + j] = acc[j];
  }
  sum_rows(scratch, c, q.rows);
  for (int k = threadIdx.x; k < g; k += kThreads) {
    float s = 0.f;
    for (int ch = k * cg; ch < (k + 1) * cg; ++ch) s += scratch[ch];
    s_rstd[k] = 1.f / sqrtf(s / count + eps);
    mean_out[n * g + k] = s_mean[k];
    rstd_out[n * g + k] = s_rstd[k];
  }
  __syncthreads();
  if (!q.active) return;
  Affine a;
  affine_of(a, s_mean, s_rstd, scale, bias, ch0, cg);
  T* yn = y + n * elems;
  for (int p = q.row; p < hw; p += q.rows) {
    float v[kVec], o[kVec];
    load8(xs + (size_t)p * c + ch0, v);
    normalize8(a, v, o);
    store8(yn + (size_t)p * c + ch0, o);
  }
}

// One block a sample: x and dy staged, A_c and B_c summed over the sample
// (one pass each) into ab [N, 2, C], s1 and s2 formed, dx written once.
// Shared memory: x, dy, kThreads * kVec floats of row sums, s1 and s2.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    group_norm_roi_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                              const float* __restrict__ scale, const float* __restrict__ mean,
                              const float* __restrict__ rstd, int hw, int c, int g,
                              T* __restrict__ dx, float* __restrict__ ab) {
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t elems = (size_t)hw * c;
  T* xs = reinterpret_cast<T*>(smem);
  T* ds = xs + elems;
  float* scratch = reinterpret_cast<float*>(smem + 2 * elems * sizeof(T));
  float* s_s1 = scratch + kThreads * kVec;
  float* s_s2 = s_s1 + g;
  const int n = blockIdx.x, cg = c / g;
  stage(xs, x + n * elems, elems);
  stage(ds, dy + n * elems, elems);
  stage_wait();
  const Place q = place_of(c);
  const int ch0 = kVec * q.lane;
  const float* mean_n = mean + n * g;
  const float* rstd_n = rstd + n * g;
  float mu[kVec], acc[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    mu[j] = mean_n[(ch0 + j) / cg];
    acc[j] = 0.f;
  }
  for (int pass = 0; pass < 2; ++pass) {
    if (q.active) {
#pragma unroll
      for (int j = 0; j < kVec; ++j) acc[j] = 0.f;
      for (int p = q.row; p < hw; p += q.rows) {
        float d[kVec];
        load8(ds + (size_t)p * c + ch0, d);
        if (pass == 0) {
#pragma unroll
          for (int j = 0; j < kVec; ++j) acc[j] += d[j];
        } else {
          float v[kVec];
          load8(xs + (size_t)p * c + ch0, v);
#pragma unroll
          for (int j = 0; j < kVec; ++j) acc[j] += d[j] * (v[j] - mu[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < kVec; ++j) scratch[q.row * c + ch0 + j] = acc[j];
    }
    sum_rows(scratch, c, q.rows);
    for (int ch = threadIdx.x; ch < c; ch += kThreads) {
      ab[(2 * (size_t)n + pass) * c + ch] = scratch[ch];
    }
    float* s_out = pass == 0 ? s_s1 : s_s2;
    for (int k = threadIdx.x; k < g; k += kThreads) {
      float s = 0.f;
      for (int ch = k * cg; ch < (k + 1) * cg; ++ch) s += scale[ch] * scratch[ch];
      s_out[k] = s;
    }
    __syncthreads();
  }
  if (!q.active) return;
  const float count = (float)hw * (float)cg;
  DxCoef k;
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    const int gi = (ch0 + j) / cg;
    k.mean[j] = mu[j];
    k.rstd[j] = rstd_n[gi];
    k.scale[j] = scale[ch0 + j];
    k.m1[j] = s_s1[gi] / count;
    k.m2[j] = k.rstd[j] * s_s2[gi] / count;
  }
  T* dxn = dx + n * elems;
  for (int p = q.row; p < hw; p += q.rows) {
    float v[kVec], d[kVec], o[kVec];
    load8(xs + (size_t)p * c + ch0, v);
    load8(ds + (size_t)p * c + ch0, d);
    dx8(k, v, d, o);
    store8(dxn + (size_t)p * c + ch0, o);
  }
}

// ---------------------------------------------------------- large-map path
// Grid (N, spans): block (n, s) takes pixels [s * span, min(hw, (s + 1) * span)).

// (n, s) of a second pass's block: the blocks in the reverse of the first
// pass's order, so that the spans it read last, still in the 50 MB L2, are
// read again first (all of them for a map of a few tens of MB).
__device__ __forceinline__ void second_pass_block(int& n, int& s) {
  const int id = gridDim.x * gridDim.y - 1 - (blockIdx.x + blockIdx.y * gridDim.x);
  n = id % gridDim.x;
  s = id / gridDim.x;
}

// (mean, M2) of each group over a block's span: part [N, spans, G] float2.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    group_norm_stats_kernel(const T* __restrict__ x, int hw, int c, int g, int span,
                            float2* __restrict__ part) {
  __shared__ float s_mean[kMaxC];
  __shared__ float s_m2[kMaxC];
  __shared__ float s_cnt[kThreads];
  const int n = blockIdx.x, s = blockIdx.y, cg = c / g;
  const int p0 = s * span, p1 = min(hw, p0 + span);
  const Place q = place_of(c);
  const int ch0 = kVec * q.lane;
  float cnt = 0.f, mean[kVec], m2[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) mean[j] = m2[j] = 0.f;
  if (q.active) {
    const T* xn = x + (size_t)n * hw * c + ch0;
    for (int base = p0 + q.row; base < p1; base += q.rows * kChunk) {
      float v[kChunk][kVec];
#pragma unroll
      for (int k = 0; k < kChunk; ++k) {
        const int p = base + k * q.rows;
        if (p < p1) {
          load8(xn + (size_t)p * c, v[k]);
        } else {
#pragma unroll
          for (int j = 0; j < kVec; ++j) v[k][j] = 0.f;
        }
      }
      const int nk = min(kChunk, (p1 - base + q.rows - 1) / q.rows);
      const float fk = (float)nk, inv = 1.f / fk, nt = cnt + fk;
      const float wb = fk / nt, wab = cnt * fk / nt;
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        float sum = 0.f;
#pragma unroll
        for (int k = 0; k < kChunk; ++k) sum += v[k][j];
        const float cm = sum * inv;
        float m2k = 0.f;
#pragma unroll
        for (int k = 0; k < kChunk; ++k) {
          const float d = v[k][j] - cm;
          if (k < nk) m2k += d * d;
        }
        const float delta = cm - mean[j];
        mean[j] += delta * wb;
        m2[j] += m2k + delta * delta * wab;
      }
      cnt = nt;
    }
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      s_mean[q.row * c + ch0 + j] = mean[j];
      s_m2[q.row * c + ch0 + j] = m2[j];
    }
    if (q.lane == 0) s_cnt[q.row] = cnt;
  }
  __syncthreads();
  for (int ch = threadIdx.x; ch < c; ch += kThreads) {
    float na = 0.f, ma = 0.f, qa = 0.f;
    for (int r = 0; r < q.rows; ++r) {
      chan_merge(na, ma, qa, s_cnt[r], s_mean[r * c + ch], s_m2[r * c + ch]);
    }
    s_mean[ch] = ma;
    s_m2[ch] = qa;
  }
  __syncthreads();
  // channels into groups: every channel counts the span's p1 - p0 pixels
  const float npix = (float)(p1 - p0);
  for (int k = threadIdx.x; k < g; k += kThreads) {
    float mu = 0.f;
    for (int ch = k * cg; ch < (k + 1) * cg; ++ch) mu += s_mean[ch];
    mu /= (float)cg;
    float m2g = 0.f;
    for (int ch = k * cg; ch < (k + 1) * cg; ++ch) {
      const float d = s_mean[ch] - mu;
      m2g += s_m2[ch] + npix * (d * d);
    }
    part[((size_t)n * gridDim.y + s) * g + k] = make_float2(mu, m2g);
  }
}

// A warp per (n, g): the spans' partials folded in a fixed order (lane j
// takes spans j, j + 32, ...; then a shuffle tree), mean and rstd out.
__global__ void __launch_bounds__(kThreads)
    group_norm_combine_kernel(const float2* __restrict__ part, int n_total, int hw, int g,
                              int cg, int span, int spans, float eps, float* __restrict__ mean_out,
                              float* __restrict__ rstd_out) {
  const int w = (blockIdx.x * kThreads + threadIdx.x) / 32, lane = threadIdx.x % 32;
  if (w >= n_total * g) return;  // whole warps
  const int n = w / g, k = w % g;
  float na = 0.f, ma = 0.f, qa = 0.f;
  for (int s = lane; s < spans; s += 32) {
    const float2 pq = part[((size_t)n * spans + s) * g + k];
    const float nb = (float)(min(hw, (s + 1) * span) - s * span) * (float)cg;
    chan_merge(na, ma, qa, nb, pq.x, pq.y);
  }
  for (int off = 16; off > 0; off >>= 1) {
    const float nb = __shfl_down_sync(kFull, na, off);
    const float mb = __shfl_down_sync(kFull, ma, off);
    const float qb = __shfl_down_sync(kFull, qa, off);
    if (lane + off < 32) chan_merge(na, ma, qa, nb, mb, qb);
  }
  if (lane == 0) {
    mean_out[w] = ma;
    rstd_out[w] = 1.f / sqrtf(qa / na + eps);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    group_norm_apply_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                            const float* __restrict__ bias, const float* __restrict__ mean,
                            const float* __restrict__ rstd, int hw, int c, int g, int span,
                            T* __restrict__ y) {
  const Place q = place_of(c);
  if (!q.active) return;
  int n, s;
  second_pass_block(n, s);
  const int p0 = s * span, p1 = min(hw, p0 + span);
  const int ch0 = kVec * q.lane;
  Affine a;
  affine_of(a, mean + n * g, rstd + n * g, scale, bias, ch0, c / g);
  const size_t off = (size_t)n * hw * c + ch0;
  for (int base = p0 + q.row; base < p1; base += q.rows * kChunk) {
    float v[kChunk][kVec];
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      const int p = base + k * q.rows;
      if (p < p1) load8(x + off + (size_t)p * c, v[k]);
    }
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      const int p = base + k * q.rows;
      if (p < p1) {
        float o[kVec];
        normalize8(a, v[k], o);
        store8(y + off + (size_t)p * c, o);
      }
    }
  }
}

// Per (n, span, channel) A = sum dy and B = sum dy * (x - mean) over the
// span: part [N, spans, 2, C].
template <typename T>
__global__ void __launch_bounds__(kThreads)
    group_norm_bwd_sums_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                               const float* __restrict__ mean, int hw, int c, int g, int span,
                               float* __restrict__ part) {
  __shared__ float s_a[kMaxC];
  __shared__ float s_b[kMaxC];
  const int n = blockIdx.x, s = blockIdx.y, cg = c / g;
  const int p0 = s * span, p1 = min(hw, p0 + span);
  const Place q = place_of(c);
  const int ch0 = kVec * q.lane;
  if (q.active) {
    float mu[kVec], a[kVec], b[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      mu[j] = mean[n * g + (ch0 + j) / cg];
      a[j] = b[j] = 0.f;
    }
    const size_t off = (size_t)n * hw * c + ch0;
    for (int base = p0 + q.row; base < p1; base += q.rows * kChunkBwd) {
      float v[kChunkBwd][kVec], d[kChunkBwd][kVec];
#pragma unroll
      for (int k = 0; k < kChunkBwd; ++k) {
        const int p = base + k * q.rows;
        if (p < p1) {
          load8(x + off + (size_t)p * c, v[k]);
          load8(dy + off + (size_t)p * c, d[k]);
        }
      }
#pragma unroll
      for (int k = 0; k < kChunkBwd; ++k) {
        if (base + k * q.rows < p1) {
#pragma unroll
          for (int j = 0; j < kVec; ++j) {
            a[j] += d[k][j];
            b[j] += d[k][j] * (v[k][j] - mu[j]);
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      s_a[q.row * c + ch0 + j] = a[j];
      s_b[q.row * c + ch0 + j] = b[j];
    }
  }
  sum_rows(s_a, c, q.rows);
  sum_rows(s_b, c, q.rows);
  float* out = part + ((size_t)n * gridDim.y + s) * 2 * c;
  for (int ch = threadIdx.x; ch < c; ch += kThreads) {
    out[ch] = s_a[ch];
    out[c + ch] = s_b[ch];
  }
}

// A block a sample: A and B summed over the spans in order into ab [N, 2, C],
// then s1 and s2 of each group into coef [N, G, 2].
__global__ void __launch_bounds__(kThreads)
    group_norm_bwd_group_kernel(const float* __restrict__ part, const float* __restrict__ scale,
                                int c, int g, int spans, float* __restrict__ ab,
                                float* __restrict__ coef) {
  __shared__ float s_ab[2 * kMaxC];
  const int n = blockIdx.x, cg = c / g;
  for (int ch = threadIdx.x; ch < 2 * c; ch += kThreads) {
    float t = 0.f;
    for (int s = 0; s < spans; ++s) t += part[((size_t)n * spans + s) * 2 * c + ch];
    s_ab[ch] = t;
    ab[(size_t)n * 2 * c + ch] = t;
  }
  __syncthreads();
  for (int k = threadIdx.x; k < g; k += kThreads) {
    float s1 = 0.f, s2 = 0.f;
    for (int ch = k * cg; ch < (k + 1) * cg; ++ch) {
      s1 += scale[ch] * s_ab[ch];
      s2 += scale[ch] * s_ab[c + ch];
    }
    coef[((size_t)n * g + k) * 2] = s1;
    coef[((size_t)n * g + k) * 2 + 1] = s2;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    group_norm_bwd_dx_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                             const float* __restrict__ scale, const float* __restrict__ mean,
                             const float* __restrict__ rstd, const float* __restrict__ coef,
                             int hw, int c, int g, int span, T* __restrict__ dx) {
  const Place q = place_of(c);
  if (!q.active) return;
  int n, s;
  second_pass_block(n, s);
  const int cg = c / g;
  const int p0 = s * span, p1 = min(hw, p0 + span);
  const int ch0 = kVec * q.lane;
  const float count = (float)hw * (float)cg;
  DxCoef k;
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    const int gi = n * g + (ch0 + j) / cg;
    k.mean[j] = mean[gi];
    k.rstd[j] = rstd[gi];
    k.scale[j] = scale[ch0 + j];
    k.m1[j] = coef[2 * gi] / count;
    k.m2[j] = k.rstd[j] * coef[2 * gi + 1] / count;
  }
  const size_t off = (size_t)n * hw * c + ch0;
  for (int base = p0 + q.row; base < p1; base += q.rows * kChunkBwd) {
    float v[kChunkBwd][kVec], d[kChunkBwd][kVec];
#pragma unroll
    for (int i = 0; i < kChunkBwd; ++i) {
      const int p = base + i * q.rows;
      if (p < p1) {
        load8(x + off + (size_t)p * c, v[i]);
        load8(dy + off + (size_t)p * c, d[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < kChunkBwd; ++i) {
      const int p = base + i * q.rows;
      if (p < p1) {
        float o[kVec];
        dx8(k, v[i], d[i], o);
        store8(dx + off + (size_t)p * c, o);
      }
    }
  }
}

// dbias_c = sum_n A_nc, dscale_c = sum_n rstd_ng * B_nc, both paths: a block
// of 32 channels x 32 sample rows (row r takes n = r, r + 32, ...), the rows
// then summed in order.
__global__ void __launch_bounds__(32 * kParamRows)
    group_norm_param_grad_kernel(const float* __restrict__ ab, const float* __restrict__ rstd,
                                 int n_total, int c, int g, float* __restrict__ dscale,
                                 float* __restrict__ dbias) {
  __shared__ float s_a[kParamRows][33];
  __shared__ float s_b[kParamRows][33];
  const int cx = threadIdx.x % 32, ry = threadIdx.x / 32;
  const int ch = blockIdx.x * 32 + cx;
  float a = 0.f, b = 0.f;
  if (ch < c) {
    const int gi = ch / (c / g);
    for (int n = ry; n < n_total; n += kParamRows) {
      a += ab[(size_t)n * 2 * c + ch];
      b += rstd[(size_t)n * g + gi] * ab[(size_t)n * 2 * c + c + ch];
    }
  }
  s_a[ry][cx] = a;
  s_b[ry][cx] = b;
  __syncthreads();
  if (ry == 0 && ch < c) {
    float ta = 0.f, tb = 0.f;
    for (int r = 0; r < kParamRows; ++r) {
      ta += s_a[r][cx];
      tb += s_b[r][cx];
    }
    dbias[ch] = ta;
    dscale[ch] = tb;
  }
}

// -------------------------------------------------------------- launching

struct Plan {
  bool roi;        // a sample (x, and dy backward) fits one block's shared memory
  size_t smem;     // the ROI kernel's dynamic shared memory
  int span, spans; // large-map path: pixels a block, blocks a sample
  long long ws;    // float32 workspace the call needs
};

bool valid(int n, int hw, int c, int g, int dtype) {
  return n >= 1 && hw >= 1 && c >= kVec && c % kVec == 0 && c <= kMaxC && g >= 1 &&
         c % g == 0 && (dtype == 0 || dtype == 1) && (long long)hw * c <= (1ll << 31) / 4;
}

Plan plan_of(int n, int hw, int c, int g, int dtype, bool backward) {
  Plan p;
  const size_t item = dtype == 0 ? sizeof(float) : sizeof(__nv_bfloat16);
  p.smem = (size_t)hw * c * item * (backward ? 2 : 1) + (kThreads * kVec + 2 * g) * sizeof(float);
  p.roi = p.smem <= kMaxSmem;
  const int want = ((backward ? kTargetBlocksBwd : kTargetBlocks) + n - 1) / n;
  const int pass = kThreads / (c / kVec) * kChunk;  // pixels of a forward block's pass
  const int most = backward ? hw / kMinSpanBwd : (hw + pass - 1) / pass;
  const int spans = std::max(1, std::min(want, most));
  p.span = (hw + spans - 1) / spans;
  p.spans = (hw + p.span - 1) / p.span;
  const long long nc2 = 2ll * n * c;
  if (p.roi) {
    p.ws = backward ? nc2 : 0;
  } else {
    p.ws = backward ? (long long)p.spans * nc2 + nc2 + 2ll * n * g : 2ll * n * p.spans * g;
  }
  return p;
}

bool aligned16(const void* ptr) { return (uintptr_t)ptr % 16 == 0; }

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

cudaError_t param_grad(const float* ab, const float* rstd, int n, int c, int g, float* dscale,
                       float* dbias, cudaStream_t st) {
  group_norm_param_grad_kernel<<<(c + 31) / 32, 32 * kParamRows, 0, st>>>(ab, rstd, n, c, g,
                                                                          dscale, dbias);
  return cudaGetLastError();
}

template <typename T>
cudaError_t forward(const Plan& p, const T* x, const float* scale, const float* bias, int n,
                    int hw, int c, int g, float eps, T* y, float* mean, float* rstd, float* ws,
                    cudaStream_t st) {
  cudaError_t e;
  if (p.roi) {
    if ((e = allow_smem(group_norm_roi_fwd_kernel<T>, p.smem)) != cudaSuccess) return e;
    group_norm_roi_fwd_kernel<T><<<n, kThreads, p.smem, st>>>(x, scale, bias, hw, c, g, eps, y,
                                                              mean, rstd);
    return cudaGetLastError();
  }
  const dim3 grid(n, p.spans);
  float2* part = reinterpret_cast<float2*>(ws);
  group_norm_stats_kernel<T><<<grid, kThreads, 0, st>>>(x, hw, c, g, p.span, part);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const int warps = n * g;
  group_norm_combine_kernel<<<(warps + kThreads / 32 - 1) / (kThreads / 32), kThreads, 0, st>>>(
      part, n, hw, g, c / g, p.span, p.spans, eps, mean, rstd);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  group_norm_apply_kernel<T><<<grid, kThreads, 0, st>>>(x, scale, bias, mean, rstd, hw, c, g,
                                                        p.span, y);
  return cudaGetLastError();
}

template <typename T>
cudaError_t backward(const Plan& p, const T* x, const T* dy, const float* scale,
                     const float* mean, const float* rstd, int n, int hw, int c, int g, T* dx,
                     float* dscale, float* dbias, float* ws, cudaStream_t st) {
  cudaError_t e;
  float* ab = ws;  // [N, 2, C]
  if (p.roi) {
    if ((e = allow_smem(group_norm_roi_bwd_kernel<T>, p.smem)) != cudaSuccess) return e;
    group_norm_roi_bwd_kernel<T><<<n, kThreads, p.smem, st>>>(x, dy, scale, mean, rstd, hw, c, g,
                                                              dx, ab);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    return param_grad(ab, rstd, n, c, g, dscale, dbias, st);
  }
  float* coef = ab + 2ll * n * c;   // [N, G, 2]
  float* part = coef + 2ll * n * g; // [N, spans, 2, C]
  const dim3 grid(n, p.spans);
  group_norm_bwd_sums_kernel<T><<<grid, kThreads, 0, st>>>(x, dy, mean, hw, c, g, p.span, part);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  group_norm_bwd_group_kernel<<<n, kThreads, 0, st>>>(part, scale, c, g, p.spans, ab, coef);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  group_norm_bwd_dx_kernel<T><<<grid, kThreads, 0, st>>>(x, dy, scale, mean, rstd, coef, hw, c,
                                                         g, p.span, dx);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  return param_grad(ab, rstd, n, c, g, dscale, dbias, st);
}

}  // namespace

// The path a call of this shape takes (1: a sample a block, 0: pixel
// spans; -1: a shape the kernels do not take) and, in *ws, the float32
// workspace it needs. dtype 0 float32, 1 bfloat16.
extern "C" int group_norm_plan(int n, int hw, int c, int g, int dtype, int backward,
                               long long* ws) {
  if (!valid(n, hw, c, g, dtype)) return -1;
  const Plan p = plan_of(n, hw, c, g, dtype, backward != 0);
  *ws = p.ws;
  return p.roi ? 1 : 0;
}

// x, y [N, HW, C] in dtype; scale, bias [C] and mean, rstd [N, G] float32;
// ws as group_norm_plan asks. Launches on `stream`; returns
// cudaGetLastError() after the launches.
extern "C" int group_norm_forward(const void* x, const void* scale, const void* bias, int n,
                                  int hw, int c, int g, float eps, int dtype, void* y, void* mean,
                                  void* rstd, void* ws, long long ws_floats, void* stream) {
  if (!valid(n, hw, c, g, dtype) || !aligned16(x) || !aligned16(y)) {
    return (int)cudaErrorInvalidValue;
  }
  const Plan p = plan_of(n, hw, c, g, dtype, false);
  if (ws_floats < p.ws) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const float *sc = (const float*)scale, *bi = (const float*)bias;
  float *mu = (float*)mean, *rs = (float*)rstd, *w = (float*)ws;
  if (dtype == 0) {
    return (int)forward<float>(p, (const float*)x, sc, bi, n, hw, c, g, eps, (float*)y, mu, rs, w,
                               st);
  }
  return (int)forward<__nv_bfloat16>(p, (const __nv_bfloat16*)x, sc, bi, n, hw, c, g, eps,
                                     (__nv_bfloat16*)y, mu, rs, w, st);
}

// dx [N, HW, C] in dtype from x and dy (same layout and dtype) and the
// forward's mean and rstd; dscale, dbias [C] float32, written whole.
extern "C" int group_norm_backward(const void* x, const void* dy, const void* scale,
                                   const void* mean, const void* rstd, int n, int hw, int c, int g,
                                   int dtype, void* dx, void* dscale, void* dbias, void* ws,
                                   long long ws_floats, void* stream) {
  if (!valid(n, hw, c, g, dtype) || !aligned16(x) || !aligned16(dy) || !aligned16(dx)) {
    return (int)cudaErrorInvalidValue;
  }
  const Plan p = plan_of(n, hw, c, g, dtype, true);
  if (ws_floats < p.ws) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const float *sc = (const float*)scale, *mu = (const float*)mean, *rs = (const float*)rstd;
  float *dsc = (float*)dscale, *dbi = (float*)dbias, *w = (float*)ws;
  if (dtype == 0) {
    return (int)backward<float>(p, (const float*)x, (const float*)dy, sc, mu, rs, n, hw, c, g,
                                (float*)dx, dsc, dbi, w, st);
  }
  return (int)backward<__nv_bfloat16>(p, (const __nv_bfloat16*)x, (const __nv_bfloat16*)dy, sc,
                                      mu, rs, n, hw, c, g, (__nv_bfloat16*)dx, dsc, dbi, w, st);
}
