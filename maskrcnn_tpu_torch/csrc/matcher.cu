// Batched RPN anchor matcher for Hopper (sm_90a).
//
// Replaces the TPU kernel maskrcnn_tpu/ops/pallas/matcher_kernel.py
// (match_anchors_pallas / _matcher_kernel). Same contract as
// maskrcnn_tpu/ops/matcher.py:match_anchors_streaming (the reference
// Matcher with allow_low_quality_matches=True), per image:
//   * each anchor's best IoU over the valid gt, and the first gt index
//     reaching it;
//   * each valid gt's best IoU over all anchors; an anchor whose IoU with a
//     valid gt equals that gt's best, when the best is > 0, keeps its match
//     whatever the thresholds (the low-quality restore);
//   * otherwise best < low gives -1, low <= best < high gives -2.
//
// The TPU kernel runs its grid in order and carries the per-gt maxima in
// VMEM scratch from its first pass over the anchors to its second. Blocks
// on this card run in no order, so the two passes are two launches over an
// (anchor tile, image) grid, each block with its image's gt rows in shared
// memory and its gt loop bounded by the last valid gt (the TPU kernel's
// nblocks):
//   1. matcher_gt_best_kernel: per gt, the block's best IoU by a warp
//      max-reduction, folded into best[image, gt] with atomicMax on the
//      float's bits. That order is the float order because a valid gt's
//      IoU is >= 0, and only best > 0 is ever used.
//   2. matcher_assign_kernel: per anchor, the IoU again, the strict-> best
//      over gt in index order, the tie test against best[image, gt], the
//      thresholds; one int32 written.
//
// Exactness: built with -fmad=false, the IoU written with explicit
// round-to-nearest operations in the order of ops/box_ops.py:box_iou (gt
// first): areas (x2-x1+1)*(y2-y1+1), union = (area_g + area_a) - inter,
// IoU = inter / union when union > 0. Both passes round alike, so the tie
// test is exact and the output equals the plain version bit for bit.
//
// What bounds it on the card: bytes, barely. At 800x1344 the anchors are
// 268,569 x 16 B (4.3 MB) and the output 8 images x 268,569 x 4 B (8.6 MB);
// the IoU work is anchors x valid gt x ~15 operations per pass, a few
// hundred MFLOP at COCO-like gt counts. Both come to a few microseconds;
// two launches and the per-block gt staging cost more than either.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGt = 1024;

__device__ __forceinline__ float area_plus1(float4 b) {
  return __fmul_rn(__fadd_rn(__fsub_rn(b.z, b.x), 1.f),
                   __fadd_rn(__fsub_rn(b.w, b.y), 1.f));
}

// box_iou(gt, anchor) with the +1 convention, area_g precomputed.
__device__ __forceinline__ float iou_gt_anchor(float4 g, float area_g, float4 a,
                                               float area_a) {
  const float iw = fmaxf(__fadd_rn(__fsub_rn(fminf(g.z, a.z), fmaxf(g.x, a.x)), 1.f), 0.f);
  const float ih = fmaxf(__fadd_rn(__fsub_rn(fminf(g.w, a.w), fmaxf(g.y, a.y)), 1.f), 0.f);
  const float inter = __fmul_rn(iw, ih);
  const float uni = __fsub_rn(__fadd_rn(area_g, area_a), inter);
  return uni > 0.f ? __fdiv_rn(inter, uni) : 0.f;
}

// Stages image b's gt rows in shared memory; returns the loop bound (last
// valid gt + 1, 0 when the image has none).
__device__ __forceinline__ int stage_gt(const float4* __restrict__ gt,
                                        const uint8_t* __restrict__ valid, int b,
                                        int g, float4* s_gt, float* s_area,
                                        uint8_t* s_valid, int* s_ng) {
  if (threadIdx.x == 0) *s_ng = 0;
  __syncthreads();
  for (int j = threadIdx.x; j < g; j += blockDim.x) {
    const float4 box = gt[(size_t)b * g + j];
    const uint8_t v = valid[(size_t)b * g + j];
    s_gt[j] = box;
    s_area[j] = area_plus1(box);
    s_valid[j] = v;
    if (v) atomicMax(s_ng, j + 1);
  }
  __syncthreads();
  return *s_ng;
}

__global__ void matcher_gt_best_kernel(const float4* __restrict__ anchors, int n,
                                       const float4* __restrict__ gt,
                                       const uint8_t* __restrict__ valid, int g,
                                       unsigned int* __restrict__ best) {
  __shared__ float4 s_gt[kMaxGt];
  __shared__ float s_area[kMaxGt];
  __shared__ uint8_t s_valid[kMaxGt];
  __shared__ unsigned int s_best[kMaxGt];
  __shared__ int s_ng;
  const int b = blockIdx.y;
  for (int j = threadIdx.x; j < g; j += blockDim.x) s_best[j] = 0u;
  const int ng = stage_gt(gt, valid, b, g, s_gt, s_area, s_valid, &s_ng);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool real = i < n;
  const float4 a = real ? anchors[i] : make_float4(0.f, 0.f, 0.f, 0.f);
  const float area_a = area_plus1(a);
  for (int j = 0; j < ng; ++j) {
    if (!s_valid[j]) continue;  // uniform across the block
    const float v = real ? iou_gt_anchor(s_gt[j], s_area[j], a, area_a) : 0.f;
    const unsigned int m = __reduce_max_sync(0xffffffffu, __float_as_uint(v));
    if ((threadIdx.x & 31) == 0 && m > 0u) atomicMax(&s_best[j], m);
  }
  __syncthreads();
  for (int j = threadIdx.x; j < ng; j += blockDim.x) {
    if (s_best[j] > 0u) atomicMax(&best[(size_t)b * g + j], s_best[j]);
  }
}

__global__ void matcher_assign_kernel(const float4* __restrict__ anchors, int n,
                                      const float4* __restrict__ gt,
                                      const uint8_t* __restrict__ valid, int g,
                                      const unsigned int* __restrict__ best,
                                      float high, float low,
                                      int* __restrict__ out) {
  __shared__ float4 s_gt[kMaxGt];
  __shared__ float s_area[kMaxGt];
  __shared__ uint8_t s_valid[kMaxGt];
  __shared__ float s_best[kMaxGt];
  __shared__ int s_ng;
  const int b = blockIdx.y;
  for (int j = threadIdx.x; j < g; j += blockDim.x) {
    s_best[j] = __uint_as_float(best[(size_t)b * g + j]);
  }
  const int ng = stage_gt(gt, valid, b, g, s_gt, s_area, s_valid, &s_ng);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float4 a = anchors[i];
  const float area_a = area_plus1(a);
  float bv = -1.f;
  int bi = 0;
  bool restore = false;
  for (int j = 0; j < ng; ++j) {
    if (!s_valid[j]) continue;
    const float v = iou_gt_anchor(s_gt[j], s_area[j], a, area_a);
    if (v > bv) {
      bv = v;
      bi = j;
    }
    if (s_best[j] > 0.f && v == s_best[j]) restore = true;
  }
  int m = bi;
  if (!restore) {
    if (bv < low) {
      m = -1;
    } else if (bv < high) {
      m = -2;
    }
  }
  out[(size_t)b * n + i] = m;
}

}  // namespace

extern "C" int match_anchors_max_gt() { return kMaxGt; }

// anchors [n, 4] f32, gt [b, g, 4] f32, valid [b, g] u8; best scratch
// [b, g] 32-bit (zeroed here); out [b, n] i32. Returns cudaGetLastError()
// after the launches (0 on success).
extern "C" int match_anchors(const void* anchors, const void* gt,
                             const void* valid, int n, int b, int g, float high,
                             float low, void* best, void* out, void* stream) {
  if (n <= 0 || b <= 0) return 0;
  if (g < 0 || g > kMaxGt) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (g > 0) {
    cudaError_t e = cudaMemsetAsync(best, 0, (size_t)b * g * sizeof(unsigned int), s);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((n + kThreads - 1) / kThreads, b);
  matcher_gt_best_kernel<<<grid, kThreads, 0, s>>>(
      (const float4*)anchors, n, (const float4*)gt, (const uint8_t*)valid, g,
      (unsigned int*)best);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  matcher_assign_kernel<<<grid, kThreads, 0, s>>>(
      (const float4*)anchors, n, (const float4*)gt, (const uint8_t*)valid, g,
      (const unsigned int*)best, high, low, (int*)out);
  return (int)cudaGetLastError();
}
