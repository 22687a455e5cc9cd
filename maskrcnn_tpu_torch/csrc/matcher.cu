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
// The TPU kernel runs its grid in order and carries each anchor's best
// value and index, and the per-gt maxima, in VMEM scratch from its first
// pass over the anchors to its second. Here one cooperative launch does
// both passes, every block resident on the card (the grid is sized from
// the occupancy), each block walking its anchor tiles grid-stride:
//   0. the block stages the gt slots of every image in shared memory in
//      one round of loads, with each image's last valid gt (its loops end
//      there, as the TPU kernel's nblocks bounds them), and the grid zeroes
//      best[image, gt]; grid.sync();
//   1. per anchor and image: the best IoU and first best gt, thresholded
//      and written to out; per gt the block's maximum (warp max-reduction,
//      shared atomicMax on the float's bits), folded into best[image, gt]
//      by a global atomicMax. That order is the float order because a
//      valid gt's IoU is >= 0, and only best > 0 is ever used;
//      grid.sync();
//   2. the restore, pruned: an anchor that ties best[image, j] lies in a
//      block whose maximum for j is that best, so a block revisits its
//      anchors only for the gt whose block maximum equals the final best,
//      and recomputes an anchor's first best gt only where it ties.
// Images are taken in groups whose gt fit the block's shared memory (all
// of them at the flagship's 8 x 100 slots); each group is one pass 1 and
// one pass 2.
//
// Exactness: built with -fmad=false, the IoU written with explicit
// round-to-nearest operations in the order of ops/box_ops.py:box_iou (gt
// first): areas (x2-x1+1)*(y2-y1+1), union = (area_g + area_a) - inter,
// IoU = inter / union when union > 0. Both passes round alike, so the tie
// test is exact and the output equals the plain version bit for bit.
//
// What bounds it on the card: bytes, barely. At 800x1344 the anchors are
// 268,569 x 16 B (4.3 MB) and the output 8 images x 268,569 x 4 B (8.6 MB);
// the IoU work is anchors x valid gt x ~15 operations, about 0.3 GFLOP at
// COCO-like gt counts. Both come to a few microseconds; the launch, the
// grid barriers and the per-block staging are what remains.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 2;  // anchors a thread holds in registers
constexpr int kTileAnchors = kThreads * kPer;
constexpr int kMaxGt = 1024;
constexpr int kMaxGroup = 64;  // images staged at once (their loop bounds in shared memory)
// shared memory a block may hold for its staged gt: 8 blocks of the
// flagship's 8 x 100 slots fit on one SM; larger batches take fewer
constexpr size_t kSmemBudget = 200 * 1024;
constexpr unsigned kFull = 0xffffffffu;

// one staged gt slot: box, area, the block's best IoU bits, validity
constexpr size_t kSlotBytes = sizeof(float4) + sizeof(float) + sizeof(unsigned) + 1;

__device__ __forceinline__ float area_plus1(float4 b) {
  return __fmul_rn(__fadd_rn(__fsub_rn(b.z, b.x), 1.f),
                   __fadd_rn(__fsub_rn(b.w, b.y), 1.f));
}

// box_iou(gt, anchor) with the +1 convention, both areas precomputed.
__device__ __forceinline__ float iou_gt_anchor(float4 g, float area_g, float4 a,
                                               float area_a) {
  const float iw = fmaxf(__fadd_rn(__fsub_rn(fminf(g.z, a.z), fmaxf(g.x, a.x)), 1.f), 0.f);
  const float ih = fmaxf(__fadd_rn(__fsub_rn(fminf(g.w, a.w), fmaxf(g.y, a.y)), 1.f), 0.f);
  const float inter = __fmul_rn(iw, ih);
  // no overlap: the IoU is +0 whatever the union (iw, ih >= +0), and most
  // anchor-gt pairs skip the division, whole warps at a time (a warp's
  // anchors are neighbours)
  if (inter == 0.f) return 0.f;
  const float uni = __fsub_rn(__fadd_rn(area_g, area_a), inter);
  return uni > 0.f ? __fdiv_rn(inter, uni) : 0.f;
}

__device__ __forceinline__ float4 hull(float4 a, float4 b) {
  return make_float4(fminf(a.x, b.x), fminf(a.y, b.y), fmaxf(a.z, b.z), fmaxf(a.w, b.w));
}

// True when gt g meets no anchor inside ext, the anchors' hull widened by 2
// (rounded, so the hull lies strictly inside it): then for every such
// anchor min(x2) - max(x1) < -2 on one axis, so the +1 width rounds to <= 0,
// the intersection is +0 and so is the IoU, exactly.
__device__ __forceinline__ bool misses_warp(float4 g, float4 ext) {
  return g.z < ext.x || g.x > ext.z || g.w < ext.y || g.y > ext.w;
}

struct Slots {
  float4* box;
  float* area;
  unsigned* best;
  bool* valid;
};

__device__ __forceinline__ Slots slots_of(unsigned char* smem, int cap) {
  Slots s;
  s.box = (float4*)smem;
  s.area = (float*)(s.box + cap);
  s.best = (unsigned*)(s.area + cap);
  s.valid = (bool*)(s.best + cap);
  return s;
}

// image k's first best gt for anchor a over its slots k * g .. k * g + ng
__device__ __forceinline__ int first_best(const Slots& s, int k, int g, int ng, float4 a,
                                          float area_a) {
  float bv = -1.f;
  int bi = 0;
  for (int j = 0; j < ng; ++j) {
    const int p = k * g + j;
    if (!s.valid[p]) continue;
    const float v = iou_gt_anchor(s.box[p], s.area[p], a, area_a);
    if (v > bv) {
      bv = v;
      bi = j;
    }
  }
  return bi;
}

__global__ void __launch_bounds__(kThreads)
matcher_kernel(const float4* __restrict__ anchors, int n, const float4* __restrict__ gt,
               const bool* __restrict__ valid, int b, int g, int group, float high, float low,
               unsigned* __restrict__ best, int* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_ng[kMaxGroup];  // per staged image: last valid gt + 1
  cg::grid_group grid = cg::this_grid();
  const Slots s = slots_of(smem, group * g);
  const int tiles = (n + kTileAnchors - 1) / kTileAnchors;
  for (size_t k = grid.thread_rank(); k < (size_t)b * g; k += grid.size()) best[k] = 0u;

  for (int b0 = 0; b0 < b; b0 += group) {
    const int nb = min(group, b - b0);
    // stage the group's gt slots; each image's loops end at its last valid gt
    for (int k = threadIdx.x; k < nb; k += kThreads) s_ng[k] = 0;
    __syncthreads();
    for (int e = threadIdx.x; e < nb * g; e += kThreads) {
      const size_t src = (size_t)b0 * g + e;
      const float4 box = gt[src];
      const bool v = valid[src];
      s.box[e] = box;
      s.area[e] = area_plus1(box);
      s.best[e] = 0u;
      s.valid[e] = v;
      if (v) atomicMax(&s_ng[e / g], e % g + 1);
    }
    grid.sync();  // best zeroed; the previous group's restore done

    // 1. each anchor's first best gt, thresholded; the block's per-gt maxima
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      float4 a[kPer];
      float area_a[kPer];
#pragma unroll
      for (int u = 0; u < kPer; ++u) {
        const int i = t * kTileAnchors + u * kThreads + threadIdx.x;
        a[u] = i < n ? anchors[i] : make_float4(0.f, 0.f, 0.f, 0.f);
        area_a[u] = area_plus1(a[u]);
      }
      // the warp's anchors' extent, widened by 2: a gt outside it meets
      // none of them (see misses_warp)
      float4 ext = a[0];
#pragma unroll
      for (int u = 1; u < kPer; ++u) ext = hull(ext, a[u]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        ext = hull(ext, make_float4(__shfl_xor_sync(kFull, ext.x, o), __shfl_xor_sync(kFull, ext.y, o),
                                    __shfl_xor_sync(kFull, ext.z, o), __shfl_xor_sync(kFull, ext.w, o)));
      }
      ext = make_float4(__fsub_rn(ext.x, 2.f), __fsub_rn(ext.y, 2.f), __fadd_rn(ext.z, 2.f),
                        __fadd_rn(ext.w, 2.f));
      for (int k = 0; k < nb; ++k) {
        float bv[kPer];
        int bi[kPer];
#pragma unroll
        for (int u = 0; u < kPer; ++u) {
          bv[u] = -1.f;
          bi[u] = 0;
        }
        const int ng = s_ng[k];
        for (int j = 0; j < ng; ++j) {  // uniform across the block
          const int p = k * g + j;
          if (!s.valid[p]) continue;
          const float4 box = s.box[p];
          if (misses_warp(box, ext)) {  // uniform across the warp: every IoU is +0
#pragma unroll
            for (int u = 0; u < kPer; ++u) {
              if (bv[u] < 0.f) {
                bv[u] = 0.f;
                bi[u] = j;
              }
            }
            continue;
          }
          const float area_g = s.area[p];
          unsigned m = 0u;
#pragma unroll
          for (int u = 0; u < kPer; ++u) {
            const int i = t * kTileAnchors + u * kThreads + threadIdx.x;
            const float v = i < n ? iou_gt_anchor(box, area_g, a[u], area_a[u]) : 0.f;
            if (v > bv[u]) {
              bv[u] = v;
              bi[u] = j;
            }
            m = max(m, __float_as_uint(v));
          }
          m = __reduce_max_sync(kFull, m);
          if ((threadIdx.x & 31) == 0 && m > 0u) atomicMax(&s.best[p], m);
        }
#pragma unroll
        for (int u = 0; u < kPer; ++u) {
          const int i = t * kTileAnchors + u * kThreads + threadIdx.x;
          if (i < n) out[(size_t)(b0 + k) * n + i] = bv[u] < low ? -1 : (bv[u] < high ? -2 : bi[u]);
        }
      }
    }
    __syncthreads();
    for (int e = threadIdx.x; e < nb * g; e += kThreads) {
      if (s.best[e] > 0u) atomicMax(&best[(size_t)b0 * g + e], s.best[e]);
    }
    grid.sync();  // every block's maxima folded into best

    // 2. the restore, only where this block holds a gt's final best: keep
    // in s.best the maxima that are final, zero the others
    for (int e = threadIdx.x; e < nb * g; e += kThreads) {
      const unsigned top = s.best[e];
      if (top > 0u && top != __ldcg(&best[(size_t)b0 * g + e])) s.best[e] = 0u;
    }
    __syncthreads();
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      float4 a[kPer];
      float area_a[kPer];
#pragma unroll
      for (int u = 0; u < kPer; ++u) {
        const int i = t * kTileAnchors + u * kThreads + threadIdx.x;
        a[u] = i < n ? anchors[i] : make_float4(0.f, 0.f, 0.f, 0.f);
        area_a[u] = area_plus1(a[u]);
      }
      for (int k = 0; k < nb; ++k) {
        const int ng = s_ng[k];
        for (int j = 0; j < ng; ++j) {
          const int p = k * g + j;
          const unsigned top = s.best[p];
          if (top == 0u) continue;  // uniform across the block
#pragma unroll
          for (int u = 0; u < kPer; ++u) {
            const int i = t * kTileAnchors + u * kThreads + threadIdx.x;
            if (i < n && iou_gt_anchor(s.box[p], s.area[p], a[u], area_a[u]) ==
                             __uint_as_float(top)) {
              out[(size_t)(b0 + k) * n + i] = first_best(s, k, g, ng, a[u], area_a[u]);
            }
          }
        }
      }
    }
    __syncthreads();  // before the next group restages the slots
  }
}

// images staged at once for g gt slots each
int group_for(int b, int g) {
  if (g == 0) return b < kMaxGroup ? b : kMaxGroup;
  int group = (int)(kSmemBudget / ((size_t)g * kSlotBytes));
  group = group < 1 ? 1 : group;
  group = group < kMaxGroup ? group : kMaxGroup;
  return group < b ? group : b;
}

}  // namespace

extern "C" int match_anchors_max_gt() { return kMaxGt; }

// anchors [n, 4] f32, gt [b, g, 4] f32, valid [b, g] bool; best scratch
// [b, g] 32-bit (zeroed by the kernel); out [b, n] i32. One cooperative
// launch. Returns the CUDA error code (0 on success).
extern "C" int match_anchors(const void* anchors, const void* gt, const void* valid, int n,
                             int b, int g, float high, float low, void* best, void* out,
                             void* stream) {
  if (n <= 0 || b <= 0) return 0;
  if (g < 0 || g > kMaxGt) return (int)cudaErrorInvalidValue;
  const int group = group_for(b, g);
  const size_t smem = (size_t)group * g * kSlotBytes;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  static bool wide = false;  // shared memory past 48 KB allowed
  if (e == cudaSuccess && !wide) {
    e = cudaFuncSetAttribute(matcher_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kSmemBudget);
    wide = e == cudaSuccess;
  }
  // all blocks must be resident for grid.sync(): as many as the card holds
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, matcher_kernel, kThreads, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const int tiles = (n + kTileAnchors - 1) / kTileAnchors;
  int grid = per_sm * sms;
  grid = grid < tiles ? grid : tiles;
  int group_arg = group;
  void* args[] = {(void*)&anchors, &n, (void*)&gt, (void*)&valid, &b, &g, &group_arg,
                  &high, &low, &best, &out};
  e = cudaLaunchCooperativeKernel((const void*)matcher_kernel, dim3(grid), dim3(kThreads), args,
                                  smem, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
