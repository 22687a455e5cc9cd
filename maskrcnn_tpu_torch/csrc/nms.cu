// Batched greedy hard-NMS over independent lanes, for Hopper (sm_90a).
//
// Replaces the TPU kernel maskrcnn_tpu/ops/pallas/nms_kernel.py
// (nms_sorted_pallas / _nms_kernel). Same contract: each lane's boxes arrive
// sorted by descending score (the PyTorch wrapper sorts, as the JAX wrapper
// does outside its kernel); IoU uses the +1 pixel convention; box j is
// suppressed by a kept earlier box i when IoU(i, j) > threshold; invalid rows
// are never kept and never suppress.
//
// Design, after the reference CUDA NMS (64-bit suppression bitmasks) with
// the serial reduce moved onto the device:
//   1. nms_mask_kernel: one block per (lane, 64-row tile, 64-column tile).
//      Thread i of the block tests its row box against the tile's 64 column
//      boxes (staged in shared memory) and writes one 64-bit word of
//      mask[lane, row, word]: bit j set when column j comes later than the
//      row and overlaps it above the threshold. Tiles left of the diagonal
//      write zeros.
//   2. nms_reduce_kernel: one block per lane. The greedy scan is serial in
//      the rows; the block stages 32 mask rows at a time in shared memory and
//      one warp walks them, OR-ing a kept row's words into the lane's
//      `removed` bitset (one word per lane of the warp).
//
// What bounds it on the card: neither bytes nor arithmetic. The IoU work is
// N^2/2 pairs per lane (0.04 GFLOP for the RPN's 5 x 1000 lanes) and the
// bytes are a few hundred KB; the serial walk over N rows in step 2 is a
// chain of N dependent shared-memory round trips, which is the kernel's
// latency floor. Lanes run in parallel blocks, so the RPN's 5 lanes and the
// box head's 80 class lanes each cost about one lane's walk.
//
// Exactness: built with -fmad=false and written with explicit round-to-
// nearest intrinsics, so the IoU is the same f32 value the plain version
// (ops/nms.py:batched_nms_plain) computes: areas (x2-x1+1)*(y2-y1+1),
// union = (area_a + area_b) - inter, IoU = inter / union when union > 0.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;          // boxes per mask word
constexpr int kReduceRows = 32;    // mask rows staged per step of the reduce
constexpr int kMaxWords = 128;     // N <= 8192 per lane
constexpr int kReduceThreads = 256;

__device__ __forceinline__ float area_plus1(float4 b) {
  return __fmul_rn(__fadd_rn(__fsub_rn(b.z, b.x), 1.f),
                   __fadd_rn(__fsub_rn(b.w, b.y), 1.f));
}

__device__ __forceinline__ float iou_plus1(float4 a, float4 b) {
  const float iw = fmaxf(__fadd_rn(__fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x)), 1.f), 0.f);
  const float ih = fmaxf(__fadd_rn(__fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y)), 1.f), 0.f);
  const float inter = __fmul_rn(iw, ih);
  const float uni = __fsub_rn(__fadd_rn(area_plus1(a), area_plus1(b)), inter);
  return uni > 0.f ? __fdiv_rn(inter, uni) : 0.f;
}

__global__ void nms_mask_kernel(const float4* __restrict__ boxes, int n,
                                int words, float thresh,
                                unsigned long long* __restrict__ mask) {
  const int lane = blockIdx.z;
  const int row_tile = blockIdx.y;
  const int col_tile = blockIdx.x;
  const int row = row_tile * kTile + threadIdx.x;
  const float4* lane_boxes = boxes + (size_t)lane * n;
  unsigned long long* out = mask + ((size_t)lane * n + row) * words + col_tile;
  if (col_tile < row_tile) {  // earlier columns never get suppressed by row
    if (row < n) *out = 0ULL;
    return;
  }
  __shared__ float4 cols[kTile];
  const int col0 = col_tile * kTile;
  const int ncols = min(kTile, n - col0);
  if (threadIdx.x < ncols) cols[threadIdx.x] = lane_boxes[col0 + threadIdx.x];
  __syncthreads();
  if (row >= n) return;
  const float4 me = lane_boxes[row];
  unsigned long long bits = 0ULL;
  const int start = col_tile == row_tile ? threadIdx.x + 1 : 0;
  for (int j = start; j < ncols; ++j) {
    if (iou_plus1(me, cols[j]) > thresh) bits |= 1ULL << j;
  }
  *out = bits;
}

__global__ void nms_reduce_kernel(const unsigned long long* __restrict__ mask,
                                  const uint8_t* __restrict__ valid, int n,
                                  int words, uint8_t* __restrict__ keep) {
  const int lane = blockIdx.x;
  __shared__ unsigned long long removed[kMaxWords];
  __shared__ unsigned long long rows[kReduceRows * kMaxWords];
  const uint8_t* v = valid + (size_t)lane * n;
  // invalid and padding rows start out removed: never kept, never suppress
  for (int w = threadIdx.x; w < words; w += blockDim.x) {
    unsigned long long r = 0ULL;
    for (int b = 0; b < 64; ++b) {
      const int i = w * 64 + b;
      if (i >= n || !v[i]) r |= 1ULL << b;
    }
    removed[w] = r;
  }
  __syncthreads();
  const unsigned long long* lane_mask = mask + (size_t)lane * n * words;
  for (int r0 = 0; r0 < n; r0 += kReduceRows) {
    const int nr = min(kReduceRows, n - r0);
    for (int k = threadIdx.x; k < nr * words; k += blockDim.x) {
      rows[k] = lane_mask[(size_t)r0 * words + k];
    }
    __syncthreads();
    if (threadIdx.x < 32) {
      for (int i = 0; i < nr; ++i) {
        const int row = r0 + i;
        const bool alive = !((removed[row >> 6] >> (row & 63)) & 1ULL);
        __syncwarp();
        if (alive) {
          for (int w = threadIdx.x; w < words; w += 32) {
            removed[w] |= rows[i * words + w];
          }
        }
        __syncwarp();
      }
    }
    __syncthreads();
  }
  // a row visited alive is never removed afterwards (bits only point at
  // later rows), so the final bitset is exactly the complement of keep
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    keep[(size_t)lane * n + i] = ((removed[i >> 6] >> (i & 63)) & 1ULL) ? 0 : 1;
  }
}

}  // namespace

extern "C" int nms_max_boxes() { return kMaxWords * kTile; }

// boxes [g, n, 4] f32 (score-sorted per lane), valid [g, n] u8,
// mask scratch [g, n, ceil(n/64)] u64, keep [g, n] u8 (sorted order).
// Returns cudaGetLastError() after the launches (0 on success).
extern "C" int nms_keep_sorted(const void* boxes, const void* valid, void* mask,
                               void* keep, int g, int n, float thresh,
                               void* stream) {
  if (g <= 0 || n <= 0) return 0;
  const int words = (n + kTile - 1) / kTile;
  if (words > kMaxWords) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  dim3 grid(words, words, g);
  nms_mask_kernel<<<grid, kTile, 0, s>>>(
      (const float4*)boxes, n, words, thresh, (unsigned long long*)mask);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  nms_reduce_kernel<<<g, kReduceThreads, 0, s>>>(
      (const unsigned long long*)mask, (const uint8_t*)valid, n, words,
      (uint8_t*)keep);
  return (int)cudaGetLastError();
}
