// Batched greedy hard-NMS over independent lanes, for Hopper (sm_90a).
//
// Replaces the TPU kernel maskrcnn_tpu/ops/pallas/nms_kernel.py
// (nms_sorted_pallas / _nms_kernel). Same contract: each lane's boxes arrive
// sorted by descending score (the PyTorch wrapper sorts, as the JAX wrapper
// does outside its kernel); IoU uses the +1 pixel convention; box j is
// suppressed by a kept earlier box i when IoU(i, j) > threshold; invalid rows
// are never kept and never suppress.
//
// Design: 64-bit suppression words, then a blocked serial scan, the TPU
// kernel's structure (resolve a block of rows serially, then sweep the later
// columns by its survivors) with the IoU tests moved into a parallel launch.
//   1. nms_mask_kernel: one 64-thread block per (lane, row tile, column
//      tile) of the upper triangle only. Thread r tests its row against the
//      tile's valid columns, staged in shared memory, and stores one word of
//      mask[lane, word, row] (word-major, so a warp's stores coalesce): bit j
//      set when column j comes later and overlaps the row above the
//      threshold. A pair that does not intersect skips the division. The
//      words of invalid rows and of tiles without a valid column are not
//      written (never read; bits of invalid columns are left arbitrary, as
//      those columns start removed). The diagonal block also writes its
//      tile's sorted-validity word vbits[lane, tile].
//   2. nms_reduce_kernel: one 128-thread block per lane. Warp 0 walks the
//      lane 64 rows at a time; lane w of it owns words w, w + 32, ... of the
//      `removed` bitset in registers: 4 a lane up to 8192 boxes, 6 up to
//      12288. Two instantiations, because the six-word walk slows short
//      lanes though its extra words are predicated off (the reduce at 40 x
//      2000 lanes: 0.080 ms against 0.057 on an H100, same 40 registers;
//      tools/profile_nms_matcher.py --variant). Block k is resolved from its
//      diagonal word, held in registers, by a 64-step bit chain (a row still
//      alive ORs its word in); then each lane ORs the kept rows' words of
//      its own later columns. Meanwhile warps 1-3 copy the next block's
//      rows into the other half of a double buffer in shared memory; one
//      barrier a block. The walk stops after the last block holding a
//      valid row, and the block writes the bool keep-mask straight into the
//      original order through `order`.
//
// What bounds it on the card: neither bytes nor arithmetic. The IoU tests
// are a triangle of N^2/2 per lane, spread over every SM (the greedy scan
// needs only kept x later of them, the TPU kernel's count); the walk is a
// chain of ceil(valid / 64) dependent block steps per lane, each a register
// chain of 64 bit tests and 64 shared-memory reads, which is the kernel's
// latency floor.
//
// Exactness: built with -fmad=false and written with explicit round-to-
// nearest intrinsics, so the IoU is the same f32 value the plain version
// (ops/nms.py:batched_nms_plain) computes: areas (x2-x1+1)*(y2-y1+1),
// union = (area_a + area_b) - inter, IoU = inter / union when union > 0.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;            // boxes per mask word; threads of a mask block
constexpr int kMaxWords = 192;       // N <= 12288 per lane
constexpr int kReduceThreads = 128;  // warp 0 walks, warps 1-3 stage the next block
constexpr int kPitch = kTile + 1;    // words of a staged column's rows (bank spread)
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float area_plus1(float4 b) {
  return __fmul_rn(__fadd_rn(__fsub_rn(b.z, b.x), 1.f),
                   __fadd_rn(__fsub_rn(b.w, b.y), 1.f));
}

__device__ __forceinline__ bool overlaps(float4 a, float area_a, float4 b, float area_b,
                                         float thresh) {
  const float iw = fmaxf(__fadd_rn(__fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x)), 1.f), 0.f);
  const float ih = fmaxf(__fadd_rn(__fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y)), 1.f), 0.f);
  const float inter = __fmul_rn(iw, ih);
  if (inter == 0.f) return 0.f > thresh;  // IoU 0 without the division
  const float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  return (uni > 0.f ? __fdiv_rn(inter, uni) : 0.f) > thresh;
}

// Tile pair p of the upper triangle (column tile >= row tile) of a lane
// with `words` tiles a side, counted from the last row of tiles.
__device__ __forceinline__ void tile_pair(int p, int words, int* rt, int* ct) {
  const int q = words * (words + 1) / 2 - 1 - p;
  int r = (int)((sqrtf(8.f * q + 1.f) - 1.f) * 0.5f);
  while ((r + 1) * (r + 2) / 2 <= q) ++r;
  while (r * (r + 1) / 2 > q) --r;
  *rt = words - 1 - r;
  *ct = words - 1 - (q - r * (r + 1) / 2);
}

__global__ void __launch_bounds__(kTile)
nms_mask_kernel(const float4* __restrict__ boxes, const int64_t* __restrict__ order,
                const bool* __restrict__ valid, int n, int words, float thresh,
                unsigned long long* __restrict__ mask,
                unsigned long long* __restrict__ vbits) {
  __shared__ float4 s_box[kTile];
  __shared__ float s_area[kTile];
  __shared__ unsigned s_rows[2], s_cols[2];
  const int lane = blockIdx.y;
  int rt, ct;
  tile_pair(blockIdx.x, words, &rt, &ct);
  const int r = threadIdx.x;
  const size_t base = (size_t)lane * n;
  const int row = rt * kTile + r;
  const int col = ct * kTile + r;
  const bool rv = row < n && valid[base + order[base + row]];
  bool cv = false;
  if (col < n) {
    cv = valid[base + order[base + col]];
    const float4 b = boxes[base + col];
    s_box[r] = b;
    s_area[r] = area_plus1(b);
  }
  const unsigned rb = __ballot_sync(kFull, rv), cb = __ballot_sync(kFull, cv);
  if ((r & 31) == 0) {
    s_rows[r >> 5] = rb;
    s_cols[r >> 5] = cb;
  }
  __syncthreads();
  const unsigned long long row_bits = s_rows[0] | ((unsigned long long)s_rows[1] << 32);
  const unsigned long long col_bits = s_cols[0] | ((unsigned long long)s_cols[1] << 32);
  if (ct == rt && r == 0) vbits[(size_t)lane * words + rt] = row_bits;
  // an invalid row's word is never read, nor is a word of invalid columns
  if (!rv || col_bits == 0ULL) return;
  const float4 me = boxes[base + row];
  const float area_me = area_plus1(me);
  // later columns only: on the diagonal tile, those after the row
  const unsigned long long todo =
      ct > rt ? col_bits : (r == kTile - 1 ? 0ULL : col_bits & (~0ULL << (r + 1)));
  unsigned long long bits = 0ULL;
#pragma unroll 8
  for (int j = 0; j < kTile; ++j) {
    if (((todo >> j) & 1ULL) && overlaps(me, area_me, s_box[j], s_area[j], thresh)) {
      bits |= 1ULL << j;
    }
  }
  mask[((size_t)lane * words + ct) * words * kTile + row] = bits;
}

// the owned word q of `rem` chosen by a warp-uniform index
template <int kOwn>
__device__ __forceinline__ unsigned long long pick(const unsigned long long (&rem)[kOwn], int q) {
  unsigned long long v = 0ULL;
#pragma unroll
  for (int k = 0; k < kOwn; ++k) v = k == q ? rem[k] : v;
  return v;
}

// Warps 1-3 copy the rows of block kb, words kb .. last - 1, into
// buf[word][row] (pitch kPitch) from the word-major mask.
__device__ __forceinline__ void stage_block(const unsigned long long* lane_mask, size_t rows,
                                            int kb, int last, unsigned long long* buf, int t,
                                            int nt) {
  const int count = (last - kb) * kTile;
  for (int e = t; e < count; e += nt) {
    const int w = kb + e / kTile;
    const int i = e % kTile;
    buf[w * kPitch + i] = __ldcg(lane_mask + (size_t)w * rows + (size_t)kb * kTile + i);
  }
}

// kOwn: words of `removed` each lane of warp 0 owns (words <= 32 * kOwn)
template <int kOwn>
__global__ void __launch_bounds__(kReduceThreads)
nms_reduce_kernel(const unsigned long long* __restrict__ mask,
                  const unsigned long long* __restrict__ vbits,
                  const int64_t* __restrict__ order, int n, int words,
                  bool* __restrict__ keep) {
  extern __shared__ unsigned long long smem[];
  unsigned long long* s_removed = smem;                 // [words]
  unsigned long long* bufs = smem + words;              // [2][words][kPitch]
  __shared__ int s_last;
  const int lane = blockIdx.x;
  const size_t rows = (size_t)words * kTile;
  const unsigned long long* lane_mask = mask + (size_t)lane * words * rows;
  const int l = threadIdx.x & 31;
  const bool walker = threadIdx.x < 32;
  // warp 0 owns words l, l + 32, ... of `removed`: invalid rows and the
  // padding past n start out removed
  unsigned long long rem[kOwn];
  if (walker) {
    int last = 0;  // one past the last word holding a valid row
#pragma unroll
    for (int q = 0; q < kOwn; ++q) {
      const int w = l + 32 * q;
      const unsigned long long v = w < words ? vbits[(size_t)lane * words + w] : 0ULL;
      rem[q] = ~v;
      if (v) last = w + 1;
    }
    last = __reduce_max_sync(kFull, last);
    if (l == 0) s_last = last;
  }
  __syncthreads();
  const int last = s_last;
  if (last > 0) stage_block(lane_mask, rows, 0, last, bufs, threadIdx.x, kReduceThreads);
  __syncthreads();
  for (int k = 0; k < last; ++k) {
    const unsigned long long* buf = bufs + (size_t)(k & 1) * words * kPitch;
    if (walker) {
      // resolve block k: row i, still alive, removes the later rows its
      // diagonal word names (bits only point at later rows)
      unsigned long long cur = __shfl_sync(kFull, pick(rem, k >> 5), k & 31);
      const unsigned long long* diag = buf + k * kPitch;
#pragma unroll
      for (int h = 0; h < kTile; h += 32) {
        unsigned long long d[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) d[i] = diag[h + i];
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          if (!((cur >> (h + i)) & 1ULL)) cur |= d[i];
        }
      }
      const unsigned long long kept = ~cur;
#pragma unroll
      for (int q = 0; q < kOwn; ++q) {
        const int w = l + 32 * q;
        if (w == k) rem[q] = cur;
        if (w > k && w < last) {
          const unsigned long long* col = buf + w * kPitch;
          unsigned long long acc = 0ULL;
#pragma unroll 16
          for (int i = 0; i < kTile; ++i) {
            if ((kept >> i) & 1ULL) acc |= col[i];
          }
          rem[q] |= acc;
        }
      }
    } else if (k + 1 < last) {  // the next block's rows, while warp 0 walks
      stage_block(lane_mask, rows, k + 1, last, bufs + (size_t)((k + 1) & 1) * words * kPitch,
                  threadIdx.x - 32, kReduceThreads - 32);
    }
    __syncthreads();
  }
  if (walker) {
#pragma unroll
    for (int q = 0; q < kOwn; ++q) {
      const int w = l + 32 * q;
      if (w < words) s_removed[w] = rem[q];
    }
  }
  __syncthreads();
  // a row visited alive is never removed afterwards, so the final bitset is
  // the complement of keep; written in the original order
  const size_t base = (size_t)lane * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    keep[base + order[base + i]] = !((s_removed[i >> 6] >> (i & 63)) & 1ULL);
  }
}

// dynamic shared memory of a reduce launch: `removed` and the double buffer
// of staged rows, sized by the lane's own words (201,216 B at 192 words)
size_t reduce_smem(int words) {
  return sizeof(unsigned long long) * ((size_t)words + 2 * (size_t)words * kPitch);
}

// A reduce launch at its instantiation; the first sets the shared-memory
// limit once, for the most words the instantiation takes.
template <int kOwn>
cudaError_t launch_reduce(const unsigned long long* mask, const unsigned long long* vbits,
                          const int64_t* order, int g, int n, int words, bool* keep,
                          cudaStream_t s) {
  static bool wide = false;  // shared memory past 48 KB allowed (n > 2944)
  if (!wide) {
    const cudaError_t e = cudaFuncSetAttribute(nms_reduce_kernel<kOwn>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)reduce_smem(32 * kOwn));
    if (e != cudaSuccess) return e;
    wide = true;
  }
  nms_reduce_kernel<kOwn><<<g, kReduceThreads, reduce_smem(words), s>>>(mask, vbits, order, n,
                                                                        words, keep);
  return cudaGetLastError();
}

}  // namespace

extern "C" int nms_max_boxes() { return kMaxWords * kTile; }

// 64-bit words of scratch nms_keep needs for g lanes of n boxes.
extern "C" long long nms_scratch_words(int g, int n) {
  const long long words = (n + kTile - 1) / kTile;
  return (long long)g * words * (words * kTile + 1);
}

// boxes [g, n, 4] f32 (score-sorted per lane), order [g, n] i64 (the sort's
// permutation: sorted position -> original index), valid [g, n] bool in the
// original order, scratch of nms_scratch_words(g, n) 64-bit words, keep
// [g, n] bool out in the original order. Returns cudaGetLastError() after
// the launches (0 on success).
extern "C" int nms_keep(const void* boxes, const void* order, const void* valid, void* scratch,
                        void* keep, int g, int n, float thresh, void* stream) {
  if (g <= 0 || n <= 0) return 0;
  const int words = (n + kTile - 1) / kTile;
  if (words > kMaxWords) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  unsigned long long* mask = (unsigned long long*)scratch;
  unsigned long long* vbits = mask + (size_t)g * words * words * kTile;
  nms_mask_kernel<<<dim3(words * (words + 1) / 2, g), kTile, 0, s>>>(
      (const float4*)boxes, (const int64_t*)order, (const bool*)valid, n, words, thresh,
      mask, vbits);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const auto* ord = (const int64_t*)order;
  if (words <= 128) return (int)launch_reduce<4>(mask, vbits, ord, g, n, words, (bool*)keep, s);
  return (int)launch_reduce<6>(mask, vbits, ord, g, n, words, (bool*)keep, s);
}
