// Multi-level FPN ROIAlign, forward and backward, for Hopper (sm_90a).
//
// What each entry point replaces (maskrcnn_tpu/ops/pallas/roi_align_kernel.py):
//   * roi_align_forward: multilevel_roi_align_pallas / _kernel (:372, :434),
//     with its jnp prep _precompute and _bin_weights;
//   * roi_align_backward: the default "roi" backward, _roi_align_bwd_roi /
//     _roi_bwd_kernel (:955, :1020);
//   * roi_align_backward_windows: the "rmw" and "chunk" backwards,
//     _roi_align_bwd / _bwd_kernel and _roi_align_bwd_chunk /
//     _chunk_bwd_kernel (:646, :850).
// Semantics are those of the exact gather path
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
// The geometry is separable: a sample's row cells and weights depend on its
// row index alone, its column's on its column index. Both kernels compute an
// ROI's P*S row axes and P*S column axes once per block, a few threads each,
// into shared memory (sample_axis, roi_axes), rounded as the plain version
// rounds them (built with -fmad=false, divisions correctly rounded), and
// every channel reads them from there.
//
// Levels are NHWC (channels_last NCHW maps, permuted), so a cell's C
// channels are contiguous: a thread moves 8 channels of a cell with one
// 16-byte load or store (two for float32). The entry points refuse C % 8 != 0
// and level, dOut or output pointers that are not 16-byte aligned, and the
// wrappers raise before they get there.
//
// Forward. What bounds it on the card: bytes. The training box head (4096
// ROIs, P=7, C=256, bf16) writes 103 MB and needs 78 MB of distinct cells;
// its ~1.7 G float32 operations take less time on the CUDA cores. Design:
// one block per ROI and band of at most 64 bins (one band for P=7, four for
// P=14), 8 warps taking the band's bins in turn, the ROI's axes in shared
// memory, a warp covering 256 channels of a bin; per sample a thread issues
// four 16-byte corner loads and their products. The corners repeat across a
// bin's samples and its neighbours', which the block runs together, so most
// of those loads hit L1. Products
// and sums keep the plain version's order: a float32 result equals it.
//
// "roi" backward: the exact adjoint of the forward, every bilinear corner of
// every sample inside the map getting w * dOut / (S*S). The TPU kernel
// merges each ROI's window in VMEM and adds it into the level gradients, its
// grid running in order. Here each part of the gradient is gathered by the
// block that owns it: one block per 8 x 8 cell tile of one (level, image)
// and 128 channels writes that part once, in the output dtype. No atomics
// into the gradient, no float32 scratch, no memset and no cast; the sums run
// in a fixed order, so two calls give the same bits. The block
//   * reads its (level, image)'s segment of the ROI list the wrapper sorted
//     by (level, image), 256 ROIs at a time, and keeps, in list order, those
//     whose footprint meets the tile: rows [floor(y1), floor(y1 + roi_h) +
//     1] and columns alike, a superset of the cells their samples touch,
//     clamps and snaps at the map's edges included (meets_tile);
//   * for 16 such ROIs at a time, a thread per bin computes the bin's
//     sample axes and its weights over the tile's rows (RowW [P, 8]) or
//     columns (ColW [P, 8]), the in-bin sums of the valid samples' bilinear
//     weights, with a bit per cell it reaches; from the bits, the bins
//     reaching the tile, each group of 4 rows and each column;
//   * copies the dOut bins reaching the tile of a run of those ROIs, as
//     many as fit 40 KB, into shared memory with cp.async, every thread
//     issuing copies, so a run waits for memory once and not once per load
//     (each warp cuts the run itself, with shuffles);
//   * adds dTile += RowW^T . dOut . ColW: a thread owns 4 rows of one tile
//     column and 8 channels; per row bin reaching its rows it sums its
//     column's bins of dOut (no branch on the weights, two bins a step) and
//     adds that into its rows. A tile no ROI meets is written as zeros.
// The channel slice, the threads per block and the stage size were chosen
// by measurement (PERF.md): 64- or 32-channel slices, 512 or 1024 threads,
// and a Hopper cluster sharing a tile's ROIs over 2 or 4 blocks were slower.
// What bounds it: bytes. It must write the dense gradient of every level
// (366 MB in bf16 at B=8, 800x1344) and read dOut (103 MB at the box head)
// once per tile an ROI meets; its float32 FMAs are ~2 GFLOP at the box
// head. What it spends beyond that: every block of a (level, image) scans
// that segment's ROIs, and the ROIs are not spread evenly: at the training
// box head a few P2 tiles are met by 100-176 ROIs each (positives clustered
// on small gt boxes), and those blocks add them one batch after another
// while the rest of the card is done (PERF.md).
//
// "rmw" and "chunk" backwards. The TPU kernels sort the ROIs by window
// (level, image, y0/8, x0/8: an origin quantized to 8 cells, each window
// 48 x 48 cells), sum dPatch = RowW^T . dOut . ColW per window in VMEM
// (one ROI at a time, or a pure chunk of 8 ROIs of one window as one
// stacked MXU contraction) and add each window into the bf16 gradient with
// one read-modify-write, the grid running in order. On this card windows
// overlap across blocks that run concurrently, so here the same tile
// blocks as the "roi" backward own the gradient, and the window sort is
// their index: an 8 x 8 tile at (ty, tx) (in tiles) lies in a window only
// if the window's origin is in [ty - 5, ty] x [tx - 5, tx], so the block
// walks those kSpan x kSpan = 36 windows in key order through a dense table
// of each window's first and last row (about 11 k entries at B=8), tests
// their rows' ROIs with meets_tile, and then its (level, image)'s oversize
// ROIs (those whose samples reach beyond their window: the TPU kernel clamps
// them, here they get their exact gradient from their geometry). At the
// training box head the rows of a tile's windows are 18 on average against
// the 478 ROIs of its segment that the "roi" block scans (PERF.md). The
// weights of a hit come from its geometry as in the "roi" backward, so the
// wrapper builds no RowW/ColW. "rmw" walks the sorted rows and adds each
// hit on the CUDA cores. "chunk" walks the chunk layout's rows (padding rows
// carry no ROI; the rows of pure chunks, 8 rows of one window, are flagged)
// and keeps the pure chunks' hits ahead of the others. In bf16, when a pass
// has at least 8 of them, it adds them as one stacked contraction on the
// tensor cores, the TPU kernel's MXU matmul: dTile[64 cells, slice] +=
// A . dOut, K running over every staged bin of those hits, A[cell, bin] =
// RowW[bin row][cell row] * ColW[bin column][cell column] rounded to bf16
// as the TPU kernel rounds its operands, dOut read from the stage by
// ldmatrix (mma.sync m16n8k16, float32 sums; M = the tile's 64 cells, so no
// row padding). The other hits, and all hits in float32, take the "rmw"
// sums (PERF.md: the box head's crowded tiles gain, a few pure hits do
// not). Each tile is written once in the output dtype: no atomics, no
// float32 scratch, no memset, no cast, and two calls give the same bits.
// The sums stay float32 to that one rounding (the TPU kernel rounds each
// window's flush into its bf16 buffer). The block finds its 37 candidate
// ranges once, a thread each, with their prefix sums in shared memory, so
// that they hold no registers through the sums; the tile blocks of all three backwards run at 3 blocks
// an SM (at most 85 registers a thread), where the mask head's many nearly
// empty tiles run 15-20% faster than at 2 (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 5;
constexpr int kWarps = 8;              // warps of a forward or tile block
constexpr int kThreads = kWarps * 32;
constexpr int kChannels = 32 * 8;      // channels a warp covers, 8 a lane
constexpr int kBandBins = 64;          // most bins a forward block pools
constexpr int kTile = 8;               // tile side in cells
constexpr int kSlice = 128;            // channels of a tile block, 8 a thread
constexpr int kLanes = kSlice / 8;
constexpr int kRowGroups = kThreads / (kTile * kLanes);  // a column's threads split its rows
constexpr int kRows = kTile / kRowGroups;
static_assert(kRowGroups * kRows == kTile && kRowGroups * kTile * kLanes == kThreads,
              "the tile block's threads cover its rows, columns and channels once");
constexpr int kHits = 16;              // ROIs whose tile weights are staged at once
// bin ranges kept per ROI: rows and columns reaching the tile, then those
// reaching each row group's rows, then each column
constexpr int kRanges = 2 + kRowGroups + kTile;
constexpr int kStageBytes = 40 * 1024; // dOut staged at once (at least one ROI's bins)
constexpr int kPatch = 48;             // window side in cells of the "rmw" / "chunk" layout
constexpr int kSpan = kPatch / kTile;  // window origins per axis whose cells reach a tile
constexpr int kCands = kSpan * kSpan + 1;  // candidate ranges of a tile: windows, oversize ROIs
// the "chunk" backward's tensor-core sum (bf16): each warp owns one 16-cell
// M tile (two tile rows) and half the slice's channels
constexpr int kMmaM = kTile * kTile / 16;  // M tiles of a tile's cells
constexpr int kMmaN = kSlice / (kWarps / kMmaM) / 8;  // n8 tiles a warp covers
static_assert(kWarps % kMmaM == 0 && kMmaN * 8 * (kWarps / kMmaM) == kSlice,
              "the warps' mma tiles cover the tile's cells and the slice once");
constexpr int kMmaMinHits = 8;  // the fewest pure-chunk hits of a pass the tensor cores take
constexpr size_t kMaxSmem = 227 * 1024;
constexpr unsigned kFull = 0xffffffffu;

struct Levels {
  const void* data[kMaxLevels];
  int h[kMaxLevels];
  int w[kMaxLevels];
  float scale[kMaxLevels];
};

// 8 consecutive channels from a 16-byte aligned address, as float32.
__device__ __forceinline__ void load8(const float* p, float v[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float v[8]) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    v[2 * k] = f.x;
    v[2 * k + 1] = f.y;
  }
}
__device__ __forceinline__ void store8(float* p, const float v[8]) {
  float4* q = reinterpret_cast<float4*>(p);
  q[0] = make_float4(v[0], v[1], v[2], v[3]);
  q[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float v[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) h[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

// Bilinear corner indices and weights of one sample coordinate along an
// axis of extent `size` (the gather path's clamp and snap rules); lo = -1
// marks a sample outside [-1, size], which contributes nothing.
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

// Sample j of an ROI along one axis (sample j % s of bin j / s), from the
// ROI's origin, bin size and sample spacing on that axis.
__device__ __forceinline__ Axis sample_axis(float origin, float bin, float sub, int j, int s,
                                            int size) {
  const float v = __fadd_rn(__fadd_rn(origin, __fmul_rn((float)(j / s), bin)),
                            __fmul_rn((float)(j % s) + 0.5f, sub));
  if (v < -1.f || v > (float)size) return Axis{-1, -1, 0.f, 0.f};
  return axis_weights(v, size);
}

// Sample j of the 2 * p * s axes of an ROI on a level of h x w cells: its
// rows first, then its columns.
__device__ __forceinline__ Axis roi_axis(const RoiGeom& g, int j, int p, int s, int h, int w) {
  const int ps = p * s;
  return j < ps ? sample_axis(g.y1, g.bin_h, g.sub_h, j, s, h)
                : sample_axis(g.x1, g.bin_w, g.sub_w, j - ps, s, w);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
roi_align_fwd_kernel(Levels lv, const float4* __restrict__ boxes,
                     const int* __restrict__ batch_idx, const int* __restrict__ level, int c,
                     int p, int s, int band, T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char s_fwd_raw[];
  Axis* s_ax = reinterpret_cast<Axis*>(s_fwd_raw);  // [2 * p * s]
  const int r = blockIdx.x;
  const int l = level[r];
  const int h = lv.h[l];
  const int w = lv.w[l];
  const T* feat = (const T*)lv.data[l] + (size_t)batch_idx[r] * h * w * c;
  const RoiGeom g = roi_geom(boxes[r], lv.scale[l], p, s);
  const int ps = p * s;
  for (int j = threadIdx.x; j < 2 * ps; j += blockDim.x) s_ax[j] = roi_axis(g, j, p, s, h, w);
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bin_end = min((blockIdx.y + 1) * band, p * p);
  const float count = (float)(s * s);
  const bool pow2 = ((s * s) & (s * s - 1)) == 0;  // then * (1 / count) is the division, exactly
  const float inv = 1.f / count;
  for (int bin = blockIdx.y * band + warp; bin < bin_end; bin += kWarps) {
    const Axis* ays = s_ax + (bin / p) * s;
    const Axis* axs = s_ax + ps + (bin % p) * s;
    T* o = out + ((size_t)r * p * p + bin) * c;
    for (int ch = lane * 8; ch < c; ch += kChannels) {
      const T* f = feat + ch;
      float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      for (int iy = 0; iy < s; ++iy) {
        const Axis ay = ays[iy];
        if (ay.lo < 0) continue;
        for (int ix = 0; ix < s; ++ix) {
          const Axis ax = axs[ix];
          if (ax.lo < 0) continue;
          const float w00 = __fmul_rn(ay.h, ax.h), w01 = __fmul_rn(ay.h, ax.l);
          const float w10 = __fmul_rn(ay.l, ax.h), w11 = __fmul_rn(ay.l, ax.l);
          float v00[8], v01[8], v10[8], v11[8];
          load8(f + ((size_t)ay.lo * w + ax.lo) * c, v00);
          load8(f + ((size_t)ay.lo * w + ax.hi) * c, v01);
          load8(f + ((size_t)ay.hi * w + ax.lo) * c, v10);
          load8(f + ((size_t)ay.hi * w + ax.hi) * c, v11);
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            float val = __fmul_rn(w00, v00[k]);
            val = __fadd_rn(val, __fmul_rn(w01, v01[k]));
            val = __fadd_rn(val, __fmul_rn(w10, v10[k]));
            val = __fadd_rn(val, __fmul_rn(w11, v11[k]));
            acc[k] = __fadd_rn(acc[k], val);
          }
        }
      }
#pragma unroll
      for (int k = 0; k < 8; ++k) acc[k] = pow2 ? __fmul_rn(acc[k], inv) : __fdiv_rn(acc[k], count);
      store8(o + ch, acc);
    }
  }
}

// The level gradients the tile kernel writes, in the output dtype, and its
// tiles: level l holds tiles [tiles[l], tiles[l + 1]), image-major, then
// row-major over ceil(h / kTile) x tiles_x.
struct TileLevels {
  void* data[kMaxLevels];
  int h[kMaxLevels];
  int w[kMaxLevels];
  float scale[kMaxLevels];
  int tiles_x[kMaxLevels];
  int tiles[kMaxLevels + 1];
  int num_levels;
};

// How a tile block finds its ROIs (see TileRois).
enum Walk { kScan, kWindows, kChunks };

// Byte offsets of the tile kernel's shared arrays, and the size of its dOut
// stage: kStageBytes, or one ROI's P x P bins if that is more. `walk` is the
// kernel's Walk: the window walks add their candidate ranges.
struct TileSmem {
  size_t rng, ints, geom, wts, bits, kbin, stage, stage_bytes, total;
};

// The bf16 "chunk" backward adds its pure chunks on the tensor cores, with a
// table of the staged bins (kbin: hit, row bin, column bin of each).
__host__ __device__ inline bool tile_mma(int item, int walk) {
  return walk == kChunks && item == 2;
}

__host__ __device__ inline TileSmem tile_smem(int p, int item, int walk) {
  TileSmem m;
  const size_t one_roi = (size_t)p * p * kSlice * item;
  m.stage_bytes = one_roi > (size_t)kStageBytes ? one_roi : (size_t)kStageBytes;
  m.rng = 0;                                               // int2 [kHits * kRanges]
  m.ints = m.rng + sizeof(int2) * kHits * kRanges;
  const int ints = kThreads + kWarps + (walk != kScan ? 3 * kCands + 1 : 0);
  m.geom = m.ints + sizeof(int) * ints;
  m.wts = m.geom + sizeof(RoiGeom) * kThreads;             // float [kHits * 2 * p * kTile]
  m.bits = m.wts + sizeof(float) * kHits * 2 * p * kTile;  // int [kHits * 2 * p]
  m.kbin = m.bits + sizeof(int) * kHits * 2 * p;           // int [staged bins]
  const size_t kbin = tile_mma(item, walk) ? sizeof(int) * (m.stage_bytes / (kSlice * item)) : 0;
  m.stage = (m.kbin + kbin + 15) / 16 * 16;
  m.total = m.stage + m.stage_bytes;
  return m;
}

// Whether the cells an ROI's samples may touch on its level meet the tile
// with rows [y0, y0 + kTile) and columns [x0, x0 + kTile): rows
// [floor(y1), floor(y1 + roi_h) + 1], columns alike (poolers.roi_footprints
// computes the same bounds and says why they hold every touched cell).
__device__ __forceinline__ bool meets_tile(float4 box, float scale, int y0, int x0) {
  const float x1 = __fmul_rn(box.x, scale), y1 = __fmul_rn(box.y, scale);
  const float rw = fmaxf(__fsub_rn(__fmul_rn(box.z, scale), x1), 1.f);
  const float rh = fmaxf(__fsub_rn(__fmul_rn(box.w, scale), y1), 1.f);
  return floorf(__fadd_rn(y1, rh)) + 1.f >= (float)y0 && floorf(y1) <= (float)(y0 + kTile - 1) &&
         floorf(__fadd_rn(x1, rw)) + 1.f >= (float)x0 && floorf(x1) <= (float)(x0 + kTile - 1);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::); }

// Two float32 as the low and high bf16 of an mma operand register.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Four 8 x 8 bf16 matrices of shared memory, transposed: the B operands of
// two m16n8k16 products.
__device__ __forceinline__ void ldmatrix_x4_trans(const void* smem, uint32_t r[4]) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// d += a . b, m16n8k16, bf16 operands, float32 sums.
__device__ __forceinline__ void mma_bf16(float d[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 8 consecutive channels of the stage, as float32.
__device__ __forceinline__ void stage8(const float* p, float v[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void stage8(const __nv_bfloat16* p, float v[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    v[2 * k] = f.x;
    v[2 * k + 1] = f.y;
  }
}

// Where a tile block finds the ROIs that may meet its tile:
//   kScan ("roi"): order [R], the ROIs sorted by (level, image), stable, and
//     seg [num_levels * nb + 1], the first position of each (level, image)
//     segment; the block tests the whole segment;
//   kWindows ("rmw") and kChunks ("chunk"): the window index of
//     poolers.window_kernel_inputs. first, end [tiles]: the rows [first,
//     end) of the window whose origin is that tile, numbered as the blocks'
//     tiles (none where end <= first); roi [rows]: the ROI of each row, -1
//     for padding rows and oversize ROIs; order and seg as for kScan, of
//     the oversize ROIs only. The block walks the kSpan x kSpan windows
//     whose cells cover the tile in key order, each window's rows in order,
//     then its segment's oversize ROIs. For kChunks, roi has kPureRow set
//     on the rows of pure chunks (one window's rows).
struct TileRois {
  const int* order;
  const int* seg;
  const int* first;
  const int* end;
  const int* roi;
};
constexpr int kPureRow = 1 << 30;

// Candidate range j of a window walk's tile (ty, tx) of level l, image b:
// for j < kSpan * kSpan the rows of the window with origin (ty - kSpan + 1 +
// j / kSpan, tx - kSpan + 1 + j % kSpan) in tiles, for the last the
// segment's oversize ROIs [first, first + n); beyond, none. (first row,
// count).
__device__ __forceinline__ int2 window_range(const TileLevels& lv, const TileRois& rois, int l,
                                             int b, int ty, int tx, int first, int n, int j) {
  if (j >= kCands) return make_int2(0, 0);
  if (j == kCands - 1) return make_int2(first, n);
  const int wy = ty - (kSpan - 1) + j / kSpan, wx = tx - (kSpan - 1) + j % kSpan;
  if (wy < 0 || wx < 0) return make_int2(0, 0);
  const int key = lv.tiles[l] + (b * ((lv.h[l] + kTile - 1) / kTile) + wy) * lv.tiles_x[l] + wx;
  const int start = rois.first[key];
  return make_int2(start, max(rois.end[key] - start, 0));
}

// Block (tile, slice) owns the tile's channels [slice * kSlice, + kSlice).
template <typename T, int kWalk>
__global__ void __launch_bounds__(kThreads, 3)
roi_align_bwd_tile_kernel(TileLevels lv, int nb, const float4* __restrict__ boxes, TileRois rois,
                          int c, int p, int s, const T* __restrict__ dout) {
  extern __shared__ __align__(16) unsigned char s_tile_raw[];
  const TileSmem sm = tile_smem(p, sizeof(T), kWalk);
  int2* s_rng = reinterpret_cast<int2*>(s_tile_raw + sm.rng);  // [kHits][kRanges]
  int* s_roi = reinterpret_cast<int*>(s_tile_raw + sm.ints);
  int* s_count = s_roi + kThreads;              // hits per warp of the scan
  int* s_cbeg = s_count + kWarps;               // the window walks' candidate ranges:
  int* s_clen = s_cbeg + kCands;                //   first row and length of each,
  int* s_pre = s_clen + kCands;                 //   and the rows before each
  RoiGeom* s_geom = reinterpret_cast<RoiGeom*>(s_tile_raw + sm.geom);
  float* s_w = reinterpret_cast<float*>(s_tile_raw + sm.wts);
  int* s_bits = reinterpret_cast<int*>(s_tile_raw + sm.bits);
  T* s_stage = reinterpret_cast<T*>(s_tile_raw + sm.stage);

  const int warp = threadIdx.x / 32, wl = threadIdx.x % 32;
  const int lane = threadIdx.x % kLanes, x = threadIdx.x / kLanes % kTile;
  const int rg = threadIdx.x / (kLanes * kTile);
  const int c0 = blockIdx.y * kSlice;
  const int ch = c0 + lane * 8;
  const int ps = p * s, pt = p * kTile;
  constexpr int kPieces = kSlice * (int)sizeof(T) / 16;  // 16-byte pieces of a staged bin
  constexpr int kPer = 16 / (int)sizeof(T);              // channels of a piece
  const int cnt = s * s;
  const float count = (float)cnt;
  const bool pow2 = (cnt & (cnt - 1)) == 0;  // then * (1 / count) is the division, exactly
  const float inv = 1.f / count;

  int t = blockIdx.x, l = 0;
  while (l + 1 < lv.num_levels && t >= lv.tiles[l + 1]) ++l;
  t -= lv.tiles[l];
  const int h = lv.h[l], w = lv.w[l];
  const float scale = lv.scale[l];
  const int per_image = lv.tiles_x[l] * ((h + kTile - 1) / kTile);
  const int b = t / per_image;
  t -= b * per_image;
  const int y0 = t / lv.tiles_x[l] * kTile, x0 = t % lv.tiles_x[l] * kTile;

  float acc[kRows][8];
#pragma unroll
  for (int y = 0; y < kRows; ++y) {
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[y][k] = 0.f;
  }

  const int seg = l * nb + b;
  int begin = rois.seg[seg], total = rois.seg[seg + 1] - begin;
  if (kWalk != kScan) {
    // the candidate ranges: the windows with origins [ty - kSpan + 1, ty] x
    // [tx - kSpan + 1, tx] in tiles (the only ones whose 48 x 48 cells
    // reach the tile), in key order, then the segment's oversize ROIs
    if (threadIdx.x < kCands) {
      const int2 rg = window_range(lv, rois, l, b, y0 / kTile, x0 / kTile, begin, total,
                                   threadIdx.x);
      s_cbeg[threadIdx.x] = rg.x;
      s_clen[threadIdx.x] = rg.y;
    }
    __syncthreads();
    if (warp == 0) {  // s_pre: the inclusive prefix sums of the lengths, shifted by one
      int a = wl < kCands ? s_clen[wl] : 0, a2 = wl + 32 < kCands ? s_clen[wl + 32] : 0;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int v = __shfl_up_sync(kFull, a, d), v2 = __shfl_up_sync(kFull, a2, d);
        if (wl >= d) {
          a += v;
          a2 += v2;
        }
      }
      const int low = __shfl_sync(kFull, a, 31);
      if (wl == 0) s_pre[0] = 0;
      if (wl < kCands) s_pre[wl + 1] = a;
      if (wl + 32 < kCands) s_pre[wl + 33] = low + a2;
    }
    __syncthreads();
    begin = 0;
    total = s_pre[kCands];
  }
  // "chunk" keeps the hits of its pure chunks (rows of one window: the TPU
  // kernel's stacked contraction) ahead of the others in each pass, and in
  // bf16 sums them on the tensor cores. Their sums (dacc: warp (mt, half)
  // owns cells [16 mt, 16 mt + 16), tile rows 2 mt and 2 mt + 1, and
  // channels [half, half + 1) * kMmaN * 8 of the slice; lane (mrow, tq)
  // holds cells mrow and mrow + 8 of those, channels 2 tq and 2 tq + 1 of
  // each n8 tile) pass to and from acc through the stage (s_sum, float32
  // [cell][kSlice]), so that only one of the two is live at a time.
  constexpr bool kMma = kWalk == kChunks && sizeof(T) == 2;
  int* s_kbin = reinterpret_cast<int*>(s_tile_raw + sm.kbin);      // [staged bins]
  float* s_sum = reinterpret_cast<float*>(s_tile_raw + sm.stage);  // [kTile^2][kSlice]
  const int mt = warp % kMmaM, half = warp / kMmaM, mrow = wl / 4, tq = wl % 4;
  for (int base = 0; base < total; base += kThreads) {
    // the candidates of this pass that meet the tile, in walk order ("chunk":
    // those of pure chunks first)
    const int i = base + threadIdx.x;
    int r = -1;
    float4 box = make_float4(0.f, 0.f, 0.f, 0.f);
    bool hit = false, pure = false;
    if (i < total) {
      if (kWalk == kScan) {
        r = rois.order[begin + i];
      } else {
        int j = 0, hi = kCands - 1;  // the range holding candidate i
        while (j < hi) {
          const int mid = (j + hi + 1) / 2;
          if (s_pre[mid] <= i) {
            j = mid;
          } else {
            hi = mid - 1;
          }
        }
        const int row = s_cbeg[j] + i - s_pre[j];
        if (j < kSpan * kSpan) {
          r = rois.roi[row];
          pure = kWalk == kChunks && r >= 0 && (r & kPureRow);
          r = pure ? r & ~kPureRow : r;
        } else {
          r = rois.order[row];
        }
      }
      if (r >= 0) {
        box = boxes[r];
        hit = meets_tile(box, scale, y0, x0);
      }
    }
    // a warp's hits, its pure-chunk hits in the high half
    const unsigned m = __ballot_sync(kFull, hit && !pure);
    const unsigned mp = kWalk == kChunks ? __ballot_sync(kFull, hit && pure) : 0u;
    if (wl == 0) s_count[warp] = __popc(m) | __popc(mp) << 16;
    __syncthreads();
    int before = 0, nhit = 0;
    for (int k = 0; k < kWarps; ++k) {
      before += k < warp ? s_count[k] : 0;
      nhit += s_count[k];
    }
    const int npure = nhit >> 16;
    nhit = (nhit & 0xffff) + npure;
    if (hit) {
      const unsigned below = (1u << wl) - 1u;
      const int k = pure ? (before >> 16) + __popc(mp & below)
                         : npure + (before & 0xffff) + __popc(m & below);
      s_roi[k] = r;
      s_geom[k] = roi_geom(box, scale, p, s);
    }
    __syncthreads();

    // bf16 "chunk": the pure chunks' hits [0, npure) on the tensor cores if
    // there are kMmaMinHits of them, then the others; else every hit on the
    // CUDA cores
    const bool use_mma = kMma && npure >= kMmaMinHits;
#pragma unroll
    for (int part = 0; part < (kMma ? 2 : 1); ++part) {
      const bool tensor = kMma && part == 0;
      const int from = kMma && part == 1 && use_mma ? npure : 0, to = tensor ? npure : nhit;
      if (from >= to || (tensor && !use_mma)) continue;
      float dacc[kMmaN][4];
      if (tensor) {
        if (base > 0) {  // acc holds an earlier pass's sums
#pragma unroll
          for (int y = 0; y < kRows; ++y) {
            store8(s_sum + ((rg * kRows + y) * kTile + x) * kSlice + lane * 8, acc[y]);
          }
          __syncthreads();
        }
#pragma unroll
        for (int n = 0; n < kMmaN; ++n) {
          const float* at = s_sum + (16 * mt + mrow) * kSlice + (half * kMmaN + n) * 8 + 2 * tq;
          dacc[n][0] = base > 0 ? at[0] : 0.f;
          dacc[n][1] = base > 0 ? at[1] : 0.f;
          dacc[n][2] = base > 0 ? at[8 * kSlice] : 0.f;
          dacc[n][3] = base > 0 ? at[8 * kSlice + 1] : 0.f;
        }
        if (base > 0) __syncthreads();  // before the stage is refilled
      }
      for (int h0 = from; h0 < to; h0 += kHits) {
        const int nh = min(kHits, to - h0);
        // RowW [p][kTile] then ColW [p][kTile] of each ROI over the tile: a
        // thread per bin computes its samples' axes and the weights they give
        // each cell, with a bit per cell the bin reaches
        for (int e = threadIdx.x; e < nh * 2 * p; e += kThreads) {
          const int col = e / p % 2, bin = e % p;
          const RoiGeom g = s_geom[h0 + e / (2 * p)];
          const int at0 = col ? x0 : y0;
          float wt[kTile];
#pragma unroll
          for (int cell = 0; cell < kTile; ++cell) wt[cell] = 0.f;
          for (int j = 0; j < s; ++j) {
            const Axis a = roi_axis(g, col * ps + bin * s + j, p, s, h, w);
            if (a.lo < 0) continue;
#pragma unroll
            for (int cell = 0; cell < kTile; ++cell) {
              if (a.lo == at0 + cell) wt[cell] = __fadd_rn(wt[cell], a.h);
              if (a.hi == at0 + cell) wt[cell] = __fadd_rn(wt[cell], a.l);
            }
          }
          int bits = 0;
#pragma unroll
          for (int cell = 0; cell < kTile; ++cell) {
            s_w[e * kTile + cell] = wt[cell];
            bits |= (wt[cell] != 0.f) << cell;
          }
          s_bits[e] = bits;
        }
        __syncthreads();
        // the bins reaching the tile, each row group's rows and each column
        for (int e = threadIdx.x; e < nh * kRanges; e += kThreads) {
          const int j = e % kRanges;
          const int col = j == 1 || j >= 2 + kRowGroups;
          const int want = j < 2 ? (1 << kTile) - 1
                           : col ? 1 << (j - 2 - kRowGroups)
                                 : ((1 << kRows) - 1) << ((j - 2) * kRows);
          const int* bits = s_bits + (e / kRanges * 2 + col) * p;
          int lo = p, hi = -1;
          for (int bin = 0; bin < p; ++bin) {
            if (bits[bin] & want) {
              lo = min(lo, bin);
              hi = bin;
            }
          }
          s_rng[e] = make_int2(lo, hi);
        }
        __syncthreads();
        // the hits in runs whose dOut bins fit the stage. Every warp works the
        // run out itself: lane i holds the first staged bin of hit k0 + i.
        for (int k0 = 0; k0 < nh;) {
          int bins = 0;
          if (k0 + wl < nh) {
            const int2 rr = s_rng[(k0 + wl) * kRanges], qq = s_rng[(k0 + wl) * kRanges + 1];
            bins = rr.x > rr.y || qq.x > qq.y ? 0 : (rr.y - rr.x + 1) * (qq.y - qq.x + 1);
          }
          int incl = bins;
#pragma unroll
          for (int d = 1; d < 32; d <<= 1) {
            const int v = __shfl_up_sync(kFull, incl, d);
            if (wl >= d) incl += v;
          }
          const int first = incl - bins;
          const int run = __popc(__ballot_sync(
              kFull, k0 + wl < nh && (wl == 0 || (size_t)incl * kSlice * sizeof(T) <= sm.stage_bytes)));
          const int staged = __shfl_sync(kFull, incl, run - 1);
          // stage dOut [row rect][column rect][kSlice] of the run's hits; the
          // loop runs alike in all lanes of a warp, for the shuffles
          for (int e0 = warp * 32; e0 < staged * kPieces; e0 += kThreads) {
            const int e = e0 + wl, bin = e / kPieces, part = e % kPieces;
            int i = 0;
            for (int j = 1; j < run; ++j) i = __shfl_sync(kFull, first, j) <= bin ? j : i;
            const int at = __shfl_sync(kFull, first, i);
            if (e >= staged * kPieces || c0 + part * kPer >= c) continue;
            const int k = k0 + i;
            const int2 rr = s_rng[k * kRanges], qq = s_rng[k * kRanges + 1];
            const int qn = qq.y - qq.x + 1, local = bin - at;
            const T* src = dout + ((size_t)s_roi[h0 + k] * p * p + (rr.x + local / qn) * p + qq.x +
                                   local % qn) * c + c0 + part * kPer;
            if (tensor) {
              // a bin's pieces swizzled by the bin, so that ldmatrix reads 8
              // bins' rows from distinct banks; the bin's hit and bins
              cp_async16(s_stage + ((size_t)bin * kPieces + (part ^ (bin % 8))) * kPer, src);
              if (part == 0) s_kbin[bin] = k << 16 | (rr.x + local / qn) << 8 | (qq.x + local % qn);
            } else {
              cp_async16(s_stage + (size_t)e * kPer, src);
            }
          }
          cp_async_wait_all();
          __syncthreads();
          if (tensor) {
            // dTile[cell, ch] += sum over the staged bins of RowW[y] ColW[x]
            // . dOut[bin, ch]: the run's hits stacked along K, 16 bins a
            // step; A, the weights' products rounded to bf16, from the bin
            // table, B by ldmatrix from the stage; bins past the run get
            // zero weight and read the step's first bin
            const int ycell = 2 * mt;
            for (int kb = 0; kb < staged; kb += 16) {
              float lo[4], hi[4];  // A of cells mrow, mrow + 8 at bins kb + 2 tq + {0, 1, 8, 9}
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                const int bin = kb + 2 * tq + (j & 1) + (j >> 1) * 8;
                lo[j] = hi[j] = 0.f;
                if (bin < staged) {
                  const int code = s_kbin[bin];
                  const float* wk = s_w + (code >> 16) * 2 * pt;
                  const float* wr = wk + ((code >> 8) & 255) * kTile + ycell;
                  const float cx = wk[pt + (code & 255) * kTile + mrow];
                  lo[j] = __fmul_rn(wr[0], cx);
                  hi[j] = __fmul_rn(wr[1], cx);
                }
              }
              const uint32_t a[4] = {pack_bf16(lo[0], lo[1]), pack_bf16(hi[0], hi[1]),
                                     pack_bf16(lo[2], lo[3]), pack_bf16(hi[2], hi[3])};
              // lane (8 mat + row) addresses row `row` of matrix mat: bins
              // kb + 8 (mat % 2) + row, channels of n8 tile 2 np + mat / 2
              int bin = kb + (wl / 8 % 2) * 8 + wl % 8;
              bin = bin < staged ? bin : kb;
#pragma unroll
              for (int np = 0; np < kMmaN / 2; ++np) {
                const int piece = half * kMmaN + 2 * np + wl / 16;
                uint32_t bq[4];
                ldmatrix_x4_trans(s_stage + ((size_t)bin * kPieces + (piece ^ (bin % 8))) * kPer,
                                  bq);
                mma_bf16(dacc[2 * np], a, bq[0], bq[1]);
                mma_bf16(dacc[2 * np + 1], a, bq[2], bq[3]);
              }
            }
            __syncthreads();  // before the next run restages
            k0 += run;
            continue;
          }
          for (int i = 0; i < run; ++i) {
            const int at = __shfl_sync(kFull, first, i);
            const int k = k0 + i;
            const int2 qr = s_rng[k * kRanges + 2 + kRowGroups + x], pr = s_rng[k * kRanges + 2 + rg];
            if (ch >= c || qr.x > qr.y || pr.x > pr.y) continue;  // no cell of this thread
            const int2 rr = s_rng[k * kRanges], qq = s_rng[k * kRanges + 1];
            const int qn = qq.y - qq.x + 1;
            const float* rw = s_w + k * 2 * pt + rg * kRows;
            const float* cw = s_w + k * 2 * pt + pt + x;
            const T* st = s_stage + (size_t)at * kSlice + lane * 8;
            for (int pi = pr.x; pi <= pr.y; ++pi) {
              float wr[kRows];
#pragma unroll
              for (int y = 0; y < kRows; ++y) wr[y] = rw[pi * kTile + y];
              // T = sum over the column's bins of ColW * dOut, without
              // branches on the weights and two bins a step, so that the
              // shared loads of a step issue together
              float tv[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
              const T* sq = st + ((size_t)(pi - rr.x) * qn + qr.x - qq.x) * kSlice;
              const float* wq = cw + qr.x * kTile;
              const int nq = qr.y - qr.x + 1;
              int q = 0;
              for (; q + 1 < nq; q += 2) {
                const float w0 = wq[q * kTile], w1 = wq[(q + 1) * kTile];
                float v0[8], v1[8];
                stage8(sq + (size_t)q * kSlice, v0);
                stage8(sq + (size_t)(q + 1) * kSlice, v1);
#pragma unroll
                for (int kk = 0; kk < 8; ++kk) tv[kk] = __fmaf_rn(w0, v0[kk], tv[kk]);
#pragma unroll
                for (int kk = 0; kk < 8; ++kk) tv[kk] = __fmaf_rn(w1, v1[kk], tv[kk]);
              }
              if (q < nq) {
                const float w0 = wq[q * kTile];
                float v0[8];
                stage8(sq + (size_t)q * kSlice, v0);
#pragma unroll
                for (int kk = 0; kk < 8; ++kk) tv[kk] = __fmaf_rn(w0, v0[kk], tv[kk]);
              }
#pragma unroll
              for (int y = 0; y < kRows; ++y) {
                if (wr[y] == 0.f) continue;
#pragma unroll
                for (int kk = 0; kk < 8; ++kk) acc[y][kk] = __fmaf_rn(wr[y], tv[kk], acc[y][kk]);
              }
            }
          }
          __syncthreads();  // before the next run restages
          k0 += run;
        }
      }
      if (tensor) {  // the tensor-core sums into acc
#pragma unroll
        for (int n = 0; n < kMmaN; ++n) {
          float* at = s_sum + (16 * mt + mrow) * kSlice + (half * kMmaN + n) * 8 + 2 * tq;
          *reinterpret_cast<float2*>(at) = make_float2(dacc[n][0], dacc[n][1]);
          *reinterpret_cast<float2*>(at + 8 * kSlice) = make_float2(dacc[n][2], dacc[n][3]);
        }
        __syncthreads();
#pragma unroll
        for (int y = 0; y < kRows; ++y) {
          stage8(s_sum + ((rg * kRows + y) * kTile + x) * kSlice + lane * 8, acc[y]);
        }
        __syncthreads();  // before the stage is refilled
      }
    }
  }

  if (x0 + x < w && ch < c) {
    T* g = (T*)lv.data[l] + (((size_t)b * h + y0 + rg * kRows) * w + x0 + x) * c + ch;
#pragma unroll
    for (int y = 0; y < kRows; ++y) {
      if (y0 + rg * kRows + y < h) {
        float v[8];
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
          v[kk] = pow2 ? __fmul_rn(acc[y][kk], inv) : __fdiv_rn(acc[y][kk], count);
        }
        store8(g + (size_t)y * w * c, v);
      }
    }
  }
}

}  // namespace

extern "C" int roi_align_max_levels() { return kMaxLevels; }

namespace {

bool aligned16(const void* ptr) { return (uintptr_t)ptr % 16 == 0; }

template <typename T, int kWalk>
cudaError_t launch_tile_backward(const TileLevels& lv, int nb, const void* boxes,
                                 const TileRois& rois, int c, int p, int s, const void* dout,
                                 cudaStream_t st) {
  const size_t smem = tile_smem(p, sizeof(T), kWalk).total;
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(roi_align_bwd_tile_kernel<T, kWalk>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(lv.tiles[lv.num_levels], (c + kSlice - 1) / kSlice);
  roi_align_bwd_tile_kernel<T, kWalk><<<grid, kThreads, smem, st>>>(
      lv, nb, (const float4*)boxes, rois, c, p, s, (const T*)dout);
  return cudaGetLastError();
}

// The tile backward of `walk` for every level's NHWC gradient in out (see
// roi_align_backward).
cudaError_t tile_backward(int walk, void* out, const long long* out_offsets, const int* hs,
                          const int* ws, const float* scales, int num_levels, int nb,
                          const void* boxes, const TileRois& rois, int c, int p, int s,
                          int dtype, const void* dout, cudaStream_t st) {
  if (num_levels < 1 || num_levels > kMaxLevels || dtype < 0 || dtype > 1 || nb < 1 ||
      c <= 0 || c % 8 != 0 || p < 1 || s < 1 || !aligned16(out) || !aligned16(dout)) {
    return cudaErrorInvalidValue;
  }
  const size_t item = dtype == 0 ? sizeof(float) : sizeof(__nv_bfloat16);
  TileLevels lv = {};
  lv.num_levels = num_levels;
  for (int i = 0; i < num_levels; ++i) {
    lv.data[i] = (char*)out + out_offsets[i] * item;
    lv.h[i] = hs[i];
    lv.w[i] = ws[i];
    lv.scale[i] = scales[i];
    lv.tiles_x[i] = (ws[i] + kTile - 1) / kTile;
    lv.tiles[i + 1] = lv.tiles[i] + lv.tiles_x[i] * ((hs[i] + kTile - 1) / kTile) * nb;
  }
  if (lv.tiles[num_levels] == 0) return cudaSuccess;
  if (dtype == 0) {
    if (walk == kScan) {
      return launch_tile_backward<float, kScan>(lv, nb, boxes, rois, c, p, s, dout, st);
    }
    if (walk == kWindows) {
      return launch_tile_backward<float, kWindows>(lv, nb, boxes, rois, c, p, s, dout, st);
    }
    return launch_tile_backward<float, kChunks>(lv, nb, boxes, rois, c, p, s, dout, st);
  }
  using B = __nv_bfloat16;
  if (walk == kScan) return launch_tile_backward<B, kScan>(lv, nb, boxes, rois, c, p, s, dout, st);
  if (walk == kWindows) {
    return launch_tile_backward<B, kWindows>(lv, nb, boxes, rois, c, p, s, dout, st);
  }
  return launch_tile_backward<B, kChunks>(lv, nb, boxes, rois, c, p, s, dout, st);
}

}  // namespace

// level_ptrs/hs/ws/scales: host arrays of num_levels entries, each level an
// NHWC-contiguous [B, H, W, c] map of `dtype` (0 = f32, 1 = bf16), 16-byte
// aligned, c % 8 == 0; boxes [r, 4] f32, batch_idx [r] i32, level [r] i32 in
// [0, num_levels); out [r, p, p, c] of `dtype`, 16-byte aligned. Returns
// cudaGetLastError() after the launch.
extern "C" int roi_align_forward(const void* const* level_ptrs, const int* hs,
                                 const int* ws, const float* scales,
                                 int num_levels, const void* boxes,
                                 const void* batch_idx, const void* level,
                                 int r, int c, int p, int s, int dtype,
                                 void* out, void* stream) {
  if (r <= 0) return 0;
  const size_t smem = sizeof(Axis) * 2 * p * s;
  if (num_levels < 1 || num_levels > kMaxLevels || dtype < 0 || dtype > 1 || c <= 0 ||
      c % 8 != 0 || p < 1 || s < 1 || smem > 48 * 1024 || !aligned16(out)) {
    return (int)cudaErrorInvalidValue;
  }
  Levels lv = {};
  for (int i = 0; i < num_levels; ++i) {
    if (!aligned16(level_ptrs[i])) return (int)cudaErrorInvalidValue;
    lv.data[i] = level_ptrs[i];
    lv.h[i] = hs[i];
    lv.w[i] = ws[i];
    lv.scale[i] = scales[i];
  }
  const int bands = (p * p + kBandBins - 1) / kBandBins;
  const int band = (p * p + bands - 1) / bands;
  const dim3 grid(r, bands);
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) {
    roi_align_fwd_kernel<float><<<grid, kThreads, smem, st>>>(
        lv, (const float4*)boxes, (const int*)batch_idx, (const int*)level, c, p, s, band,
        (float*)out);
  } else {
    roi_align_fwd_kernel<__nv_bfloat16><<<grid, kThreads, smem, st>>>(
        lv, (const float4*)boxes, (const int*)batch_idx, (const int*)level, c, p, s, band,
        (__nv_bfloat16*)out);
  }
  return (int)cudaGetLastError();
}

// The "roi" backward. out: every level's NHWC [nb, H, W, c] gradient of
// `dtype` back to back (level l at out_offsets[l] elements), written whole
// here, 16-byte aligned, c % 8 == 0; hs/ws/scales as for the forward; boxes
// [r, 4] f32; order [r] i32, the ROIs sorted by (level, image), stable;
// seg_start [num_levels * nb + 1] i32, the first position in order of each
// (level, image); dout [r, p, p, c] of `dtype`, 16-byte aligned. Returns
// cudaGetLastError() after the launch.
extern "C" int roi_align_backward(void* out, const long long* out_offsets, const int* hs,
                                  const int* ws, const float* scales, int num_levels, int nb,
                                  const void* boxes, const void* order,
                                  const void* seg_start, int c, int p, int s, int dtype,
                                  const void* dout, void* stream) {
  const TileRois rois = {(const int*)order, (const int*)seg_start, nullptr, nullptr, nullptr};
  return (int)tile_backward(kScan, out, out_offsets, hs, ws, scales, num_levels, nb, boxes, rois,
                            c, p, s, dtype, dout, (cudaStream_t)stream);
}

// The largest P the window backwards take: one ROI's float32 bins of a
// channel slice and its tile weights fit a block's shared memory.
extern "C" int roi_align_window_max_p() {
  int p = 1;
  while (tile_smem(p + 1, sizeof(float), kChunks).total <= kMaxSmem) ++p;
  return p;
}

// The "rmw" (chunk = 0) and "chunk" (chunk = 1) backwards: the arguments of
// roi_align_backward, with the window index of poolers.window_kernel_inputs
// in place of order and seg_start: first, end [tiles] i32; roi [rows] i32;
// over_order [r] and over_seg [num_levels * nb + 1] i32, the oversize ROIs
// by (level, image). Returns cudaGetLastError() after the launch.
extern "C" int roi_align_backward_windows(int chunk, void* out, const long long* out_offsets,
                                          const int* hs, const int* ws, const float* scales,
                                          int num_levels, int nb, const void* boxes, int c,
                                          int p, int s, int dtype, const void* dout,
                                          const void* first, const void* end, const void* roi,
                                          const void* over_order, const void* over_seg,
                                          void* stream) {
  const TileRois rois = {(const int*)over_order, (const int*)over_seg, (const int*)first,
                         (const int*)end, (const int*)roi};
  return (int)tile_backward(chunk ? kChunks : kWindows, out, out_offsets, hs, ws, scales,
                            num_levels, nb, boxes, rois, c, p, s, dtype, dout,
                            (cudaStream_t)stream);
}
