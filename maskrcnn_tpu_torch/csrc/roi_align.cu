// Multi-level FPN ROIAlign, forward and backward, for Hopper (sm_90a).
//
// What each entry point replaces (maskrcnn_tpu/ops/pallas/roi_align_kernel.py):
//   * roi_align_forward: multilevel_roi_align_pallas / _kernel (:372, :434),
//     with its jnp prep _precompute and _bin_weights;
//   * roi_align_backward: the default "roi" backward, _roi_align_bwd_roi /
//     _roi_bwd_kernel (:955, :1020);
//   * roi_align_backward_rmw and roi_align_backward_chunk, at the end of the
//     file: the "rmw" and "chunk" backwards (:646, :850).
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
// roi_align_bwd_kernel, the former "roi" backward (a float32 atomicAdd
// scatter of every sample into one zeroed buffer, then one cast), stays as
// the helper of the window backwards, which scatter their oversize ROIs
// exactly with it.

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
constexpr unsigned kFull = 0xffffffffu;

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

// Byte offsets of the tile kernel's shared arrays, and the size of its dOut
// stage: kStageBytes, or one ROI's P x P bins if that is more.
struct TileSmem {
  size_t rng, ints, geom, wts, bits, stage, stage_bytes, total;
};

__host__ __device__ inline TileSmem tile_smem(int p, int s, int item) {
  TileSmem m;
  m.rng = 0;                                               // int2 [kHits * kRanges]
  m.ints = m.rng + sizeof(int2) * kHits * kRanges;
  m.geom = m.ints + sizeof(int) * (kThreads + kWarps);
  m.wts = m.geom + sizeof(RoiGeom) * kThreads;             // float [kHits * 2 * p * kTile]
  m.bits = m.wts + sizeof(float) * kHits * 2 * p * kTile;  // int [kHits * 2 * p]
  m.stage = (m.bits + sizeof(int) * kHits * 2 * p + 15) / 16 * 16;
  const size_t one_roi = (size_t)p * p * kSlice * item;
  m.stage_bytes = one_roi > (size_t)kStageBytes ? one_roi : (size_t)kStageBytes;
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

// order [R]: ROI indices sorted by (level, image), stable; seg_start
// [num_levels * nb + 1]: the first position of each (level, image) segment.
// Block (tile, slice) owns the tile's channels [slice * kSlice, + kSlice).
template <typename T>
__global__ void __launch_bounds__(kThreads)
roi_align_bwd_tile_kernel(TileLevels lv, int nb, const float4* __restrict__ boxes,
                          const int* __restrict__ order, const int* __restrict__ seg_start,
                          int c, int p, int s, const T* __restrict__ dout) {
  extern __shared__ __align__(16) unsigned char s_tile_raw[];
  const TileSmem sm = tile_smem(p, s, sizeof(T));
  int2* s_rng = reinterpret_cast<int2*>(s_tile_raw + sm.rng);  // [kHits][kRanges]
  int* s_roi = reinterpret_cast<int*>(s_tile_raw + sm.ints);
  int* s_count = s_roi + kThreads;              // hits per warp of the scan
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
  constexpr int kChunks = kSlice * (int)sizeof(T) / 16;  // 16-byte pieces of a staged bin
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
  const int begin = seg_start[seg], end = seg_start[seg + 1];
  for (int base = begin; base < end; base += kThreads) {
    // the ROIs of this part of the segment that meet the tile, in list order
    const int i = base + threadIdx.x;
    int r = -1;
    float4 box = make_float4(0.f, 0.f, 0.f, 0.f);
    bool hit = false;
    if (i < end) {
      r = order[i];
      box = boxes[r];
      hit = meets_tile(box, scale, y0, x0);
    }
    const unsigned m = __ballot_sync(kFull, hit);
    if (wl == 0) s_count[warp] = __popc(m);
    __syncthreads();
    int before = 0, nhit = 0;
    for (int k = 0; k < kWarps; ++k) {
      before += k < warp ? s_count[k] : 0;
      nhit += s_count[k];
    }
    if (hit) {
      const int k = before + __popc(m & ((1u << wl) - 1u));
      s_roi[k] = r;
      s_geom[k] = roi_geom(box, scale, p, s);
    }
    __syncthreads();

    for (int h0 = 0; h0 < nhit; h0 += kHits) {
      const int nh = min(kHits, nhit - h0);
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
        for (int e0 = warp * 32; e0 < staged * kChunks; e0 += kThreads) {
          const int e = e0 + wl, bin = e / kChunks, part = e % kChunks;
          int i = 0;
          for (int j = 1; j < run; ++j) i = __shfl_sync(kFull, first, j) <= bin ? j : i;
          const int at = __shfl_sync(kFull, first, i);
          if (e >= staged * kChunks || c0 + part * kPer >= c) continue;
          const int k = k0 + i;
          const int2 rr = s_rng[k * kRanges], qq = s_rng[k * kRanges + 1];
          const int qn = qq.y - qq.x + 1, local = bin - at;
          const T* src = dout + ((size_t)s_roi[h0 + k] * p * p + (rr.x + local / qn) * p + qq.x +
                                 local % qn) * c + c0 + part * kPer;
          cp_async16(s_stage + (size_t)e * kPer, src);
        }
        cp_async_wait_all();
        __syncthreads();
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

// Level gradients of the window backwards: float32 NHWC accumulation
// buffers, one per level.
struct GradLevels {
  float* data[kMaxLevels];
  int h[kMaxLevels];
  int w[kMaxLevels];
  float scale[kMaxLevels];
};

// The exact per-sample scatter: one block per (ROI, output row), one
// channel a thread, each corner's share added by float32 atomicAdd. `only`,
// when given, restricts it to the ROIs it flags (the window backwards hand
// it their oversize ROIs); the others' blocks return.
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
//     one zeroed float32 NHWC buffer (GradLevels). Windows overlap
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
// 48 * 48 * C atomic adds, fewer than the exact scatter's
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

namespace {

bool aligned16(const void* ptr) { return (uintptr_t)ptr % 16 == 0; }

template <typename T>
cudaError_t launch_tile_backward(const TileLevels& lv, int nb, const void* boxes,
                                 const void* order, const void* seg_start, int c, int p,
                                 int s, const void* dout, cudaStream_t st) {
  const size_t smem = tile_smem(p, s, sizeof(T)).total;
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        roi_align_bwd_tile_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(lv.tiles[lv.num_levels], (c + kSlice - 1) / kSlice);
  roi_align_bwd_tile_kernel<T><<<grid, kThreads, smem, st>>>(
      lv, nb, (const float4*)boxes, (const int*)order, (const int*)seg_start, c, p, s,
      (const T*)dout);
  return cudaGetLastError();
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
  if (num_levels < 1 || num_levels > kMaxLevels || dtype < 0 || dtype > 1 || nb < 1 ||
      c <= 0 || c % 8 != 0 || p < 1 || s < 1 || !aligned16(out) || !aligned16(dout)) {
    return (int)cudaErrorInvalidValue;
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
  if (lv.tiles[num_levels] == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t e =
      dtype == 0
          ? launch_tile_backward<float>(lv, nb, boxes, order, seg_start, c, p, s, dout, st)
          : launch_tile_backward<__nv_bfloat16>(lv, nb, boxes, order, seg_start, c, p, s, dout,
                                                st);
  return (int)e;
}

namespace {

// The buffers of the window backwards: acc, a float32 buffer of `total`
// elements holding every level's NHWC gradient back to back (level l at
// acc_offsets[l] elements, [B, H, W, c]), zeroed here; dout [r, p, p, c] of
// `dtype` (0 = f32, 1 = bf16); boxes, batch_idx, level as for the forward.
// For dtype 1 the float32 sums are cast once into out (bf16, same layout as
// acc); for dtype 0 acc is the result and out is unused.

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
