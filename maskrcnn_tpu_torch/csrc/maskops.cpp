// Host mask operations of the port's data pipeline and evaluation.
//
// Copies of three routines of the JAX package's csrc/maskops.cpp (which
// maskrcnn_tpu/utils/_maskops_native.py binds), so that the port's masks and
// RLEs are bit-equal to that package's native path:
//
//   polygons_to_mask  : COCO-compatible polygon rasterization, a 5x
//                       supersampled scanline even-odd fill with the boundary
//                       marked, max-pooled back to the coarse grid, as COCO's
//                       frPoly (the port has no OpenCV, so this is its only
//                       rasterizer)
//   run_intersection  : intersection area of two column-major RLEs
//   paste_encode_mask : one detection's [M, M] mask probabilities pasted into
//                       its box on the image and emitted as COCO RLE counts,
//                       without the [h, w] canvas
//
// and one of its own, the JAX package's cv2.findContours call:
//
//   find_external_contours : the outer borders of a binary mask, as OpenCV's
//                       findContours(RETR_EXTERNAL, CHAIN_APPROX_TC89_L1)
//                       returns them (OpenCV 5's implementation)
//
// Built by the host C++ compiler at first use (ops/native.py), called
// through ctypes from maskrcnn_tpu_torch/utils/maskops.py.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Rasterize one instance (list of polygons, flattened xy pairs) into a
// h*w uint8 mask. coords: all polygons concatenated; sizes[i] = number of
// DOUBLES (2*points) in polygon i.
void polygons_to_mask(const double* coords, const int64_t* sizes,
                      int64_t n_polys, int64_t h, int64_t w,
                      uint8_t* out /* h*w, zeroed by caller or not */) {
  const int64_t S = 5;  // supersample factor (COCO uses 5)
  const int64_t H = h * S, W = w * S;
  std::memset(out, 0, (size_t)(h * w));
  if (n_polys <= 0) return;

  // supersampled accumulation buffer (bit per fine pixel would be leaner;
  // byte keeps the code simple and this is still ~25x the coarse mask)
  std::vector<uint8_t> fine((size_t)(H * W), 0);

  const double* p = coords;
  for (int64_t pi = 0; pi < n_polys; ++pi) {
    int64_t n = sizes[pi] / 2;  // points
    if (n >= 3) {
      // scale with COCO rounding: floor(5*v + 0.5)
      std::vector<double> xs(n), ys(n);
      for (int64_t i = 0; i < n; ++i) {
        xs[i] = std::floor(S * p[2 * i] + 0.5);
        ys[i] = std::floor(S * p[2 * i + 1] + 0.5);
      }
      // 1) scanline even-odd fill on the fine grid (pixel centers at k+0.5)
      for (int64_t y = 0; y < H; ++y) {
        double yc = y + 0.5;
        // gather x crossings
        std::vector<double> xcross;
        for (int64_t i = 0; i < n; ++i) {
          int64_t j = (i + 1) % n;
          double y0 = ys[i], y1 = ys[j];
          if ((y0 <= yc && y1 > yc) || (y1 <= yc && y0 > yc)) {
            double t = (yc - y0) / (y1 - y0);
            xcross.push_back(xs[i] + t * (xs[j] - xs[i]));
          }
        }
        std::sort(xcross.begin(), xcross.end());
        for (size_t k = 0; k + 1 < xcross.size(); k += 2) {
          int64_t x0 = (int64_t)std::ceil(xcross[k] - 0.5);
          int64_t x1 = (int64_t)std::floor(xcross[k + 1] - 0.5);
          x0 = std::max<int64_t>(x0, 0);
          x1 = std::min<int64_t>(x1, W - 1);
          for (int64_t x = x0; x <= x1; ++x) fine[(size_t)(y * W + x)] = 1;
        }
      }
      // 2) boundary: mark every fine pixel each edge passes through
      for (int64_t i = 0; i < n; ++i) {
        int64_t j = (i + 1) % n;
        double x0 = xs[i], y0 = ys[i], x1 = xs[j], y1 = ys[j];
        double dx = x1 - x0, dy = y1 - y0;
        int64_t steps = (int64_t)std::max(std::fabs(dx), std::fabs(dy)) + 1;
        for (int64_t s = 0; s <= steps; ++s) {
          double t = (double)s / (double)steps;
          int64_t xx = (int64_t)std::llround(x0 + t * dx);
          int64_t yy = (int64_t)std::llround(y0 + t * dy);
          if (xx >= 0 && xx < W && yy >= 0 && yy < H)
            fine[(size_t)(yy * W + xx)] = 1;
        }
      }
    }
    p += sizes[pi];
  }

  // 3) max-pool SxS back to the coarse grid
  for (int64_t y = 0; y < h; ++y) {
    for (int64_t x = 0; x < w; ++x) {
      uint8_t v = 0;
      for (int64_t sy = 0; sy < S && !v; ++sy) {
        const uint8_t* row = &fine[(size_t)((y * S + sy) * W + x * S)];
        for (int64_t sx = 0; sx < S; ++sx) {
          if (row[sx]) { v = 1; break; }
        }
      }
      out[(size_t)(y * w + x)] = v;
    }
  }
}

// Intersection area of two column-major RLEs (counts arrays).
int64_t run_intersection(const int64_t* a, int64_t na, const int64_t* b,
                         int64_t nb) {
  int64_t ia = 0, ib = 0;
  int64_t ea = na > 0 ? a[0] : 0;  // end position of current a-run
  int64_t eb = nb > 0 ? b[0] : 0;
  int64_t pos = 0, inter = 0;
  int va = 0, vb = 0;
  while (ia < na && ib < nb) {
    int64_t nxt = std::min(ea, eb);
    if (va && vb) inter += nxt - pos;
    pos = nxt;
    if (ea == nxt) {
      ++ia;
      va ^= 1;
      if (ia < na) ea += a[ia];
    }
    if (eb == nxt) {
      ++ib;
      vb ^= 1;
      if (ib < nb) eb += b[ib];
    }
  }
  return inter;
}

}  // extern "C"

// -- fused mask paste + column-major RLE encode ------------------------------
//
// One call bilinearly resizes the padded [M, M] probability patch onto its
// (expanded, integerized) box, thresholds, and emits COCO column-major RLE
// counts directly: the [im_h, im_w] canvas is never materialized (the
// reference accounts the per-image paste at +0.034 s/im, MODEL_ZOO.md:26).
//
// Semantics mirror reference mask_head/inference.py:119-160: zero pad by
// `padding`, expand the box by (M+2p)/M about its center, truncate to
// int64, resize to (bw, bh) with pixel-center bilinear sampling (clamped
// borders, as cv2 INTER_LINEAR), threshold strictly, clip to the image.
// counts_out must hold im_h * im_w + 2 entries.

extern "C" int64_t paste_encode_mask(
    const float* mask, int64_t m, int64_t padding, const double* box_xyxy,
    double thresh, int64_t im_h, int64_t im_w, int64_t* counts_out) {
  // padded patch
  const int64_t n = m + 2 * padding;
  std::vector<float> padded(n * n, 0.f);
  for (int64_t y = 0; y < m; ++y)
    for (int64_t x = 0; x < m; ++x)
      padded[(y + padding) * n + x + padding] = mask[y * m + x];

  // expand about center by (m+2p)/m, then truncate (numpy int64 cast)
  const double scale = (double)n / (double)m;
  double wh = (box_xyxy[2] - box_xyxy[0]) * 0.5 * scale;
  double hh = (box_xyxy[3] - box_xyxy[1]) * 0.5 * scale;
  double xc = (box_xyxy[2] + box_xyxy[0]) * 0.5;
  double yc = (box_xyxy[3] + box_xyxy[1]) * 0.5;
  const int64_t bx0 = (int64_t)(xc - wh), bx1 = (int64_t)(xc + wh);
  const int64_t by0 = (int64_t)(yc - hh), by1 = (int64_t)(yc + hh);
  int64_t bw = bx1 - bx0 + 1;  if (bw < 1) bw = 1;
  int64_t bh = by1 - by0 + 1;  if (bh < 1) bh = 1;

  // clip to the image
  int64_t x_0 = bx0 > 0 ? bx0 : 0;
  int64_t x_1 = bx1 + 1 < im_w ? bx1 + 1 : im_w;
  int64_t y_0 = by0 > 0 ? by0 : 0;
  int64_t y_1 = by1 + 1 < im_h ? by1 + 1 : im_h;

  int64_t nc = 0;          // counts written
  int64_t run = 0;         // current run length
  int cur = 0;             // current value (counts start at zeros)
  auto emit = [&](int v, int64_t len) {
    if (len == 0) return;
    if (v == cur) { run += len; return; }
    counts_out[nc++] = run;
    cur = v;
    run = len;
  };

  if (x_1 <= x_0 || y_1 <= y_0) {
    counts_out[0] = (int64_t)im_h * im_w;
    return 1;
  }

  // precomputed pixel-center row tables (y0/y1 indices + fraction) and a
  // column-factored bilinear: per destination column, interpolate the two
  // source columns along y once, then mix by fx — ~3 ops/pixel
  const double sy_scale = (double)n / (double)bh;
  const double sx_scale = (double)n / (double)bw;
  const int64_t nrows = y_1 - y_0;
  std::vector<int64_t> ry0(nrows), ry1(nrows);
  std::vector<double> rfy(nrows);
  for (int64_t y = y_0; y < y_1; ++y) {
    double sy = ((double)(y - by0) + 0.5) * sy_scale - 0.5;
    if (sy < 0) sy = 0;
    if (sy > n - 1) sy = n - 1;
    int64_t i0 = (int64_t)sy;
    ry0[y - y_0] = i0;
    ry1[y - y_0] = i0 + 1 < n ? i0 + 1 : i0;
    rfy[y - y_0] = sy - i0;
  }
  std::vector<double> ca(nrows), cb(nrows);
  const float* P = padded.data();

  emit(0, x_0 * im_h);  // leading all-zero columns
  for (int64_t x = x_0; x < x_1; ++x) {
    double sx = ((double)(x - bx0) + 0.5) * sx_scale - 0.5;
    if (sx < 0) sx = 0;
    if (sx > n - 1) sx = n - 1;
    const int64_t cx0 = (int64_t)sx;
    const int64_t cx1 = cx0 + 1 < n ? cx0 + 1 : cx0;
    const double fx = sx - cx0;
    for (int64_t r = 0; r < nrows; ++r) {
      ca[r] = P[ry0[r] * n + cx0] * (1 - rfy[r]) + P[ry1[r] * n + cx0] * rfy[r];
      cb[r] = P[ry0[r] * n + cx1] * (1 - rfy[r]) + P[ry1[r] * n + cx1] * rfy[r];
    }
    emit(0, y_0);
    for (int64_t r = 0; r < nrows; ++r) {
      const double v = ca[r] * (1 - fx) + cb[r] * fx;
      emit(v > thresh ? 1 : 0, 1);
    }
    emit(0, im_h - y_1);
  }
  emit(0, (im_w - x_1) * im_h);  // trailing all-zero columns
  counts_out[nc++] = run;
  return nc;
}

// -- outer contours: Suzuki-Abe border following + Teh-Chin L1 ----------------
//
// OpenCV's findContours(mask, RETR_EXTERNAL, CHAIN_APPROX_TC89_L1), point for
// point. The mask (nonzero = 1) gets a zero border of one pixel and is
// scanned in raster order; a 0 -> 1 step starts an outer border unless the
// last marked border pixel of the row (lnbd) belongs to an outer border
// already followed (marked 2: inside it). The border is followed as a chain
// of Freeman codes (0 = +x, counter-clockwise with y down), its pixels marked
// -126 where the pixel to their right is background and 2 otherwise; the
// chain is then reduced by the Teh-Chin dominant-point passes with the
// 1-curvature (OpenCV approx.cpp: support regions, non-maxima suppression,
// one-pixel support, then couples of neighbours), including the three places
// where OpenCV 5's rewrite of that last pass differs from the older code
// (maskops.py:trace_contours_plain, the numpy twin, says which). Contours come
// out in OpenCV's order, the last one found first.

namespace {

const int kDx[8] = {1, 1, 0, -1, -1, -1, 0, 1};
const int kDy[8] = {0, -1, -1, -1, 0, 1, 1, 1};
const int kAbsDiff[15] = {1, 2, 3, 4, 3, 2, 1, 0, 1, 2, 3, 4, 3, 2, 1};

// Follow the outer border that starts at flat index i0 of the bordered image
// (row stride `stride`); returns its chain codes, marks its pixels.
std::vector<int8_t> trace_border(std::vector<int8_t>& img, int64_t stride, int64_t i0) {
  const int64_t d8[8] = {1, 1 - stride, -stride, -stride - 1, -1, stride - 1, stride, stride + 1};
  int64_t deltas[16];
  for (int k = 0; k < 16; ++k) deltas[k] = d8[k & 7];
  std::vector<int8_t> codes;
  int s_end = 4, s = 4;
  int64_t i1;
  do {
    s = (s - 1) & 7;
    i1 = i0 + deltas[s];
  } while (img[i1] == 0 && s != s_end);
  if (s == s_end) {  // a single pixel
    img[i0] = -126;
    return codes;
  }
  int64_t i3 = i0, i4 = i0;
  for (;;) {
    s_end = s;
    while (s < 15) {
      i4 = i3 + deltas[++s];
      if (img[i4] != 0) break;
    }
    s &= 7;
    if (static_cast<unsigned>(s - 1) < static_cast<unsigned>(s_end)) {
      img[i3] = -126;
    } else if (img[i3] == 1) {
      img[i3] = 2;
    }
    codes.push_back(static_cast<int8_t>(s));
    if (i4 == i0 && i3 == i1) break;
    i3 = i4;
    s = (s + 4) & 7;
  }
  return codes;
}

struct ChainPoint {
  int x, y, s, k;
  int64_t next;
};

// The Teh-Chin L1 reduction of a closed chain starting at (x0, y0); appends
// the kept points to out as x, y pairs.
void approximate_tc89_l1(const std::vector<int8_t>& codes, int x0, int y0,
                         std::vector<int32_t>& out) {
  const int64_t n = static_cast<int64_t>(codes.size());
  if (n == 0) {
    out.push_back(x0);
    out.push_back(y0);
    return;
  }
  const int64_t nil = -1, head = n + 1;
  std::vector<ChainPoint> a(n + 2, ChainPoint{0, 0, 0, 0, nil});
  int x = x0, y = y0, prev = codes[n - 1];
  int64_t cur = head;
  for (int64_t i = 0; i < n; ++i) {  // pass 0: the 1-curvature of each point
    const int c = codes[i];
    const int s = kAbsDiff[c - prev + 7];
    if (s != 0) {
      a[cur].next = i;
      cur = i;
    }
    a[i].s = s;
    a[i].x = x;
    a[i].y = y;
    x += kDx[c];
    y += kDy[c];
    prev = c;
  }
  a[cur].next = nil;
  auto wrap_lo = [n](int64_t i) { return i < 0 ? i + n : i; };
  auto wrap_hi = [n](int64_t i) { return i >= n ? i - n : i; };
  for (cur = a[head].next; cur != nil; cur = a[cur].next) {  // pass 1: support regions
    const int64_t i = cur;
    int l = 0, d_num = 0, k = 1;
    for (;; ++k) {
      const int64_t i1 = wrap_lo(i - k), i2 = wrap_hi(i + k);
      const int dx = a[i2].x - a[i1].x, dy = a[i2].y - a[i1].y;
      const int lk = dx * dx + dy * dy;
      const int dk_num = (a[i].x - a[i1].x) * dy - (a[i].y - a[i1].y) * dx;
      const float d = static_cast<float>(static_cast<double>(d_num) * lk -
                                         static_cast<double>(dk_num) * l);
      if (k > 1 && (l >= lk || (d_num > 0 && d <= 0) || (d_num < 0 && d >= 0))) break;
      d_num = dk_num;
      l = lk;
    }
    a[i].k = k - 1;
  }
  int64_t prev_cur = head;
  for (cur = a[head].next; cur != nil; cur = a[cur].next) {  // pass 2: non-maxima
    const int k2 = a[cur].k >> 1, s = a[cur].s;
    int j = 1;
    for (; j <= k2; ++j) {
      if (a[wrap_lo(cur - j)].s > s || a[wrap_hi(cur + j)].s > s) break;
    }
    if (j <= k2) {
      a[prev_cur].next = a[cur].next;
      a[cur].s = 0;
    } else {
      prev_cur = cur;
    }
  }
  prev_cur = head;
  for (cur = a[head].next; cur != nil; cur = a[cur].next) {  // pass 3: support of 1
    if (a[cur].k == 1 && (a[cur].s <= a[wrap_lo(cur - 1)].s || a[cur].s <= a[wrap_hi(cur + 1)].s)) {
      a[prev_cur].next = a[cur].next;
      a[cur].s = 0;
    } else {
      prev_cur = cur;
    }
  }
  bool all_survived = false;
  if (a[0].s != 0 && a[n - 1].s != 0) {  // pass 4: a run across the chain's start
    int64_t i1 = 1;
    for (; i1 < n && a[i1].s != 0; ++i1) a[i1 - 1].s = 0;
    if (i1 == n) {
      all_survived = true;
    } else {
      --i1;
      int64_t i2 = n - 2;
      for (; i2 > 0 && a[i2].s != 0; --i2) {
        a[i2].next = nil;
        a[i2 + 1].s = 0;
      }
      ++i2;
      if (i1 == 0 && i2 == n - 1) {  // only two points: the first one also at the end
        a[n] = a[0];
        a[n].next = nil;
        a[n - 1].next = n;
      }
      a[head].next = i1;
    }
  }
  if (!all_survived) {  // pass 4: couples and longer runs of neighbours
    cur = a[head].next;
    int64_t first = cur == 0 ? 0 : head;
    prev_cur = first;
    int count = 1;
    while (cur != nil) {
      const int64_t nx = a[cur].next;
      if (nx == nil || nx - cur != 1) {
        if (count == 2) {
          if (a[prev_cur].s > a[cur].s ||
              (a[prev_cur].s == a[cur].s && a[prev_cur].k <= a[cur].k)) {
            a[prev_cur].next = nx;  // drop the second
            cur = prev_cur;
          } else {
            a[first == prev_cur ? head : first].next = cur;  // drop the first
          }
        } else if (count > 2) {
          a[a[first].next].next = cur;  // keep the run's ends
        }
        first = cur;
        count = 1;
      } else {
        ++count;
      }
      prev_cur = cur;
      cur = a[cur].next;
    }
  }
  for (cur = a[head].next; cur != nil; cur = a[cur].next) {
    out.push_back(a[cur].x);
    out.push_back(a[cur].y);
  }
}

}  // namespace

// mask: h*w uint8 (nonzero = foreground). Writes the contours' x, y pairs
// (int32, contour after contour) into points (room for point_cap pairs) and
// each contour's number of points into sizes (room for size_cap); returns
// the number of contours and sets *n_points. When either buffer is too
// small nothing is written and the caller retries with the returned sizes.
extern "C" int64_t find_external_contours(const uint8_t* mask, int64_t h, int64_t w,
                                          int32_t* points, int64_t point_cap,
                                          int64_t* sizes, int64_t size_cap,
                                          int64_t* n_points) {
  const int64_t stride = w + 2;
  std::vector<int8_t> img((h + 2) * stride, 0);
  for (int64_t y = 0; y < h; ++y)
    for (int64_t x = 0; x < w; ++x) img[(y + 1) * stride + x + 1] = mask[y * w + x] != 0;
  std::vector<std::vector<int32_t>> found;
  for (int64_t y = 1; y <= h; ++y) {
    const int64_t row = y * stride;
    int prev = 0;
    int64_t lnbd = row;
    for (int64_t x = 1; x <= w; ++x) {
      int p = img[row + x];
      if (p == prev) continue;
      if (prev == 0 && p == 1 && img[lnbd] <= 0) {
        std::vector<int8_t> codes = trace_border(img, stride, row + x);
        found.emplace_back();
        approximate_tc89_l1(codes, static_cast<int>(x - 1), static_cast<int>(y - 1), found.back());
        p = img[row + x];
      }
      prev = p;
      if (prev & -2) lnbd = row + x;
    }
  }
  int64_t total = 0;
  for (const auto& c : found) total += static_cast<int64_t>(c.size()) / 2;
  *n_points = total;
  const int64_t n = static_cast<int64_t>(found.size());
  if (n > size_cap || total > point_cap) return n;
  int64_t at = 0;
  for (int64_t i = 0; i < n; ++i) {  // the last contour found first
    const auto& c = found[n - 1 - i];
    sizes[i] = static_cast<int64_t>(c.size()) / 2;
    std::memcpy(points + at, c.data(), c.size() * sizeof(int32_t));
    at += static_cast<int64_t>(c.size());
  }
  return n;
}
