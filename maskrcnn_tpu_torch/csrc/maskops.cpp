// COCO-compatible polygon rasterization for the port's data pipeline.
//
// Copy of polygons_to_mask in the JAX package's csrc/maskops.cpp (which
// maskrcnn_tpu/utils/_maskops_native.py binds): a 5x supersampled scanline
// even-odd fill with the boundary marked, max-pooled back to the coarse
// grid, as COCO's frPoly. The port has no OpenCV (the JAX package's numpy
// fallback calls cv2.fillPoly), so this routine is its only rasterizer.
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

}  // extern "C"
