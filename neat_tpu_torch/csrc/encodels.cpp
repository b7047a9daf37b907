// Attraction-field rasterizer: for every pixel, the closest 2D line
// segment (point-to-segment distance) and a 6-channel map
// (port's copy of the JAX package's csrc/encodels.cpp, same arithmetic):
//   [0:2] offset from the pixel to its attraction point, the perpendicular
//         foot clamped to the segment (x, y order), so
//         sqrt(lmap0^2+lmap1^2) is the point-to-segment distance
//   [2:4] offset to the segment's first endpoint
//   [4:6] offset to the segment's second endpoint
// plus the closest-line index per pixel. The distance gate is applied in
// Python (neat_tpu_torch/data/encodels.py).
//
// Host code, run once per image when a scene is packed. O(N_lines * H * W),
// parallel over rows with OpenMP when available. Built by
// neat_tpu_torch/data/encodels.py with -ffp-contract=off: no product is
// fused into a multiply-add, so every value rounds as the numpy version's
// elementwise operations do and the two agree bit for bit.

#include <cmath>
#include <cstdint>
#include <limits>

extern "C" {

void encodels(const float* lines,  // (n_lines, 4): x1 y1 x2 y2
              int n_lines,
              int height,
              int width,
              float* lmap,     // out: (6, height, width)
              int32_t* labels  // out: (height, width)
) {
  const long hw = (long)height * width;
  // a view with zero detected lines must not read lines[0..3] (the
  // Python-level assert guarding this is stripped under -O): zero-fill
  // the maps and return
  if (n_lines <= 0) {
    for (long k = 0; k < 6 * hw; ++k) lmap[k] = 0.f;
    for (long k = 0; k < hw; ++k) labels[k] = 0;
    return;
  }
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
  for (int py = 0; py < height; ++py) {
    for (int px = 0; px < width; ++px) {
      const float bx = (float)px;
      const float by = (float)py;
      float best_d2 = std::numeric_limits<float>::max();
      int best_i = 0;
      float best_t = 0.f;  // clamped projection parameter of best line
      for (int i = 0; i < n_lines; ++i) {
        const float x1 = lines[4 * i + 0];
        const float y1 = lines[4 * i + 1];
        const float x2 = lines[4 * i + 2];
        const float y2 = lines[4 * i + 3];
        const float dx = x2 - x1;
        const float dy = y2 - y1;
        const float len2 = dx * dx + dy * dy;
        const float t =
            ((bx - x1) * dx + (by - y1) * dy) / (len2 > 1e-12f ? len2 : 1e-12f);
        const float tc = t < 0.f ? 0.f : (t > 1.f ? 1.f : t);
        const float qx = x1 + tc * dx;
        const float qy = y1 + tc * dy;
        const float d2 = (bx - qx) * (bx - qx) + (by - qy) * (by - qy);
        if (d2 < best_d2) {
          best_d2 = d2;
          best_i = i;
          best_t = tc;
        }
      }
      const float x1 = lines[4 * best_i + 0];
      const float y1 = lines[4 * best_i + 1];
      const float x2 = lines[4 * best_i + 2];
      const float y2 = lines[4 * best_i + 3];
      const float fx = x1 + best_t * (x2 - x1);  // attraction point
      const float fy = y1 + best_t * (y2 - y1);
      const long p = (long)py * width + px;
      lmap[0 * hw + p] = fx - bx;
      lmap[1 * hw + p] = fy - by;
      lmap[2 * hw + p] = x1 - bx;
      lmap[3 * hw + p] = y1 - by;
      lmap[4 * hw + p] = x2 - bx;
      lmap[5 * hw + p] = y2 - by;
      labels[p] = best_i;
    }
  }
}

}  // extern "C"
