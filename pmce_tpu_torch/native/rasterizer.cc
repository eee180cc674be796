// Software z-buffer triangle rasterizer for the demo mesh overlay.
//
// The port's own copy of the JAX package's native/rasterizer.cc.
//
// Replaces the reference's pyrender/OSMesa OpenGL renderer
// (reference demo/renderer.py:37-118) with a dependency-free C++
// rasterizer: weak-perspective projected vertices, barycentric coverage,
// z-buffered Lambertian shading composited over the input frame.
//
// Cost model: a CPU rasterizer pays per scanned pixel, so pathological
// input (a broken camera fit projecting screen-filling triangles) would
// degrade to O(n_faces * H * W) — ~1e9 pixel tests per 720p frame for the
// 13,776-face SMPL mesh.  Two guards bound the worst case to O(H * W):
//   * max_tri_px  — skip any triangle whose frame-clipped bbox exceeds
//     this many pixels.  A sane mesh spreads its faces over the subject,
//     so even a frame-filling person keeps individual triangles tiny;
//     only degenerate fits produce frame-scale single triangles.
//   * budget_px   — cumulative clipped-bbox budget for the whole mesh;
//     once exhausted, remaining faces are dropped.  Normal overdraw
//     (front + back surfaces, bbox slop) is ~4x the covered area, so a
//     generous budget never triggers on real fits.
// Both guards use the *clipped bbox* area so the C++ kernel and the numpy
// fallback (demo/renderer.py) make bit-identical skip decisions.
//
// Exposed via a C ABI and driven from Python through ctypes.

#include <algorithm>
#include <cmath>
#include <cstdint>

extern "C" {

// verts: [n_verts * 3] — x, y in pixels, z = depth (smaller = closer).
// faces: [n_faces * 3] vertex indices.
// image: [h * w * 3] uint8, composited in place.
// depth: [h * w] float workspace, caller-initialized to +inf.
// color: [3] base RGB in 0..255.  alpha: overlay opacity 0..1.
// max_tri_px: skip triangles whose clipped bbox exceeds this many pixels
//   (<= 0 disables the guard).
// budget_px: stop rasterizing once cumulative clipped-bbox area exceeds
//   this (<= 0 disables).
// stats (nullable): [2] int32 out — faces skipped by the per-triangle
//   guard, faces dropped by the budget.
void rasterize_mesh(const float* verts, int n_verts,
                    const int32_t* faces, int n_faces,
                    uint8_t* image, float* depth,
                    int h, int w,
                    const float* color, float alpha,
                    float max_tri_px, float budget_px,
                    int32_t* stats) {
  // Fixed headlight direction (towards -z, slightly from above-left).
  const float lx = -0.25f, ly = -0.35f, lz = -0.90f;
  const float lnorm = std::sqrt(lx * lx + ly * ly + lz * lz);
  const float ldx = lx / lnorm, ldy = ly / lnorm, ldz = lz / lnorm;

  int32_t n_skip_area = 0, n_skip_budget = 0;
  double scanned = 0.0;

  for (int f = 0; f < n_faces; ++f) {
    const int32_t i0 = faces[3 * f + 0];
    const int32_t i1 = faces[3 * f + 1];
    const int32_t i2 = faces[3 * f + 2];
    if (i0 >= n_verts || i1 >= n_verts || i2 >= n_verts) continue;

    const float x0 = verts[3 * i0], y0 = verts[3 * i0 + 1],
                z0 = verts[3 * i0 + 2];
    const float x1 = verts[3 * i1], y1 = verts[3 * i1 + 1],
                z1 = verts[3 * i1 + 2];
    const float x2 = verts[3 * i2], y2 = verts[3 * i2 + 1],
                z2 = verts[3 * i2 + 2];

    const int xmin = std::max(0, (int)std::floor(std::min({x0, x1, x2})));
    const int xmax = std::min(w - 1, (int)std::ceil(std::max({x0, x1, x2})));
    const int ymin = std::max(0, (int)std::floor(std::min({y0, y1, y2})));
    const int ymax = std::min(h - 1, (int)std::ceil(std::max({y0, y1, y2})));
    if (xmin > xmax || ymin > ymax) continue;

    const double bbox_px = (double)(xmax - xmin + 1) * (ymax - ymin + 1);
    if (max_tri_px > 0.0f && bbox_px > (double)max_tri_px) {
      ++n_skip_area;
      continue;
    }
    if (budget_px > 0.0f && scanned + bbox_px > (double)budget_px) {
      ++n_skip_budget;
      continue;  // keep scanning: later smaller faces may still fit
    }
    scanned += bbox_px;

    const float denom = (y1 - y2) * (x0 - x2) + (x2 - x1) * (y0 - y2);
    if (std::fabs(denom) < 1e-12f) continue;
    const float inv_d = 1.0f / denom;

    // Screen-space face normal for shading + backface-agnostic coverage.
    const float ax = x1 - x0, ay = y1 - y0, az = z1 - z0;
    const float bx = x2 - x0, by = y2 - y0, bz = z2 - z0;
    float nx = ay * bz - az * by;
    float ny = az * bx - ax * bz;
    float nz = ax * by - ay * bx;
    const float nn = std::sqrt(nx * nx + ny * ny + nz * nz) + 1e-12f;
    nx /= nn; ny /= nn; nz /= nn;
    float lambert = nx * ldx + ny * ldy + nz * ldz;
    if (lambert < 0) lambert = -lambert;  // double-sided
    const float shade = 0.35f + 0.65f * lambert;
    const float lit[3] = {
        std::min(255.0f, std::max(0.0f, color[0] * shade)),
        std::min(255.0f, std::max(0.0f, color[1] * shade)),
        std::min(255.0f, std::max(0.0f, color[2] * shade))};

    // Barycentric weights are affine in (px, py): evaluate at the bbox
    // origin and step with per-axis deltas — 3 adds per pixel instead of
    // 6 multiply-adds.
    const float dw0dx = (y1 - y2) * inv_d, dw0dy = (x2 - x1) * inv_d;
    const float dw1dx = (y2 - y0) * inv_d, dw1dy = (x0 - x2) * inv_d;
    const float fx0 = xmin + 0.5f, fy0 = ymin + 0.5f;
    float w0row = ((y1 - y2) * (fx0 - x2) + (x2 - x1) * (fy0 - y2)) * inv_d;
    float w1row = ((y2 - y0) * (fx0 - x2) + (x0 - x2) * (fy0 - y2)) * inv_d;

    for (int py = ymin; py <= ymax;
         ++py, w0row += dw0dy, w1row += dw1dy) {
      float w0 = w0row, w1 = w1row;
      int idx = py * w + xmin;
      for (int px = xmin; px <= xmax;
           ++px, w0 += dw0dx, w1 += dw1dx, ++idx) {
        const float w2 = 1.0f - w0 - w1;
        if (w0 < 0 || w1 < 0 || w2 < 0) continue;
        const float z = w0 * z0 + w1 * z1 + w2 * z2;
        if (z >= depth[idx]) continue;
        depth[idx] = z;
        for (int c = 0; c < 3; ++c) {
          const float base = image[3 * idx + c];
          image[3 * idx + c] =
              (uint8_t)((1.0f - alpha) * base + alpha * lit[c]);
        }
      }
    }
  }
  if (stats) {
    stats[0] = n_skip_area;
    stats[1] = n_skip_budget;
  }
}

}  // extern "C"
