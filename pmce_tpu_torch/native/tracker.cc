// Multi-object tracking core: IoU cost + Hungarian assignment.
//
// The port's own copy of the JAX package's native/tracker.cc.
//
// Replaces the matching core of the reference's external
// multi-person-tracker (YOLOv3 + SORT; reference main/
// run_demo.py:199-215) with a dependency-free O(n³) Hungarian solver on a
// 1−IoU cost matrix. Driven from Python through ctypes; the motion model
// (constant-velocity prediction) stays in numpy.

#include <algorithm>
#include <cfloat>
#include <cstdint>
#include <vector>

namespace {

float iou(const float* a, const float* b) {
  // boxes are (x, y, w, h)
  const float ax1 = a[0], ay1 = a[1], ax2 = a[0] + a[2], ay2 = a[1] + a[3];
  const float bx1 = b[0], by1 = b[1], bx2 = b[0] + b[2], by2 = b[1] + b[3];
  const float ix = std::max(
      0.0f, std::min(ax2, bx2) - std::max(ax1, bx1));
  const float iy = std::max(
      0.0f, std::min(ay2, by2) - std::max(ay1, by1));
  const float inter = ix * iy;
  const float uni = a[2] * a[3] + b[2] * b[3] - inter;
  return uni <= 0 ? 0.0f : inter / uni;
}

// Hungarian algorithm (Jonker–Volgenant style shortest augmenting paths)
// on a rectangular cost matrix [n x m], n <= m after padding by caller.
void hungarian(const std::vector<float>& cost, int n, int m,
               std::vector<int>& match_row) {
  std::vector<float> u(n + 1, 0), v(m + 1, 0);
  std::vector<int> p(m + 1, 0), way(m + 1, 0);
  for (int i = 1; i <= n; ++i) {
    p[0] = i;
    int j0 = 0;
    std::vector<float> minv(m + 1, FLT_MAX);
    std::vector<char> used(m + 1, 0);
    do {
      used[j0] = 1;
      int i0 = p[j0], j1 = 0;
      float delta = FLT_MAX;
      for (int j = 1; j <= m; ++j) {
        if (used[j]) continue;
        const float cur = cost[(i0 - 1) * m + (j - 1)] - u[i0] - v[j];
        if (cur < minv[j]) { minv[j] = cur; way[j] = j0; }
        if (minv[j] < delta) { delta = minv[j]; j1 = j; }
      }
      for (int j = 0; j <= m; ++j) {
        if (used[j]) { u[p[j]] += delta; v[j] -= delta; }
        else minv[j] -= delta;
      }
      j0 = j1;
    } while (p[j0] != 0);
    do {
      const int j1 = way[j0];
      p[j0] = p[j1];
      j0 = j1;
    } while (j0);
  }
  match_row.assign(n, -1);
  for (int j = 1; j <= m; ++j)
    if (p[j] > 0 && p[j] <= n) match_row[p[j] - 1] = j - 1;
}

}  // namespace

extern "C" {

// tracks: [n_tracks * 4], dets: [n_dets * 4] (x, y, w, h).
// assignment: [n_tracks] int32 out — det index or -1.
// Returns number of matches.
int32_t iou_assign(const float* tracks, int32_t n_tracks,
                   const float* dets, int32_t n_dets,
                   float min_iou, int32_t* assignment) {
  if (n_tracks == 0) return 0;
  const int m = std::max(n_tracks, n_dets);
  // Pad to square with prohibitive cost.
  std::vector<float> cost(n_tracks * m, 2.0f);
  for (int i = 0; i < n_tracks; ++i)
    for (int j = 0; j < n_dets; ++j)
      cost[i * m + j] = 1.0f - iou(tracks + 4 * i, dets + 4 * j);

  std::vector<int> match;
  hungarian(cost, n_tracks, m, match);

  int32_t n_match = 0;
  for (int i = 0; i < n_tracks; ++i) {
    int j = match[i];
    if (j >= 0 && j < n_dets &&
        iou(tracks + 4 * i, dets + 4 * j) >= min_iou) {
      assignment[i] = j;
      ++n_match;
    } else {
      assignment[i] = -1;
    }
  }
  return n_match;
}

}  // extern "C"
