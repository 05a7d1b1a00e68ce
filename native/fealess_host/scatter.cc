// Greedy scattered-feature selection — native host path.
//
// Exact semantics of cup_linemod::QuantizedPyramid::selectScatteredFeatures
// (reference linemod/linemod.cpp:135-164): walk candidates (pre-sorted by
// descending score), keep one iff it is at least `distance` away from every
// kept feature; on exhausting the list, restart with distance-1.  The loop
// is inherently sequential (each decision depends on all prior picks), so it
// runs on the host; this C implementation replaces the reference's C++ and
// the Python fallback (fealess/training.py) for large candidate sets.

#include <cstdint>

extern "C" {

// candidates: (n, 3) int32 rows of (x, y, label), sorted by descending score.
// out: (num_features, 3) int32.  Returns number of features written
// (always num_features when n > 0; 0 when n == 0).
int fealess_select_scattered_features(const int32_t* candidates, int n,
                                      int num_features, float distance,
                                      int32_t* out) {
  if (n <= 0 || num_features <= 0) return 0;
  int kept = 0;
  float distance_sq = distance * distance;
  int i = 0;
  while (kept < num_features) {
    const int32_t* c = candidates + 3 * i;
    bool keep = true;
    for (int j = 0; j < kept && keep; ++j) {
      const int32_t* f = out + 3 * j;
      const int64_t dx = c[0] - f[0];
      const int64_t dy = c[1] - f[1];
      keep = static_cast<float>(dx * dx + dy * dy) >= distance_sq;
    }
    if (keep) {
      out[3 * kept + 0] = c[0];
      out[3 * kept + 1] = c[1];
      out[3 * kept + 2] = c[2];
      ++kept;
    }
    if (++i == n) {
      i = 0;
      distance -= 1.0f;
      distance_sq = distance * distance;
    }
  }
  return kept;
}

}  // extern "C"
