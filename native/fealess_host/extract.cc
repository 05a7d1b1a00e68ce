// Full per-view template extraction — native host path.
//
// One GIL-free call per (view, level, modality) replacing the numpy
// pipeline in fealess/training.py (bit-identical, tested there):
// mask erosion, candidate collection in raster order, stable descending
// score sort, and the greedy scattered selection
// (ColorGradientPyramid::extractTemplate linemod.cpp:461-513,
// DepthNormalPyramid::extractTemplate linemod.cpp:747-825).  The
// quantized maps come from the device front-end; only the inherently
// sequential selection runs here, so training views fan out across host
// threads without GIL contention.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {
int fealess_select_scattered_features(const int32_t* candidates, int n,
                                      int num_features, float distance,
                                      int32_t* out);
void fealess_chamfer_chessboard(const uint8_t* nonzero, int h, int w,
                                float* out);
}

namespace {

// 3x3 binary erosion, BORDER_REPLICATE (cv::erode default kernel;
// reference linemod.cpp:466/751) — matches training._erode3_np.
void erode3(const uint8_t* src, int h, int w, int iterations,
            std::vector<uint8_t>* dst) {
  std::vector<uint8_t> cur(src, src + h * w);
  std::vector<uint8_t> next(h * w);
  for (int it = 0; it < iterations; ++it) {
    for (int r = 0; r < h; ++r) {
      const int r0 = r > 0 ? r - 1 : 0;
      const int r1 = r + 1 < h ? r + 1 : h - 1;
      for (int c = 0; c < w; ++c) {
        const int c0 = c > 0 ? c - 1 : 0;
        const int c1 = c + 1 < w ? c + 1 : w - 1;
        uint8_t v = 1;
        for (int rr : {r0, r, r1})
          for (int cc : {c0, c, c1}) v &= cur[rr * w + cc] ? 1 : 0;
        next[r * w + c] = v;
      }
    }
    cur.swap(next);
  }
  dst->swap(cur);
}

// 1<<k -> k for one-hot bitmasks (training._LABEL_LUT).
inline int label_of(uint8_t bits) {
  switch (bits) {
    case 1: return 0;
    case 2: return 1;
    case 4: return 2;
    case 8: return 3;
    case 16: return 4;
    case 32: return 5;
    case 64: return 6;
    case 128: return 7;
    default: return -1;
  }
}

struct Cand {
  int32_t x, y, label;
  float score;
};

// stable sort by descending score (std::stable_sort with score >,
// linemod.hpp:98-101 == np.argsort(-scores, kind="stable")).
void sort_desc(std::vector<Cand>* cands) {
  std::stable_sort(cands->begin(), cands->end(),
                   [](const Cand& a, const Cand& b) {
                     return a.score > b.score;
                   });
}

int run_greedy(const std::vector<Cand>& cands, int nf, float distance,
               int32_t* out) {
  std::vector<int32_t> rows(cands.size() * 3);
  for (size_t i = 0; i < cands.size(); ++i) {
    rows[3 * i + 0] = cands[i].x;
    rows[3 * i + 1] = cands[i].y;
    rows[3 * i + 2] = cands[i].label;
  }
  return fealess_select_scattered_features(
      rows.data(), static_cast<int>(cands.size()), nf, distance, out);
}

}  // namespace

extern "C" {

// ColorGradient extraction: returns nf on success, 0 when fewer than nf
// candidates exist (the Python path returns None there).  mask may be
// NULL (no-mask variant).  bits/mag/mask are (h, w) row-major.
int fealess_extract_gradient_template(const uint8_t* bits, const float* mag,
                                      const uint8_t* mask, int h, int w,
                                      int nf, float strong_threshold,
                                      int32_t* out) {
  std::vector<uint8_t> local(h * w, 1);
  if (mask) {
    std::vector<uint8_t> eroded;
    erode3(mask, h, w, 1, &eroded);
    for (int i = 0; i < h * w; ++i)
      local[i] = (mask[i] && !eroded[i]) ? 1 : 0;
  }
  const float thr_sq = strong_threshold * strong_threshold;
  std::vector<Cand> cands;
  cands.reserve(1024);
  for (int r = 0; r < h; ++r)
    for (int c = 0; c < w; ++c) {
      const int i = r * w + c;
      if (local[i] && bits[i] > 0 && mag[i] > thr_sq)
        cands.push_back({c, r, label_of(bits[i]), mag[i]});
    }
  if (static_cast<int>(cands.size()) < nf) return 0;
  sort_desc(&cands);
  const float distance =
      static_cast<float>(static_cast<int>(cands.size()) / nf + 1);
  return run_greedy(cands, nf, distance, out);
}

// DepthNormal extraction: per-label chessboard distance transforms,
// extract_threshold gate, per-label count balancing, greedy selection
// with sqrt(area)/sqrt(nf)+1.5 spacing.  Returns nf or 0.
int fealess_extract_normal_template(const uint8_t* bits,
                                    const uint8_t* mask, int h, int w,
                                    int nf, int extract_threshold,
                                    int32_t* out) {
  std::vector<uint8_t> local;
  if (mask) {
    erode3(mask, h, w, 2, &local);
  } else {
    local.assign(h * w, 1);
  }
  // per-label chamfer over (local & bit) source sets
  std::vector<float> dist(8 * h * w);
  std::vector<uint8_t> has(h * w);
  for (int l = 0; l < 8; ++l) {
    const uint8_t bit = static_cast<uint8_t>(1 << l);
    for (int i = 0; i < h * w; ++i)
      has[i] = (local[i] && (bits[i] & bit)) ? 1 : 0;
    fealess_chamfer_chessboard(has.data(), h, w, dist.data() + l * h * w);
  }
  std::vector<Cand> cands;
  cands.reserve(4096);
  int64_t counts[8] = {0};
  for (int r = 0; r < h; ++r)
    for (int c = 0; c < w; ++c) {
      const int i = r * w + c;
      if (!local[i] || bits[i] == 0 || bits[i] == 255) continue;
      const int l = label_of(bits[i]);
      if (l < 0) continue;
      const float d = dist[l * h * w + i];
      if (d >= static_cast<float>(extract_threshold)) {
        cands.push_back({c, r, l, d});
        ++counts[l];
      }
    }
  if (static_cast<int>(cands.size()) < nf) return 0;
  for (auto& cd : cands)
    cd.score = cd.score / static_cast<float>(counts[cd.label]);
  sort_desc(&cands);
  double area = 0.0;
  if (mask) {
    for (int i = 0; i < h * w; ++i) area += local[i] ? 1.0 : 0.0;
  } else {
    area = static_cast<double>(h) * w;
  }
  const float distance = static_cast<float>(
      std::sqrt(area) / std::sqrt(static_cast<double>(nf)) + 1.5);
  return run_greedy(cands, nf, distance, out);
}

}  // extern "C"
