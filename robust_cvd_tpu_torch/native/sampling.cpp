// Native helpers for constraint building — the only genuinely sequential
// parts of the pipeline (greedy corner-strength-ordered sampling with disk
// suppression, reference lib/FlowConstraints.cpp:352-397, and disk stamping
// for static-flag pruning, reference .cpp:662-748).
//
// Everything dense/parallel (the corner response) runs on the GPU; these
// loops run once per clip on the host and are O(candidates). A copy of
// robust_cvd_tpu/native/sampling.cpp, so both packages pick the same
// constraints from the same inputs.
//
// Built as a plain shared library, loaded via ctypes.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

inline void stamp_disk(
    std::vector<uint8_t>& invalid, int32_t x, int32_t y, int32_t w, int32_t h,
    int32_t radius, int64_t r2) {
  const int32_t mx0 = x - radius < 0 ? 0 : x - radius;
  const int32_t mx1 = x + radius >= w ? w - 1 : x + radius;
  const int32_t my0 = y - radius < 0 ? 0 : y - radius;
  const int32_t my1 = y + radius >= h ? h - 1 : y + radius;
  for (int32_t my = my0; my <= my1; ++my) {
    const int64_t dy = my - y;
    uint8_t* row = invalid.data() + static_cast<size_t>(my) * w;
    for (int32_t mx = mx0; mx <= mx1; ++mx) {
      const int64_t dx = mx - x;
      if (dx * dx + dy * dy <= r2) row[mx] = 1;
    }
  }
}

// Stable descending order of float keys via 4-pass LSD counting radix sort
// (exactly np.argsort(-keys, kind="stable"): ties keep original order).
// Faster than std::stable_sort on ~1e5 candidates.
inline void radix_order_desc(
    const float* keys, int64_t n, std::vector<uint32_t>& order) {
  std::vector<uint32_t> k(n), tmp_k(n), tmp_o(n);
  order.resize(n);
  for (int64_t i = 0; i < n; ++i) {
    uint32_t b;
    std::memcpy(&b, keys + i, 4);
    // np.argsort semantics the transform must reproduce exactly:
    //  - -0.0 compares equal to +0.0 (tie -> original order), so
    //    canonicalize the sign of zero before the bit trick;
    //  - NaN sorts LAST in numpy's ascending sort of -keys, i.e. last
    //    in this descending order (any NaN payload/sign).
    if (b == 0x80000000u) b = 0;  // -0.0 == +0.0
    const bool is_nan =
        (b & 0x7F800000u) == 0x7F800000u && (b & 0x007FFFFFu) != 0;
    // monotone float->uint transform, then invert for descending
    const uint32_t asc = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
    k[i] = is_nan ? 0xFFFFFFFFu : ~asc;
    order[i] = static_cast<uint32_t>(i);
  }
  for (int shift = 0; shift < 32; shift += 8) {
    uint32_t count[257] = {0};
    for (int64_t i = 0; i < n; ++i) ++count[((k[i] >> shift) & 0xFF) + 1];
    for (int b = 0; b < 256; ++b) count[b + 1] += count[b];
    for (int64_t i = 0; i < n; ++i) {
      const uint32_t pos = count[(k[i] >> shift) & 0xFF]++;
      tmp_k[pos] = k[i];
      tmp_o[pos] = order[i];
    }
    k.swap(tmp_k);
    order.swap(tmp_o);
  }
}

}  // namespace

extern "C" {

// Greedy selection of candidates (already sorted by descending corner
// strength). Marks selected[i] = 1 for kept candidates; suppresses any later
// candidate whose reference pixel falls within a disk of `radius` around a
// kept one.
void greedy_sample(
    const int32_t* xs,
    const int32_t* ys,
    int64_t n,
    int32_t w,
    int32_t h,
    int32_t radius,
    uint8_t* selected) {
  std::vector<uint8_t> invalid(static_cast<size_t>(w) * h, 0);
  const int64_t r2 = static_cast<int64_t>(radius) * radius;

  for (int64_t i = 0; i < n; ++i) {
    const int32_t x = xs[i];
    const int32_t y = ys[i];
    if (x < 0 || x >= w || y < 0 || y >= h) {
      selected[i] = 0;
      continue;
    }
    if (invalid[static_cast<size_t>(y) * w + x]) {
      selected[i] = 0;
      continue;
    }
    selected[i] = 1;

    const int32_t mx0 = x - radius < 0 ? 0 : x - radius;
    const int32_t mx1 = x + radius >= w ? w - 1 : x + radius;
    const int32_t my0 = y - radius < 0 ? 0 : y - radius;
    const int32_t my1 = y + radius >= h ? h - 1 : y + radius;
    for (int32_t my = my0; my <= my1; ++my) {
      const int64_t dy = my - y;
      uint8_t* row = invalid.data() + static_cast<size_t>(my) * w;
      for (int32_t mx = mx0; mx <= mx1; ++mx) {
        const int64_t dx = mx - x;
        if (dx * dx + dy * dy <= r2) {
          row[mx] = 1;
        }
      }
    }
  }
}

// Stamp disks of `radius` at the given points into mask (h x w, row-major).
void stamp_disks(
    const int32_t* xs,
    const int32_t* ys,
    int64_t n,
    int32_t w,
    int32_t h,
    int32_t radius,
    uint8_t* mask) {
  const int64_t r2 = static_cast<int64_t>(radius) * radius;
  for (int64_t i = 0; i < n; ++i) {
    const int32_t x = xs[i];
    const int32_t y = ys[i];
    const int32_t mx0 = x - radius < 0 ? 0 : x - radius;
    const int32_t mx1 = x + radius >= w ? w - 1 : x + radius;
    const int32_t my0 = y - radius < 0 ? 0 : y - radius;
    const int32_t my1 = y + radius >= h ? h - 1 : y + radius;
    for (int32_t my = my0; my <= my1; ++my) {
      const int64_t dy = my - y;
      uint8_t* row = mask + static_cast<size_t>(my) * w;
      for (int32_t mx = mx0; mx <= mx1; ++mx) {
        const int64_t dx = mx - x;
        if (dx * dx + dy * dy <= r2) {
          row[mx] = 1;
        }
      }
    }
  }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Fused per-pair candidate selection: mask/bounds filtering + stable
// descending-corner sort + greedy disk suppression in ONE host call
// (reference lib/FlowConstraints.cpp:401-465), in place of a numpy
// nonzero -> gather -> argsort -> greedy chain whose sort dominates.
// ---------------------------------------------------------------------------

extern "C" {

// Returns the number of kept constraints (<= max_out).
// corner: (h, w) f32; flow: (h, w, 2) f32 pixel displacements;
// mask: (h, w) u8 0/1. Outputs: out_xy (max_out, 2) kept source pixels
// (x, y int32); out_f (max_out, 2) flow-target coordinates (fx, fy f32).
int64_t build_pair_candidates(
    const float* corner,
    const float* flow,
    const uint8_t* mask,
    int32_t w,
    int32_t h,
    int32_t radius,
    int32_t* out_xy,
    float* out_f,
    int64_t max_out) {
  struct Cand {
    int32_t x, y;
    float fx, fy;
  };
  std::vector<Cand> cands;
  std::vector<float> keys;
  cands.reserve(4096);
  keys.reserve(4096);
  for (int32_t y = 0; y < h; ++y) {
    const uint8_t* mrow = mask + static_cast<size_t>(y) * w;
    const float* frow = flow + static_cast<size_t>(y) * w * 2;
    const float* crow = corner + static_cast<size_t>(y) * w;
    for (int32_t x = 0; x < w; ++x) {
      if (!mrow[x]) continue;
      const float fx = x + frow[2 * x];
      const float fy = y + frow[2 * x + 1];
      if (!std::isfinite(fx) || !std::isfinite(fy)) continue;
      // match numpy's (f + 0.5).astype(int32): truncation toward zero
      const int32_t ix = static_cast<int32_t>(fx + 0.5f);
      const int32_t iy = static_cast<int32_t>(fy + 0.5f);
      if (ix < 0 || ix >= w || iy < 0 || iy >= h) continue;
      cands.push_back({x, y, fx, fy});
      keys.push_back(crow[x]);
    }
  }
  // np.argsort(-corner, kind="stable") equivalence: descending, ties in
  // original (row-major) order.
  std::vector<uint32_t> order;
  radix_order_desc(keys.data(), static_cast<int64_t>(keys.size()), order);

  std::vector<uint8_t> invalid(static_cast<size_t>(w) * h, 0);
  const int64_t r2 = static_cast<int64_t>(radius) * radius;
  int64_t n_out = 0;
  for (const uint32_t oi : order) {
    if (n_out >= max_out) break;
    const Cand& cd = cands[oi];
    if (invalid[static_cast<size_t>(cd.y) * w + cd.x]) continue;
    out_xy[2 * n_out] = cd.x;
    out_xy[2 * n_out + 1] = cd.y;
    out_f[2 * n_out] = cd.fx;
    out_f[2 * n_out + 1] = cd.fy;
    ++n_out;
    stamp_disk(invalid, cd.x, cd.y, w, h, radius, r2);
  }
  return n_out;
}

// Triplet variant: candidates pass BOTH the backward (center->prev) and
// forward (center->next) masks with both flow targets in-bounds
// (reference lib/FlowConstraints.cpp:467-550).
int64_t build_triplet_candidates(
    const float* corner,
    const float* flow10,
    const uint8_t* mask10,
    const float* flow12,
    const uint8_t* mask12,
    int32_t w,
    int32_t h,
    int32_t radius,
    int32_t* out_xy,
    float* out_f0,
    float* out_f2,
    int64_t max_out) {
  struct Cand {
    int32_t x, y;
    float fx0, fy0, fx2, fy2;
  };
  std::vector<Cand> cands;
  std::vector<float> keys;
  cands.reserve(4096);
  keys.reserve(4096);
  for (int32_t y = 0; y < h; ++y) {
    const uint8_t* m0 = mask10 + static_cast<size_t>(y) * w;
    const uint8_t* m2 = mask12 + static_cast<size_t>(y) * w;
    const float* f0 = flow10 + static_cast<size_t>(y) * w * 2;
    const float* f2 = flow12 + static_cast<size_t>(y) * w * 2;
    const float* crow = corner + static_cast<size_t>(y) * w;
    for (int32_t x = 0; x < w; ++x) {
      if (!m0[x] || !m2[x]) continue;
      const float fx0 = x + f0[2 * x];
      const float fy0 = y + f0[2 * x + 1];
      const float fx2 = x + f2[2 * x];
      const float fy2 = y + f2[2 * x + 1];
      if (!std::isfinite(fx0) || !std::isfinite(fy0) ||
          !std::isfinite(fx2) || !std::isfinite(fy2)) {
        continue;
      }
      const int32_t ix0 = static_cast<int32_t>(fx0 + 0.5f);
      const int32_t iy0 = static_cast<int32_t>(fy0 + 0.5f);
      const int32_t ix2 = static_cast<int32_t>(fx2 + 0.5f);
      const int32_t iy2 = static_cast<int32_t>(fy2 + 0.5f);
      if (ix0 < 0 || ix0 >= w || iy0 < 0 || iy0 >= h) continue;
      if (ix2 < 0 || ix2 >= w || iy2 < 0 || iy2 >= h) continue;
      cands.push_back({x, y, fx0, fy0, fx2, fy2});
      keys.push_back(crow[x]);
    }
  }
  std::vector<uint32_t> order;
  radix_order_desc(keys.data(), static_cast<int64_t>(keys.size()), order);

  std::vector<uint8_t> invalid(static_cast<size_t>(w) * h, 0);
  const int64_t r2 = static_cast<int64_t>(radius) * radius;
  int64_t n_out = 0;
  for (const uint32_t oi : order) {
    if (n_out >= max_out) break;
    const Cand& cd = cands[oi];
    if (invalid[static_cast<size_t>(cd.y) * w + cd.x]) continue;
    out_xy[2 * n_out] = cd.x;
    out_xy[2 * n_out + 1] = cd.y;
    out_f0[2 * n_out] = cd.fx0;
    out_f0[2 * n_out + 1] = cd.fy0;
    out_f2[2 * n_out] = cd.fx2;
    out_f2[2 * n_out + 1] = cd.fy2;
    ++n_out;
    stamp_disk(invalid, cd.x, cd.y, w, h, radius, r2);
  }
  return n_out;
}

}  // extern "C"
