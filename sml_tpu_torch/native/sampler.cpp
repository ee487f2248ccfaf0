// Native data-path kernels for sml_tpu (host side).
//
// The reference's offline test-set builder is a per-interaction Python loop
// doing oversample + np.setdiff1d against the user's history
// (reference data/dataset2.py:356-414) — minutes of wall clock for
// real datasets. This library provides the same contract ~100x faster:
//
//   * build_eval_rows: for each (user, pos) interaction emit
//     [user, pos, neg_1..neg_k], negatives drawn uniformly from the seen
//     catalog, excluding the user's full history, distinct within the row.
//   * sample_negatives: batched one-negative-per-row rejection sampling
//     (host-side analogue of the on-device sampler; used by tooling).
//
// Exposed through a plain C ABI for ctypes (no pybind11 in this image).
// Ids must fit in int32 range per side (50M users / 5M items ok).

#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <vector>

namespace {

// SplitMix64 — seeding and per-row streams.
static inline uint64_t splitmix64(uint64_t &x) {
  uint64_t z = (x += 0x9E3779B97F4A7C15ULL);
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
  return z ^ (z >> 31);
}

// Open-addressing hash set of uint64 keys (user<<32 | item).
// Fixed capacity, power of two, linear probing. EMPTY = ~0ull.
class PairSet {
 public:
  explicit PairSet(size_t n_keys) {
    size_t cap = 16;
    while (cap < n_keys * 2) cap <<= 1;
    mask_ = cap - 1;
    slots_.assign(cap, kEmpty);
  }
  static inline uint64_t mix(uint64_t k) {
    k ^= k >> 33;
    k *= 0xFF51AFD7ED558CCDULL;
    k ^= k >> 33;
    return k;
  }
  void insert(uint64_t key) {
    size_t i = mix(key) & mask_;
    while (slots_[i] != kEmpty) {
      if (slots_[i] == key) return;
      i = (i + 1) & mask_;
    }
    slots_[i] = key;
  }
  bool contains(uint64_t key) const {
    size_t i = mix(key) & mask_;
    while (slots_[i] != kEmpty) {
      if (slots_[i] == key) return true;
      i = (i + 1) & mask_;
    }
    return false;
  }

 private:
  static constexpr uint64_t kEmpty = ~0ULL;
  std::vector<uint64_t> slots_;
  size_t mask_ = 0;
};

static inline uint64_t pair_key(int64_t u, int64_t i) {
  return (static_cast<uint64_t>(static_cast<uint32_t>(u)) << 32) |
         static_cast<uint32_t>(i);
}

}  // namespace

extern "C" {

// Returns 0 on success, -1 if a row could not be filled (catalog too small
// after exclusions — caller should treat as an input error).
int sml_build_eval_rows(const int64_t *users, const int64_t *items,
                        int64_t n_inter, const int64_t *hist_users,
                        const int64_t *hist_items, int64_t n_hist,
                        const int64_t *catalog, int64_t n_catalog,
                        int64_t neg_num, uint64_t seed, int64_t *out) {
  PairSet hist(static_cast<size_t>(n_hist) + 1);
  for (int64_t k = 0; k < n_hist; ++k)
    hist.insert(pair_key(hist_users[k], hist_items[k]));

  const int64_t width = 2 + neg_num;
  for (int64_t r = 0; r < n_inter; ++r) {
    const int64_t u = users[r];
    out[r * width + 0] = u;
    out[r * width + 1] = items[r];

    PairSet row_seen(static_cast<size_t>(neg_num) + 1);
    uint64_t rng = seed + 0x9E3779B97F4A7C15ULL * static_cast<uint64_t>(r + 1);
    int64_t filled = 0;
    // bounded attempts: E[draws] ~ neg_num / P(valid); cap generously.
    int64_t budget = 64 * (neg_num + 16);
    while (filled < neg_num && budget-- > 0) {
      const int64_t cand =
          catalog[splitmix64(rng) % static_cast<uint64_t>(n_catalog)];
      const uint64_t ck = pair_key(u, cand);
      if (hist.contains(ck)) continue;
      // distinct-within-row (reference uses np.unique, dataset2.py:396)
      const uint64_t rk = pair_key(0, cand) ^ 0xABCDEF1234567890ULL;
      if (row_seen.contains(rk)) continue;
      row_seen.insert(rk);
      out[r * width + 2 + filled] = cand;
      ++filled;
    }
    if (filled < neg_num) return -1;
  }
  return 0;
}

// One negative per row; tries bounded like the on-device sampler. The last
// draw is kept if all collide (statistical guarantee, SURVEY.md §7).
int sml_sample_negatives(const int64_t *users, int64_t n,
                         const int64_t *hist_users, const int64_t *hist_items,
                         int64_t n_hist, const int64_t *pool, int64_t n_pool,
                         int64_t tries, uint64_t seed, int64_t *out) {
  PairSet hist(static_cast<size_t>(n_hist) + 1);
  for (int64_t k = 0; k < n_hist; ++k)
    hist.insert(pair_key(hist_users[k], hist_items[k]));

  for (int64_t r = 0; r < n; ++r) {
    uint64_t rng = seed + 0x9E3779B97F4A7C15ULL * static_cast<uint64_t>(r + 1);
    int64_t pick = pool[splitmix64(rng) % static_cast<uint64_t>(n_pool)];
    for (int64_t t = 0; t < tries; ++t) {
      const int64_t cand =
          pool[splitmix64(rng) % static_cast<uint64_t>(n_pool)];
      pick = cand;
      if (!hist.contains(pair_key(users[r], cand))) break;
    }
    out[r] = pick;
  }
  return 0;
}


// ---------------------------------------------------------------------------
// CSV log parsing (ingest fast path; replaces np.genfromtxt, which parses
// the reference-style raw logs ~50x slower).
// ---------------------------------------------------------------------------

// Count data lines (non-empty after skipping skip_rows header lines).
int64_t sml_count_csv_rows(const char *buf, int64_t len, int64_t skip_rows) {
  int64_t rows = 0, line = 0;
  int64_t start = 0;
  for (int64_t p = 0; p <= len; ++p) {
    if (p == len || buf[p] == '\n') {
      int64_t end = p;
      if (end > start && buf[end - 1] == '\r') --end;
      if (end > start && line >= skip_rows && buf[start] != '#') ++rows;
      ++line;
      start = p + 1;
    }
  }
  return rows;
}

// Parse three columns (user, item, timestamp) out of a delimited log.
// Returns the number of rows written, or -(1 + line_index) on a malformed
// line (missing column / unparsable number).
int64_t sml_parse_csv_log(const char *buf, int64_t len, int32_t user_col,
                          int32_t item_col, int32_t time_col, char delim,
                          int64_t skip_rows, int64_t *users, int64_t *items,
                          double *times) {
  const int32_t max_col =
      user_col > item_col ? (user_col > time_col ? user_col : time_col)
                          : (item_col > time_col ? item_col : time_col);
  int64_t rows = 0, line = 0;
  int64_t start = 0;
  for (int64_t p = 0; p <= len; ++p) {
    if (p != len && buf[p] != '\n') continue;
    int64_t end = p;
    if (end > start && buf[end - 1] == '\r') --end;
    if (end > start && line >= skip_rows && buf[start] != '#') {
      double vals[3];
      bool got[3] = {false, false, false};
      int32_t col = 0;
      int64_t f = start;
      while (f < end && col <= max_col) {
        int64_t fe = f;
        while (fe < end && buf[fe] != delim) ++fe;
        const bool want_u = (col == user_col), want_i = (col == item_col),
                   want_t = (col == time_col);
        if (want_u || want_i || want_t) {
          char tmp[64];
          int64_t n = fe - f;
          if (n <= 0 || n >= 63) return -(1 + line);
          std::memcpy(tmp, buf + f, n);
          tmp[n] = 0;
          char *endp = nullptr;
          const double v = std::strtod(tmp, &endp);
          if (endp == tmp) return -(1 + line);
          while (*endp == ' ' || *endp == '\t') ++endp;
          if (*endp != 0) return -(1 + line);
          if (want_u) { vals[0] = v; got[0] = true; }
          if (want_i) { vals[1] = v; got[1] = true; }
          if (want_t) { vals[2] = v; got[2] = true; }
        }
        ++col;
        f = fe + 1;
      }
      if (!(got[0] && got[1] && got[2])) return -(1 + line);
      users[rows] = static_cast<int64_t>(vals[0]);
      items[rows] = static_cast<int64_t>(vals[1]);
      times[rows] = vals[2];
      ++rows;
    }
    ++line;
    start = p + 1;
  }
  return rows;
}

}  // extern "C"
