// Native negative sampler for the CTR data pipeline.
//
// Replaces the per-user Python sampling loops (reference:
// deepfm/data/movielens.py:482-530 — python set arithmetic +
// random.choices per user) with:
//   * Walker alias-method tables for O(1) popularity-weighted draws
//   * byte-matrix membership tests for the "unseen" constraint
//   * splitmix64/xoshiro-style PRNG, one stream per call (seeded)
//
// Exposed as a plain C ABI consumed via ctypes (deepfm_tpu_torch/native/sampler.py).

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Rng {
  uint64_t s;
  explicit Rng(uint64_t seed) : s(seed ? seed : 0x9e3779b97f4a7c15ULL) {}
  inline uint64_t next() {
    // splitmix64
    uint64_t z = (s += 0x9e3779b97f4a7c15ULL);
    z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
    z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
    return z ^ (z >> 31);
  }
  inline double uniform() {
    return (next() >> 11) * (1.0 / 9007199254740992.0);  // [0, 1)
  }
  inline int64_t below(int64_t n) {
    return static_cast<int64_t>(next() % static_cast<uint64_t>(n));
  }
};

// Walker alias tables over a weight vector restricted to "unseen" items.
struct Alias {
  std::vector<double> prob;
  std::vector<int64_t> alias;
  std::vector<int64_t> items;

  void build(const double* w, const uint8_t* seen_row, int64_t n_items) {
    items.clear();
    double total = 0.0;
    for (int64_t i = 0; i < n_items; ++i) {
      if (!seen_row[i]) {
        items.push_back(i);
        total += w[i];
      }
    }
    const int64_t n = static_cast<int64_t>(items.size());
    prob.assign(n, 0.0);
    alias.assign(n, 0);
    if (n == 0 || total <= 0.0) return;
    std::vector<double> scaled(n);
    for (int64_t i = 0; i < n; ++i) scaled[i] = w[items[i]] * n / total;
    std::vector<int64_t> small, large;
    small.reserve(n);
    large.reserve(n);
    for (int64_t i = 0; i < n; ++i) {
      (scaled[i] < 1.0 ? small : large).push_back(i);
    }
    while (!small.empty() && !large.empty()) {
      int64_t s = small.back(); small.pop_back();
      int64_t l = large.back(); large.pop_back();
      prob[s] = scaled[s];
      alias[s] = l;
      scaled[l] = (scaled[l] + scaled[s]) - 1.0;
      (scaled[l] < 1.0 ? small : large).push_back(l);
    }
    while (!large.empty()) { prob[large.back()] = 1.0; large.pop_back(); }
    while (!small.empty()) { prob[small.back()] = 1.0; small.pop_back(); }
  }

  inline int64_t draw(Rng& rng) const {
    const int64_t n = static_cast<int64_t>(items.size());
    if (n == 0) return -1;
    const int64_t i = rng.below(n);
    return items[rng.uniform() < prob[i] ? i : alias[i]];
  }
};

}  // namespace

extern "C" {

// Popularity-weighted with-replacement sampling of unseen items per uid.
// out: flat item indices; counts[k]: how many were written for uids[k].
// Returns total items written.
int64_t weighted_unseen_batch(const uint8_t* seen, int64_t n_items,
                              const double* weights, const int64_t* uids,
                              int64_t n_uids, int64_t num_neg, uint64_t seed,
                              int64_t* out, int64_t* counts) {
  Rng rng(seed);
  Alias alias;
  int64_t written = 0;
  int64_t prev_uid = -1;
  for (int64_t k = 0; k < n_uids; ++k) {
    const int64_t uid = uids[k];
    if (uid != prev_uid) {
      alias.build(weights, seen + uid * n_items, n_items);
      prev_uid = uid;
    }
    const int64_t avail = static_cast<int64_t>(alias.items.size());
    const int64_t take = num_neg < avail ? num_neg : avail;
    for (int64_t j = 0; j < take; ++j) out[written + j] = alias.draw(rng);
    counts[k] = take;
    written += take;
  }
  return written;
}

// Uniform without-replacement (per row) sampling of unseen items.
// out is (n_uids * num_neg) row-major. Requires num_neg << unseen count;
// falls back to sampling from the explicit unseen list when rejection
// sampling struggles.
int64_t uniform_unseen_batch(const uint8_t* seen, int64_t n_items,
                             const int64_t* uids, int64_t n_uids,
                             int64_t num_neg, uint64_t seed, int64_t* out) {
  Rng rng(seed);
  std::vector<int64_t> row(num_neg);
  for (int64_t k = 0; k < n_uids; ++k) {
    const uint8_t* seen_row = seen + uids[k] * n_items;
    int64_t got = 0;
    int64_t attempts = 0;
    const int64_t max_attempts = num_neg * 64;
    while (got < num_neg && attempts < max_attempts) {
      ++attempts;
      const int64_t cand = rng.below(n_items);
      if (seen_row[cand]) continue;
      bool dup = false;
      for (int64_t j = 0; j < got; ++j) {
        if (row[j] == cand) { dup = true; break; }
      }
      if (!dup) row[got++] = cand;
    }
    if (got < num_neg) {
      // Dense fallback: walk the unseen list round-robin.
      for (int64_t i = 0; i < n_items && got < num_neg; ++i) {
        if (!seen_row[i]) {
          bool dup = false;
          for (int64_t j = 0; j < got; ++j) {
            if (row[j] == i) { dup = true; break; }
          }
          if (!dup) row[got++] = i;
        }
      }
      // If the user has seen almost everything, pad with repeats.
      for (; got < num_neg; ++got) row[got] = row[got % (got ? got : 1)];
    }
    std::memcpy(out + k * num_neg, row.data(), num_neg * sizeof(int64_t));
  }
  return n_uids * num_neg;
}

}  // extern "C"
