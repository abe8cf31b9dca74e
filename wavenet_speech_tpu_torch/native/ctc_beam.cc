// Host-side CTC prefix beam search — native replacement for the reference's
// C++ `ctcdecode` dependency (CTCBeamDecoder; reference pretrain_rnn.py:23
// and eval notebooks: beam_width 7, blank 0).
//
// A copy of the JAX package's native/ctc_beam.cc, unchanged in its code.
// Same algorithm as decoding/prefix_beam.py (the host reference): log-space
// prefix beam search with (p_blank, p_nonblank) per prefix, merge-by-prefix,
// top-W per frame. Batch decoding fans out over a std::thread pool.
//
// Exported C ABI (see native/ctc_beam.py for the ctypes binding):
//   ctc_beam_search_batch(log_probs, B, T, C, lengths, beam_width, blank,
//                         max_label_len, out_labels, out_lengths, out_scores,
//                         out_times, num_threads)
//
// out_times matches ctcdecode's `times` output (eval notebook cells 19-22):
// the frame at which each emitted label entered the hypothesis; on a prefix
// merge the more probable path family's frames win.
//
// Built by native/ctc_beam.py: g++ -O3 -std=c++17 -shared -fPIC ... -lpthread,
// into native/build/ under a hash of this source and the flags.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <limits>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

constexpr double kNegInf = -std::numeric_limits<double>::infinity();

inline double logaddexp(double a, double b) {
  if (a == kNegInf) return b;
  if (b == kNegInf) return a;
  const double m = a > b ? a : b;
  return m + std::log(std::exp(a - m) + std::exp(b - m));
}

struct Mass {
  double pb;                   // log P(prefix, ends in blank)
  double pnb;                  // log P(prefix, ends in non-blank)
  std::vector<int32_t> times;  // emission frame of each prefix label
  double total() const { return logaddexp(pb, pnb); }
};

struct PrefixHash {
  size_t operator()(const std::vector<int32_t>& v) const {
    size_t h = 1469598103934665603ull;
    for (int32_t x : v) {
      h ^= static_cast<size_t>(x) + 0x9e3779b97f4a7c15ull + (h << 6) + (h >> 2);
    }
    return h;
  }
};

// Decode one sequence of `T` frames over `C` labels from row-major
// log-probabilities lp[t*C + c].
void decode_one(const float* lp, int T, int C, int beam_width, int blank,
                int max_label_len, int32_t* out_labels, int32_t* out_length,
                float* out_score, int32_t* out_times) {
  std::unordered_map<std::vector<int32_t>, Mass, PrefixHash> beams;
  beams[{}] = {0.0, kNegInf, {}};

  std::unordered_map<std::vector<int32_t>, Mass, PrefixHash> next;
  std::vector<std::pair<double, std::vector<int32_t>>> scored;

  auto add = [&next](std::vector<int32_t>&& prefix, double pb, double pnb,
                     std::vector<int32_t>&& times) {
    auto it = next.find(prefix);
    if (it == next.end()) {
      next.emplace(std::move(prefix), Mass{pb, pnb, std::move(times)});
    } else {
      // merged times follow the more probable path family
      if (logaddexp(pb, pnb) > it->second.total()) {
        it->second.times = std::move(times);
      }
      it->second.pb = logaddexp(it->second.pb, pb);
      it->second.pnb = logaddexp(it->second.pnb, pnb);
    }
  };

  for (int t = 0; t < T; ++t) {
    const float* row = lp + static_cast<size_t>(t) * C;
    next.clear();
    for (const auto& kv : beams) {
      const std::vector<int32_t>& prefix = kv.first;
      const double pb = kv.second.pb;
      const double pnb = kv.second.pnb;
      const std::vector<int32_t>& times = kv.second.times;
      const double total = logaddexp(pb, pnb);

      // stay candidate, added atomically: blank-extend (ends in blank) plus
      // repeat-collapse of the last label (ends in non-blank).  One add so
      // the times-merge comparison sees the prefix's total stay mass — the
      // same aggregate rule as the on-device kernel.
      const double stay_pnb =
          prefix.empty() ? kNegInf : pnb + row[prefix.back()];
      add(std::vector<int32_t>(prefix), total + row[blank], stay_pnb,
          std::vector<int32_t>(times));

      for (int c = 0; c < C; ++c) {
        if (c == blank) continue;
        const double lpc = row[c];
        if (!prefix.empty() && prefix.back() == c) {
          if (static_cast<int>(prefix.size()) < max_label_len) {
            std::vector<int32_t> ext(prefix);
            ext.push_back(c);
            std::vector<int32_t> etimes(times);
            etimes.push_back(t);
            add(std::move(ext), kNegInf, pb + lpc, std::move(etimes));
          }
        } else if (static_cast<int>(prefix.size()) < max_label_len) {
          std::vector<int32_t> ext(prefix);
          ext.push_back(c);
          std::vector<int32_t> etimes(times);
          etimes.push_back(t);
          add(std::move(ext), kNegInf, total + lpc, std::move(etimes));
        }
      }
    }

    scored.clear();
    scored.reserve(next.size());
    for (auto& kv : next) {
      scored.emplace_back(kv.second.total(), kv.first);
    }
    const size_t keep = std::min<size_t>(beam_width, scored.size());
    std::partial_sort(scored.begin(), scored.begin() + keep, scored.end(),
                      [](const auto& a, const auto& b) { return a.first > b.first; });
    beams.clear();
    for (size_t i = 0; i < keep; ++i) {
      beams[scored[i].second] = std::move(next[scored[i].second]);
    }
  }

  // best beam
  double best = kNegInf;
  const std::vector<int32_t>* best_prefix = nullptr;
  const std::vector<int32_t>* best_times = nullptr;
  for (const auto& kv : beams) {
    const double s = kv.second.total();
    if (s > best) {
      best = s;
      best_prefix = &kv.first;
      best_times = &kv.second.times;
    }
  }
  int n = best_prefix ? static_cast<int>(best_prefix->size()) : 0;
  n = std::min(n, max_label_len);
  for (int i = 0; i < n; ++i) out_labels[i] = (*best_prefix)[i];
  for (int i = n; i < max_label_len; ++i) out_labels[i] = 0;
  if (out_times) {
    for (int i = 0; i < n; ++i) out_times[i] = (*best_times)[i];
    for (int i = n; i < max_label_len; ++i) out_times[i] = 0;
  }
  *out_length = n;
  *out_score = static_cast<float>(best);
}

}  // namespace

extern "C" {

// log_probs: (B, T, C) row-major float32 log-probabilities.
// lengths: (B,) valid frame counts (NULL -> all T).
// out_labels: (B, max_label_len) int32; out_lengths: (B,); out_scores: (B,);
// out_times: (B, max_label_len) int32 emission frames (nullable).
void ctc_beam_search_batch(const float* log_probs, int B, int T, int C,
                           const int32_t* lengths, int beam_width, int blank,
                           int max_label_len, int32_t* out_labels,
                           int32_t* out_lengths, float* out_scores,
                           int32_t* out_times, int num_threads) {
  if (num_threads <= 0) {
    num_threads = static_cast<int>(std::thread::hardware_concurrency());
    if (num_threads <= 0) num_threads = 1;
  }
  num_threads = std::min(num_threads, B);

  auto worker = [&](int start, int step) {
    for (int b = start; b < B; b += step) {
      const int len = lengths ? lengths[b] : T;
      decode_one(log_probs + static_cast<size_t>(b) * T * C,
                 std::min(len, T), C, beam_width, blank, max_label_len,
                 out_labels + static_cast<size_t>(b) * max_label_len,
                 out_lengths + b, out_scores + b,
                 out_times ? out_times + static_cast<size_t>(b) * max_label_len
                           : nullptr);
    }
  };

  if (num_threads <= 1) {
    worker(0, 1);
    return;
  }
  std::vector<std::thread> pool;
  pool.reserve(num_threads);
  for (int i = 0; i < num_threads; ++i) pool.emplace_back(worker, i, num_threads);
  for (auto& th : pool) th.join();
}

}  // extern "C"
