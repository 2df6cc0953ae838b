// Native host kernels for tombo_tpu.
//
// TPU-native architecture note: device (XLA) code computes changepoint
// scores for whole read batches; the greedy minimum-spacing selection that
// follows (reference behavior: tombo/_c_helper.pyx:89-202) is sequential in
// descending-score order, so it runs here on the host — vectorized sort +
// tight selection loop, threaded across the reads of a batch.  This replaces
// the reference's per-read Cython loops with a batch-oriented library the
// ingest pipeline can overlap with device work.
//
// Build: csrc/Makefile -> tombo_tpu/native/libtombo_native.so (ctypes).

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <numeric>
#include <thread>
#include <vector>
#ifdef __AVX512F__
#include <immintrin.h>
#endif

extern "C" {

// Greedy top-k changepoint selection with spacing blacklist.
//
// scores:      n_cands candidate scores (padding candidates must be < all
//              real scores, e.g. -1 for non-negative score functions)
// min_base_obs: spacing; an accepted candidate at p blacklists
//              [p - min_base_obs + 1, p + min_base_obs - 1]
// num_cpts:    number of changepoints to select
// out:         num_cpts accepted candidate positions (unshifted, in
//              acceptance order)
// returns 0 on success, 1 if fewer than num_cpts valid candidates exist.
//
// Tie-breaking matches numpy stable argsort reversed: equal scores are
// visited higher-index first.
int greedy_cpts(const double* scores, int64_t n_cands, int64_t min_base_obs,
                int64_t num_cpts, int64_t* out) {
  if (num_cpts <= 0) return 0;
  if (n_cands <= 0) return 1;

  std::vector<int64_t> order(n_cands);
  std::iota(order.begin(), order.end(), 0);
  std::stable_sort(order.begin(), order.end(),
                   [scores](int64_t a, int64_t b) {
                     if (scores[a] != scores[b])
                       return scores[a] > scores[b];
                     return a > b;
                   });

  std::vector<uint8_t> blacklist(n_cands, 0);
  int64_t n_accepted = 0;
  for (int64_t i = 0; i < n_cands; ++i) {
    const int64_t cand = order[i];
    if (blacklist[cand]) continue;
    out[n_accepted++] = cand;
    if (n_accepted == num_cpts) return 0;
    const int64_t lo = std::max<int64_t>(0, cand - min_base_obs + 1);
    const int64_t hi = std::min<int64_t>(n_cands, cand + min_base_obs);
    std::memset(blacklist.data() + lo, 1, static_cast<size_t>(hi - lo));
  }
  return 1;
}

// Batched greedy selection over a padded score matrix, threaded.
//
// scores:     row-major (batch, max_cands)
// n_cands:    per-read true candidate counts
// num_cpts:   per-read number of changepoints to pick
// out:        row-major (batch, max_cpts); rows are sorted ascending and
//             shifted by `shift` (running_stat_width), matching the
//             reference wrapper (tombo/tombo_helper.py:76-82)
// status:     per-read status (0 ok, 1 not enough changepoints)
void greedy_cpts_batch(const double* scores, int64_t batch, int64_t max_cands,
                       const int64_t* n_cands, const int64_t* num_cpts,
                       int64_t max_cpts, int64_t shift, int64_t min_base_obs,
                       int64_t* out, int32_t* status, int64_t n_threads) {
  if (n_threads <= 0) {
    n_threads = static_cast<int64_t>(std::thread::hardware_concurrency());
    if (n_threads <= 0) n_threads = 1;
  }
  n_threads = std::min<int64_t>(n_threads, batch);

  std::atomic<int64_t> next(0);
  auto worker = [&]() {
    for (;;) {
      const int64_t b = next.fetch_add(1);
      if (b >= batch) return;
      int64_t* row_out = out + b * max_cpts;
      const int64_t k = std::min(num_cpts[b], max_cpts);
      status[b] = greedy_cpts(scores + b * max_cands, n_cands[b],
                              min_base_obs, k, row_out);
      if (status[b] == 0) {
        std::sort(row_out, row_out + k);
        for (int64_t i = 0; i < k; ++i) row_out[i] += shift;
      }
    }
  };

  std::vector<std::thread> threads;
  threads.reserve(static_cast<size_t>(n_threads));
  for (int64_t t = 0; t < n_threads; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
}

// Uncapped changepoint selection (reference behavior:
// tombo/_c_helper.pyx:122-142 c_valid_cpts): accepts every candidate not
// blacklisted, visiting in descending-score order.  Quirks preserved: the
// first (best) candidate does NOT blacklist its neighborhood, and the
// blacklist extends one extra position to the right.
// Returns the number of accepted positions written to out (caller provides
// n_cands capacity).  Output is in acceptance order, unshifted.
int64_t greedy_cpts_uncapped(const double* scores, int64_t n_cands,
                             int64_t min_base_obs, int64_t* out) {
  if (n_cands <= 0) return 0;
  std::vector<int64_t> order(n_cands);
  std::iota(order.begin(), order.end(), 0);
  std::stable_sort(order.begin(), order.end(),
                   [scores](int64_t a, int64_t b) {
                     if (scores[a] != scores[b])
                       return scores[a] > scores[b];
                     return a > b;
                   });
  std::vector<uint8_t> blacklist(n_cands, 0);
  int64_t n_accepted = 0;
  out[n_accepted++] = order[0];
  for (int64_t i = 1; i < n_cands; ++i) {
    const int64_t cand = order[i];
    if (blacklist[cand]) continue;
    out[n_accepted++] = cand;
    const int64_t lo = std::max<int64_t>(0, cand - min_base_obs + 1);
    const int64_t hi = std::min<int64_t>(n_cands, cand + min_base_obs + 1);
    std::memset(blacklist.data() + lo, 1, static_cast<size_t>(hi - lo));
  }
  return n_accepted;
}

}  // extern "C"

// Theil-Sen estimator: median of all-pairs slopes between event means and
// model means (reference behavior: tombo/_c_helper.pyx:362-377
// c_compute_slopes + numpy median in tombo/tombo_stats.py:417-419).
// Equal event means contribute max_slope.  Returns (slope, intercept) where
// intercept = median(model - slope * event).
// Exact k-th smallest (0-based) of v[0..len), v preserved.  Floyd-Rivest
// style: an evenly-strided sample brackets the target quantile, one
// branchless pass counts + compacts the bracket (few % of the data), and a
// small nth_element finishes.  Falls back to nth_element on a copy when the
// bracket misses (duplicates-heavy or adversarial data).
static double select_kth(const double* v, size_t len, size_t k,
                         std::vector<double>& scratch) {
  if (len < 8192) {
    scratch.assign(v, v + len);
    std::nth_element(scratch.begin(), scratch.begin() + k, scratch.end());
    return scratch[k];
  }
  // deterministic sample at fixed stride
  constexpr size_t kSample = 4096;
  thread_local std::vector<double> samp_v(kSample);
  double* samp = samp_v.data();
  const size_t stride = len / kSample;
  for (size_t i = 0; i < kSample; ++i) samp[i] = v[i * stride];
  const double q = static_cast<double>(k) / static_cast<double>(len);
  // bracket the quantile with ~4 standard errors of the sample estimate
  const double se = 4.0 * std::sqrt(q * (1.0 - q) / kSample) + 2.0 / kSample;
  auto samp_quant = [&](double qq) {
    size_t j = static_cast<size_t>(qq * kSample);
    if (j >= kSample) j = kSample - 1;
    std::nth_element(samp, samp + j, samp + kSample);
    return samp[j];
  };
  const double lo = samp_quant(q > se ? q - se : 0.0);
  const double hi = samp_quant(q + se < 1.0 ? q + se : 1.0);
  // one branchless pass: count below-bracket and compact the bracket.
  // The bracket straddles the dense distribution center, so any branch on
  // x >= lo is a ~50% coin flip — always-store / masked-compress avoids
  // the mispredict wall
  if (scratch.size() < len) scratch.resize(len);
  double* mid = scratch.data();
  size_t c_lo = 0, n_mid = 0, i0 = 0;
#ifdef __AVX512F__
  {
    const __m512d vlo = _mm512_set1_pd(lo), vhi = _mm512_set1_pd(hi);
    for (; i0 + 8 <= len; i0 += 8) {
      const __m512d x = _mm512_loadu_pd(v + i0);
      const __mmask8 mlt = _mm512_cmp_pd_mask(x, vlo, _CMP_LT_OQ);
      const __mmask8 mbr = _mm512_cmp_pd_mask(x, vlo, _CMP_GE_OQ) &
                           _mm512_cmp_pd_mask(x, vhi, _CMP_LE_OQ);
      c_lo += static_cast<size_t>(__builtin_popcount(mlt));
      _mm512_mask_compressstoreu_pd(mid + n_mid, mbr, x);
      n_mid += static_cast<size_t>(__builtin_popcount(mbr));
    }
  }
#endif
  for (size_t i = i0; i < len; ++i) {
    const double x = v[i];
    c_lo += x < lo;
    mid[n_mid] = x;
    n_mid += (x >= lo) & (x <= hi);
  }
  if (k >= c_lo && k < c_lo + n_mid && n_mid <= len / 8) {
    std::nth_element(mid, mid + (k - c_lo), mid + n_mid);
    return mid[k - c_lo];
  }
  scratch.assign(v, v + len);
  std::nth_element(scratch.begin(), scratch.begin() + k, scratch.end());
  return scratch[k];
}

// numpy-compatible median over v[0..len) (v preserved): averages the two
// middle order statistics for even len.
static double median_of(const double* v, size_t len,
                        std::vector<double>& scratch) {
  const size_t m = len / 2;
  const double hi = select_kth(v, len, m, scratch);
  if (len % 2 == 0) {
    // (m-1)-th: equal to hi when duplicates span the middle, else the
    // largest element strictly below hi.  This pass runs over the full
    // pair buffer, so it must be vector code: a branchy (or even
    // branchless-ternary) max_less update does not auto-vectorize and
    // costs more than the whole bracketed select.
    constexpr double kNegInf = -std::numeric_limits<double>::infinity();
    size_t c_strict = 0;
    double max_less = kNegInf;
    size_t i0 = 0;
#ifdef __AVX512F__
    {
      const __m512d vhi = _mm512_set1_pd(hi);
      __m512d vmax = _mm512_set1_pd(kNegInf);
      for (; i0 + 8 <= len; i0 += 8) {
        const __m512d x = _mm512_loadu_pd(v + i0);
        const __mmask8 mlt = _mm512_cmp_pd_mask(x, vhi, _CMP_LT_OQ);
        c_strict += static_cast<size_t>(__builtin_popcount(mlt));
        vmax = _mm512_mask_max_pd(vmax, mlt, vmax, x);
      }
      max_less = _mm512_reduce_max_pd(vmax);
    }
#endif
    for (size_t i = i0; i < len; ++i) {
      const double x = v[i];
      c_strict += x < hi;
      const double cand = x < hi ? x : kNegInf;
      max_less = max_less > cand ? max_less : cand;
    }
    const double lo_mid = c_strict <= m - 1 ? hi : max_less;
    return (hi + lo_mid) / 2.0;
  }
  return hi;
}

// f32 slope buffer: the 4 MB/read f64 pair buffer is memory-bound through
// the selection passes; storing f32 halves the traffic and doubles SIMD
// width.  Used by the float32 production lane only (slope error ~1e-7
// relative, far inside its tie tolerance); the float64 oracle-parity mode
// keeps the exact f64 path.  Same Floyd-Rivest bracket scheme as the f64
// select_kth above.
static float select_kth_f32(const float* v, size_t len, size_t k,
                            std::vector<float>& scratch) {
  if (len < 8192) {
    scratch.assign(v, v + len);
    std::nth_element(scratch.begin(), scratch.begin() + k, scratch.end());
    return scratch[k];
  }
  constexpr size_t kSample = 4096;
  thread_local std::vector<float> samp_v(kSample);
  float* samp = samp_v.data();
  const size_t stride = len / kSample;
  for (size_t i = 0; i < kSample; ++i) samp[i] = v[i * stride];
  const double q = static_cast<double>(k) / static_cast<double>(len);
  const double se = 4.0 * std::sqrt(q * (1.0 - q) / kSample) + 2.0 / kSample;
  auto samp_quant = [&](double qq) {
    size_t j = static_cast<size_t>(qq * kSample);
    if (j >= kSample) j = kSample - 1;
    std::nth_element(samp, samp + j, samp + kSample);
    return samp[j];
  };
  const float lo = samp_quant(q > se ? q - se : 0.0);
  const float hi = samp_quant(q + se < 1.0 ? q + se : 1.0);
  if (scratch.size() < len) scratch.resize(len);
  float* mid = scratch.data();
  size_t c_lo = 0, n_mid = 0, i0 = 0;
#ifdef __AVX512F__
  {
    const __m512 vlo = _mm512_set1_ps(lo), vhi = _mm512_set1_ps(hi);
    for (; i0 + 16 <= len; i0 += 16) {
      const __m512 x = _mm512_loadu_ps(v + i0);
      const __mmask16 mlt = _mm512_cmp_ps_mask(x, vlo, _CMP_LT_OQ);
      const __mmask16 mbr = _mm512_cmp_ps_mask(x, vlo, _CMP_GE_OQ) &
                            _mm512_cmp_ps_mask(x, vhi, _CMP_LE_OQ);
      c_lo += static_cast<size_t>(__builtin_popcount(mlt));
      _mm512_mask_compressstoreu_ps(mid + n_mid, mbr, x);
      n_mid += static_cast<size_t>(__builtin_popcount(mbr));
    }
  }
#endif
  for (size_t i = i0; i < len; ++i) {
    const float x = v[i];
    c_lo += x < lo;
    mid[n_mid] = x;
    n_mid += (x >= lo) & (x <= hi);
  }
  if (k >= c_lo && k < c_lo + n_mid && n_mid <= len / 8) {
    std::nth_element(mid, mid + (k - c_lo), mid + n_mid);
    return mid[k - c_lo];
  }
  scratch.assign(v, v + len);
  std::nth_element(scratch.begin(), scratch.begin() + k, scratch.end());
  return scratch[k];
}

static double median_of_f32(const float* v, size_t len,
                            std::vector<float>& scratch) {
  const size_t m = len / 2;
  const float hi = select_kth_f32(v, len, m, scratch);
  if (len % 2 == 0) {
    // vector pass (see median_of): a scalar max_less update on the
    // 500k-slope buffer dominated the whole selection
    constexpr float kNegInf = -std::numeric_limits<float>::infinity();
    size_t c_strict = 0;
    float max_less = kNegInf;
    size_t i0 = 0;
#ifdef __AVX512F__
    {
      const __m512 vhi = _mm512_set1_ps(hi);
      __m512 vmax = _mm512_set1_ps(kNegInf);
      for (; i0 + 16 <= len; i0 += 16) {
        const __m512 x = _mm512_loadu_ps(v + i0);
        const __mmask16 mlt = _mm512_cmp_ps_mask(x, vhi, _CMP_LT_OQ);
        c_strict += static_cast<size_t>(__builtin_popcount(mlt));
        vmax = _mm512_mask_max_ps(vmax, mlt, vmax, x);
      }
      max_less = _mm512_reduce_max_ps(vmax);
    }
#endif
    for (size_t i = i0; i < len; ++i) {
      const float x = v[i];
      c_strict += x < hi;
      const float cand = x < hi ? x : kNegInf;
      max_less = max_less > cand ? max_less : cand;
    }
    const float lo_mid = c_strict <= m - 1 ? hi : max_less;
    return (static_cast<double>(hi) + static_cast<double>(lo_mid)) / 2.0;
  }
  return hi;
}

// ---------------------------------------------------------------------------
// Fast exact Theil-Sen slope selection — expected O(n log n) per read.
//
// The reference estimator is the median of all O(n^2/2) pairwise slopes
// (reference: tombo/_c_helper.pyx:362 c_compute_slopes +
// tombo/tombo_stats.py:413 np.median).  Instead of materializing the pairs,
// this selects the k-th smallest slope by interval narrowing
// (Dillencourt/Mount/Netanyahu-style slope selection): counting
// #{pairs: slope <= t} is an inversion count of w_i = mod_i - t*ev_i over
// the ev-sorted order (one mergesort), and the final few candidates are
// enumerated output-sensitively from the inversions between the orderings
// at the two interval ends.  Comparisons run on w in double precision, so
// the selected pair can differ from the f32-quotient median of the pair
// enumeration by ~1 ulp for near-tied slopes — inside the f32 production
// lane's documented tolerance (the exact f64 pair path remains the oracle).
// Degenerate pairs (equal event means) contribute slope = max_slope,
// matching the pair-enumeration semantics.
namespace ts_fast {

struct Rng {  // xorshift64*; only affects pivot quality, never the result
  uint64_t s;
  explicit Rng(uint64_t seed) : s(seed | 1) {}
  uint64_t next() {
    s ^= s >> 12; s ^= s << 25; s ^= s >> 27;
    return s * 0x2545F4914F6CDD1DULL;
  }
  int64_t below(int64_t n) {
    return static_cast<int64_t>(next() % static_cast<uint64_t>(n));
  }
};

// Count pairs (a before b) with y[b] <= y[a] via mergesort (right element
// popped on ties so equal values count).  buf is scratch of size n.
static int64_t merge_count_le(double* y, double* buf, int64_t n) {
  if (n < 2) return 0;
  int64_t cnt = 0;
  for (int64_t width = 1; width < n; width *= 2) {
    for (int64_t lo = 0; lo < n - width; lo += 2 * width) {
      const int64_t mid = lo + width;
      const int64_t hi = std::min(lo + 2 * width, n);
      int64_t li = lo, ri = mid, o = lo;
      while (li < mid && ri < hi) {
        if (y[ri] <= y[li]) { cnt += mid - li; buf[o++] = y[ri++]; }
        else buf[o++] = y[li++];
      }
      while (li < mid) buf[o++] = y[li++];
      while (ri < hi) buf[o++] = y[ri++];
      std::copy(buf + lo, buf + hi, y + lo);
    }
  }
  return cnt;
}

struct Sel {
  const double* ev;   // ev-sorted
  const double* mod;  // matching order
  int64_t n;
  double max_slope;
  int64_t m_real;     // cross pairs (distinct ev)
  int64_t n_eq;       // degenerate pairs (equal ev)
  int64_t d_le;       // degenerate pairs with mod[j] <= mod[i], i<j
  double slope_bound; // finite value strictly above all |slopes|
  std::vector<double> w, buf;

  // #{slopes <= t} over the full multiset (real + degenerate at max_slope)
  int64_t count_le(double t) {
    for (int64_t i = 0; i < n; ++i) w[i] = mod[i] - t * ev[i];
    const int64_t c = merge_count_le(w.data(), buf.data(), n) - d_le;
    return c + (max_slope <= t ? n_eq : 0);
  }

  // Collect slopes of pairs with lo < slope <= t_hi (convention of
  // count_le) into out; returns false if more than cap found.
  bool enumerate(double t_lo, double t_hi, int64_t cap,
                 std::vector<double>& out) {
    const int64_t nn = n;
    std::vector<double> wlo(nn), whi(nn);
    for (int64_t i = 0; i < nn; ++i) {
      wlo[i] = mod[i] - t_lo * ev[i];
      whi[i] = mod[i] - t_hi * ev[i];
    }
    // order by w_lo ascending; ties by ev-rank DESCENDING so slope==lo
    // pairs land j-before-i and are excluded (see count_le convention)
    std::vector<int32_t> perm(nn);
    for (int64_t i = 0; i < nn; ++i) perm[i] = static_cast<int32_t>(i);
    std::sort(perm.begin(), perm.end(), [&](int32_t a, int32_t b) {
      if (wlo[a] != wlo[b]) return wlo[a] < wlo[b];
      return a > b;
    });
    std::vector<double> y(nn);
    std::vector<int32_t> id(nn), idbuf(nn);
    for (int64_t i = 0; i < nn; ++i) { y[i] = whi[perm[i]]; id[i] = perm[i]; }
    std::vector<double> ybuf(nn);
    out.clear();
    // mergesort over y emitting (left, right) pairs on pop-right
    for (int64_t width = 1; width < nn; width *= 2) {
      for (int64_t lo = 0; lo < nn - width; lo += 2 * width) {
        const int64_t mid = lo + width;
        const int64_t hi = std::min(lo + 2 * width, nn);
        int64_t li = lo, ri = mid, o = lo;
        while (li < mid && ri < hi) {
          if (y[ri] <= y[li]) {
            for (int64_t l = li; l < mid; ++l) {
              const int32_t a = id[l], b = id[ri];
              const double de = ev[a] - ev[b];
              if (de != 0.0)
                out.push_back((mod[a] - mod[b]) / de);
              if (static_cast<int64_t>(out.size()) > cap) return false;
            }
            ybuf[o] = y[ri]; idbuf[o++] = id[ri++];
          } else {
            ybuf[o] = y[li]; idbuf[o++] = id[li++];
          }
        }
        while (li < mid) { ybuf[o] = y[li]; idbuf[o++] = id[li++]; }
        while (ri < hi) { ybuf[o] = y[ri]; idbuf[o++] = id[ri++]; }
        std::copy(ybuf.begin() + lo, ybuf.begin() + hi, y.begin() + lo);
        std::copy(idbuf.begin() + lo, idbuf.begin() + hi, id.begin() + lo);
      }
    }
    return true;
  }

  // k-th smallest (0-based) of the slope multiset; false on giving up
  bool select(int64_t k, Rng& rng, double* out) {
    const int64_t m_tot = m_real + n_eq;
    double lo = -std::numeric_limits<double>::infinity();
    double hi = std::numeric_limits<double>::infinity();
    int64_t c_lo = 0, c_hi = m_tot;
    const int64_t cap = std::max<int64_t>(4 * n, 256);
    for (int iter = 0; iter < 48 && c_hi - c_lo > cap; ++iter) {
      // pivot: median of sampled pair slopes inside (lo, hi)
      double samp[65];
      int ns = 0;
      for (int d = 0; d < 256 && ns < 64; ++d) {
        const int64_t i = rng.below(n), j = rng.below(n);
        if (ev[i] == ev[j]) continue;
        const double s = (mod[i] - mod[j]) / (ev[i] - ev[j]);
        if (s > lo && s < hi) samp[ns++] = s;
      }
      double t;
      if (ns > 0) {
        std::nth_element(samp, samp + ns / 2, samp + ns);
        t = samp[ns / 2];
      } else if (std::isfinite(lo) && std::isfinite(hi)) {
        t = lo + (hi - lo) / 2;
      } else if (max_slope > lo && max_slope < hi) {
        t = max_slope;
      } else {
        break;
      }
      if (!(t > lo && t < hi)) break;
      const int64_t c = count_le(t);
      if (c <= k) { lo = t; c_lo = c; }
      else { hi = t; c_hi = c; }
    }
    if (c_hi - c_lo > 4 * cap) return false;
    // infinite interval ends become finite bounds strictly outside the
    // attainable slope range (counts are unchanged: 0 / m_tot)
    if (std::isinf(lo)) lo = -slope_bound;
    if (std::isinf(hi)) hi = slope_bound;
    std::vector<double> cand;
    cand.reserve(static_cast<size_t>(c_hi - c_lo) + 8);
    if (!enumerate(lo, hi, 8 * cap, cand)) return false;
    if (max_slope > lo && max_slope <= hi)
      cand.insert(cand.end(), static_cast<size_t>(n_eq), max_slope);
    const int64_t r = k - c_lo;
    if (r < 0 || r >= static_cast<int64_t>(cand.size())) return false;
    std::nth_element(cand.begin(), cand.begin() + r, cand.end());
    *out = cand[static_cast<size_t>(r)];
    return true;
  }
};

// Exact slope median via fast selection; returns false to request the
// O(n^2) fallback.
static bool slope_median_fast(const double* ev_in, const double* mod_in,
                              int64_t n, double max_slope, double* out) {
  if (n < 64) return false;
  std::vector<int32_t> ord(n);
  for (int64_t i = 0; i < n; ++i) ord[i] = static_cast<int32_t>(i);
  std::sort(ord.begin(), ord.end(), [&](int32_t a, int32_t b) {
    if (ev_in[a] != ev_in[b]) return ev_in[a] < ev_in[b];
    return a < b;
  });
  std::vector<double> ev(n), mod(n);
  for (int64_t i = 0; i < n; ++i) {
    ev[i] = ev_in[ord[i]];
    mod[i] = mod_in[ord[i]];
  }
  // degenerate (equal-ev) bookkeeping
  int64_t n_eq = 0, d_le = 0;
  for (int64_t g = 0; g < n;) {
    int64_t e = g + 1;
    while (e < n && ev[e] == ev[g]) ++e;
    const int64_t len = e - g;
    if (len > 1) {
      n_eq += len * (len - 1) / 2;
      for (int64_t i = g; i < e; ++i)
        for (int64_t j = i + 1; j < e; ++j) d_le += mod[j] <= mod[i];
    }
    g = e;
  }
  const int64_t m = n * (n - 1) / 2;
  if (m == n_eq) { *out = max_slope; return true; }  // all pairs degenerate
  // finite bound strictly above every attainable |slope|
  double min_gap = std::numeric_limits<double>::infinity();
  for (int64_t i = 1; i < n; ++i)
    if (ev[i] != ev[i - 1]) min_gap = std::min(min_gap, ev[i] - ev[i - 1]);
  double mod_lo = mod[0], mod_hi = mod[0];
  for (int64_t i = 1; i < n; ++i) {
    mod_lo = std::min(mod_lo, mod[i]);
    mod_hi = std::max(mod_hi, mod[i]);
  }
  const double bound =
      ((mod_hi - mod_lo) / min_gap) * 1.0000001 + std::abs(max_slope) + 1.0;
  if (!std::isfinite(bound)) return false;
  Sel sel{ev.data(), mod.data(), n, max_slope, m - n_eq, n_eq, d_le, bound,
          std::vector<double>(static_cast<size_t>(n)),
          std::vector<double>(static_cast<size_t>(n))};
  Rng rng(0x9E3779B97F4A7C15ULL ^ static_cast<uint64_t>(n));
  const int64_t k_lo = (m - 1) / 2, k_hi = m / 2;
  double v_lo, v_hi;
  if (!sel.select(k_lo, rng, &v_lo)) return false;
  if (k_hi == k_lo) { *out = v_lo; return true; }
  if (!sel.select(k_hi, rng, &v_hi)) return false;
  *out = (v_lo + v_hi) / 2.0;
  return true;
}

}  // namespace ts_fast

static void theil_sen_one(const double* ev, const double* mod, int64_t n,
                          double max_slope, double* out_slope,
                          double* out_inter, int use_f32) {
  const int64_t n_pairs = n * (n - 1) / 2;
  double slope;
  if (use_f32 == 2 &&
      ts_fast::slope_median_fast(ev, mod, n, max_slope, &slope)) {
    thread_local std::vector<double> fast_inters;
    if (static_cast<int64_t>(fast_inters.size()) < n)
      fast_inters.resize(static_cast<size_t>(n));
    for (int64_t i = 0; i < n; ++i)
      fast_inters[static_cast<size_t>(i)] = mod[i] - slope * ev[i];
    thread_local std::vector<double> fast_sel;
    *out_slope = slope;
    *out_inter = median_of(fast_inters.data(), static_cast<size_t>(n),
                           fast_sel);
    return;
  }
  if (use_f32) {
    thread_local std::vector<float> slopes32;
    if (static_cast<int64_t>(slopes32.size()) < n_pairs)
      slopes32.resize(static_cast<size_t>(n_pairs));
    thread_local std::vector<float> evf, modf;
    if (static_cast<int64_t>(evf.size()) < n) {
      evf.resize(static_cast<size_t>(n));
      modf.resize(static_cast<size_t>(n));
    }
    for (int64_t i = 0; i < n; ++i) {
      evf[static_cast<size_t>(i)] = static_cast<float>(ev[i]);
      modf[static_cast<size_t>(i)] = static_cast<float>(mod[i]);
    }
    const float ms = static_cast<float>(max_slope);
    float* sp = slopes32.data();
    size_t k = 0;
    for (int64_t i = 0; i < n; ++i) {
      const float evi = evf[static_cast<size_t>(i)];
      const float modi = modf[static_cast<size_t>(i)];
      for (int64_t j = i + 1; j < n; ++j) {
        const float de = evi - evf[static_cast<size_t>(j)];
        const float s = (modi - modf[static_cast<size_t>(j)]) / de;
        sp[k++] = de == 0.0f ? ms : s;
      }
    }
    thread_local std::vector<float> sel32;
    slope = median_of_f32(sp, static_cast<size_t>(n_pairs), sel32);
  } else {
    // thread-local scratch reused across reads: a fresh multi-MB vector
    // per read costs more in page faults than the median computation
    thread_local std::vector<double> slopes;
    if (static_cast<int64_t>(slopes.size()) < n_pairs)
      slopes.resize(static_cast<size_t>(n_pairs));
    double* sp = slopes.data();
    size_t k = 0;
    for (int64_t i = 0; i < n; ++i) {
      const double evi = ev[i], modi = mod[i];
      // branch-free inner loop vectorizes (the de == 0 case selects
      // max_slope after the division, matching numpy's where() semantics)
      for (int64_t j = i + 1; j < n; ++j) {
        const double de = evi - ev[j];
        const double s = (modi - mod[j]) / de;
        sp[k++] = de == 0.0 ? max_slope : s;
      }
    }
    thread_local std::vector<double> sel_scratch_d;
    slope = median_of(sp, static_cast<size_t>(n_pairs), sel_scratch_d);
  }
  thread_local std::vector<double> inters;
  if (static_cast<int64_t>(inters.size()) < n)
    inters.resize(static_cast<size_t>(n));
  for (int64_t i = 0; i < n; ++i) inters[i] = mod[i] - slope * ev[i];
  thread_local std::vector<double> sel_scratch;
  *out_slope = slope;
  *out_inter = median_of(inters.data(), static_cast<size_t>(n),
                         sel_scratch);
}

extern "C" {

// Batched Theil-Sen over padded (batch, max_n) arrays, threaded.
// n_points[b] gives each row's true length (callers pre-sample to <= 1000
// points, matching MAX_POINTS_FOR_THEIL_SEN).
void theil_sen_batch(const double* ev, const double* mod, int64_t batch,
                     int64_t max_n, const int64_t* n_points,
                     double max_slope, double* out_slopes,
                     double* out_inters, int64_t n_threads) {
  if (n_threads <= 0) {
    n_threads = static_cast<int64_t>(std::thread::hardware_concurrency());
    if (n_threads <= 0) n_threads = 1;
  }
  n_threads = std::min<int64_t>(n_threads, batch);
  std::atomic<int64_t> next(0);
  auto worker = [&]() {
    for (;;) {
      const int64_t b = next.fetch_add(1);
      if (b >= batch) return;
      theil_sen_one(ev + b * max_n, mod + b * max_n, n_points[b], max_slope,
                    out_slopes + b, out_inters + b, /*use_f32=*/0);
    }
  };
  std::vector<std::thread> threads;
  for (int64_t t = 0; t < n_threads; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
}

// Fast-selection variant for the float32 production lane: expected
// O(n log n) exact slope selection (ts_fast above; ~1 ulp from the pair
// enumeration on near-tied slopes), with the f32 pair-buffer path as the
// per-read fallback when the selection gives up.
void theil_sen_batch_fast(const double* ev, const double* mod, int64_t batch,
                          int64_t max_n, const int64_t* n_points,
                          double max_slope, double* out_slopes,
                          double* out_inters, int64_t n_threads) {
  if (n_threads <= 0) {
    n_threads = static_cast<int64_t>(std::thread::hardware_concurrency());
    if (n_threads <= 0) n_threads = 1;
  }
  n_threads = std::min<int64_t>(n_threads, batch);
  std::atomic<int64_t> next(0);
  auto worker = [&]() {
    for (;;) {
      const int64_t b = next.fetch_add(1);
      if (b >= batch) return;
      theil_sen_one(ev + b * max_n, mod + b * max_n, n_points[b], max_slope,
                    out_slopes + b, out_inters + b, /*use_f32=*/2);
    }
  };
  std::vector<std::thread> threads;
  for (int64_t t = 0; t < n_threads; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
}

// f32-pair-buffer variant for the float32 production lane (see
// theil_sen_one): ~2x less selection-pass memory traffic, identical
// calling convention.
void theil_sen_batch32(const double* ev, const double* mod, int64_t batch,
                       int64_t max_n, const int64_t* n_points,
                       double max_slope, double* out_slopes,
                       double* out_inters, int64_t n_threads) {
  if (n_threads <= 0) {
    n_threads = static_cast<int64_t>(std::thread::hardware_concurrency());
    if (n_threads <= 0) n_threads = 1;
  }
  n_threads = std::min<int64_t>(n_threads, batch);
  std::atomic<int64_t> next(0);
  auto worker = [&]() {
    for (;;) {
      const int64_t b = next.fetch_add(1);
      if (b >= batch) return;
      theil_sen_one(ev + b * max_n, mod + b * max_n, n_points[b], max_slope,
                    out_slopes + b, out_inters + b, /*use_f32=*/1);
    }
  };
  std::vector<std::thread> threads;
  for (int64_t t = 0; t < n_threads; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Raw-signal deletion-fix DP (reference behavior:
// tombo/_c_dynamic_programming.pyx:34-183 c_reg_z_scores /
// c_base_forward_pass / c_base_traceback driven by
// tombo/resquiggle.py:345-540).  One call resolves one deletion window:
// re-segment n_events bases over the window's raw signal with a min-obs
// constraint.  Windows are independent, so the batch entry threads them.
// ---------------------------------------------------------------------------

namespace {

struct BaseLane {
  std::vector<double> z;      // half z-scores for this base's signal window
  std::vector<double> fwd;    // forward scores
  std::vector<int64_t> ld;    // last-diag counters
  int64_t start = 0, end = 0; // window bounds relative to region signal
};

// returns 0 ok, 1 traceback failure
int raw_window_dp_one(const double* sig, const double* means,
                      const double* sds, const int64_t* ps,
                      int64_t n_events, int64_t min_obs, int winsorize,
                      double max_half_z, int64_t* out) {
  // per-base signal windows (reg_z_scores with reg_start=0,
  // reg_end=n_events, max_base_shift=n_events => chains from the ends)
  std::vector<int64_t> starts(n_events), ends(n_events);
  for (int64_t i = 0; i < n_events; ++i) {
    int64_t b_start = ps[0];
    if (i > 0 && b_start < starts[i - 1] + min_obs)
      b_start = starts[i - 1] + min_obs;
    starts[i] = b_start;
  }
  for (int64_t ri = 0; ri < n_events; ++ri) {
    const int64_t i = n_events - 1 - ri;
    int64_t b_end = ps[n_events];
    if (ri > 0 && b_end > ends[i + 1] - min_obs)
      b_end = ends[i + 1] - min_obs;
    ends[i] = b_end;
  }

  std::vector<BaseLane> lanes(static_cast<size_t>(n_events));
  const int64_t sig_off = ps[0];
  for (int64_t i = 0; i < n_events; ++i) {
    BaseLane& L = lanes[static_cast<size_t>(i)];
    L.start = starts[i] - sig_off;
    L.end = ends[i] - sig_off;
    const int64_t len = L.end - L.start;
    L.z.resize(static_cast<size_t>(len));
    for (int64_t j = 0; j < len; ++j) {
      double z = -std::abs((sig[L.start + j] - means[i]) / sds[i]);
      if (winsorize && z < -max_half_z) z = -max_half_z;
      L.z[static_cast<size_t>(j)] = z;
    }
  }

  // forward pass (reference: pyx:99-163 via tombo/resquiggle.py:345-380)
  {
    BaseLane& L0 = lanes[0];
    const int64_t len = L0.end - L0.start;
    L0.fwd.resize(static_cast<size_t>(len));
    L0.ld.assign(static_cast<size_t>(len), min_obs);
    double acc = 0.0;
    for (int64_t j = 0; j < len; ++j) {
      acc += L0.z[static_cast<size_t>(j)];
      L0.fwd[static_cast<size_t>(j)] = acc;
    }
  }
  std::vector<double> prev_cumsum;
  for (int64_t b = 1; b < n_events; ++b) {
    BaseLane& P = lanes[static_cast<size_t>(b - 1)];
    BaseLane& C = lanes[static_cast<size_t>(b)];
    const int64_t b_len = C.end - C.start;
    C.fwd.resize(static_cast<size_t>(b_len));
    C.ld.resize(static_cast<size_t>(b_len));
    prev_cumsum.resize(P.z.size());
    double acc = 0.0;
    for (size_t j = 0; j < P.z.size(); ++j) {
      acc += P.z[j];
      prev_cumsum[j] = acc;
    }
    C.fwd[0] = C.z[0] + P.fwd[static_cast<size_t>(C.start - P.start - 1)];
    C.ld[0] = 1;
    for (int64_t pos = C.start + 1; pos <= P.end; ++pos) {
      int64_t lag = 1;
      while (P.ld[static_cast<size_t>(pos - P.start - lag)] + lag <= min_obs)
        ++lag;
      double diag = P.fwd[static_cast<size_t>(pos - P.start - lag)];
      if (lag > 1)
        diag += prev_cumsum[static_cast<size_t>(pos - P.start - 1)] -
                prev_cumsum[static_cast<size_t>(pos - P.start - lag)];
      const double stay = C.fwd[static_cast<size_t>(pos - C.start - 1)];
      double score;
      int64_t pd;
      if (diag > stay) {
        score = diag;
        pd = 1;
      } else {
        score = stay;
        pd = C.ld[static_cast<size_t>(pos - C.start - 1)] + 1;
      }
      C.fwd[static_cast<size_t>(pos - C.start)] =
          C.z[static_cast<size_t>(pos - C.start)] + score;
      C.ld[static_cast<size_t>(pos - C.start)] = pd;
    }
    if (C.end > P.end + 1) {
      const int64_t start_i = P.end - C.start;
      double fwd_value = C.fwd[static_cast<size_t>(start_i)];
      int64_t last_diag = C.ld[static_cast<size_t>(start_i)];
      for (int64_t j = start_i + 1; j < b_len; ++j) {
        fwd_value += C.z[static_cast<size_t>(j)];
        ++last_diag;
        C.fwd[static_cast<size_t>(j)] = fwd_value;
        C.ld[static_cast<size_t>(j)] = last_diag;
      }
    }
  }

  // traceback (reference: pyx:165-184 via tombo/resquiggle.py:382-400)
  auto base_tb = [&](const BaseLane& curr, const BaseLane& next,
                     int64_t sig_start) -> int64_t {
    int64_t curr_base_sig = 1;
    for (int64_t sig_pos = sig_start; sig_pos >= 0; --sig_pos) {
      ++curr_base_sig;
      if (curr_base_sig <= min_obs || sig_pos - 1 >= next.end) continue;
      if (sig_pos <= curr.start ||
          next.fwd[static_cast<size_t>(sig_pos - next.start - 1)] >
              curr.fwd[static_cast<size_t>(sig_pos - curr.start - 1)])
        return sig_pos;
    }
    return -1;
  };
  const int64_t n_bnd = n_events - 1;
  {
    const BaseLane& curr = lanes[static_cast<size_t>(n_events - 1)];
    const BaseLane& next = lanes[static_cast<size_t>(n_events - 2)];
    const int64_t r = base_tb(curr, next, curr.end - 1);
    if (r < 0) return 1;
    out[n_bnd - 1] = r;
  }
  for (int64_t bp = n_events - 3; bp >= 0; --bp) {
    const BaseLane& curr = lanes[static_cast<size_t>(bp + 1)];
    const BaseLane& next = lanes[static_cast<size_t>(bp)];
    const int64_t r = base_tb(curr, next, out[bp + 1] - 1);
    if (r < 0) return 1;
    out[bp] = r;
  }
  return 0;
}

}  // namespace

namespace {

// numpy linspace(a, b, n).astype(int64): y[i] = trunc(a + step*i), final
// element exactly b (same arithmetic as np.linspace -> astype, so the
// pseudo starts match the python path bit for bit)
void linspace_i64(double a, double b, int64_t n, int64_t* out) {
  if (n == 1) {
    out[0] = static_cast<int64_t>(a);
    return;
  }
  const double step = (b - a) / static_cast<double>(n - 1);
  for (int64_t i = 0; i < n - 1; ++i)
    out[i] = static_cast<int64_t>(a + step * static_cast<double>(i));
  out[n - 1] = static_cast<int64_t>(b);
}

// Full deletion fix for one read: window planning (merge / expand / trim),
// raw-signal window DP, boundary scatter and validity checks (reference
// behavior: tombo/resquiggle.py:402-540 resolve_skipped_bases_with_raw;
// python halves: tombo_tpu/pipeline/resquiggle.py plan_del_fix_windows /
// build_del_fix_inputs / apply_del_fix — kept bit-identical, verified by
// the float64 exact-parity tests).  ``segs`` (seq_len+1, relative to
// ``norm``) is updated in place.
//
// Status codes (mapped to reference error strings by the ctypes wrapper):
//   0 ok (windows resolved, or no deletions)
//   2 not enough raw signal around deletions
//   3 too many potential genomic deletions
//   4 raw-signal traceback failed
//   5 zero-length events after fix
//   6 segments start negative
//   7 segments end past raw signal
int del_fix_one(const double* norm, int64_t norm_len, const double* means,
                const double* sds, int64_t seq_len, int64_t* segs,
                int64_t raw_min_obs, int winsorize, double max_half_z,
                int64_t del_fix_window, int64_t max_del_fix_window,
                double extra_sig_factor, int64_t max_raw_cpts) {
  std::vector<std::pair<int64_t, int64_t>> wins;
  for (int64_t i = 0; i < seq_len; ++i) {
    if (segs[i + 1] != segs[i]) continue;
    if (!wins.empty() && i < wins.back().second + del_fix_window)
      wins.back().second = i + del_fix_window + 1;
    else
      wins.emplace_back(i - del_fix_window, i + del_fix_window + 1);
  }
  if (wins.empty()) return 0;

  auto merge_trim = [&](std::vector<std::pair<int64_t, int64_t>>& w) {
    std::vector<std::pair<int64_t, int64_t>> m;
    for (auto& p : w) {
      if (!m.empty() && p.first < m.back().second)
        m.back().second = p.second;
      else
        m.push_back(p);
    }
    if (m.front().first < 0) m.front().first = 0;
    if (m.back().second > seq_len) m.back().second = seq_len;
    w = std::move(m);
  };
  auto too_small = [&](int64_t s, int64_t e) {
    const int64_t ne = e - s;
    const int64_t sl = segs[e] - segs[s];
    return static_cast<double>(sl) <=
           static_cast<double>((ne + 1) * raw_min_obs) * extra_sig_factor;
  };
  merge_trim(wins);
  bool expanded = false;
  for (int64_t it = 0; it < max_del_fix_window - del_fix_window; ++it) {
    expanded = false;
    for (auto& p : wins) {
      if (too_small(p.first, p.second)) {
        expanded = true;
        --p.first;
        ++p.second;
      }
    }
    if (!expanded) break;
    merge_trim(wins);
  }
  if (expanded) {
    for (auto& p : wins)
      if (too_small(p.first, p.second)) return 2;
  }
  for (auto& p : wins)
    if (max_raw_cpts >= 0 && p.second - p.first > max_raw_cpts) return 3;

  thread_local std::vector<int64_t> ps;
  thread_local std::vector<int64_t> wout;
  for (auto& p : wins) {
    const int64_t s = p.first, e = p.second;
    const int64_t ne = e - s;
    const int64_t ss = segs[s], se = segs[e];
    if (static_cast<int64_t>(ps.size()) < ne + 1) ps.resize(ne + 1);
    if (static_cast<int64_t>(wout.size()) < ne - 1) wout.resize(ne - 1);
    linspace_i64(0.0, static_cast<double>(se - ss), ne + 1, ps.data());
    if (raw_window_dp_one(norm + ss, means + s, sds + s, ps.data(), ne,
                          raw_min_obs, winsorize, max_half_z, wout.data()))
      return 4;
    for (int64_t i = s + 1; i < e; ++i) segs[i] = wout[i - s - 1] + ss;
  }
  for (int64_t i = 0; i < seq_len; ++i)
    if (segs[i + 1] - segs[i] < 1) return 5;
  if (segs[0] < 0) return 6;
  if (segs[seq_len] > norm_len) return 7;
  return 0;
}

}  // namespace

extern "C" {

// Fused batch finalize for the f32 production lane, threaded across
// reads: normalize the mapped raw slice (exact same double ops as the
// python host lane: (x - shift)/scale then clip), run the raw-signal
// deletion fix where flagged, compute per-base event means (sequential
// cumulative-sum difference, bitwise-equal to ops/ref_impl.new_means),
// Theil-Sen fit (theil_sen_one, ts_mode as theil_sen_batch* variants;
// -1 skips the fit), and apply the fitted rescale to the normalized
// signal ((x - shift_corr)/scale_corr, same two ops as python).
// Outputs: norm_out (rescaled normalized mapped slice, raw layout),
// ev_out (PRE-rescale per-base means, lvl layout; callers derive the
// signal-match score from these to keep numpy reduction semantics),
// slopes/inters, and per-read status (del_fix_one codes; 100 = fit
// produced slope 0).  has_del: 1 = run fix, 0 = skip, -1 = detect here.
void finalize_batch(const double* raw, const int64_t* raw_off,
                    const double* shift, const double* scale,
                    const double* lower, const double* upper,
                    const double* means, const double* sds,
                    const int64_t* lvl_off, int64_t* segs,
                    const int64_t* segs_off, const int32_t* has_del,
                    const int32_t* ts_samp, const int64_t* samp_off,
                    int64_t n_reads, int64_t raw_min_obs, int winsorize,
                    double max_half_z, int64_t del_fix_window,
                    int64_t max_del_fix_window, double extra_sig_factor,
                    int64_t max_raw_cpts, double max_slope, int ts_mode,
                    double* norm_out, double* ev_out, double* out_slopes,
                    double* out_inters, int32_t* status,
                    int64_t n_threads) {
  if (n_threads <= 0) {
    n_threads = static_cast<int64_t>(std::thread::hardware_concurrency());
    if (n_threads <= 0) n_threads = 1;
  }
  n_threads = std::min<int64_t>(n_threads, n_reads);
  std::atomic<int64_t> next(0);
  auto worker = [&]() {
    thread_local std::vector<double> cs;
    thread_local std::vector<double> ev_s, mod_s;
    for (;;) {
      const int64_t r = next.fetch_add(1);
      if (r >= n_reads) return;
      const int64_t S = raw_off[r + 1] - raw_off[r];
      const int64_t L = lvl_off[r + 1] - lvl_off[r];
      const double* rr = raw + raw_off[r];
      double* nn = norm_out + raw_off[r];
      const double sh = shift[r], sc = scale[r];
      const double lo = lower[r], hi = upper[r];
      const bool clip = std::isfinite(lo) && std::isfinite(hi);
      for (int64_t i = 0; i < S; ++i) {
        double v = (rr[i] - sh) / sc;
        if (clip) v = std::min(std::max(v, lo), hi);
        nn[i] = v;
      }
      int64_t* rsegs = segs + segs_off[r];
      status[r] = 0;
      bool need_fix = has_del[r] == 1;
      if (has_del[r] < 0) {
        need_fix = false;
        for (int64_t i = 0; i < L && !need_fix; ++i)
          need_fix = rsegs[i + 1] == rsegs[i];
      }
      if (need_fix) {
        status[r] = static_cast<int32_t>(del_fix_one(
            nn, S, means + lvl_off[r], sds + lvl_off[r], L, rsegs,
            raw_min_obs, winsorize, max_half_z, del_fix_window,
            max_del_fix_window, extra_sig_factor, max_raw_cpts));
        if (status[r] != 0) continue;
      }
      // per-base means: cumulative-sum difference, sequential order
      if (static_cast<int64_t>(cs.size()) < S + 1)
        cs.resize(static_cast<size_t>(S + 1));
      cs[0] = 0.0;
      double acc = 0.0;
      for (int64_t i = 0; i < S; ++i) {
        acc += nn[i];
        cs[static_cast<size_t>(i + 1)] = acc;
      }
      double* ev = ev_out + lvl_off[r];
      for (int64_t i = 0; i < L; ++i) {
        const int64_t a = rsegs[i], b = rsegs[i + 1];
        ev[i] = (cs[static_cast<size_t>(b)] - cs[static_cast<size_t>(a)]) /
                static_cast<double>(b - a);
      }
      if (ts_mode < 0) {
        out_slopes[r] = 1.0;
        out_inters[r] = 0.0;
        continue;
      }
      const int64_t k = samp_off[r + 1] - samp_off[r];
      const double* fit_ev = ev;
      const double* fit_mod = means + lvl_off[r];
      int64_t fit_n = L;
      if (k > 0) {
        if (static_cast<int64_t>(ev_s.size()) < k) {
          ev_s.resize(static_cast<size_t>(k));
          mod_s.resize(static_cast<size_t>(k));
        }
        const int32_t* si = ts_samp + samp_off[r];
        for (int64_t i = 0; i < k; ++i) {
          ev_s[static_cast<size_t>(i)] = ev[si[i]];
          mod_s[static_cast<size_t>(i)] = means[lvl_off[r] + si[i]];
        }
        fit_ev = ev_s.data();
        fit_mod = mod_s.data();
        fit_n = k;
      }
      double slope, inter;
      theil_sen_one(fit_ev, fit_mod, fit_n, max_slope, &slope, &inter,
                    ts_mode);
      out_slopes[r] = slope;
      out_inters[r] = inter;
      if (slope == 0.0) {
        status[r] = 100;
        continue;
      }
      const double scale_corr = 1.0 / slope;
      const double shift_corr = -inter / slope;
      for (int64_t i = 0; i < S; ++i)
        nn[i] = (nn[i] - shift_corr) / scale_corr;
    }
  };
  std::vector<std::thread> threads;
  for (int64_t t = 0; t < n_threads; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
}

// Full deletion fix over a batch of reads, threaded across reads.
// Concatenated layout: read r has normalized signal
// norm[norm_off[r]:norm_off[r+1]], seq_len = lvl_off[r+1]-lvl_off[r]
// expected levels at lvl_off[r], and seq_len+1 segment boundaries at
// segs_off[r] (updated in place).  Per-read status as in del_fix_one.
void del_fix_batch(const double* norm, const int64_t* norm_off,
                   const double* means, const double* sds,
                   const int64_t* lvl_off, int64_t* segs,
                   const int64_t* segs_off, int64_t n_reads,
                   int64_t raw_min_obs, int winsorize, double max_half_z,
                   int64_t del_fix_window, int64_t max_del_fix_window,
                   double extra_sig_factor, int64_t max_raw_cpts,
                   int32_t* status, int64_t n_threads) {
  if (n_threads <= 0) {
    n_threads = static_cast<int64_t>(std::thread::hardware_concurrency());
    if (n_threads <= 0) n_threads = 1;
  }
  n_threads = std::min<int64_t>(n_threads, n_reads);
  std::atomic<int64_t> next(0);
  auto worker = [&]() {
    for (;;) {
      const int64_t r = next.fetch_add(1);
      if (r >= n_reads) return;
      const int64_t seq_len = lvl_off[r + 1] - lvl_off[r];
      status[r] = static_cast<int32_t>(del_fix_one(
          norm + norm_off[r], norm_off[r + 1] - norm_off[r],
          means + lvl_off[r], sds + lvl_off[r], seq_len, segs + segs_off[r],
          raw_min_obs, winsorize, max_half_z, del_fix_window,
          max_del_fix_window, extra_sig_factor, max_raw_cpts));
    }
  };
  std::vector<std::thread> threads;
  for (int64_t t = 0; t < n_threads; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
}

// Batched deletion-window DP, threaded across windows.
//
// Concatenated layout: window w has signal sig[sig_off[w]:sig_off[w+1]],
// n_events[w] bases with means/sds at ev_off[w], pseudo starts (n_events+1
// values, relative to the window signal) at ps_off[w], and writes
// n_events[w]-1 boundaries (relative to the window signal) at out_off[w].
void raw_windows_dp_batch(const double* sig, const int64_t* sig_off,
                          const double* means, const double* sds,
                          const int64_t* ev_off, const int64_t* ps,
                          const int64_t* ps_off, int64_t n_windows,
                          int64_t min_obs, int winsorize, double max_half_z,
                          int64_t* out, const int64_t* out_off,
                          int32_t* status, int64_t n_threads) {
  if (n_threads <= 0) {
    n_threads = static_cast<int64_t>(std::thread::hardware_concurrency());
    if (n_threads <= 0) n_threads = 1;
  }
  n_threads = std::min<int64_t>(n_threads, n_windows);
  std::atomic<int64_t> next(0);
  auto worker = [&]() {
    for (;;) {
      const int64_t w = next.fetch_add(1);
      if (w >= n_windows) return;
      const int64_t n_ev = ps_off[w + 1] - ps_off[w] - 1;
      status[w] = static_cast<int32_t>(raw_window_dp_one(
          sig + sig_off[w], means + ev_off[w], sds + ev_off[w],
          ps + ps_off[w], n_ev, min_obs, winsorize, max_half_z,
          out + out_off[w]));
    }
  };
  std::vector<std::thread> threads;
  for (int64_t t = 0; t < n_threads; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
}

}  // extern "C"

namespace {

// One band row of the static-band DP, mirroring the float64 oracle's
// max-plus formulation (tombo_tpu/ops/ref_impl.py process_band_row) op for
// op so results are bit-identical to the numpy path: c = prefix sum of the
// stay increments, u = d - c with u[0] = first_val, fwd = c + cummax(u).
void static_band_row(const double* prev_fwd, const double* sz, int64_t bw,
                     double first_val, int8_t first_move, double stay_pen,
                     double skip_pen, int64_t diff, double* fwd,
                     int8_t* moves, double* diag, double* skip, double* c) {
  const double neg_inf = -std::numeric_limits<double>::infinity();
  for (int64_t p = 0; p < bw; ++p) {
    const int64_t dpos = p + diff - 1;
    diag[p] = ((dpos >= 0 && dpos < bw) ? prev_fwd[dpos] : neg_inf) + sz[p];
    const int64_t spos = p + diff;
    skip[p] = ((spos < bw) ? prev_fwd[spos] : neg_inf) - skip_pen;
  }
  c[0] = 0.0;
  for (int64_t p = 1; p < bw; ++p) c[p] = c[p - 1] + (sz[p] - stay_pen);
  // fwd[0] pre-reassert is 0.0 + first_val (what the oracle's stay_score
  // reads); the exported fwd[0] is first_val itself (oracle line 271)
  const double fwd0_pre = 0.0 + first_val;
  double run = first_val;
  double fwd_prev = fwd0_pre;
  fwd[0] = first_val;
  moves[0] = first_move;
  for (int64_t p = 1; p < bw; ++p) {
    const double d = diag[p] > skip[p] ? diag[p] : skip[p];
    const double u = d - c[p];
    if (u > run) run = u;
    const double f = c[p] + run;
    const double stay_s = fwd_prev - stay_pen + sz[p];
    int8_t m = 0;
    if (diag[p] > stay_s) m = 2;
    const double best_sd = stay_s > diag[p] ? stay_s : diag[p];
    if (skip[p] > best_sd) m = 1;
    moves[p] = m;
    fwd[p] = f;
    fwd_prev = f;
  }
}

}  // namespace

extern "C" {

// Short-read static-band base assignment: band plan + per-row winsorized
// z-scores + static-band DP + traceback in one native call (reference:
// tombo/resquiggle.py:547-600 ``find_static_base_assignment``,
// tombo/_c_dynamic_programming.pyx:240 ``c_banded_forward_pass`` and :281
// ``c_banded_traceback``).  Bit-identical to the float64 numpy oracle path
// in pipeline/resquiggle.py + ops/ref_impl.py (verified by
// tests/test_native.py).  Writes seq_len + 1 event boundaries to ``out``.
// Returns 0 on success, 1 on degenerate shapes.
int static_base_assignment(const double* event_means, int64_t events_len,
                           const double* ref_means, const double* ref_sds,
                           int64_t seq_len, double z_shift, double skip_pen,
                           double stay_pen, int winsorize, double max_half_z,
                           int64_t* out) {
  const int64_t mask_len = std::min(seq_len, events_len) / 4;
  const int64_t bw = events_len - mask_len;
  if (seq_len <= 0 || bw <= 0) return 1;

  std::vector<int64_t> starts(seq_len, 0);
  const int64_t n_ramp = mask_len * 2;
  if (n_ramp > 0)
    linspace_i64(0.0, static_cast<double>(mask_len), n_ramp,
                 starts.data() + (seq_len - n_ramp));

  std::vector<double> fwd_prev(bw, 0.0), fwd_cur(bw), sz(bw);
  std::vector<double> diag(bw), skip(bw), c(bw);
  std::vector<int8_t> tb(static_cast<size_t>(seq_len + 1) * bw, 0);

  for (int64_t row = 0; row < seq_len; ++row) {
    const int64_t start = starts[row];
    const double m = ref_means[row], sd = ref_sds[row];
    for (int64_t p = 0; p < bw; ++p) {
      double z = std::fabs((event_means[start + p] - m) / sd);
      if (winsorize && z > max_half_z) z = max_half_z;
      sz[p] = z_shift - z;
    }
    const int64_t diff = row > 0 ? starts[row] - starts[row - 1] : 0;
    double first_val;
    int8_t first_move;
    if (diff == 0) {
      first_val = fwd_prev[0] - skip_pen;
      first_move = 1;
    } else {
      first_val = fwd_prev[diff - 1] + sz[0];
      first_move = 2;
    }
    static_band_row(fwd_prev.data(), sz.data(), bw, first_val, first_move,
                    stay_pen, skip_pen, diff, fwd_cur.data(),
                    tb.data() + static_cast<size_t>(row + 1) * bw,
                    diag.data(), skip.data(), c.data());
    fwd_prev.swap(fwd_cur);
  }

  // argmax of the final forward row (first maximal index, as np.argmax)
  int64_t band_pos = 0;
  for (int64_t p = 1; p < bw; ++p)
    if (fwd_prev[p] > fwd_prev[band_pos]) band_pos = p;

  // traceback (ops/ref_impl.py banded_traceback, no boundary check)
  int64_t curr_event_pos = band_pos + starts[seq_len - 1];
  out[seq_len] = curr_event_pos + 1;
  for (int64_t seq = seq_len; seq > 0; --seq) {
    int64_t bp = curr_event_pos - starts[seq - 1];
    const int8_t* row_tb = tb.data() + static_cast<size_t>(seq) * bw;
    while (bp > 0 && row_tb[bp] == 0) --bp;
    if (row_tb[bp] == 2) --bp;
    curr_event_pos = starts[seq - 1] + bp;
    out[seq - 1] = curr_event_pos + 1;
  }
  return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Wire packing: int8-delta encoding of int16 raw signal rows
// (pipeline/batch.py seg_pack; the per-read numpy diff/clip/escape loop was
// ~0.25 ms/read of host time on the hot path — one threaded pass here).
// ---------------------------------------------------------------------------
extern "C" {

// raws: per-read pointers to int16 sample buffers; lens: sample counts.
// offs[i] (precomputed by the caller): destination of read i's deltas in
// flat8 (d8 length == lens[i]-1; offs is their exclusive prefix sum).
// Escapes (|delta| > 127) emit (read, pos, residual) triples into the
// shared buffers, claimed per read with an atomic cursor; n_exc_out
// reports the total written, and a total beyond exc_cap leaves the
// overflow marked so the caller can retry with a larger buffer.
void pack_delta8_batch(const int16_t** raws, const int64_t* lens,
                       int64_t n_reads, const int64_t* offs, int8_t* flat8,
                       int16_t* firsts, int32_t* exc_read, int32_t* exc_pos,
                       int32_t* exc_res, int64_t exc_cap,
                       int64_t* n_exc_out, int64_t n_threads) {
  if (n_threads <= 0) {
    n_threads = static_cast<int64_t>(std::thread::hardware_concurrency());
    if (n_threads <= 0) n_threads = 1;
  }
  n_threads = std::min<int64_t>(n_threads, std::max<int64_t>(n_reads, 1));
  std::atomic<int64_t> next{0};
  std::atomic<int64_t> exc_cursor{0};
  auto worker = [&]() {
    std::vector<int32_t> epos_local;
    std::vector<int32_t> eres_local;
    for (;;) {
      int64_t i = next.fetch_add(1);
      if (i >= n_reads) break;
      const int16_t* x = raws[i];
      int64_t n = lens[i];
      firsts[i] = n > 0 ? x[0] : 0;
      if (n <= 1) continue;
      int8_t* dst = flat8 + offs[i];
      epos_local.clear();
      eres_local.clear();
      for (int64_t j = 1; j < n; ++j) {
        int32_t d = static_cast<int32_t>(x[j]) - static_cast<int32_t>(x[j - 1]);
        int32_t c = d < -128 ? -128 : (d > 127 ? 127 : d);
        dst[j - 1] = static_cast<int8_t>(c);
        if (d != c) {
          epos_local.push_back(static_cast<int32_t>(j - 1));
          eres_local.push_back(d - c);
        }
      }
      if (!epos_local.empty()) {
        int64_t k = exc_cursor.fetch_add(
            static_cast<int64_t>(epos_local.size()));
        for (size_t e = 0; e < epos_local.size(); ++e) {
          if (k + static_cast<int64_t>(e) >= exc_cap) break;
          exc_read[k + e] = static_cast<int32_t>(i);
          exc_pos[k + e] = epos_local[e];
          exc_res[k + e] = eres_local[e];
        }
      }
    }
  };
  std::vector<std::thread> threads;
  threads.reserve(static_cast<size_t>(n_threads));
  for (int64_t t = 0; t < n_threads; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  *n_exc_out = exc_cursor.load();
}

}  // extern "C"
