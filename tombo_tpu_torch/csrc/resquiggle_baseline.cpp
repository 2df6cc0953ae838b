// Single-core end-to-end re-squiggle: the honest CPU baseline.
//
// The reference's hot path is compiled Cython/C++ (the adaptive banded DP,
// tombo/_c_dynamic_programming.pyx:202-412, is ">60% of time"), so a fair
// per-chip speedup denominator must be a compiled single-core pipeline, not
// a numpy loop.  This file implements the complete DNA re-squiggle for one
// read — normalize -> changepoint detection -> event means -> start
// discovery -> masked-start adaptive banded DP -> traceback -> raw-signal
// deletion fix -> Theil-Sen sequence-fitted rescaling (<=3 iterations) —
// with the same sequential inner loops the reference uses
// (reference: tombo/resquiggle.py:1122-1214 resquiggle_read and the kernels
// it drives).  bench.py times this on one core as vs_baseline's denominator;
// tests assert it produces the same segments as the Python/numpy path.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

extern "C" {
// from tombo_native.cpp
int greedy_cpts(const double* scores, int64_t n_cands, int64_t min_base_obs,
                int64_t num_cpts, int64_t* out);
void theil_sen_batch(const double* ev, const double* mod, int64_t batch,
                     int64_t max_n, const int64_t* n_points,
                     double max_slope, double* out_slopes,
                     double* out_inters, int64_t n_threads);
void raw_windows_dp_batch(const double* sig, const int64_t* sig_off,
                          const double* means, const double* sds,
                          const int64_t* ev_off, const int64_t* ps,
                          const int64_t* ps_off, int64_t n_windows,
                          int64_t min_obs, int winsorize, double max_half_z,
                          int64_t* out, const int64_t* out_off,
                          int32_t* status, int64_t n_threads);
}

namespace {

// numpy-compatible median (averages the two middle values for even n)
double median_inplace(std::vector<double>& v) {
  const size_t n = v.size();
  const size_t m = n / 2;
  std::nth_element(v.begin(), v.begin() + m, v.end());
  double hi = v[m];
  if (n % 2 == 0) {
    std::nth_element(v.begin(), v.begin() + m - 1, v.begin() + m);
    return (hi + v[m - 1]) / 2.0;
  }
  return hi;
}

// numpy linspace(a, b, n).astype(int64): final element exactly b
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

struct DpScalars {
  double z_shift, skip_pen, stay_pen, max_half_z;  // max_half_z < 0: off
  double mask_fill;
};

// one band row: stay/diag/skip recurrence.  Implemented as the same
// max-plus prefix scan the package's numpy oracle and device kernels use
// (ops/ref_impl.py process_band_row) so fwd scores round identically and
// the baseline's tracebacks match the TPU pipeline bit for bit:
//   fwd[p] = c[p] + cummax(u)[p],  c = prefix-sum of (z - stay_pen)
//   (c[0] = 0),  u[p] = max(diag, skip)[p] - c[p],  u[0] = first_val
// (reference recurrence: tombo/_c_dynamic_programming.pyx:202-236)
void process_band_row(const double* prev_fwd, const double* z,
                      double first_val, int8_t first_move, int64_t diff,
                      int64_t bw, double stay_pen, double skip_pen,
                      double* fwd, int8_t* tb) {
  constexpr double kNegInf = -std::numeric_limits<double>::infinity();
  double c = 0.0;
  double run = first_val;
  fwd[0] = first_val;
  tb[0] = first_move;
  for (int64_t p = 1; p < bw; ++p) {
    const int64_t prev_b_pos = p + diff;
    const double diag =
        prev_b_pos - 1 < bw ? prev_fwd[prev_b_pos - 1] + z[p] : kNegInf;
    const double skip =
        prev_b_pos < bw ? prev_fwd[prev_b_pos] - skip_pen : kNegInf;
    const double d = std::max(diag, skip);
    c += z[p] - stay_pen;
    const double u = d - c;
    if (u > run) run = u;
    fwd[p] = c + run;
    // move codes recomputed from the final fwd row, matching the oracle's
    // priority chain (stay wins ties, then diag; skip needs strict >)
    const double stay = fwd[p - 1] - stay_pen + z[p];
    int8_t mv = 0;
    if (diag > stay) mv = 2;
    if (skip > std::max(stay, diag)) mv = 1;
    tb[p] = mv;
  }
}

int64_t argmax_first(const double* v, int64_t n) {
  int64_t best = 0;
  for (int64_t i = 1; i < n; ++i)
    if (v[i] > v[best]) best = i;
  return best;
}

// static-band DP + traceback (reference: pyx:240-310); tb matrix row r
// corresponds to forward row r+1.
// Returns false on traceback boundary failure.
bool banded_dp_traceback(const std::vector<double>& zmat, int64_t n_rows,
                         int64_t bw, const int64_t* starts, double skip_pen,
                         double stay_pen, int64_t bound_thresh,
                         int64_t* seq_poss /* n_rows + 1 */) {
  std::vector<double> fwd_a(bw, 0.0), fwd_b(bw);
  std::vector<int8_t> tb(static_cast<size_t>(n_rows) * bw);
  double* prev = fwd_a.data();
  double* curr = fwd_b.data();
  for (int64_t r = 0; r < n_rows; ++r) {
    const int64_t diff = r > 0 ? starts[r] - starts[r - 1] : 0;
    const double* z = zmat.data() + r * bw;
    double first_val;
    int8_t first_move;
    if (diff == 0) {
      first_val = prev[0] - skip_pen;
      first_move = 1;
    } else {
      first_val = prev[diff - 1] + z[0];
      first_move = 2;
    }
    process_band_row(prev, z, first_val, first_move, diff, bw, stay_pen,
                     skip_pen, curr, tb.data() + r * bw);
    std::swap(prev, curr);
  }
  // prev now holds the final forward row
  int64_t band_pos = argmax_first(prev, bw);
  int64_t curr_event_pos = band_pos + starts[n_rows - 1];
  seq_poss[n_rows] = curr_event_pos + 1;
  for (int64_t r = n_rows; r > 0; --r) {
    band_pos = curr_event_pos - starts[r - 1];
    const int8_t* row = tb.data() + (r - 1) * bw;
    while (row[band_pos] == 0) --band_pos;
    if (row[band_pos] == 2) --band_pos;
    if (bound_thresh >= 0 &&
        std::min(band_pos, bw - band_pos - 1) < bound_thresh)
      return false;
    curr_event_pos = starts[r - 1] + band_pos;
    seq_poss[r - 1] = curr_event_pos + 1;
  }
  return true;
}

void band_z_row(const double* em, int64_t n_events, int64_t start,
                double mu, double sd, int64_t bw, const DpScalars& s,
                double* out) {
  const int64_t n_valid = std::min(bw, n_events - start);
  for (int64_t j = 0; j < n_valid; ++j) {
    double z = std::fabs((em[start + j] - mu) / sd);
    if (s.max_half_z > 0 && z > s.max_half_z) z = s.max_half_z;
    out[j] = s.z_shift - z;
  }
  for (int64_t j = std::max<int64_t>(n_valid, 0); j < bw; ++j)
    out[j] = s.mask_fill;
}

// start discovery score (reference: tombo/tombo_stats.py:2341-2362
// score_valid_bases): mean half z over non-duplicated traceback bases
double score_valid_bases(const int64_t* read_tb, int64_t n_rows,
                         const double* em, const double* rm,
                         const double* rs) {
  double total = 0.0;
  int64_t n_valid = 0;
  for (int64_t i = 0; i < n_rows; ++i) {
    const int64_t s0 = read_tb[i], s1 = read_tb[i + 1];
    if (s0 == s1) continue;
    double acc = 0.0;
    for (int64_t j = s0; j < s1; ++j) acc += em[j];
    const double bm = acc / static_cast<double>(s1 - s0);
    total += std::fabs((bm - rm[i]) / rs[i]);
    ++n_valid;
  }
  if (n_valid == 0) return 1e30;
  return total / static_cast<double>(n_valid);
}

}  // namespace

extern "C" {

int resquiggle_read_baseline_dbg(
    const double* raw, int64_t sig_len, const double* ref_means,
    const double* ref_sds, int64_t seq_len, const int64_t* iparams,
    const double* dparams, int64_t* segs_out, int64_t* rsrtr_out,
    double* scale_out, double* score_out, int64_t* dbg_i, double* dbg_epb,
    int64_t* dbg_tb);

int resquiggle_read_baseline_impl(
    const double* raw, int64_t sig_len, const double* ref_means,
    const double* ref_sds, int64_t seq_len, const int64_t* iparams,
    const double* dparams, int rna, const int64_t* stall_s,
    const int64_t* stall_e, int64_t n_stalls, int64_t* segs_out,
    int64_t* rsrtr_out, double* scale_out, double* score_out,
    int64_t* dbg_i, double* dbg_epb, int64_t* dbg_tb);

// Error codes (python wrapper maps to messages)
//   0 ok, 1 too much signal, 2 too few changepoints, 3 read too short for
//   start discovery, 4 poor start matching, 5 open pore (events_per_base 0),
//   6 band overran events, 7 traceback beyond bandwidth, 8 deletion-fix
//   failure, 9 zero-length events after fix, 10 Theil-Sen failed,
//   11 masked-plan failure (read starts too far into events)
//
// iparams: [bandwidth, start_bw, start_save_bw, start_n_bases,
//           running_stat_width, min_obs_per_base, mean_obs_per_event,
//           raw_min_obs_per_base, band_bound_thresh, mask_bases,
//           del_fix_window, max_del_fix_window, max_raw_cpts,
//           max_scaling_iters, max_points_theil_sen]
// dparams: [z_shift, skip_pen, stay_pen, max_half_z(<0 off), outlier_thresh,
//           sig_match_thresh, mask_fill_z, min_event_to_seq_ratio,
//           extra_sig_factor, shift_change_thresh, scale_change_thresh]
int resquiggle_read_baseline(
    const double* raw, int64_t sig_len, const double* ref_means,
    const double* ref_sds, int64_t seq_len, const int64_t* iparams,
    const double* dparams, int64_t* segs_out /* seq_len + 1 */,
    int64_t* rsrtr_out, double* scale_out /* shift scale lower upper */,
    double* score_out) {
  return resquiggle_read_baseline_dbg(
      raw, sig_len, ref_means, ref_sds, seq_len, iparams, dparams, segs_out,
      rsrtr_out, scale_out, score_out, nullptr, nullptr, nullptr);
}

// RNA lane (reference: tombo/resquiggle.py:1057-1120 RNA branches of
// segment_signal): t-test changepoint scores on the RAW signal, stall
// changepoints removed, event-based MAD scaling with absolute winsorize
// limits; the DP/traceback/fix/rescale machinery is shared with DNA.
int resquiggle_read_baseline_rna(
    const double* raw, int64_t sig_len, const double* ref_means,
    const double* ref_sds, int64_t seq_len, const int64_t* stall_s,
    const int64_t* stall_e, int64_t n_stalls, const int64_t* iparams,
    const double* dparams, int64_t* segs_out, int64_t* rsrtr_out,
    double* scale_out, double* score_out) {
  return resquiggle_read_baseline_impl(
      raw, sig_len, ref_means, ref_sds, seq_len, iparams, dparams, 1,
      stall_s, stall_e, n_stalls, segs_out, rsrtr_out, scale_out, score_out,
      nullptr, nullptr, nullptr);
}

int resquiggle_read_baseline_dbg(
    const double* raw, int64_t sig_len, const double* ref_means,
    const double* ref_sds, int64_t seq_len, const int64_t* iparams,
    const double* dparams, int64_t* segs_out, int64_t* rsrtr_out,
    double* scale_out, double* score_out, int64_t* dbg_i, double* dbg_epb,
    int64_t* dbg_tb) {
  return resquiggle_read_baseline_impl(
      raw, sig_len, ref_means, ref_sds, seq_len, iparams, dparams, 0,
      nullptr, nullptr, 0, segs_out, rsrtr_out, scale_out, score_out,
      dbg_i, dbg_epb, dbg_tb);
}

// Full implementation.  When non-null, dbg_i receives [num_events,
// mapped_start, events_start_clip, mapped_start_offset, mask_seq_len,
// n_ev_c] and dbg_epb the events-per-base estimate; dbg_tb the pre-trim
// traceback (seq_len + 1 entries).  All from the FIRST scaling iteration.
int resquiggle_read_baseline_impl(
    const double* raw, int64_t sig_len, const double* ref_means,
    const double* ref_sds, int64_t seq_len, const int64_t* iparams,
    const double* dparams, int rna, const int64_t* stall_s,
    const int64_t* stall_e, int64_t n_stalls,
    int64_t* segs_out /* seq_len + 1 */,
    int64_t* rsrtr_out, double* scale_out /* shift scale lower upper */,
    double* score_out, int64_t* dbg_i, double* dbg_epb, int64_t* dbg_tb) {
  const int64_t bandwidth = iparams[0], start_bw = iparams[1],
                start_save_bw = iparams[2], start_n_bases = iparams[3],
                rsw = iparams[4], min_obs = iparams[5],
                mean_obs_per_event = iparams[6], raw_min_obs = iparams[7],
                bound_thresh = iparams[8], mask_bases = iparams[9],
                del_fix_window = iparams[10], max_del_fix_window = iparams[11],
                max_raw_cpts = iparams[12], max_scaling_iters = iparams[13],
                max_ts_points = iparams[14];
  const double z_shift = dparams[0], skip_pen = dparams[1],
               stay_pen = dparams[2], max_half_z = dparams[3],
               outlier_thresh = dparams[4], sig_match_thresh = dparams[5],
               mask_fill = dparams[6], min_ev_seq_ratio = dparams[7],
               extra_sig_factor = dparams[8], shift_thresh = dparams[9],
               scale_thresh = dparams[10];
  const DpScalars dps{z_shift, skip_pen, stay_pen, max_half_z, mask_fill};

  // reference: tombo/tombo_stats.py:1558 compute_num_events
  const int64_t num_events = std::max<int64_t>(
      sig_len / mean_obs_per_event,
      static_cast<int64_t>(static_cast<double>(seq_len) * min_ev_seq_ratio));
  if (static_cast<double>(num_events) / static_cast<double>(bandwidth) >
      static_cast<double>(seq_len))
    return 1;
  if (dbg_i) dbg_i[0] = num_events;

  bool have_sv = false;
  double sv_shift = 0.0, sv_scale = 1.0, sv_lower = 0.0, sv_upper = 0.0;
  std::vector<double> norm(static_cast<size_t>(sig_len));
  std::vector<double> scratch;
  std::vector<int64_t> cpts(static_cast<size_t>(num_events));
  std::vector<double> em(static_cast<size_t>(num_events) - 1);
  std::vector<int64_t> read_tb;
  std::vector<int64_t> segs(static_cast<size_t>(seq_len) + 1);
  double final_score = 0.0;

  for (int64_t iter = 0; iter < max_scaling_iters; ++iter) {
    int64_t n_cpts = num_events;
    if (rna) {
      // --- RNA: t-test changepoint scores on the RAW signal
      // (reference: tombo/_c_helper.pyx:144-179), then stall-interval
      // removal and event-based MAD scaling
      // (tombo/resquiggle.py:1057-1090, tombo/tombo_stats.py:217-233)
      const int64_t n_cands = sig_len - 2 * rsw;
      if (n_cands < num_events) return 2;
      std::vector<double> cs(static_cast<size_t>(sig_len) + 1, 0.0);
      std::vector<double> cs2(static_cast<size_t>(sig_len) + 1, 0.0);
      for (int64_t i = 0; i < sig_len; ++i) {
        cs[i + 1] = cs[i] + raw[i];
        cs2[i + 1] = cs2[i] + raw[i] * raw[i];
      }
      std::vector<double> scores(static_cast<size_t>(n_cands));
      const double w = static_cast<double>(rsw);
      for (int64_t i = 0; i < n_cands; ++i) {
        const double s1 = cs[i + rsw] - cs[i];
        const double q1 = cs2[i + rsw] - cs2[i];
        const double s2 = cs[i + 2 * rsw] - cs[i + rsw];
        const double q2 = cs2[i + 2 * rsw] - cs2[i + rsw];
        const double ss1 = q1 - (s1 * s1) / w;
        const double ss2 = q2 - (s2 * s2) / w;
        const double denom = ss1 + ss2;
        scores[i] = denom > 0.0
                        ? std::fabs(s1 / w - s2 / w) / std::sqrt(denom)
                        : 0.0;
      }
      if (greedy_cpts(scores.data(), n_cands, min_obs, num_events,
                      cpts.data()) != 0)
        return 2;
      std::sort(cpts.begin(), cpts.begin() + num_events);
      for (int64_t i = 0; i < num_events; ++i) cpts[i] += rsw;
      // drop changepoints strictly inside stall intervals
      // (reference: tombo/tombo_stats.py:1576-1597)
      if (n_stalls > 0) {
        int64_t out = 0;
        for (int64_t i = 0; i < num_events; ++i) {
          bool keep = true;
          for (int64_t k = 0; k < n_stalls; ++k) {
            if (cpts[i] > stall_s[k] && cpts[i] < stall_e[k]) {
              keep = false;
              break;
            }
          }
          if (keep) cpts[out++] = cpts[i];
        }
        n_cpts = out;
      }
      if (n_cpts < 2) return 2;
      if (!have_sv) {
        // event-based scale: median/MAD of raw event means over the
        // first min(10000, 0.75*n) events (RNA_SCALE_* constants)
        int64_t n_scale = n_cpts;
        const double frac = 0.75 * static_cast<double>(n_cpts);
        n_scale = (frac < 10000.0) ? static_cast<int64_t>(frac) : 10000;
        if (n_scale < 2) n_scale = std::min<int64_t>(2, n_cpts);
        std::vector<double> ev_means(static_cast<size_t>(n_scale) - 1);
        for (int64_t i = 0; i + 1 < n_scale; ++i)
          ev_means[i] = (cs[cpts[i + 1]] - cs[cpts[i]]) /
                        static_cast<double>(cpts[i + 1] - cpts[i]);
        scratch.assign(ev_means.begin(), ev_means.end());
        sv_shift = median_inplace(scratch);
        scratch.assign(ev_means.begin(), ev_means.end());
        for (auto& v : scratch) v = std::fabs(v - sv_shift);
        sv_scale = median_inplace(scratch);
        sv_lower = -outlier_thresh;
        sv_upper = outlier_thresh;
      }
      for (int64_t i = 0; i < sig_len; ++i)
        norm[i] = std::min(
            std::max((raw[i] - sv_shift) / sv_scale, sv_lower), sv_upper);
      scratch.resize(static_cast<size_t>(sig_len) + 1);
      scratch[0] = 0.0;
      for (int64_t i = 0; i < sig_len; ++i)
        scratch[i + 1] = scratch[i] + norm[i];
    } else {
      // --- normalize (reference: tombo/tombo_stats.py:482-573)
      if (!have_sv) {
        scratch.assign(raw, raw + sig_len);
        sv_shift = median_inplace(scratch);
        for (int64_t i = 0; i < sig_len; ++i)
          scratch[i] = std::fabs(raw[i] - sv_shift);
        sv_scale = median_inplace(scratch);
      }
      for (int64_t i = 0; i < sig_len; ++i)
        norm[i] = (raw[i] - sv_shift) / sv_scale;
      if (!have_sv) {
        scratch.assign(norm.begin(), norm.end());
        const double med = median_inplace(scratch);
        for (int64_t i = 0; i < sig_len; ++i)
          scratch[i] = std::fabs(norm[i] - med);
        const double mad = median_inplace(scratch);
        sv_lower = med - mad * outlier_thresh;
        sv_upper = med + mad * outlier_thresh;
      }
      for (int64_t i = 0; i < sig_len; ++i)
        norm[i] = std::min(std::max(norm[i], sv_lower), sv_upper);

      // --- changepoint scores + greedy selection (reference:
      // tombo/_c_helper.pyx:89-120 via the running-diff score)
      const int64_t n_cands = sig_len - 2 * rsw + 1;
      if (n_cands < num_events) return 2;
      scratch.resize(static_cast<size_t>(sig_len) + 1);
      scratch[0] = 0.0;
      for (int64_t i = 0; i < sig_len; ++i)
        scratch[i + 1] = scratch[i] + norm[i];
      std::vector<double> scores(static_cast<size_t>(n_cands));
      for (int64_t i = 0; i < n_cands; ++i)
        scores[i] = std::fabs(2.0 * scratch[rsw + i] - scratch[i] -
                              scratch[2 * rsw + i]);
      if (greedy_cpts(scores.data(), n_cands, min_obs, num_events,
                      cpts.data()) != 0)
        return 2;
      std::sort(cpts.begin(), cpts.end());
      for (auto& c : cpts) c += rsw;
    }

    // --- event means (cumsum of the normalized signal is in scratch)
    const int64_t n_ev = n_cpts - 1;
    em.resize(static_cast<size_t>(n_ev));
    for (int64_t i = 0; i < n_ev; ++i)
      em[i] = (scratch[cpts[i + 1]] - scratch[cpts[i]]) /
              static_cast<double>(cpts[i + 1] - cpts[i]);

    // --- start discovery (reference: tombo/resquiggle.py:685-752)
    if (n_ev < start_bw + start_n_bases || seq_len < start_n_bases) return 3;
    int64_t mapped_start = 0;
    double events_per_base = 0.0;
    {
      std::vector<double> zmat(static_cast<size_t>(start_n_bases) * start_bw);
      std::vector<int64_t> starts(static_cast<size_t>(start_n_bases));
      std::vector<int64_t> start_tb(static_cast<size_t>(start_n_bases) + 1);
      auto run_start = [&](int64_t ne) -> bool {
        if (n_ev < ne + start_n_bases) return false;
        zmat.resize(static_cast<size_t>(start_n_bases) * ne);
        for (int64_t r = 0; r < start_n_bases; ++r) {
          starts[r] = r;
          for (int64_t j = 0; j < ne; ++j) {
            double z = std::fabs((em[r + j] - ref_means[r]) / ref_sds[r]);
            if (max_half_z > 0 && z > max_half_z) z = max_half_z;
            zmat[r * ne + j] = z_shift - z;
          }
        }
        return banded_dp_traceback(zmat, start_n_bases, ne, starts.data(),
                                   skip_pen, stay_pen, -1, start_tb.data());
      };
      if (!run_start(start_bw)) return 3;
      if (score_valid_bases(start_tb.data(), start_n_bases, em.data(),
                            ref_means, ref_sds) > sig_match_thresh) {
        // save-bandwidth retry without the score check
        // (reference: tombo/resquiggle.py:996-1006)
        if (!run_start(start_save_bw)) return 4;
      }
      mapped_start = start_tb[0];
      events_per_base =
          static_cast<double>(start_tb[start_n_bases] - start_tb[0]) /
          static_cast<double>(start_n_bases + 1);
    }
    if (events_per_base == 0.0) return 5;
    if (dbg_i && iter == 0) {
      dbg_i[1] = mapped_start;
      if (dbg_epb) *dbg_epb = events_per_base;
    }

    const int64_t half_bw = bandwidth / 2;
    int64_t events_start_clip, mapped_start_offset;
    if (mapped_start < half_bw) {
      events_start_clip = 0;
      mapped_start_offset = mapped_start;
    } else {
      events_start_clip = mapped_start - half_bw;
      mapped_start_offset = half_bw;
    }
    const int64_t n_ev_c = n_ev - events_start_clip;
    if (static_cast<int64_t>(static_cast<double>(half_bw + 1) /
                             events_per_base) >= seq_len ||
        n_ev_c - mapped_start_offset < bandwidth)
      return 3;  // short-read static fallback not exercised by the baseline
    const double* em_c = em.data() + events_start_clip;

    // --- masked start plan (reference: tombo/resquiggle.py:607-677)
    const int64_t bes_pos =
        half_bw <= mapped_start_offset ? 0 : mapped_start_offset - half_bw;
    const int64_t tmp_seq_len =
        std::max(std::max(half_bw, mask_bases),
                 static_cast<int64_t>(static_cast<double>(half_bw + 1) /
                                      events_per_base)) +
        1;
    std::vector<int64_t> bes(static_cast<size_t>(tmp_seq_len));
    linspace_i64(static_cast<double>(bes_pos),
                 static_cast<double>(bes_pos) +
                     static_cast<double>(tmp_seq_len) * events_per_base,
                 tmp_seq_len, bes.data());
    int64_t mask_seq_len = -1;
    for (int64_t i = 0; i < tmp_seq_len; ++i) {
      if (bes[i] >= mapped_start_offset) {
        mask_seq_len = std::max(mask_bases, i + 2);
        break;
      }
    }
    if (mask_seq_len < 0 || mask_seq_len > tmp_seq_len ||
        mask_seq_len > seq_len)
      return 11;
    if (dbg_i && iter == 0) {
      dbg_i[2] = events_start_clip;
      dbg_i[3] = mapped_start_offset;
      dbg_i[4] = mask_seq_len;
      dbg_i[5] = n_ev_c;
    }
    bes.resize(static_cast<size_t>(mask_seq_len));
    std::vector<int64_t> mask_start_pos(static_cast<size_t>(mask_bases));
    linspace_i64(static_cast<double>(mapped_start_offset + 1),
                 static_cast<double>(bes[mask_bases - 1] + bandwidth),
                 mask_bases, mask_start_pos.data());

    // --- prefix (masked static band) + adaptive banded DP, rolling rows,
    // full int8 move matrix (reference: pyx:240-412)
    std::vector<int8_t> tbm(static_cast<size_t>(seq_len) * bandwidth);
    std::vector<int64_t> starts(static_cast<size_t>(seq_len));
    std::vector<double> fwd_a(static_cast<size_t>(bandwidth), 0.0);
    std::vector<double> fwd_b(static_cast<size_t>(bandwidth));
    std::vector<double> zrow(static_cast<size_t>(bandwidth));
    double* prev = fwd_a.data();
    double* curr = fwd_b.data();
    bool band_overrun = false;
    for (int64_t r = 0; r < seq_len; ++r) {
      int64_t bstart;
      if (r < mask_seq_len) {
        bstart = bes[r];
      } else {
        bstart = starts[r - 1] + argmax_first(prev, bandwidth) - half_bw + 1;
        if (bstart < starts[r - 1]) bstart = starts[r - 1];
        if (bstart >= n_ev_c) {
          if (r < seq_len - 2) {
            band_overrun = true;
            break;
          }
          bstart = n_ev_c - 1;
        }
      }
      starts[r] = bstart;
      if (r < mask_seq_len) {
        // masked prefix row: window indices clipped, invalid filled
        const int64_t row_end =
            std::min(r < mask_bases ? mask_start_pos[r] : (int64_t{1} << 62),
                     n_ev_c);
        for (int64_t j = 0; j < bandwidth; ++j) {
          const int64_t ap = bstart + j;
          const int64_t cl = std::min(std::max<int64_t>(ap, 0), n_ev_c - 1);
          double z = std::fabs((em_c[cl] - ref_means[r]) / ref_sds[r]);
          if (max_half_z > 0 && z > max_half_z) z = max_half_z;
          zrow[j] = (ap < mapped_start_offset || ap >= row_end)
                        ? mask_fill
                        : z_shift - z;
        }
      } else {
        band_z_row(em_c, n_ev_c, bstart, ref_means[r], ref_sds[r], bandwidth,
                   dps, zrow.data());
      }
      const int64_t diff = r > 0 ? bstart - starts[r - 1] : 0;
      double first_val;
      int8_t first_move;
      if (diff == 0) {
        first_val = prev[0] - skip_pen;
        first_move = 1;
      } else {
        first_val = prev[diff - 1] + zrow[0];
        first_move = 2;
      }
      process_band_row(prev, zrow.data(), first_val, first_move, diff,
                       bandwidth, stay_pen, skip_pen, curr,
                       tbm.data() + r * bandwidth);
      std::swap(prev, curr);
    }
    if (band_overrun) return 6;

    // --- traceback (reference: pyx:281-310)
    read_tb.resize(static_cast<size_t>(seq_len) + 1);
    {
      int64_t band_pos = argmax_first(prev, bandwidth);
      int64_t ev_pos = band_pos + starts[seq_len - 1];
      read_tb[seq_len] = ev_pos + 1;
      for (int64_t r = seq_len; r > 0; --r) {
        band_pos = ev_pos - starts[r - 1];
        const int8_t* row = tbm.data() + (r - 1) * bandwidth;
        while (row[band_pos] == 0) --band_pos;
        if (row[band_pos] == 2) --band_pos;
        if (bound_thresh >= 0 &&
            std::min(band_pos, bandwidth - band_pos - 1) < bound_thresh)
          return 7;
        ev_pos = starts[r - 1] + band_pos;
        read_tb[r - 1] = ev_pos + 1;
      }
    }
    if (dbg_tb && iter == 0)
      std::memcpy(dbg_tb, read_tb.data(),
                  static_cast<size_t>(seq_len + 1) * sizeof(int64_t));
    // trim (reference: tombo/resquiggle.py:754-764)
    for (int64_t i = 0; i < seq_len + 1 && read_tb[i] < 0; ++i)
      read_tb[i] = 0;
    for (int64_t j = seq_len; j >= 0 && read_tb[j] > n_ev_c; --j)
      read_tb[j] = n_ev_c;

    // segs + rsrtr (reference: tombo/resquiggle.py:858-864)
    const int64_t rsrtr_abs = cpts[events_start_clip + read_tb[0]];
    for (int64_t i = 0; i <= seq_len; ++i)
      segs[i] = cpts[events_start_clip + read_tb[i]] - rsrtr_abs;
    const int64_t norm_len = segs[seq_len];

    // --- deletion fix (reference: tombo/resquiggle.py:402-540)
    {
      std::vector<std::pair<int64_t, int64_t>> wins;
      for (int64_t i = 0; i < seq_len; ++i) {
        if (segs[i + 1] != segs[i]) continue;
        if (!wins.empty() && i < wins.back().second + del_fix_window)
          wins.back().second = i + del_fix_window + 1;
        else
          wins.emplace_back(i - del_fix_window, i + del_fix_window + 1);
      }
      if (!wins.empty()) {
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
                 static_cast<double>((ne + 1) * raw_min_obs) *
                     extra_sig_factor;
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
            if (too_small(p.first, p.second)) return 8;
        }
        for (auto& p : wins)
          if (max_raw_cpts >= 0 && p.second - p.first > max_raw_cpts)
            return 8;

        // batched native raw DP over this read's windows (single thread)
        const int64_t W = static_cast<int64_t>(wins.size());
        std::vector<int64_t> sig_off(W + 1, 0), ev_off(W + 1, 0),
            ps_off(W + 1, 0), out_off(W + 1, 0);
        std::vector<double> wsig, wmeans, wsds;
        std::vector<int64_t> wps;
        for (int64_t w = 0; w < W; ++w) {
          const int64_t s = wins[w].first, e = wins[w].second;
          const int64_t ne = e - s;
          const int64_t ss = segs[s], se = segs[e];
          sig_off[w + 1] = sig_off[w] + (se - ss);
          ev_off[w + 1] = ev_off[w] + ne;
          ps_off[w + 1] = ps_off[w] + ne + 1;
          out_off[w + 1] = out_off[w] + ne - 1;
          for (int64_t i = ss; i < se; ++i)
            wsig.push_back(norm[rsrtr_abs + i]);
          for (int64_t i = s; i < e; ++i) {
            wmeans.push_back(ref_means[i]);
            wsds.push_back(ref_sds[i]);
          }
          const size_t base = wps.size();
          wps.resize(base + static_cast<size_t>(ne) + 1);
          linspace_i64(0.0, static_cast<double>(se - ss), ne + 1,
                       wps.data() + base);
        }
        std::vector<int64_t> wout(static_cast<size_t>(out_off[W]));
        std::vector<int32_t> wstatus(static_cast<size_t>(W));
        raw_windows_dp_batch(wsig.data(), sig_off.data(), wmeans.data(),
                             wsds.data(), ev_off.data(), wps.data(),
                             ps_off.data(), W, raw_min_obs,
                             max_half_z > 0 ? 1 : 0,
                             max_half_z > 0 ? max_half_z : 0.0, wout.data(),
                             out_off.data(), wstatus.data(), 1);
        for (int64_t w = 0; w < W; ++w) {
          if (wstatus[w] != 0) return 8;
          const int64_t s = wins[w].first, e = wins[w].second;
          for (int64_t i = s + 1; i < e; ++i)
            segs[i] = wout[out_off[w] + (i - s - 1)] + segs[s];
        }
        for (int64_t i = 0; i < seq_len; ++i)
          if (segs[i + 1] - segs[i] < 1) return 9;
        if (segs[0] < 0 || segs[seq_len] > norm_len) return 9;
      }
    }

    // --- Theil-Sen sequence-fitted rescaling
    // (reference: tombo/tombo_stats.py:370-450)
    double shift_corr = 0.0, scale_corr = 1.0;
    {
      int64_t n = seq_len;
      // cumsum-difference means, matching the float rounding of the numpy
      // path (ops/ref_impl.py new_means) bit for bit
      std::vector<double> cs(static_cast<size_t>(norm_len) + 1);
      cs[0] = 0.0;
      for (int64_t i = 0; i < norm_len; ++i)
        cs[i + 1] = cs[i] + norm[rsrtr_abs + i];
      std::vector<double> r_ev(static_cast<size_t>(seq_len));
      for (int64_t i = 0; i < seq_len; ++i)
        r_ev[i] = (cs[segs[i + 1]] - cs[segs[i]]) /
                  static_cast<double>(segs[i + 1] - segs[i]);
      std::vector<double> ts_ev, ts_mod;
      if (n > max_ts_points) {
        // even-stride subsample (the python path samples uniformly at
        // random with a fixed seed; identical cost profile)
        ts_ev.reserve(static_cast<size_t>(max_ts_points));
        ts_mod.reserve(static_cast<size_t>(max_ts_points));
        for (int64_t i = 0; i < max_ts_points; ++i) {
          const int64_t idx = i * n / max_ts_points;
          ts_ev.push_back(r_ev[idx]);
          ts_mod.push_back(ref_means[idx]);
        }
        n = max_ts_points;
      } else {
        ts_ev = r_ev;
        ts_mod.assign(ref_means, ref_means + seq_len);
      }
      double slope = 0.0, inter = 0.0;
      theil_sen_batch(ts_ev.data(), ts_mod.data(), 1, n, &n, 1000.0, &slope,
                      &inter, 1);
      if (slope == 0.0) return 10;
      scale_corr = 1.0 / slope;
      shift_corr = -inter / slope;
      sv_shift += shift_corr * sv_scale;
      sv_scale *= scale_corr;
      have_sv = true;

      // final score: correct the signal first, then cumsum-difference
      // means, matching the python path's rounding exactly
      cs[0] = 0.0;
      for (int64_t i = 0; i < norm_len; ++i)
        cs[i + 1] =
            cs[i] + (norm[rsrtr_abs + i] - shift_corr) / scale_corr;
      double total = 0.0;
      for (int64_t i = 0; i < seq_len; ++i) {
        const double bm = (cs[segs[i + 1]] - cs[segs[i]]) /
                          static_cast<double>(segs[i + 1] - segs[i]);
        total += std::fabs((bm - ref_means[i]) / ref_sds[i]);
      }
      final_score = total / static_cast<double>(seq_len);
    }

    const bool changed = std::fabs(shift_corr) > shift_thresh ||
                         std::fabs(scale_corr - 1.0) > scale_thresh;
    if (!changed || iter == max_scaling_iters - 1) {
      std::memcpy(segs_out, segs.data(),
                  static_cast<size_t>(seq_len + 1) * sizeof(int64_t));
      *rsrtr_out = rsrtr_abs;
      scale_out[0] = sv_shift;
      scale_out[1] = sv_scale;
      scale_out[2] = sv_lower;
      scale_out[3] = sv_upper;
      *score_out = final_score;
      return 0;
    }
  }
  return 0;  // unreachable
}

}  // extern "C"
