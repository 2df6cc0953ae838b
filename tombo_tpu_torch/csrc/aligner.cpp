// Native genomic aligner: minimizer seeding + anchor chaining + piecewise
// banded base-level alignment.
//
// The reference treats minimap2 (via mappy) as an external engine
// (reference: tombo/resquiggle.py:14-21, 2031-2032).  mappy is not
// available in this environment, so this file provides a self-contained
// equivalent sufficient for tombo-style mapping of error-prone nanopore
// basecalls: it reports the best hit's contig/strand/coordinates, a
// base-level CIGAR, match counts and a mapping quality.  The algorithm is
// the standard long-read recipe (minimizer index, gap-cost anchor
// chaining, banded global alignment between anchors); the implementation
// is original.
//
// C ABI (ctypes; see tombo_tpu/native/__init__.py):
//   aln_index_build(seq, offsets, n_seqs, k, w, max_occ) -> handle
//   aln_index_free(handle)
//   aln_map(handle, query, qlen, out_i64[10], cigar, cigar_cap) -> n_cigar
//     out_i64 = {ctg_id, r_st, r_en, q_st, q_en, strand(+1/-1), mlen,
//                blen, mapq, chain_score}; cigar entries are
//     (len << 4) | op with BAM/mappy op codes 0=M 1=I 2=D.
//     Returns -1 when no acceptable hit exists, -2 when cigar_cap is too
//     small (caller retries with a larger buffer).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <deque>
#include <vector>

namespace {

constexpr int64_t NO_HIT = -1;
constexpr int64_t CIGAR_OVERFLOW = -2;

inline int base_code(char c) {
  switch (c) {
    case 'A': case 'a': return 0;
    case 'C': case 'c': return 1;
    case 'G': case 'g': return 2;
    case 'T': case 't': case 'U': case 'u': return 3;
    default: return 4;
  }
}

// Thomas Wang's 64-bit integer mix (public domain), masked to 2k bits —
// the usual invertible scrambler that de-correlates minimizer selection
// from k-mer lexicographic order.
inline uint64_t mix64(uint64_t key, uint64_t mask) {
  key = (~key + (key << 21)) & mask;
  key = key ^ (key >> 24);
  key = ((key + (key << 3)) + (key << 8)) & mask;
  key = key ^ (key >> 14);
  key = ((key + (key << 2)) + (key << 4)) & mask;
  key = key ^ (key >> 28);
  key = (key + (key << 31)) & mask;
  return key;
}

struct Minimizer {
  uint64_t hash;
  int64_t pos;     // start position of the k-mer
  uint8_t strand;  // 0: canonical == forward, 1: canonical == rev-comp
};

// All (w,k)-minimizers of seq; k-mers containing non-ACGT are skipped,
// as are strand-ambiguous k-mers (fwd == rc).
void extract_minimizers(const char* seq, int64_t len, int k, int w,
                        std::vector<Minimizer>* out) {
  if (len < k) return;
  const uint64_t mask = (k < 32) ? ((1ULL << (2 * k)) - 1) : ~0ULL;
  uint64_t fwd = 0, rev = 0;
  int valid = 0;  // consecutive valid bases ending at i
  // ring buffer of window hashes for the monotonic min-queue
  std::deque<std::pair<uint64_t, int64_t>> q;  // (hash, kmer start)
  std::vector<uint8_t> strand_at;  // parallel map kmer start -> strand
  strand_at.assign((size_t)len, 0);
  int64_t last_emitted = -1;
  for (int64_t i = 0; i < len; ++i) {
    int c = base_code(seq[i]);
    if (c > 3) {
      valid = 0;
      fwd = rev = 0;
      q.clear();
      continue;
    }
    fwd = ((fwd << 2) | (uint64_t)c) & mask;
    rev = (rev >> 2) | ((uint64_t)(3 - c) << (2 * (k - 1)));
    ++valid;
    if (valid < k) continue;
    int64_t start = i - k + 1;
    if (fwd == rev) continue;  // strand-ambiguous
    uint8_t strand = fwd < rev ? 0 : 1;
    uint64_t h = mix64(std::min(fwd, rev), mask);
    strand_at[(size_t)start] = strand;
    while (!q.empty() && q.back().first >= h) q.pop_back();
    q.emplace_back(h, start);
    while (!q.empty() && q.front().second <= start - w) q.pop_front();
    // emit once a full window of k-mers is available
    if (start >= w - 1 && !q.empty() && q.front().second != last_emitted) {
      last_emitted = q.front().second;
      out->push_back({q.front().first, last_emitted,
                      strand_at[(size_t)last_emitted]});
    }
  }
}

struct AlnIndex {
  std::vector<char> seq;          // concatenated contigs
  std::vector<int64_t> offsets;   // n_seqs + 1
  int k, w;
  // minimizers sorted by hash; bucket lookup via sorted array
  std::vector<Minimizer> mins;
  int max_occ;

  int64_t ctg_of(int64_t gpos) const {
    return (int64_t)(std::upper_bound(offsets.begin(), offsets.end(), gpos) -
                     offsets.begin()) - 1;
  }
};

struct Anchor {
  int64_t rpos, qpos;
};

struct Chain {
  double score = -1.0;
  std::vector<Anchor> anchors;  // ascending positions
  int strand = 1;               // +1 / -1 (relative to forward query)
};

// Gap-cost chaining over anchors sorted by (rpos, qpos).
// f[i] = max(k, max_j f[j] + min(dq, dr, k) - cost(dd)), lookback capped.
void chain_anchors(std::vector<Anchor>& a, int k, double* best_score,
                   double* second_score, std::vector<Anchor>* best_chain) {
  const int64_t n = (int64_t)a.size();
  *best_score = -1.0;
  *second_score = 0.0;
  if (n == 0) return;
  std::sort(a.begin(), a.end(), [](const Anchor& x, const Anchor& y) {
    return x.rpos != y.rpos ? x.rpos < y.rpos : x.qpos < y.qpos;
  });
  std::vector<double> f((size_t)n);
  std::vector<int64_t> parent((size_t)n, -1);
  const int lookback = 64;
  const int64_t max_dist = 5000, max_dd = 500;
  for (int64_t i = 0; i < n; ++i) {
    f[(size_t)i] = (double)k;
    int64_t j0 = std::max<int64_t>(0, i - lookback);
    for (int64_t j = i - 1; j >= j0; --j) {
      int64_t dr = a[(size_t)i].rpos - a[(size_t)j].rpos;
      int64_t dq = a[(size_t)i].qpos - a[(size_t)j].qpos;
      if (dq <= 0 || dr <= 0 || dq > max_dist || dr > max_dist) continue;
      int64_t dd = dr > dq ? dr - dq : dq - dr;
      if (dd > max_dd) continue;
      double gain = (double)std::min<int64_t>({dq, dr, k}) -
                    (0.12 * (double)dd +
                     (dd ? 0.5 * std::log2((double)dd + 1.0) : 0.0));
      double cand = f[(size_t)j] + gain;
      if (cand > f[(size_t)i]) {
        f[(size_t)i] = cand;
        parent[(size_t)i] = j;
      }
    }
  }
  int64_t best_i = 0;
  for (int64_t i = 1; i < n; ++i)
    if (f[(size_t)i] > f[(size_t)best_i]) best_i = i;
  *best_score = f[(size_t)best_i];
  // backtrack
  std::vector<char> in_best((size_t)n, 0);
  for (int64_t i = best_i; i >= 0; i = parent[(size_t)i]) {
    in_best[(size_t)i] = 1;
    best_chain->push_back(a[(size_t)i]);
    if (parent[(size_t)i] < 0) break;
  }
  std::reverse(best_chain->begin(), best_chain->end());
  for (int64_t i = 0; i < n; ++i)
    if (!in_best[(size_t)i] && f[(size_t)i] > *second_score)
      *second_score = f[(size_t)i];
}

// ---------------------------------------------------------------- CIGAR
struct CigarBuf {
  std::vector<uint32_t> ops;
  void push(int64_t len, int op) {
    if (len <= 0) return;
    if (!ops.empty() && (int)(ops.back() & 0xf) == op)
      ops.back() += (uint32_t)(len << 4);
    else
      ops.push_back((uint32_t)((len << 4) | op));
  }
};

// Banded alignment of q[0..m) vs r[0..n); appends the CIGAR and
// accumulates exact-match count.  Scores: match +2, mismatch -4, gap -3
// (linear).  Band spans the diagonal range [lo, hi] in d = j - i.
//
// extend == false: global (traceback from (m, n)).
// extend == true: anchored-left extension — traceback starts from the
// best-scoring cell anywhere in the matrix; *q_used / *r_used report how
// far the extension reached (soft-clip the rest).
void banded_align(const char* q, int64_t m, const char* r, int64_t n,
                  bool extend, CigarBuf* cig, int64_t* mlen,
                  int64_t* q_used, int64_t* r_used) {
  if (q_used) *q_used = extend ? 0 : m;
  if (r_used) *r_used = extend ? 0 : n;
  if (m == 0 || n == 0) {
    if (extend) return;  // nothing gained by pure-gap extension
    if (m == 0) { cig->push(n, 2); return; }
    cig->push(m, 1);
    return;
  }
  const int64_t pad = extend ? 48 : 32;
  int64_t lo = std::min<int64_t>(0, n - m) - pad;
  int64_t hi = std::max<int64_t>(0, n - m) + pad;
  lo = std::max(lo, -m);
  hi = std::min(hi, n);
  const int64_t bw = hi - lo + 1;
  const double NEG = -1e18;
  const double MATCH = 2.0, MISMATCH = -4.0, GAP = -3.0;
  std::vector<double> prev((size_t)bw, NEG), cur((size_t)bw, NEG);
  std::vector<uint8_t> moves((size_t)((m + 1) * bw), 0);  // 0 diag 1 ins 2 del
  double best_cell = 0.0;
  int64_t best_i = 0, best_j = 0;
  // row i holds scores for q[0..i) at column j = i + d, d in [lo, hi]
  for (int64_t d = lo; d <= hi; ++d)
    if (d >= 0) {
      prev[(size_t)(d - lo)] = GAP * (double)d;  // first row: all deletions
      moves[(size_t)(d - lo)] = 2;
    }
  for (int64_t i = 1; i <= m; ++i) {
    uint8_t* mrow = &moves[(size_t)(i * bw)];
    for (int64_t b = 0; b < bw; ++b) cur[(size_t)b] = NEG;
    for (int64_t d = lo; d <= hi; ++d) {
      int64_t j = i + d;
      if (j < 0 || j > n) continue;
      int64_t b = d - lo;
      double best;
      uint8_t mv;
      if (j == 0) {
        best = GAP * (double)i;  // first column: all insertions
        mv = 1;
      } else {
        // diagonal: prev row, same d
        double diag = prev[(size_t)b];
        best = diag + (base_code(q[i - 1]) == base_code(r[j - 1]) &&
                               base_code(q[i - 1]) <= 3
                           ? MATCH : MISMATCH);
        mv = 0;
        // insertion (consume q): prev row, d+1
        if (b + 1 < bw && prev[(size_t)(b + 1)] + GAP > best) {
          best = prev[(size_t)(b + 1)] + GAP;
          mv = 1;
        }
        // deletion (consume r): same row, d-1
        if (b - 1 >= 0 && cur[(size_t)(b - 1)] + GAP > best) {
          best = cur[(size_t)(b - 1)] + GAP;
          mv = 2;
        }
      }
      cur[(size_t)b] = best;
      mrow[b] = mv;
      if (extend && best > best_cell) {
        best_cell = best;
        best_i = i;
        best_j = j;
      }
    }
    std::swap(prev, cur);
  }
  // traceback: global from (m, n), extension from the best cell
  std::vector<uint32_t> rev_ops;
  int64_t i = extend ? best_i : m, j = extend ? best_j : n;
  if (q_used) *q_used = i;
  if (r_used) *r_used = j;
  auto push_rev = [&](int op) {
    if (!rev_ops.empty() && (int)(rev_ops.back() & 0xf) == op)
      rev_ops.back() += 16;
    else
      rev_ops.push_back((uint32_t)(16 | op));
  };
  while (i > 0 || j > 0) {
    int64_t d = j - i;
    if (d < lo || d > hi) break;  // defensive; cannot happen
    uint8_t mv = moves[(size_t)(i * bw + (d - lo))];
    if (i == 0) mv = 2;
    if (j == 0) mv = 1;
    if (mv == 0) {
      if (base_code(q[i - 1]) == base_code(r[j - 1]) &&
          base_code(q[i - 1]) <= 3)
        ++*mlen;
      push_rev(0);
      --i; --j;
    } else if (mv == 1) {
      push_rev(1);
      --i;
    } else {
      push_rev(2);
      --j;
    }
  }
  for (auto it = rev_ops.rbegin(); it != rev_ops.rend(); ++it)
    cig->push((int64_t)(*it >> 4), (int)(*it & 0xf));
}

char comp_base(char c) {
  switch (c) {
    case 'A': case 'a': return 'T';
    case 'C': case 'c': return 'G';
    case 'G': case 'g': return 'C';
    case 'T': case 't': case 'U': case 'u': return 'A';
    default: return 'N';
  }
}

}  // namespace

extern "C" {

void* aln_index_build(const char* seq, const int64_t* offsets, int n_seqs,
                      int k, int w, int max_occ) {
  auto* idx = new AlnIndex();
  idx->k = k;
  idx->w = w;
  idx->max_occ = max_occ;
  idx->offsets.assign(offsets, offsets + n_seqs + 1);
  idx->seq.assign(seq, seq + offsets[n_seqs]);
  // minimizers per contig (windows must not straddle contig boundaries)
  for (int s = 0; s < n_seqs; ++s) {
    std::vector<Minimizer> part;
    extract_minimizers(idx->seq.data() + offsets[s],
                       offsets[s + 1] - offsets[s], k, w, &part);
    for (auto& mz : part) mz.pos += offsets[s];
    idx->mins.insert(idx->mins.end(), part.begin(), part.end());
  }
  std::sort(idx->mins.begin(), idx->mins.end(),
            [](const Minimizer& a, const Minimizer& b) {
              return a.hash != b.hash ? a.hash < b.hash : a.pos < b.pos;
            });
  return idx;
}

void aln_index_free(void* handle) { delete (AlnIndex*)handle; }

int64_t aln_map(void* handle, const char* query, int64_t qlen,
                int64_t* out, int32_t* cigar, int64_t cigar_cap) {
  const AlnIndex& idx = *(const AlnIndex*)handle;
  const int k = idx.k;
  if (qlen < k) return NO_HIT;

  // Map the forward query and its reverse complement independently; the
  // winner's coordinates convert back to the forward-query convention
  // (mappy reports q_st/q_en on the original read).
  std::vector<char> rc((size_t)qlen);
  for (int64_t i = 0; i < qlen; ++i)
    rc[(size_t)(qlen - 1 - i)] = comp_base(query[i]);

  Chain best, second;
  double runner_up = 0.0;
  for (int pass = 0; pass < 2; ++pass) {
    const char* qseq = pass == 0 ? query : rc.data();
    std::vector<Minimizer> qmins;
    extract_minimizers(qseq, qlen, k, idx.w, &qmins);
    std::vector<Anchor> anchors;
    for (const auto& qm : qmins) {
      auto lo = std::lower_bound(
          idx.mins.begin(), idx.mins.end(), qm.hash,
          [](const Minimizer& m, uint64_t h) { return m.hash < h; });
      auto hi = lo;
      while (hi != idx.mins.end() && hi->hash == qm.hash) ++hi;
      if (hi - lo > idx.max_occ) continue;  // repeat filter
      for (auto it = lo; it != hi; ++it) {
        // a forward-pass anchor pairs same canonical strands; the rc pass
        // already flipped the query, so the same rule applies
        if (it->strand == qm.strand)
          anchors.push_back({it->pos, qm.pos});
      }
    }
    double score, second_sc;
    std::vector<Anchor> chain;
    chain_anchors(anchors, k, &score, &second_sc, &chain);
    if (score > best.score) {
      runner_up = std::max(best.score, second_sc);
      best.score = score;
      best.anchors = std::move(chain);
      best.strand = pass == 0 ? 1 : -1;
    } else {
      runner_up = std::max(runner_up, score);
      runner_up = std::max(runner_up, second_sc);
    }
  }
  // acceptance: at least 3 chained anchors or a decisive single window
  if (best.score < 2.0 * k || best.anchors.size() < 2) return NO_HIT;

  const char* qseq = best.strand > 0 ? query : rc.data();
  const std::vector<Anchor>& ch = best.anchors;
  int64_t r_st = ch.front().rpos, q_st = ch.front().qpos;
  int64_t r_en = ch.back().rpos + k, q_en = ch.back().qpos + k;

  // the chain must stay inside one contig
  int64_t ctg = idx.ctg_of(r_st);
  if (idx.ctg_of(r_en - 1) != ctg) return NO_HIT;
  int64_t ctg_st = idx.offsets[(size_t)ctg];
  int64_t ctg_en = idx.offsets[(size_t)ctg + 1];

  // greedy exact extension to the read/contig edge on both sides
  while (q_st > 0 && r_st > ctg_st &&
         base_code(qseq[q_st - 1]) <= 3 &&
         base_code(qseq[q_st - 1]) == base_code(idx.seq[(size_t)r_st - 1])) {
    --q_st; --r_st;
  }
  while (q_en < qlen && r_en < ctg_en &&
         base_code(qseq[q_en]) <= 3 &&
         base_code(qseq[q_en]) == base_code(idx.seq[(size_t)r_en])) {
    ++q_en; ++r_en;
  }

  // DP extension past the terminal anchors: minimizer deserts at noisy
  // read ends leave real alignable sequence beyond the greedy exact
  // extension (with ~12% errors the expected anchor spacing near the
  // ends is >100 bp) — recover it with anchored-left local extensions.
  int64_t q_st_g = q_st, r_st_g = r_st;  // post-greedy (exact) bounds
  int64_t q_en_g = q_en, r_en_g = r_en;
  CigarBuf head_cig, tail_cig;
  int64_t head_mlen = 0, tail_mlen = 0;
  if (q_st_g > 0 && r_st_g > ctg_st) {
    int64_t qm = q_st_g;
    int64_t rn = std::min(r_st_g - ctg_st, qm + qm / 4 + 64);
    std::vector<char> qrev((size_t)qm), rrev((size_t)rn);
    for (int64_t t = 0; t < qm; ++t) qrev[(size_t)t] = qseq[q_st_g - 1 - t];
    for (int64_t t = 0; t < rn; ++t)
      rrev[(size_t)t] = idx.seq[(size_t)(r_st_g - 1 - t)];
    int64_t qu = 0, ru = 0;
    banded_align(qrev.data(), qm, rrev.data(), rn, true, &head_cig,
                 &head_mlen, &qu, &ru);
    q_st -= qu;
    r_st -= ru;
  }
  if (q_en_g < qlen && r_en_g < ctg_en) {
    int64_t qm = qlen - q_en_g;
    int64_t rn = std::min(ctg_en - r_en_g, qm + qm / 4 + 64);
    int64_t qu = 0, ru = 0;
    banded_align(qseq + q_en_g, qm, idx.seq.data() + r_en_g, rn, true,
                 &tail_cig, &tail_mlen, &qu, &ru);
    q_en += qu;
    r_en += ru;
  }

  // piecewise alignment: exact k-mer blocks at anchors, banded global
  // alignment in between
  CigarBuf cig;
  int64_t mlen = head_mlen + tail_mlen;
  // head extension CIGAR was produced on reversed strings: emit its op
  // blocks in reverse order to express it in forward orientation
  for (auto it = head_cig.ops.rbegin(); it != head_cig.ops.rend(); ++it)
    cig.push((int64_t)(*it >> 4), (int)(*it & 0xf));
  cig.push(ch.front().qpos - q_st_g, 0);  // greedy prefix (exact matches)
  mlen += ch.front().qpos - q_st_g;
  int64_t cur_q = ch.front().qpos, cur_r = ch.front().rpos;
  for (size_t ai = 1; ai <= ch.size(); ++ai) {
    int64_t nxt_q = ai < ch.size() ? ch[ai].qpos : q_en_g;
    int64_t nxt_r = ai < ch.size() ? ch[ai].rpos : r_en_g;
    if (ai == ch.size()) {
      // terminal block: last anchor k-mer + exact extension
      cig.push(nxt_q - cur_q, 0);
      mlen += nxt_q - cur_q;
      break;
    }
    int64_t dq = nxt_q - cur_q, dr = nxt_r - cur_r;
    if (dq == dr) {
      // same-length segment: count matches directly
      for (int64_t t = 0; t < dq; ++t)
        if (base_code(qseq[cur_q + t]) <= 3 &&
            base_code(qseq[cur_q + t]) ==
                base_code(idx.seq[(size_t)(cur_r + t)]))
          ++mlen;
      cig.push(dq, 0);
    } else if (dq >= k && dr >= k) {
      // anchor k-mer exact block, then align the remaining gap
      cig.push(k, 0);
      mlen += k;
      banded_align(qseq + cur_q + k, dq - k,
                   idx.seq.data() + cur_r + k, dr - k, false, &cig, &mlen,
                   nullptr, nullptr);
    } else {
      banded_align(qseq + cur_q, dq, idx.seq.data() + cur_r, dr, false,
                   &cig, &mlen, nullptr, nullptr);
    }
    cur_q = nxt_q;
    cur_r = nxt_r;
  }
  // tail extension (already in forward orientation)
  for (uint32_t op : tail_cig.ops)
    cig.push((int64_t)(op >> 4), (int)(op & 0xf));

  if ((int64_t)cig.ops.size() > cigar_cap) return CIGAR_OVERFLOW;
  int64_t blen = 0;
  for (size_t t = 0; t < cig.ops.size(); ++t) {
    cigar[t] = (int32_t)cig.ops[t];
    blen += (int64_t)(cig.ops[t] >> 4);
  }

  // mapq from chain-score separation, tempered by anchor support
  double frac = best.score > 0 ? 1.0 - runner_up / best.score : 0.0;
  int64_t mapq = (int64_t)(40.0 * frac *
                           std::min(1.0, (double)ch.size() / 10.0) + 0.5);
  mapq = std::max<int64_t>(0, std::min<int64_t>(60, mapq));

  // convert rc-pass query coordinates back to the forward read
  int64_t oq_st = q_st, oq_en = q_en;
  if (best.strand < 0) {
    oq_st = qlen - q_en;
    oq_en = qlen - q_st;
  }
  out[0] = ctg;
  out[1] = r_st - ctg_st;
  out[2] = r_en - ctg_st;
  out[3] = oq_st;
  out[4] = oq_en;
  out[5] = best.strand;
  out[6] = mlen;
  out[7] = blen;
  out[8] = mapq;
  out[9] = (int64_t)best.score;
  return (int64_t)cig.ops.size();
}

}  // extern "C"
