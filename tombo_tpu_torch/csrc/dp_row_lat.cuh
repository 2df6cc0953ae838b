// The adaptive banded DP's row step, shared by the fused kernel K1
// (banded_dp.cu) and the sequence-chunked pair K2, K2'
// (banded_dp_chunked.cu).  One block works on one read, whose rows run one
// after another, so what bounds a read is the time from one row's band
// start to the next's.
//
// Per row, the band is placed at the first argmax of the previous forward
// row (clamped monotone; prefix rows use a precomputed start plan), the
// masked winsorized shifted z-scores are formed, and the stay/diag/skip
// recurrence is solved in closed form, fwd = c + cummax(d - c) with c the
// prefix sum of z - stay_pen (tombo_tpu_torch/ops/dp.py _row_update).
// Ties break stay > diag > skip.
//
// The summation order, which makes a row of any kernel bitwise the same
// row of another:
//   - thread t holds the band positions [t * ipt, (t + 1) * ipt), ipt =
//     ceil(bw / 256), and sums their stay terms in ascending order, in
//     double;
//   - each warp scans its 32 per-thread sums with a Hillis-Steele shuffle
//     scan (offsets 1, 2, 4, 8, 16);
//   - the warp totals combine in warp 0's order: the same Hillis-Steele
//     scan over the (at most 8) totals, a missing warp counting 0;
//   - a position's stay prefix is (its warp's prefix + its thread's
//     exclusive prefix in the warp) + its thread's running sum through it,
//     in double, rounded to float once.
// The running max of the closed form takes the same order (a missing warp
// or a thread past the band counts -inf).  The number of threads does not
// enter: a thread that holds no position adds 0 and -inf.
//
// What makes a row short:
//   - The block has only the warps that hold band positions (5 at bw 300,
//     not 8), and three __syncthreads a row.  Warp totals go to a shared
//     slot and every warp combines the <= 8 totals itself in registers, so
//     no barrier follows a combine.
//   - The next row's band start comes from the first argmax of the values
//     still in registers when the row is written (a thread's first
//     maximum, then redux.sync on order-preserving keys, then one shared
//     exchange on the barrier that publishes the row), not from reading
//     the row back.
//   - A position's work has no branch but the division's own: loads
//     first, then divisions, then the rest, so a thread's positions
//     overlap.  Positions past the band are computed from clamped indices
//     and ignored.  (With branches around every position, each cost some
//     300 cycles in sequence.)
//   - No global load waits on the band start.  The read's ref levels,
//     prefix band starts and ends for STAGE_ROWS rows, and a window of
//     bw + EM_MARGIN event means from the band start on, are staged in
//     shared memory one interval ahead with cp.async, double-buffered.  A
//     band that runs past the staged window reads device memory for the
//     positions outside it (correct either way, only slower).
//   - Positions are 32-bit (event indices fit int32; a position that wraps
//     lies outside every mask, as it lies outside the read in 64 bits).
//
// A skip move from a position left of the previous band (a band start that
// moved back, possible only in a prefix plan that is not monotone) reads
// the previous row's position 0, as the plain version (ops/dp.py
// _row_update) does.
//
// Precondition: every row the loop runs is inside its read (r < seq_len);
// all three kernels stop at the read's own length.
#pragma once

#include "dp_row.cuh"

namespace dplat {

using dprow::DpIn;
using dprow::FULL;
using dprow::NEG;
using dprow::ReadView;

constexpr int MAX_NW = dprow::NT / 32;   // warps of the widest band
constexpr int STAGE_ROWS = 32;           // rows of ref levels per stage
constexpr int EM_MARGIN = 256;           // staged events past the band

// positions per thread
__host__ __device__ inline int pos_per_thread(int bw) {
  return (bw + dprow::NT - 1) / dprow::NT;
}
// threads per read: the warps that hold band positions
__host__ __device__ inline int block_threads(int bw) {
  const int ipt = pos_per_thread(bw);
  return ((bw + ipt - 1) / ipt + 31) / 32 * 32;
}

// dynamic shared memory of the row loop: two forward rows, two staged
// event windows, two stages of (ref mean, ref sd, prefix start, prefix
// end) per row.  ops/banded_dp.py mirrors this formula.
__host__ __device__ inline size_t rows_smem_bytes(int bw) {
  return (size_t)2 * bw * 4 + (size_t)2 * (bw + EM_MARGIN) * 4 +
         (size_t)2 * STAGE_ROWS * 16;
}

struct Slots {                 // one warp total per warp and exchange
  double sum[MAX_NW];
  float mx[MAX_NW];
  int akey[MAX_NW];
  int aidx[MAX_NW];
};

__device__ inline void cp_async4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}
// 16 bytes, both addresses 16-byte aligned; read from L2, not L1
__device__ inline void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}
__device__ inline void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ inline void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// order-preserving int key of a float that is not NaN, with -0 and +0
// equal (they compare equal as floats)
__device__ inline int fkey(float x) {
  const int b = __float_as_int(x + 0.0f);
  return b ^ ((b >> 31) & 0x7fffffff);
}

// (key, idx) of the lanes -> in every lane: the largest key and the
// smallest idx among the lanes holding it
__device__ inline void warp_argmax(int& key, int& idx) {
  const int mk = __reduce_max_sync(FULL, key);
  idx = __reduce_min_sync(FULL, key == mk ? idx : 0x7fffffff);
  key = mk;
}

// The block's first argmax from every thread's first maximum (bv, bi):
// the smallest position among those holding the largest value, where no
// position holding -inf or NaN counts (0x7fffffff if none does).  One
// barrier, which also publishes the caller's earlier shared writes and,
// with wait_copies, its finished cp.async.
__device__ inline int block_argmax(float bv, int bi, Slots& s,
                                   bool wait_copies) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  int key = fkey(bv);
  warp_argmax(key, bi);
  if (wait_copies) cp_async_wait_all();
  if (nw == 1) {
    __syncwarp();
    return bi;
  }
  if (lane == 0) { s.akey[warp] = key; s.aidx[warp] = bi; }
  __syncthreads();
  key = lane < nw ? s.akey[lane] : (int)0x80000000;
  int idx = lane < nw ? s.aidx[lane] : 0x7fffffff;
  warp_argmax(key, idx);
  return idx;
}

// the first argmax of a row in memory, every thread in ascending order
// over its share of the positions
__device__ inline int row_first_argmax(const float* row, int bw, Slots& s,
                                       bool wait_copies) {
  float bv = -INFINITY;
  int bi = 0x7fffffff;
  for (int q = threadIdx.x; q < bw; q += blockDim.x)
    if (row[q] > bv) { bv = row[q]; bi = q; }
  return block_argmax(bv, bi, s, wait_copies);
}

// w[i] of eight, selected without indexing a register array
template <typename T>
__device__ inline T mux8(const T (&w)[MAX_NW], int i) {
  const T a0 = (i & 1) ? w[1] : w[0], a1 = (i & 1) ? w[3] : w[2];
  const T a2 = (i & 1) ? w[5] : w[4], a3 = (i & 1) ? w[7] : w[6];
  const T b0 = (i & 2) ? a1 : a0, b1 = (i & 2) ? a3 : a2;
  return (i & 4) ? b1 : b0;
}

// the inclusive prefix at warp - 1 of the warp totals t[0, nw), summed in
// warp 0's Hillis-Steele order (0 for warp 0)
__device__ inline double warps_before_sum(const double* t, int nw,
                                          int warp) {
  double w[MAX_NW];
#pragma unroll
  for (int k = 0; k < MAX_NW; ++k) w[k] = k < nw ? t[k] : 0.0;
#pragma unroll
  for (int o = 1; o < MAX_NW; o <<= 1) {
#pragma unroll
    for (int i = MAX_NW - 1; i >= o; --i) w[i] += w[i - o];
  }
  return warp > 0 ? mux8(w, warp - 1) : 0.0;
}

// the same for the running max (-inf for warp 0)
__device__ inline float warps_before_max(const float* t, int nw, int warp) {
  float w[MAX_NW];
#pragma unroll
  for (int k = 0; k < MAX_NW; ++k) w[k] = k < nw ? t[k] : -INFINITY;
#pragma unroll
  for (int o = 1; o < MAX_NW; o <<= 1) {
#pragma unroll
    for (int i = MAX_NW - 1; i >= o; --i) w[i] = fmaxf(w[i], w[i - o]);
  }
  return warp > 0 ? mux8(w, warp - 1) : -INFINITY;
}

// The rows [r_begin, r_end) of one read, one block.  The caller fills
// fprev() with the forward row before r_begin and calls begin(), then
// step(r) for each row in order.  MOVES: step also writes the row's move
// codes (0 stay, 1 skip, 2 diag) to mv[0, bw).  ROWS: step also stores the
// row's forward values to fo[0, bw) in device memory, each thread its own
// positions from registers (the DP debug dump's instances; the other
// instances compile without it).
//
// Stage buffer b (of two) holds, from stg + b * stage_n: bw + EM_MARGIN
// event means, then STAGE_ROWS each of ref means, ref sds, prefix starts
// and prefix ends.  Buffers are picked by offset, not from an array, so
// the loop's state stays in registers.
template <int MAXI, bool MOVES, bool ROWS = false>
struct LatRows {
  const DpIn& a;
  const ReadView& v;
  Slots& s;
  float* fp;                     // forward row before the next row
  float* fc;                     // the other row buffer
  float* stg;                    // the two stage buffers
  int stage_n;                   // floats per stage buffer
  int eb0, eb1;                  // first staged event of each buffer
  int r_begin, r_end;
  long long prev_start;          // band start of the row in fp
  int amax;                      // first argmax of fp
  bool band_err;
  int nt, nw, warp, lane, tid, ipt;

  __device__ LatRows(const DpIn& a_, const ReadView& v_, Slots& s_,
                     float* sm)
      : a(a_), v(v_), s(s_) {
    fp = sm;
    fc = sm + a.bw;
    stg = sm + 2 * a.bw;
    stage_n = a.bw + EM_MARGIN + 4 * STAGE_ROWS;
    tid = threadIdx.x;
    nt = blockDim.x;
    nw = nt >> 5;
    warp = tid >> 5;
    lane = tid & 31;
    ipt = pos_per_thread(a.bw);
  }

  // shared memory past the row loop's, for the caller
  __device__ unsigned char* end() const {
    return (unsigned char*)(stg + 2 * stage_n);
  }

  __device__ float* ems(int buf) const { return stg + buf * stage_n; }
  __device__ float* rms(int buf) const {
    return ems(buf) + a.bw + EM_MARGIN;
  }


  // start copying the inputs of rows [rb, rb + STAGE_ROWS) and the event
  // means from band start `base` into stage buffer `buf`
  __device__ void stage(int buf, int rb, long long base) {
    float* rm = rms(buf);
    for (int i = tid; i < STAGE_ROWS; i += nt) {
      const int r = rb + i;
      const int ri = r < a.L_in ? r : a.L_in - 1;
      const int pi = r < a.P - 1 ? r : a.P - 1;
      cp_async4(rm + i, v.rm + ri);
      cp_async4(rm + STAGE_ROWS + i, v.rs + ri);
      cp_async4(rm + 2 * STAGE_ROWS + i, v.ps + pi);
      cp_async4(rm + 3 * STAGE_ROWS + i, v.pe + pi);
    }
    if (base < 0) base = 0;
    if (base > a.E) base = a.E;
    if (buf) eb1 = (int)base; else eb0 = (int)base;
    // events past the read's array read as 0, as in the unstaged path
    const int n = a.E - (int)base;
    float* em = ems(buf);
    for (int i = tid; i < a.bw + EM_MARGIN; i += nt) {
      if (i < n) cp_async4(em + i, v.em + base + i);
      else em[i] = 0.f;
    }
    cp_async_commit();
  }

  // after fprev() holds the row before r0, whose band started at start
  __device__ void begin(int r0, int r1, long long start) {
    r_begin = r0;
    r_end = r1;
    prev_start = start;
    band_err = false;
    __syncthreads();             // fp written; the stages are free
    stage(0, r0, start);
    amax = row_first_argmax(fp, a.bw, s, true);
  }

  __device__ float* fprev() const { return fp; }

  // row r; returns its band start
  __device__ long long step(int r, uint8_t* mv, float* fo = nullptr) {
    const int bw = a.bw;
    const int si = r - r_begin, ri = si & (STAGE_ROWS - 1);
    const int buf = (si / STAGE_ROWS) & 1;
    const bool is_prefix = r < v.sr;
    const float* rm = rms(buf);

    // adaptive band placement from the previous row's first argmax
    long long adapt = prev_start + amax - v.half_bw + 1;
    if (adapt < prev_start) adapt = prev_start;
    if (adapt >= v.nev && r < v.sl - 2 && !is_prefix) band_err = true;
    if (adapt > v.nev - 1) adapt = v.nev - 1;
    const long long bs =
        is_prefix ? (long long)((const int*)rm)[2 * STAGE_ROWS + ri] : adapt;
    if (ri == 0 && r + STAGE_ROWS < r_end) stage(buf ^ 1, r + STAGE_ROWS,
                                                  bs);
    const int lo = is_prefix ? (v.pv > 0 ? (int)v.pv : 0) : 0;
    int hi = (int)v.nev;
    if (is_prefix) {
      const int pe = ((const int*)rm)[3 * STAGE_ROWS + ri];
      if (pe < hi) hi = pe;
    }
    const float mu = rm[ri];
    const float sd = rm[STAGE_ROWS + ri];
    long long diff = bs - prev_start;
    // beyond +-(bw + 1) every diag and skip read is outside the band
    const int dc = (int)(diff > bw + 1 ? bw + 1
                                       : diff < -bw - 1 ? -bw - 1 : diff);
    const float* ew = ems(buf);
    const unsigned eb = (unsigned)(buf ? eb1 : eb0);
    const unsigned bsu = (unsigned)bs;

    // Positions q0 + j, j < ipt, of this thread.  Their work has no branch
    // but the division's own (its rare exact path): first every load, then
    // every division, then the rest.  A position past the band (j >= ipt
    // or q >= bw) is computed from clamped indices and then ignored.
    const int q0 = tid * ipt;
    float wv[MAXI], dv[MAXI], sv[MAXI];
    const int wof = (int)(bsu - eb);           // band start in the window
    if ((unsigned)wof <= (unsigned)EM_MARGIN) {
#pragma unroll
      for (int j = 0; j < MAXI; ++j) {
        const int q = q0 + j;
        wv[j] = ew[wof + (q < bw ? q : bw - 1)];
      }
    } else {                                   // the band left the window
#pragma unroll
      for (int j = 0; j < MAXI; ++j) {
        const int ap = (int)(bsu + (unsigned)(q0 + j));
        const unsigned wi = (unsigned)ap - eb;
        wv[j] = wi < (unsigned)(bw + EM_MARGIN)
                    ? ew[wi]
                    : (unsigned)ap < (unsigned)a.E ? v.em[ap] : 0.f;
      }
    }
#pragma unroll
    for (int j = 0; j < MAXI; ++j) {
      const int di = q0 + j + dc - 1, sj = q0 + j + dc;
      const float d = fp[di < 0 ? 0 : di < bw ? di : bw - 1];
      const float sw = fp[sj < 0 ? 0 : sj < bw ? sj : bw - 1];
      dv[j] = (unsigned)di < (unsigned)bw ? d : NEG;
      sv[j] = sj < bw ? sw : NEG;
    }
    int d0 = dc - 1;
    if (d0 > bw - 1) d0 = bw - 1;
    if (d0 < 0) d0 = 0;
    const float fp0 = fp[0], fpd = fp[d0];

    float zq[MAXI];
#pragma unroll
    for (int j = 0; j < MAXI; ++j) zq[j] = (wv[j] - mu) / sd;

    float zs[MAXI], dg[MAXI], sk[MAXI], cf[MAXI], um[MAXI], f[MAXI];
    double cs[MAXI];
    double run = 0.0;
#pragma unroll
    for (int j = 0; j < MAXI; ++j) {
      const int q = q0 + j;
      const int ap = (int)(bsu + (unsigned)q);
      float z = fabsf(zq[j]);
      if (a.max_half_z > 0.f) z = fminf(z, a.max_half_z);
      const float sh = (ap >= lo && ap < hi) ? a.z_shift - z : a.mask_fill;
      zs[j] = sh;
      dg[j] = dv[j] + sh;
      sk[j] = sv[j] - a.skip_pen;
      const float st = (q == 0) ? 0.f : (sh - a.stay_pen);
      run = j < ipt && q < bw ? run + (double)st : run;
      cs[j] = run;
    }

    // first band position (zs[0] is position 0's z in thread 0, the only
    // thread that reads first_val)
    const float first_val = diff == 0 ? fp0 - a.skip_pen : fpd + zs[0];
    const int first_move = diff == 0 ? 1 : 2;

    // exclusive prefix sum of run in thread order (barrier 1)
    double inc = run;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const double y = __shfl_up_sync(FULL, inc, o);
      if (lane >= o) inc += y;
    }
    if (lane == 31) s.sum[warp] = inc;
    __syncthreads();
    const double off = warps_before_sum(s.sum, nw, warp) + (inc - run);

    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < MAXI; ++j) {
      const int q = q0 + j;
      cf[j] = (float)(off + cs[j]);
      const float u = (q == 0) ? first_val : fmaxf(dg[j], sk[j]) - cf[j];
      mx = j < ipt && q < bw ? fmaxf(mx, u) : mx;
      um[j] = mx;
    }

    // exclusive running max in thread order (barrier 2)
    float minc = mx;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float y = __shfl_up_sync(FULL, minc, o);
      if (lane >= o) minc = fmaxf(minc, y);
    }
    float exc = __shfl_up_sync(FULL, minc, 1);
    if (lane == 0) exc = -INFINITY;
    if (lane == 31) s.mx[warp] = minc;
    __syncthreads();
    const float moff = fmaxf(warps_before_max(s.mx, nw, warp), exc);

    // the new row, and its first argmax for the next row (barrier 3, which
    // also publishes the row and, at a stage's last row, the next stage)
    float bv = -INFINITY;
    int bi = 0x7fffffff;
#pragma unroll
    for (int j = 0; j < MAXI; ++j) {
      const int q = q0 + j;
      f[j] = (q == 0) ? first_val : cf[j] + fmaxf(moff, um[j]);
      if (j < ipt && q < bw) {
        fc[q] = f[j];
        if (ROWS) fo[q] = f[j];
        if (f[j] > bv) { bv = f[j]; bi = q; }
      }
    }
    amax = block_argmax(bv, bi, s, ri == STAGE_ROWS - 1);

    if (MOVES) {
      const float left = (q0 >= 1 && q0 <= bw) ? fc[q0 - 1] : 0.f;
#pragma unroll
      for (int j = 0; j < MAXI; ++j) {
        const int q = q0 + j;
        if (j < ipt && q < bw) {
          uint8_t m = 0;
          if (q == 0) {
            m = (uint8_t)first_move;
          } else {
            const float fl = j == 0 ? left : f[j > 0 ? j - 1 : 0];
            const float stay = fl - a.stay_pen + zs[j];
            if (dg[j] > stay) m = 2;
            if (sk[j] > fmaxf(stay, dg[j])) m = 1;
          }
          mv[q] = m;
        }
      }
    }
    float* t = fp; fp = fc; fc = t;
    prev_start = bs;
    return bs;
  }
};

}  // namespace dplat
