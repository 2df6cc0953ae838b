// One row step of the adaptive banded DP, the fused kernel's
// (banded_dp.cu), and one traceback row, which the sequence-chunked pair
// (banded_dp_chunked.cu) shares; the pair's row step is dp_row_lat.cuh,
// the same arithmetic rebuilt for latency.  One thread block works on one
// read.
//
// Per row, the band is placed at the first argmax of the previous forward
// row (clamped monotone; prefix rows use a precomputed start plan), the
// masked winsorized shifted z-scores are formed, and the stay/diag/skip
// recurrence is solved in closed form, fwd = c + cummax(d - c) with c the
// prefix sum of z - stay_pen (tombo_tpu_torch/ops/dp.py _row_update).
// Ties break stay > diag > skip.
//
// Every kernel is built with the same flags (-fmad=false), so a row
// recomputed by the chunked traceback is bitwise the row the forward pass
// computed, and both are the fused kernel's row.
//
// Precision: the stay prefix sum accumulates in double and rounds to float
// once per position, as ops/precision.py seq_cumsum does for float32, so the
// block scan agrees with the plain version independent of summation order.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace dprow {

constexpr int NT = 256;           // threads per block (one read)
constexpr int NW = NT / 32;
constexpr int MAXI_CAP = 16;      // positions per thread: bw <= 4096
constexpr float NEG = -1e30f;     // ops/dp.py NEG_LARGE
constexpr unsigned FULL = 0xffffffffu;

// the DP's inputs for a batch of reads, as the wrappers in
// ops/banded_dp.py pass them
struct DpIn {
  const float* em; int E;
  const int* n_events;
  const float* rm; const float* rs; int L_in;
  const int* seq_lens;
  const int* pstarts; const int* pvalid; const int* pend; int P;
  const int* start_rows;
  int L; int bw;
  float z_shift, skip_pen, stay_pen, mask_fill, max_half_z;
  int bound_thresh;
};

struct Scratch {
  double wd[NW];
  float wf[NW];
  int wi[NW];
  double bd;
  float bf;
  int bi;
};

// first index of the maximum over the block: (v, i) pairs, larger v wins,
// equal v -> smaller i
__device__ inline int block_argmax(float v, int i, Scratch& sc) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) {
    float ov = __shfl_down_sync(FULL, v, o);
    int oi = __shfl_down_sync(FULL, i, o);
    if (ov > v || (ov == v && oi < i)) { v = ov; i = oi; }
  }
  if (lane == 0) { sc.wf[warp] = v; sc.wi[warp] = i; }
  __syncthreads();
  if (warp == 0) {
    v = lane < NW ? sc.wf[lane] : -INFINITY;
    i = lane < NW ? sc.wi[lane] : 0x7fffffff;
    for (int o = 16; o > 0; o >>= 1) {
      float ov = __shfl_down_sync(FULL, v, o);
      int oi = __shfl_down_sync(FULL, i, o);
      if (ov > v || (ov == v && oi < i)) { v = ov; i = oi; }
    }
    if (lane == 0) sc.bi = i;
  }
  __syncthreads();
  int r = sc.bi;
  __syncthreads();
  return r;
}

// exclusive prefix sum of one double per thread, in thread order
__device__ inline double block_exscan_sum(double x, Scratch& sc) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  double inc = x;
  for (int o = 1; o < 32; o <<= 1) {
    double y = __shfl_up_sync(FULL, inc, o);
    if (lane >= o) inc += y;
  }
  if (lane == 31) sc.wd[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    double w = lane < NW ? sc.wd[lane] : 0.0;
    for (int o = 1; o < 32; o <<= 1) {
      double y = __shfl_up_sync(FULL, w, o);
      if (lane >= o) w += y;
    }
    if (lane < NW) sc.wd[lane] = w;  // inclusive warp totals
  }
  __syncthreads();
  double before = warp > 0 ? sc.wd[warp - 1] : 0.0;
  double r = before + (inc - x);
  __syncthreads();
  return r;
}

// exclusive running max of one float per thread (identity -inf)
__device__ inline float block_exscan_max(float x, Scratch& sc) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float inc = x;
  for (int o = 1; o < 32; o <<= 1) {
    float y = __shfl_up_sync(FULL, inc, o);
    if (lane >= o) inc = fmaxf(inc, y);
  }
  float exc = __shfl_up_sync(FULL, inc, 1);
  if (lane == 0) exc = -INFINITY;
  if (lane == 31) sc.wf[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    float w = lane < NW ? sc.wf[lane] : -INFINITY;
    for (int o = 1; o < 32; o <<= 1) {
      float y = __shfl_up_sync(FULL, w, o);
      if (lane >= o) w = fmaxf(w, y);
    }
    if (lane < NW) sc.wf[lane] = w;
  }
  __syncthreads();
  float before = warp > 0 ? sc.wf[warp - 1] : -INFINITY;
  float r = fmaxf(before, exc);
  __syncthreads();
  return r;
}

// first index of the maximum of a band row held in memory (each thread
// scans its own run of positions, then one block argmax)
__device__ inline int row_argmax(const float* row, int bw, Scratch& sc) {
  const int ipt = (bw + NT - 1) / NT, q0 = threadIdx.x * ipt;
  float bv = -INFINITY; int bi = 0x7fffffff;
  for (int j = 0; j < ipt; ++j) {
    int q = q0 + j;
    if (q < bw && row[q] > bv) { bv = row[q]; bi = q; }
  }
  return block_argmax(bv, bi, sc);
}

// one read's row-invariant inputs
struct ReadView {
  const float* em;
  const float* rm;
  const float* rs;
  const int* ps;
  const int* pe;
  long long nev, pv;
  int sl, sr, ipt, q0, half_bw;

  __device__ ReadView(const DpIn& a, int b)
      : em(a.em + (size_t)b * a.E), rm(a.rm + (size_t)b * a.L_in),
        rs(a.rs + (size_t)b * a.L_in), ps(a.pstarts + (size_t)b * a.P),
        pe(a.pend + (size_t)b * a.P), nev(a.n_events[b]), pv(a.pvalid[b]),
        sl(a.seq_lens[b]), sr(a.start_rows[b]),
        ipt((a.bw + NT - 1) / NT), q0(threadIdx.x * ((a.bw + NT - 1) / NT)),
        half_bw(a.bw / 2) {}
};

// Row r of read v: places the band from fprev (the forward row of row
// r - 1, whose band started at prev_start), writes the new forward row to
// fcur (fprev again where r is past the read) and, where mv is not null,
// the row's move codes (0 stay, 1 skip, 2 diag; 0 past the read) to
// mv[0, bw).  Sets band_err on a band overrun.  Returns the row's band
// start.  MAXI: band positions per thread, at least ceil(bw / NT).  The
// block is synchronised after fcur is written; the caller synchronises
// again before fcur is read as the next row's fprev.
template <int MAXI>
__device__ inline long long dp_row(const DpIn& a, const ReadView& v, int r,
                                   const float* fprev, float* fcur,
                                   long long prev_start, bool& band_err,
                                   uint8_t* mv, Scratch& sc) {
  const int bw = a.bw, P = a.P, ipt = v.ipt, q0 = v.q0;
  const bool is_prefix = r < v.sr;
  const bool active = r < v.sl;

  // adaptive band placement from the previous row's first argmax
  const int amax = row_argmax(fprev, bw, sc);
  long long adapt = prev_start + amax - v.half_bw + 1;
  if (adapt < prev_start) adapt = prev_start;
  if (adapt >= v.nev && r < v.sl - 2 && active && !is_prefix)
    band_err = true;
  if (adapt > v.nev - 1) adapt = v.nev - 1;
  const int pidx = r < P - 1 ? r : P - 1;
  long long bs = is_prefix ? (long long)v.ps[pidx] : adapt;
  if (!active) bs = prev_start;
  const long long lo = is_prefix ? (v.pv > 0 ? v.pv : 0) : 0;
  long long hi = v.nev;
  if (is_prefix && (long long)v.pe[pidx] < hi) hi = v.pe[pidx];
  const float mu = v.rm[r < a.L_in ? r : a.L_in - 1];
  const float sd = v.rs[r < a.L_in ? r : a.L_in - 1];
  const long long diff = bs - prev_start;

  // shifted z at one band position
  auto zat = [&](int q) -> float {
    long long ap = bs + q;
    float w = (ap >= 0 && ap < a.E) ? v.em[ap] : 0.f;
    float z = fabsf((w - mu) / sd);
    if (a.max_half_z > 0.f) z = fminf(z, a.max_half_z);
    float sh = a.z_shift - z;
    return (ap >= lo && ap < hi) ? sh : a.mask_fill;
  };

  // first band position (reference: pyx:392-401)
  float first_val;
  int first_move;
  if (diff == 0) {
    first_val = fprev[0] - a.skip_pen;
    first_move = 1;
  } else {
    long long di = diff - 1;
    if (di > bw - 1) di = bw - 1;
    if (di < 0) di = 0;
    first_val = fprev[di] + zat(0);
    first_move = 2;
  }

  float zs[MAXI], dg[MAXI], sk[MAXI], cf[MAXI];
  double cs[MAXI];
  double run = 0.0;
#pragma unroll
  for (int j = 0; j < MAXI; ++j) {
    int q = q0 + j;
    if (j < ipt && q < bw) {
      float sh = zat(q);
      zs[j] = sh;
      long long di = q + diff - 1;
      float dv = (di >= 0 && di < bw) ? fprev[di] : NEG;
      dg[j] = dv + sh;
      long long si = q + diff;
      float sv = (si < bw) ? fprev[si] : NEG;
      sk[j] = sv - a.skip_pen;
      float s = (q == 0) ? 0.f : (sh - a.stay_pen);
      run += (double)s;
      cs[j] = run;
    }
  }
  const double off = block_exscan_sum(run, sc);

  float mx = -INFINITY;
  float um[MAXI];
#pragma unroll
  for (int j = 0; j < MAXI; ++j) {
    int q = q0 + j;
    if (j < ipt && q < bw) {
      cf[j] = (float)(off + cs[j]);
      float u = (q == 0) ? first_val : fmaxf(dg[j], sk[j]) - cf[j];
      mx = fmaxf(mx, u);
      um[j] = mx;
    }
  }
  const float moff = block_exscan_max(mx, sc);

#pragma unroll
  for (int j = 0; j < MAXI; ++j) {
    int q = q0 + j;
    if (j < ipt && q < bw) {
      float f = (q == 0) ? first_val : cf[j] + fmaxf(moff, um[j]);
      fcur[q] = active ? f : fprev[q];
    }
  }
  __syncthreads();

  if (mv != nullptr) {
#pragma unroll
    for (int j = 0; j < MAXI; ++j) {
      int q = q0 + j;
      if (j < ipt && q < bw) {
        uint8_t m = 0;
        if (active) {
          if (q == 0) {
            m = (uint8_t)first_move;
          } else {
            float stay = fcur[q - 1] - a.stay_pen + zs[j];
            if (dg[j] > stay) m = 2;
            if (sk[j] > fmaxf(stay, dg[j])) m = 1;
          }
        }
        mv[q] = m;
      }
    }
  }
  return bs;
}

// One traceback row (reference: pyx:281-310), run by a whole warp with
// the same arguments in every lane: from event position ep, the last
// non-stay move at or left of ep's band position on this row (position 0
// is never a stay; ballot search, 32 positions at a time).  Returns the
// row's event position; sets berr where the path comes within
// bound_thresh of the band's edge.
__device__ inline long long tb_row(const uint8_t* row, long long bsr,
                                   long long ep, int bw, int bound_thresh,
                                   bool& berr) {
  const int lane = threadIdx.x & 31;
  long long bp = ep - bsr;
  if (bp < 0) bp = 0;
  if (bp > bw - 1) bp = bw - 1;
  long long pos = -1;
  for (long long base = bp; base >= 0; base -= 32) {
    long long q = base - lane;
    bool nz = q >= 0 && row[q] != 0;
    unsigned m = __ballot_sync(FULL, nz);
    if (m) { pos = base - (__ffs(m) - 1); break; }
  }
  if (pos < 0) pos = 0;
  long long bp2 = row[pos] == 2 ? pos - 1 : pos;
  long long edge = bp2 < bw - bp2 - 1 ? bp2 : bw - bp2 - 1;
  if (edge < bound_thresh) berr = true;
  return bsr + bp2;
}

// launch one block of NT threads per read with `smem` bytes of dynamic
// shared memory; returns the CUDA error code (0 on success).  Above 48 KB
// of dynamic and static shared memory together a kernel must opt in.
template <typename... Args>
int launch(void (*kernel)(Args...), int B, size_t smem, cudaStream_t st,
           Args... args) {
  if (smem + sizeof(Scratch) > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<B, NT, smem, st>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace dprow
