// Fused adaptive banded DP + traceback, one thread block per read.
//
// Replaces the Pallas TPU kernel tombo_tpu/ops/pallas_dp.py
// adaptive_banded_dp_tb (_make_kernel; _pallas_dp_block for small blocks).
// It computes what tombo_tpu_torch/ops/dp.py adaptive_banded_dp followed by
// banded_traceback computes (the plain version in ops/banded_dp.py):
// per row, the band is placed at the first argmax of the previous forward
// row (clamped monotone; prefix rows use a precomputed start plan), the
// masked winsorized shifted z-scores are formed, and the stay/diag/skip
// recurrence is solved in closed form, fwd = c + cummax(d - c) with c the
// prefix sum of z - stay_pen.  Ties break stay > diag > skip.  The
// traceback walks the move codes back from the first argmax of the last
// row, in the same kernel.
//
// What bounds it on an H100: neither bytes nor FLOPs.  A 512-read batch at
// L 1024, bw 300 moves ~10 MB of inputs and outputs and does ~3 GFLOP; the
// rows of one read are sequential, so the kernel is bound by the latency
// of one row step (a block argmax and two block scans, each a few
// __syncthreads) times the number of rows.  The design keeps everything a
// row step touches on chip: the previous and current forward rows live in
// shared memory, each thread owns a contiguous run of band positions in
// registers, and the scans are warp shuffles plus one shared-memory pass.
// Reads run in parallel, one block each, so a batch fills the card.  Move
// codes go to a global (B, L, bw) uint8 scratch that the traceback (one
// warp) reads back; the Mosaic-specific lane rolls, barrel shifters and
// VMEM planning of the TPU kernel have no counterpart here.
//
// Precision: the stay prefix sum accumulates in double and rounds to float
// once per position, as ops/precision.py seq_cumsum does for float32, so the
// block scan agrees with the plain version independent of summation order.
// Build with -fmad=false so no multiply-add is contracted.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;           // threads per block (one read)
constexpr int NW = NT / 32;
constexpr int MAXI_CAP = 16;      // positions per thread: bw <= 4096
constexpr float NEG = -1e30f;     // ops/dp.py NEG_LARGE
constexpr unsigned FULL = 0xffffffffu;

struct DpArgs {
  const float* em; int E;
  const int* n_events;
  const float* rm; const float* rs; int L_in;
  const int* seq_lens;
  const int* pstarts; const int* pvalid; const int* pend; int P;
  const int* start_rows;
  int L; int bw;
  float z_shift, skip_pen, stay_pen, mask_fill, max_half_z;
  int bound_thresh;
  uint8_t* moves; int* bstarts;
  int* segs; uint8_t* band_err; uint8_t* bound_err; float* ffwd;
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
__device__ int block_argmax(float v, int i, Scratch& sc) {
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
__device__ double block_exscan_sum(double x, Scratch& sc) {
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
__device__ float block_exscan_max(float x, Scratch& sc) {
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

// MAXI: band positions per thread, the smallest instantiation that
// covers bw, so narrow bands keep few registers and many blocks per SM
template <int MAXI>
__global__ void __launch_bounds__(NT) banded_dp_kernel(DpArgs a) {
  extern __shared__ float smem[];
  __shared__ Scratch sc;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int bw = a.bw, L = a.L, P = a.P;
  const int half_bw = bw / 2;
  const int ipt = (bw + NT - 1) / NT;
  const int q0 = tid * ipt;

  float* fprev = smem;
  float* fcur = smem + bw;
  float* ffin = smem + 2 * bw;

  const long long nev = a.n_events[b];
  const int sl = a.seq_lens[b];
  const int sr = a.start_rows[b];
  const long long pv = a.pvalid[b];
  const float* em = a.em + (size_t)b * a.E;
  const float* rm = a.rm + (size_t)b * a.L_in;
  const float* rs = a.rs + (size_t)b * a.L_in;
  const int* ps = a.pstarts + (size_t)b * P;
  const int* pe = a.pend + (size_t)b * P;
  uint8_t* mv_out = a.moves + (size_t)b * L * bw;
  int* bst = a.bstarts + (size_t)b * L;

  for (int q = tid; q < bw; q += NT) { fprev[q] = 0.f; ffin[q] = 0.f; }
  __syncthreads();

  long long prev_start = ps[0];
  bool band_err = false;

  for (int r = 0; r < L; ++r) {
    const bool is_prefix = r < sr;
    const bool active = r < sl;

    // adaptive band placement from the previous row's first argmax
    float bv = -INFINITY; int bi = 0x7fffffff;
    for (int j = 0; j < ipt; ++j) {
      int q = q0 + j;
      if (q < bw && fprev[q] > bv) { bv = fprev[q]; bi = q; }
    }
    const int amax = block_argmax(bv, bi, sc);
    long long adapt = prev_start + amax - half_bw + 1;
    if (adapt < prev_start) adapt = prev_start;
    if (adapt >= nev && r < sl - 2 && active && !is_prefix) band_err = true;
    if (adapt > nev - 1) adapt = nev - 1;
    const int pidx = r < P - 1 ? r : P - 1;
    long long bs = is_prefix ? (long long)ps[pidx] : adapt;
    if (!active) bs = prev_start;
    const long long lo = is_prefix ? (pv > 0 ? pv : 0) : 0;
    long long hi = nev;
    if (is_prefix && (long long)pe[pidx] < hi) hi = pe[pidx];
    const float mu = rm[r < a.L_in ? r : a.L_in - 1];
    const float sd = rs[r < a.L_in ? r : a.L_in - 1];
    const long long diff = bs - prev_start;

    // shifted z at one band position
    auto zat = [&](int q) -> float {
      long long ap = bs + q;
      float w = (ap >= 0 && ap < a.E) ? em[ap] : 0.f;
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
        mv_out[(size_t)r * bw + q] = m;
        if (r == sl - 1) ffin[q] = fcur[q];
      }
    }
    if (tid == 0) bst[r] = (int)bs;
    prev_start = bs;
    float* t = fprev; fprev = fcur; fcur = t;
    __syncthreads();
  }

  // traceback from the first argmax of the last active row
  float bv = -INFINITY; int bi = 0x7fffffff;
  for (int j = 0; j < ipt; ++j) {
    int q = q0 + j;
    if (q < bw && ffin[q] > bv) { bv = ffin[q]; bi = q; }
  }
  const int top = block_argmax(bv, bi, sc);
  for (int q = tid; q < bw; q += NT) a.ffwd[(size_t)b * bw + q] = ffin[q];
  if (tid == 0) a.band_err[b] = band_err ? 1 : 0;

  if (tid < 32) {
    const int lane = tid;
    int* segs = a.segs + (size_t)b * (L + 1);
    const long long init = (long long)top + bst[sl >= 1 ? sl - 1 : 0];
    long long ep = init;
    bool berr = false;
    for (int r = L - 1; r >= 0; --r) {
      if (r >= sl) {
        if (lane == 0) segs[r] = 0;
        continue;
      }
      const long long bsr = bst[r];
      long long bp = ep - bsr;
      if (bp < 0) bp = 0;
      if (bp > bw - 1) bp = bw - 1;
      const uint8_t* row = mv_out + (size_t)r * bw;
      // last non-stay position <= bp (position 0 is never a stay)
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
      if (edge < a.bound_thresh) berr = true;
      ep = bsr + bp2;
      if (lane == 0) segs[r] = (int)(ep + 1);
    }
    if (lane == 0) {
      segs[L] = 0;
      segs[sl] = (int)(init + 1);
      a.bound_err[b] = berr ? 1 : 0;
    }
  }
}

template <int MAXI>
int launch(const DpArgs& a, int B, size_t smem, cudaStream_t st) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        banded_dp_kernel<MAXI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  banded_dp_kernel<MAXI><<<B, NT, smem, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int tombo_banded_dp(
    const float* em, int E, const int* n_events, const float* rm,
    const float* rs, int L_in, const int* seq_lens, const int* pstarts,
    const int* pvalid, const int* pend, int P, const int* start_rows,
    int B, int L, int bw, float z_shift, float skip_pen, float stay_pen,
    float mask_fill, float max_half_z, int bound_thresh, uint8_t* moves,
    int* bstarts, int* segs, uint8_t* band_err, uint8_t* bound_err,
    float* ffwd, void* stream) {
  if (bw < 1 || bw > NT * MAXI_CAP || B < 1 || L < 1 || P < 1) return -1;
  DpArgs a{em, E, n_events, rm, rs, L_in, seq_lens, pstarts, pvalid, pend,
           P, start_rows, L, bw, z_shift, skip_pen, stay_pen, mask_fill,
           max_half_z, bound_thresh, moves, bstarts, segs, band_err,
           bound_err, ffwd};
  const int ipt = (bw + NT - 1) / NT;
  const size_t smem = (size_t)3 * bw * sizeof(float);
  cudaStream_t st = (cudaStream_t)stream;
  if (ipt <= 2) return launch<2>(a, B, smem, st);
  if (ipt <= 4) return launch<4>(a, B, smem, st);
  if (ipt <= 8) return launch<8>(a, B, smem, st);
  return launch<16>(a, B, smem, st);
}
