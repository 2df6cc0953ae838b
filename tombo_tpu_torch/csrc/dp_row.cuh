// What the three adaptive banded DP kernels share, K1 (banded_dp.cu) and
// the sequence-chunked pair K2, K2' (banded_dp_chunked.cu): the DP's inputs
// for a batch of reads, one read's view of them, one traceback row and the
// launch of one block per read.  Their row step is dp_row_lat.cuh.
//
// Every kernel is built with the same flags (-fmad=false), so a row
// recomputed by K2' is bitwise the row K2 computed, and both are K1's row.
//
// Precision: the stay prefix sum accumulates in double and rounds to float
// once per position, as ops/precision.py seq_cumsum does for float32, so the
// block scan agrees with the plain version independent of summation order.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace dprow {

constexpr int NT = 256;           // threads of the widest block (one read)
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

// one read's row-invariant inputs
struct ReadView {
  const float* em;
  const float* rm;
  const float* rs;
  const int* ps;
  const int* pe;
  long long nev, pv;
  int sl, sr, half_bw;

  __device__ ReadView(const DpIn& a, int b)
      : em(a.em + (size_t)b * a.E), rm(a.rm + (size_t)b * a.L_in),
        rs(a.rs + (size_t)b * a.L_in), ps(a.pstarts + (size_t)b * a.P),
        pe(a.pend + (size_t)b * a.P), nev(a.n_events[b]), pv(a.pvalid[b]),
        sl(a.seq_lens[b]), sr(a.start_rows[b]), half_bw(a.bw / 2) {}
};

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

// Launch one block of `threads` threads per read with `smem` bytes of
// dynamic shared memory, allowed first (above 48 KB of dynamic and static
// shared memory together a kernel must opt in); returns the CUDA error
// code (0 on success).
template <typename... Args>
int launch(void (*kernel)(Args...), int B, int threads, size_t smem,
           cudaStream_t st, Args... args) {
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<B, threads, smem, st>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace dprow
