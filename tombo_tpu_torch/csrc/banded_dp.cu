// Fused adaptive banded DP + traceback, one thread block per read.
//
// Replaces the Pallas TPU kernel tombo_tpu/ops/pallas_dp.py
// adaptive_banded_dp_tb (_make_kernel; _pallas_dp_block for small blocks).
// It computes what tombo_tpu_torch/ops/dp.py adaptive_banded_dp followed by
// banded_traceback computes (the plain version in ops/banded_dp.py): the
// row step of dp_row.cuh over every row, then, in the same kernel, the
// traceback of the move codes from the first argmax of the last row.
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
// Build with -fmad=false so no multiply-add is contracted (dp_row.cuh,
// Precision).
#include "dp_row.cuh"

namespace {

using namespace dprow;

struct Out {
  uint8_t* moves; int* bstarts;
  int* segs; uint8_t* band_err; uint8_t* bound_err; float* ffwd;
};

template <int MAXI>
__global__ void __launch_bounds__(NT) banded_dp_kernel(DpIn a, Out o) {
  extern __shared__ float smem[];
  __shared__ Scratch sc;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int bw = a.bw, L = a.L;
  const ReadView v(a, b);

  float* fprev = smem;
  float* fcur = smem + bw;
  float* ffin = smem + 2 * bw;
  uint8_t* mv_out = o.moves + (size_t)b * L * bw;
  int* bst = o.bstarts + (size_t)b * L;

  for (int q = tid; q < bw; q += NT) { fprev[q] = 0.f; ffin[q] = 0.f; }
  __syncthreads();

  long long prev_start = v.ps[0];
  long long last_bs = prev_start;   // band start of row seq_len - 1
  bool band_err = false;
  for (int r = 0; r < L; ++r) {
    const long long bs = dp_row<MAXI>(a, v, r, fprev, fcur, prev_start,
                                      band_err, mv_out + (size_t)r * bw, sc);
    if (r == v.sl - 1) {
      for (int q = tid; q < bw; q += NT) ffin[q] = fcur[q];
      last_bs = bs;
    }
    if (tid == 0) bst[r] = (int)bs;
    prev_start = bs;
    float* t = fprev; fprev = fcur; fcur = t;
    __syncthreads();
  }

  // traceback from the first argmax of the last active row
  const int top = row_argmax(ffin, bw, sc);
  for (int q = tid; q < bw; q += NT) o.ffwd[(size_t)b * bw + q] = ffin[q];
  if (tid == 0) o.band_err[b] = band_err ? 1 : 0;

  if (tid < 32) {
    const int sl = v.sl;
    int* segs = o.segs + (size_t)b * (L + 1);
    const long long init = (long long)top + last_bs;
    long long ep = init;
    bool berr = false;
    for (int r = L - 1; r >= 0; --r) {
      if (r >= sl) {
        if (tid == 0) segs[r] = 0;
        continue;
      }
      ep = tb_row(mv_out + (size_t)r * bw, bst[r], ep, bw, a.bound_thresh,
                  berr);
      if (tid == 0) segs[r] = (int)(ep + 1);
    }
    if (tid == 0) {
      segs[L] = 0;
      if (sl <= L) segs[sl] = (int)(init + 1);   // a read past L has none
      o.bound_err[b] = berr ? 1 : 0;
    }
  }
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
  DpIn a{em, E, n_events, rm, rs, L_in, seq_lens, pstarts, pvalid, pend,
         P, start_rows, L, bw, z_shift, skip_pen, stay_pen, mask_fill,
         max_half_z, bound_thresh};
  Out o{moves, bstarts, segs, band_err, bound_err, ffwd};
  const int ipt = (bw + NT - 1) / NT;
  const size_t smem = (size_t)3 * bw * sizeof(float);
  cudaStream_t st = (cudaStream_t)stream;
  if (ipt <= 2) return launch(banded_dp_kernel<2>, B, smem, st, a, o);
  if (ipt <= 4) return launch(banded_dp_kernel<4>, B, smem, st, a, o);
  if (ipt <= 8) return launch(banded_dp_kernel<8>, B, smem, st, a, o);
  return launch(banded_dp_kernel<16>, B, smem, st, a, o);
}
