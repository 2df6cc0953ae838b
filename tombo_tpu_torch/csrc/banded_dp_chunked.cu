// Sequence-chunked adaptive banded DP + traceback for long reads: a
// forward kernel (K2) and a traceback kernel (K2'), one thread block per
// read each.
//
// Replaces the Pallas TPU kernels of tombo_tpu/ops/pallas_dp.py
// adaptive_banded_dp_tb_chunked: the forward (_make_fwd_chunk_kernel,
// pallas_call at _chunked_dp_block) and the traceback
// (_make_tb_chunk_kernel).  The result is the fused kernel's
// (banded_dp.cu), bit for bit: segs (B, L+1), band and bound error flags,
// final forward row.  The plain version is ops/banded_dp.py
// adaptive_banded_dp_tb_chunked_plain.
//
// What it is designed around.  The TPU chunks the rows to keep VMEM
// independent of read length but still writes all (B, L, bw) int8 move
// codes to HBM.  On the H100 the move matrix is what grows: the fused
// kernel keeps L * bw bytes per read in device memory (49 MB for a 32 kb
// read at the save bandwidth 1500).  Here no move matrix exists:
//   K2  runs every row of the read once, storing no moves.  Before each
//       Lc-row chunk it writes a checkpoint of the carried state: the
//       forward row (bw floats) and the band start.  At the end it writes
//       the band error flag, the final forward row and its band start.
//   K2' walks the chunks last to first.  For each it restores the
//       checkpoint, recomputes the chunk's moves and band starts with the
//       same row step (dp_row.cuh) into a per-read (Lc, bw) uint8 tile,
//       then one warp walks the tile back, carrying the event position and
//       bound error flag into the chunk below.
// Per-read device scratch is ceil(L/Lc) * (bw * 4 + 4) + Lc * bw bytes.
// Rows past a read's length do not change the carried state, so both
// kernels stop at the read's own length rather than the batch's L.
//
// What bounds it: as the fused kernel, the latency of the sequential row
// step (a block argmax and two block scans per row), not bytes or FLOPs.
// The recompute runs each row step a second time, so the pair does about
// twice the fused kernel's row steps on the rows a read has.
// Build with -fmad=false (dp_row.cuh, Precision): the recomputed rows are
// bitwise the forward rows only if both are compiled alike.
#include "dp_row.cuh"

namespace {

using namespace dprow;

struct FwdOut {
  int Lc;
  float* ckpt; int* ckpt_start;     // (B, n_chunks, bw), (B, n_chunks)
  uint8_t* band_err; float* ffwd; int* last_bs;
};

struct TbArgs {
  int Lc;
  const float* ckpt; const int* ckpt_start;
  const float* ffwd; const int* last_bs;
  uint8_t* tile;                    // (B, Lc, bw)
  int* segs; uint8_t* bound_err;
};

template <int MAXI>
__global__ void __launch_bounds__(NT) chunked_fwd_kernel(DpIn a, FwdOut o) {
  extern __shared__ float smem[];
  __shared__ Scratch sc;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int bw = a.bw, L = a.L, Lc = o.Lc;
  const int n_chunks = (L + Lc - 1) / Lc;
  const ReadView v(a, b);

  float* fprev = smem;
  float* fcur = smem + bw;
  float* ffin = smem + 2 * bw;
  float* ck = o.ckpt + (size_t)b * n_chunks * bw;
  int* cks = o.ckpt_start + (size_t)b * n_chunks;

  for (int q = tid; q < bw; q += NT) { fprev[q] = 0.f; ffin[q] = 0.f; }
  __syncthreads();

  long long prev_start = v.ps[0];
  long long last_bs = prev_start;
  bool band_err = false;
  const int rows = v.sl < L ? v.sl : L;
  for (int r = 0; r < rows; ++r) {
    if (r % Lc == 0) {
      for (int q = tid; q < bw; q += NT)
        ck[(size_t)(r / Lc) * bw + q] = fprev[q];
      if (tid == 0) cks[r / Lc] = (int)prev_start;
    }
    const long long bs = dp_row<MAXI>(a, v, r, fprev, fcur, prev_start,
                                      band_err, nullptr, sc);
    if (r == v.sl - 1) {
      for (int q = tid; q < bw; q += NT) ffin[q] = fcur[q];
      last_bs = bs;
    }
    prev_start = bs;
    float* t = fprev; fprev = fcur; fcur = t;
    __syncthreads();
  }

  for (int q = tid; q < bw; q += NT) o.ffwd[(size_t)b * bw + q] = ffin[q];
  if (tid == 0) {
    o.band_err[b] = band_err ? 1 : 0;
    o.last_bs[b] = (int)last_bs;
  }
}

template <int MAXI>
__global__ void __launch_bounds__(NT) chunked_tb_kernel(DpIn a, TbArgs o) {
  extern __shared__ float smem[];
  __shared__ Scratch sc;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int bw = a.bw, L = a.L, Lc = o.Lc;
  const int n_chunks = (L + Lc - 1) / Lc;
  const ReadView v(a, b);

  float* fprev = smem;
  float* fcur = smem + bw;
  int* tile_bs = (int*)(smem + 2 * bw);          // (Lc,) band starts
  uint8_t* tile = o.tile + (size_t)b * Lc * bw;
  const float* ck = o.ckpt + (size_t)b * n_chunks * bw;
  const int* cks = o.ckpt_start + (size_t)b * n_chunks;
  int* segs = o.segs + (size_t)b * (L + 1);
  const int sl = v.sl;
  const int rows = sl < L ? sl : L;

  // the walk starts at the first argmax of the read's last row
  const long long init =
      (long long)row_argmax(o.ffwd + (size_t)b * bw, bw, sc) + o.last_bs[b];
  for (int r = rows + tid; r <= L; r += NT) segs[r] = 0;
  __syncthreads();

  long long ep = init;
  bool berr = false;
  for (int c = (rows - 1) / Lc; rows > 0 && c >= 0; --c) {
    const int r0 = c * Lc;
    const int r1 = r0 + Lc < rows ? r0 + Lc : rows;
    for (int q = tid; q < bw; q += NT) fprev[q] = ck[(size_t)c * bw + q];
    long long prev_start = cks[c];
    bool unused = false;
    __syncthreads();
    for (int r = r0; r < r1; ++r) {
      const long long bs = dp_row<MAXI>(a, v, r, fprev, fcur, prev_start,
                                        unused, tile + (size_t)(r - r0) * bw,
                                        sc);
      if (tid == 0) tile_bs[r - r0] = (int)bs;
      prev_start = bs;
      float* t = fprev; fprev = fcur; fcur = t;
      __syncthreads();
    }
    if (tid < 32) {
      for (int r = r1 - 1; r >= r0; --r) {
        ep = tb_row(tile + (size_t)(r - r0) * bw, tile_bs[r - r0], ep, bw,
                    a.bound_thresh, berr);
        if (tid == 0) segs[r] = (int)(ep + 1);
      }
    }
    __syncthreads();
  }
  if (tid == 0) {
    segs[sl] = (int)(init + 1);
    o.bound_err[b] = berr ? 1 : 0;
  }
}

bool bad_shape(int B, int L, int bw, int P, int Lc) {
  return bw < 1 || bw > NT * MAXI_CAP || B < 1 || L < 1 || P < 1 ||
         Lc < 1;
}

}  // namespace

extern "C" int tombo_banded_dp_chunked_fwd(
    const float* em, int E, const int* n_events, const float* rm,
    const float* rs, int L_in, const int* seq_lens, const int* pstarts,
    const int* pvalid, const int* pend, int P, const int* start_rows,
    int B, int L, int bw, float z_shift, float skip_pen, float stay_pen,
    float mask_fill, float max_half_z, int bound_thresh, int Lc,
    float* ckpt, int* ckpt_start, uint8_t* band_err, float* ffwd,
    int* last_bs, void* stream) {
  if (bad_shape(B, L, bw, P, Lc)) return -1;
  DpIn a{em, E, n_events, rm, rs, L_in, seq_lens, pstarts, pvalid, pend,
         P, start_rows, L, bw, z_shift, skip_pen, stay_pen, mask_fill,
         max_half_z, bound_thresh};
  FwdOut o{Lc, ckpt, ckpt_start, band_err, ffwd, last_bs};
  const int ipt = (bw + NT - 1) / NT;
  const size_t smem = (size_t)3 * bw * sizeof(float);
  cudaStream_t st = (cudaStream_t)stream;
  if (ipt <= 2) return launch(chunked_fwd_kernel<2>, B, smem, st, a, o);
  if (ipt <= 4) return launch(chunked_fwd_kernel<4>, B, smem, st, a, o);
  if (ipt <= 8) return launch(chunked_fwd_kernel<8>, B, smem, st, a, o);
  return launch(chunked_fwd_kernel<16>, B, smem, st, a, o);
}

extern "C" int tombo_banded_dp_chunked_tb(
    const float* em, int E, const int* n_events, const float* rm,
    const float* rs, int L_in, const int* seq_lens, const int* pstarts,
    const int* pvalid, const int* pend, int P, const int* start_rows,
    int B, int L, int bw, float z_shift, float skip_pen, float stay_pen,
    float mask_fill, float max_half_z, int bound_thresh, int Lc,
    const float* ckpt, const int* ckpt_start, const float* ffwd,
    const int* last_bs, uint8_t* tile, int* segs, uint8_t* bound_err,
    void* stream) {
  if (bad_shape(B, L, bw, P, Lc)) return -1;
  DpIn a{em, E, n_events, rm, rs, L_in, seq_lens, pstarts, pvalid, pend,
         P, start_rows, L, bw, z_shift, skip_pen, stay_pen, mask_fill,
         max_half_z, bound_thresh};
  TbArgs o{Lc, ckpt, ckpt_start, ffwd, last_bs, tile, segs, bound_err};
  const int ipt = (bw + NT - 1) / NT;
  const size_t smem = (size_t)2 * bw * sizeof(float) + (size_t)Lc * sizeof(int);
  cudaStream_t st = (cudaStream_t)stream;
  if (ipt <= 2) return launch(chunked_tb_kernel<2>, B, smem, st, a, o);
  if (ipt <= 4) return launch(chunked_tb_kernel<4>, B, smem, st, a, o);
  if (ipt <= 8) return launch(chunked_tb_kernel<8>, B, smem, st, a, o);
  return launch(chunked_tb_kernel<16>, B, smem, st, a, o);
}
