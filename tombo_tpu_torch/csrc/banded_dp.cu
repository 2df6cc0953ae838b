// Fused adaptive banded DP + traceback (K1), one thread block per read.
//
// Replaces the Pallas TPU kernel tombo_tpu/ops/pallas_dp.py
// adaptive_banded_dp_tb (_make_kernel; _pallas_dp_block for small blocks).
// It computes what tombo_tpu_torch/ops/banded_dp.py
// adaptive_banded_dp_tb_plain computes (the row loops of ops/dp.py): the
// row step of dp_row_lat.cuh over each read's own rows [0, min(seq_len,
// L)), then, in the same kernel, the walk back from the first argmax of
// the read's last row.
//
// What bounds it on an H100: neither bytes nor FLOPs.  A 512-read batch at
// L 1024, bw 300 moves ~10 MB of inputs and outputs and does ~3 GFLOP.  A
// read's rows run one after another, so the latency of one row step bounds
// it, with fewer reads than SMs (a long length group) and with ~4 reads an
// SM (512 reads on 132 SMs, where reads sharing an SM lengthened a row by
// ~18% on an H100 SXM).  The row step (dp_row_lat.cuh) is built for that
// latency: a block of only the warps that hold band positions (160
// threads at bw 300), three barriers a row, branch-free positions, inputs
// staged in shared memory ahead of the band.  The register budget lets 5
// blocks share an SM at bw 300, so a 512-read batch runs in one wave.
// Rows past a read's length are not run: they would change nothing the
// walk reads.
//
// Each row's move codes (0 stay, 1 skip, 2 diag) and band start go to one
// row of a device scratch, mst bytes a row (ops/banded_dp.py move_stride:
// the bw codes, then the band start as an int in the row's last 4 bytes,
// rows 16-byte aligned).  The walk is one warp, one row at a time, each row
// waiting on the row after it; but which bytes a row holds does not depend
// on the walk, so the whole block copies windows of rows into shared
// memory ahead of the warp (cp.async, 16 bytes a copy, two windows, one
// barrier a window) and the warp reads only shared memory.
//
// The row-writing instance (ROWS, the DP debug dump of the one-read path,
// replacing what tombo_tpu/pipeline/resquiggle.py _dump_dp_debug reads
// from the JAX package's numpy forward pass) also stores each row's bw
// forward values, from registers, to a (B, L, bw) float32 output; the
// move codes and band starts are the scratch rows above, which the
// wrapper returns.  Its extra stores, L * bw * 4 bytes a read, are what
// it adds to the normal instance; every other output is bitwise the
// normal instance's.  The normal instance compiles without them.
// Build with -fmad=false so no multiply-add is contracted (dp_row.cuh,
// Precision).
#include "dp_row_lat.cuh"

namespace {

using namespace dprow;
using dplat::LatRows;
using dplat::Slots;

constexpr int WALK_ROWS = 64;          // rows of a walk window, at most
constexpr int WALK_SMEM = 40 * 1024;   // bytes of the two windows, at most

struct Out {
  uint8_t* moves; int mst;           // (B, L, mst) scratch rows
  int walk_rows;                     // rows of a walk window
  int* segs; uint8_t* band_err; uint8_t* bound_err; float* ffwd;
  float* rows;                       // (B, L, bw) forward rows (ROWS)
};

// blocks of 256 threads an SM that the register budget keeps room for:
// 3 caps a thread at 80 registers, and at 80 an SM's 65,536 registers hold
// 5 blocks of 160 threads (bw 300), so 512 reads fit 132 SMs at once
constexpr int min_blocks(int maxi) {
  return maxi == 2 ? 3 : maxi == 4 ? 2 : 1;
}

template <int MAXI, bool ROWS>
__global__ void __launch_bounds__(NT, min_blocks(MAXI))
    banded_dp_kernel(DpIn a, Out o) {
  extern __shared__ __align__(16) float smem[];
  __shared__ Slots slots;
  const int b = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int bw = a.bw, L = a.L, mst = o.mst;
  const ReadView v(a, b);
  uint8_t* mv = o.moves + (size_t)b * L * mst;
  int* segs = o.segs + (size_t)b * (L + 1);
  const int sl = v.sl;
  const int rows = sl < 0 ? 0 : sl < L ? sl : L;
  const long long ps0 = v.ps[0];

  // no boundary past the read's rows (segs[seq_len] is set last)
  for (int r = rows + tid; r <= L; r += nt) segs[r] = 0;

  LatRows<MAXI, true, ROWS> rw(a, v, slots, smem);
  float* fo = ROWS ? o.rows + (size_t)b * L * bw : nullptr;
  for (int q = tid; q < bw; q += nt) rw.fprev()[q] = 0.f;
  rw.begin(0, rows, ps0);
  for (int r = 0; r < rows; ++r) {
    uint8_t* row = mv + (size_t)r * mst;
    const long long bs = rw.step(r, row, ROWS ? fo + (size_t)r * bw
                                              : nullptr);
    if (tid == 0) *(int*)(row + mst - 4) = (int)bs;
  }

  // The final row is row seq_len - 1 where the read has one within L; a
  // read without one keeps a zero row and walks from its first prefix
  // band start.
  const bool fin = sl >= 1 && sl <= L;
  const float* fp = rw.fprev();
  for (int q = tid; q < bw; q += nt)
    o.ffwd[(size_t)b * bw + q] = fin ? fp[q] : 0.f;
  const long long init = fin ? (long long)rw.amax + rw.prev_start : ps0;
  if (tid == 0) o.band_err[b] = rw.band_err ? 1 : 0;

  // The walk, last row first, window by window.  Window w holds rows
  // [lo, hi), hi = rows - w * W, in buffer w & 1 of the row loop's shared
  // memory, which is free once every thread is past the barrier below.
  const int W = o.walk_rows;
  const int n_win = (rows + W - 1) / W;
  uint8_t* win = (uint8_t*)smem;
  auto copy_window = [&](int w) {
    const int hi = rows - w * W, lo = hi > W ? hi - W : 0;
    const uint8_t* src = mv + (size_t)lo * mst;
    uint8_t* dst = win + (size_t)(w & 1) * W * mst;
    const int n = (hi - lo) * mst / 16;
    for (int i = tid; i < n; i += nt)
      dplat::cp_async16(dst + 16 * i, src + 16 * i);
    dplat::cp_async_commit();
  };
  __syncthreads();             // the scratch rows written, the final row read
  if (n_win > 0) copy_window(0);
  long long ep = init;
  bool berr = false;
  for (int w = 0; w < n_win; ++w) {
    const int hi = rows - w * W, lo = hi > W ? hi - W : 0;
    dplat::cp_async_wait_all();
    __syncthreads();           // window w is in; window w - 1 was walked
    if (w + 1 < n_win) copy_window(w + 1);
    if (tid < 32) {
      const uint8_t* buf = win + (size_t)(w & 1) * W * mst;
      for (int r = hi - 1; r >= lo; --r) {
        const uint8_t* row = buf + (size_t)(r - lo) * mst;
        ep = tb_row(row, *(const int*)(row + mst - 4), ep, bw,
                    a.bound_thresh, berr);
        if (tid == 0) segs[r] = (int)(ep + 1);
      }
    }
  }
  if (tid == 0) {
    if (sl >= 0 && sl <= L) segs[sl] = (int)(init + 1);
    o.bound_err[b] = berr ? 1 : 0;
  }
}

using Kernel = void(DpIn, Out);

// the instance for bandwidth bw: MAXI >= positions per thread
template <bool ROWS>
Kernel* kernel_for(int bw) {
  const int ipt = dplat::pos_per_thread(bw);
  return ipt <= 2   ? banded_dp_kernel<2, ROWS>
         : ipt <= 4 ? banded_dp_kernel<4, ROWS>
         : ipt <= 8 ? banded_dp_kernel<8, ROWS>
                    : banded_dp_kernel<16, ROWS>;
}

int walk_rows(int mst) {
  const int w = WALK_SMEM / (2 * mst);
  return w < 1 ? 1 : w > WALK_ROWS ? WALK_ROWS : w;
}

// dynamic shared memory: the row loop's, then the walk's two windows in
// the same bytes
size_t smem_bytes(int bw, int mst) {
  const size_t rows_loop = dplat::rows_smem_bytes(bw);
  const size_t walk = (size_t)2 * walk_rows(mst) * mst;
  return rows_loop > walk ? rows_loop : walk;
}

// bw codes and a 4-byte band start, 16-byte rows
bool bad_shape(int bw, int mst) {
  return bw < 1 || bw > NT * MAXI_CAP || mst < bw + 4 || mst % 16 != 0;
}

}  // namespace

extern "C" int tombo_banded_dp(
    const float* em, int E, const int* n_events, const float* rm,
    const float* rs, int L_in, const int* seq_lens, const int* pstarts,
    const int* pvalid, const int* pend, int P, const int* start_rows,
    int B, int L, int bw, float z_shift, float skip_pen, float stay_pen,
    float mask_fill, float max_half_z, int bound_thresh, uint8_t* moves,
    int mst, int* segs, uint8_t* band_err, uint8_t* bound_err, float* ffwd,
    float* rows, void* stream) {
  if (bad_shape(bw, mst) || B < 1 || L < 1 || P < 1) return -1;
  DpIn a{em, E, n_events, rm, rs, L_in, seq_lens, pstarts, pvalid, pend,
         P, start_rows, L, bw, z_shift, skip_pen, stay_pen, mask_fill,
         max_half_z, bound_thresh};
  Out o{moves, mst, walk_rows(mst), segs, band_err, bound_err, ffwd, rows};
  // rows null: the normal instance; else the row-writing one
  return launch(rows ? kernel_for<true>(bw) : kernel_for<false>(bw), B,
                dplat::block_threads(bw), smem_bytes(bw, mst),
                (cudaStream_t)stream, a, o);
}

// K1's block at bandwidth bw and move-row stride mst: its threads, its
// dynamic shared memory and how many of its blocks an SM holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), for reports
extern "C" int tombo_banded_dp_occupancy(int bw, int mst, int* threads,
                                         long long* smem, int* blocks) {
  if (bad_shape(bw, mst)) return -1;
  Kernel* k = kernel_for<false>(bw);
  *threads = dplat::block_threads(bw);
  *smem = (long long)smem_bytes(bw, mst);
  const cudaError_t e = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, k, *threads, (size_t)*smem);
}
