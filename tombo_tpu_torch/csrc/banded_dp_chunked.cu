// Sequence-chunked adaptive banded DP + traceback for long reads: a
// forward kernel (K2), one block per read, and a traceback kernel (K2'),
// one thread-block cluster per read.
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
// read at the save bandwidth 1500).  Here no move code leaves the chip:
//   K2  runs every row of the read once with the row step of
//       dp_row_lat.cuh, storing no moves.  Before every Lc-row chunk it
//       writes a checkpoint of the carried state: the forward row (bw
//       floats) and the band start.  At the end it writes the band error
//       flag, the final forward row and its band start.
//   K2' gives each read a cluster of G blocks.  The read's chunks are
//       taken last to first, G at a time (a window): block g restores
//       the checkpoint of the window's g-th chunk from the top and
//       recomputes the chunk's move codes and band starts with the same
//       row step into its own shared memory (an (Lc, bw) uint8 tile and
//       Lc ints), all G chunks side by side.  Then the walk passes down
//       the cluster: the block with the window's highest chunk walks its
//       tile back with one warp (dp_row.cuh tb_row) and writes the event
//       position and bound flag into the next block's shared memory
//       (distributed shared memory), and the cluster meets at
//       cluster.sync() before the next block walks.  The last block of a
//       window hands on to the first block of the next window.
// Per-read device scratch is ceil(L/Lc) * (bw * 4 + 4) bytes.  Lc is the
// tile rows that fit a block's shared-memory budget at this bw
// (ops/banded_dp.py tile_rows: half an SM at bw 300, so two blocks share
// one).  Rows past a read's length do not change the carried state,
// so both kernels stop at the read's own length rather than the batch's L.
//
// What bounds it: the latency of the sequential row step, not bytes or
// FLOPs.  K2 runs a read's rows one after another (dp_row_lat.cuh: a
// block of only the warps that hold band positions, three barriers a
// row).  K2' recomputes G chunks at a time, so its recompute takes about
// 1/G of K2's rows in sequence, and its walk, one warp reading shared
// memory row by row, takes the rest: the walk is the only part of the
// traceback that has to run in order.
//
// K2' has a row-writing instance (ROWS, the DP debug dump of a long read
// on the one-read path): the recompute also stores each row's forward
// values (from registers), and once a chunk's tile is whole the block
// copies its move codes and band starts to device memory, (B, L, bw)
// float32, (B, L, bw) uint8 and (B, L) int32; 45 MB a read at L 30,000,
// bw 300.  Segs and flags stay bitwise the normal instance's, which
// compiles without the stores.
// Build with -fmad=false (dp_row.cuh, Precision): the recomputed rows are
// bitwise the forward rows only if both are compiled alike.
#include <cooperative_groups.h>

#include "dp_row_lat.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace dprow;
using dplat::LatRows;
using dplat::Slots;

struct FwdOut {
  int Lc;
  float* ckpt; int* ckpt_start;     // (B, n_chunks, bw), (B, n_chunks)
  uint8_t* band_err; float* ffwd; int* last_bs;
};

struct TbArgs {
  int Lc;
  const float* ckpt; const int* ckpt_start;
  const float* ffwd; const int* last_bs;
  int* segs; uint8_t* bound_err;
  // ROWS: (B, L, bw) forward rows and move codes, (B, L) band starts
  float* rows; uint8_t* codes; int* starts;
};

// walk state handed from one block of the cluster to the next
struct Carry {
  long long ep;
  int berr;
};

template <int MAXI>
__global__ void __launch_bounds__(NT) chunked_fwd_kernel(DpIn a, FwdOut o) {
  extern __shared__ __align__(16) float smem[];
  __shared__ Slots slots;
  const int b = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int bw = a.bw, L = a.L, Lc = o.Lc;
  const int n_chunks = (L + Lc - 1) / Lc;
  const ReadView v(a, b);
  LatRows<MAXI, false> rw(a, v, slots, smem);
  float* ck = o.ckpt + (size_t)b * n_chunks * bw;
  int* cks = o.ckpt_start + (size_t)b * n_chunks;

  const long long ps0 = v.ps[0];
  const int rows = v.sl < L ? v.sl : L;
  for (int q = tid; q < bw; q += nt) rw.fprev()[q] = 0.f;
  rw.begin(0, rows, ps0);
  for (int r = 0, c = 0; r < rows; ++r) {
    if (r == c * Lc) {           // the state before chunk c
      const float* fp = rw.fprev();
      for (int q = tid; q < bw; q += nt) ck[(size_t)c * bw + q] = fp[q];
      if (tid == 0) cks[c] = (int)rw.prev_start;
      ++c;
    }
    rw.step(r, nullptr);
  }

  // the final row is row seq_len - 1 where the read has one within L
  const bool fin = v.sl >= 1 && v.sl <= L;
  const float* fp = rw.fprev();
  for (int q = tid; q < bw; q += nt)
    o.ffwd[(size_t)b * bw + q] = fin ? fp[q] : 0.f;
  if (tid == 0) {
    o.band_err[b] = rw.band_err ? 1 : 0;
    o.last_bs[b] = (int)(fin ? rw.prev_start : ps0);
  }
}

template <int MAXI, bool ROWS>
__global__ void __launch_bounds__(NT) chunked_tb_kernel(DpIn a, TbArgs o) {
  extern __shared__ __align__(16) float smem[];
  __shared__ Slots slots;
  __shared__ Carry carry;
  cg::cluster_group cluster = cg::this_cluster();
  const int G = (int)cluster.num_blocks();
  const int g = (int)cluster.block_rank();
  const int b = blockIdx.x / G;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int bw = a.bw, L = a.L, Lc = o.Lc;
  const int n_chunks = (L + Lc - 1) / Lc;
  const ReadView v(a, b);
  LatRows<MAXI, true, ROWS> rw(a, v, slots, smem);
  int* tile_bs = (int*)rw.end();                       // (Lc,)
  uint8_t* tile = (uint8_t*)(tile_bs + Lc);            // (Lc, bw)
  const float* ck = o.ckpt + (size_t)b * n_chunks * bw;
  const int* cks = o.ckpt_start + (size_t)b * n_chunks;
  int* segs = o.segs + (size_t)b * (L + 1);
  const int sl = v.sl;
  const int rows = sl < L ? sl : L;
  const int C = (rows + Lc - 1) / Lc;                  // this read's chunks
  const int n_win = (C + G - 1) / G;

  // block 0: the walk starts at the first argmax of the read's last row
  long long init = 0;
  if (g == 0) {
    init = (long long)dplat::row_first_argmax(o.ffwd + (size_t)b * bw, bw,
                                              slots, false) +
           o.last_bs[b];
    for (int r = rows + tid; r <= L; r += nt) segs[r] = 0;
    if (tid == 0) { carry.ep = init; carry.berr = 0; }
  }
  cluster.sync();              // every block running, block 0's carry set

  // Every block of the cluster meets every cluster.sync() below: the
  // window and hop counts depend only on the read, and a block whose
  // chunk lies before row 0 skips its work, not the syncs.
  for (int w = 0; w < n_win; ++w) {
    const int c = C - 1 - w * G - g;
    const int r0 = c * Lc;
    const int r1 = r0 + Lc < rows ? r0 + Lc : rows;
    if (c >= 0) {
      for (int q = tid; q < bw; q += nt)
        rw.fprev()[q] = ck[(size_t)c * bw + q];
      rw.begin(r0, r1, cks[c]);
      for (int r = r0; r < r1; ++r) {
        const long long bs = rw.step(
            r, tile + (size_t)(r - r0) * bw,
            ROWS ? o.rows + ((size_t)b * L + r) * bw : nullptr);
        if (tid == 0) tile_bs[r - r0] = (int)bs;
      }
      __syncthreads();         // the tile is whole
      if (ROWS) {
        const size_t row0 = (size_t)b * L + r0;
        const int n = (r1 - r0) * bw;
        for (int i = tid; i < n; i += nt) o.codes[row0 * bw + i] = tile[i];
        for (int i = tid; i < r1 - r0; i += nt)
          o.starts[row0 + i] = tile_bs[i];
      }
    }
    for (int h = 0; h < G; ++h) {
      if (h == g && c >= 0 && tid < 32) {
        long long ep = carry.ep;
        bool berr = carry.berr != 0;
        for (int r = r1 - 1; r >= r0; --r) {
          ep = tb_row(tile + (size_t)(r - r0) * bw, tile_bs[r - r0], ep, bw,
                      a.bound_thresh, berr);
          if (tid == 0) segs[r] = (int)(ep + 1);
        }
        if (tid == 0) {
          if (c > 0) {
            Carry* nxt = cluster.map_shared_rank(&carry, (g + 1) % G);
            nxt->ep = ep;
            nxt->berr = berr ? 1 : 0;
          } else {
            o.bound_err[b] = berr ? 1 : 0;
          }
        }
      }
      cluster.sync();
    }
  }
  if (g == 0 && tid == 0) {
    if (sl <= L) segs[sl] = (int)(init + 1);
    if (C == 0) o.bound_err[b] = 0;
  }
  cluster.sync();              // no block leaves while another may reach it
}

bool bad_shape(int B, int L, int bw, int P, int Lc) {
  return bw < 1 || bw > NT * MAXI_CAP || B < 1 || L < 1 || P < 1 ||
         Lc < 1;
}

// the instance for bandwidth bw: MAXI >= positions per thread
template <typename K>
K* pick(int bw, K* k2, K* k4, K* k8, K* k16) {
  const int ipt = dplat::pos_per_thread(bw);
  return ipt <= 2 ? k2 : ipt <= 4 ? k4 : ipt <= 8 ? k8 : k16;
}

using FwdKernel = void(DpIn, FwdOut);
using TbKernel = void(DpIn, TbArgs);

FwdKernel* fwd_kernel(int bw) {
  return pick<FwdKernel>(bw, chunked_fwd_kernel<2>, chunked_fwd_kernel<4>,
                         chunked_fwd_kernel<8>, chunked_fwd_kernel<16>);
}

template <bool ROWS>
TbKernel* tb_kernel(int bw) {
  return pick<TbKernel>(bw, chunked_tb_kernel<2, ROWS>,
                        chunked_tb_kernel<4, ROWS>,
                        chunked_tb_kernel<8, ROWS>,
                        chunked_tb_kernel<16, ROWS>);
}

size_t tb_smem(int bw, int Lc) {
  return dplat::rows_smem_bytes(bw) + (size_t)Lc * (bw + 4);
}

// the launch configuration of K2': one cluster of G blocks per read (G <=
// 8, the portable cluster size)
cudaError_t tb_config(TbKernel* k, int B, int bw, int Lc, int G,
                      cudaStream_t st, cudaLaunchConfig_t& cfg,
                      cudaLaunchAttribute* attr) {
  const size_t smem = tb_smem(bw, Lc);
  cudaError_t e = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3((unsigned)B * G);
  cfg.blockDim = dim3(dplat::block_threads(bw));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = G;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaSuccess;
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
  return launch(fwd_kernel(bw), B, dplat::block_threads(bw),
                dplat::rows_smem_bytes(bw), (cudaStream_t)stream, a, o);
}

extern "C" int tombo_banded_dp_chunked_tb(
    const float* em, int E, const int* n_events, const float* rm,
    const float* rs, int L_in, const int* seq_lens, const int* pstarts,
    const int* pvalid, const int* pend, int P, const int* start_rows,
    int B, int L, int bw, float z_shift, float skip_pen, float stay_pen,
    float mask_fill, float max_half_z, int bound_thresh, int Lc, int G,
    const float* ckpt, const int* ckpt_start, const float* ffwd,
    const int* last_bs, int* segs, uint8_t* bound_err, float* rows,
    uint8_t* codes, int* starts, void* stream) {
  if (bad_shape(B, L, bw, P, Lc) || G < 1 || G > 8) return -1;
  // rows null: the normal instance; else all three outputs, row-writing
  if (rows && !(codes && starts)) return -1;
  DpIn a{em, E, n_events, rm, rs, L_in, seq_lens, pstarts, pvalid, pend,
         P, start_rows, L, bw, z_shift, skip_pen, stay_pen, mask_fill,
         max_half_z, bound_thresh};
  TbArgs o{Lc, ckpt, ckpt_start, ffwd, last_bs, segs, bound_err, rows,
           codes, starts};
  TbKernel* k = rows ? tb_kernel<true>(bw) : tb_kernel<false>(bw);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t e = tb_config(k, B, bw, Lc, G, (cudaStream_t)stream, cfg,
                            attr);
  if (e != cudaSuccess) return (int)e;
  e = cudaLaunchKernelEx(&cfg, k, a, o);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// the shared memory K2' asks per block, and how many of its clusters the
// card holds at once (cudaOccupancyMaxActiveClusters), for reports
extern "C" int tombo_banded_dp_chunked_tb_occupancy(int bw, int Lc, int G,
                                                    long long* smem,
                                                    int* clusters) {
  if (bw < 1 || bw > NT * MAXI_CAP || Lc < 1 || G < 1 || G > 8) return -1;
  TbKernel* k = tb_kernel<false>(bw);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t e = tb_config(k, G, bw, Lc, G, 0, cfg, attr);
  if (e != cudaSuccess) return (int)e;
  *smem = (long long)cfg.dynamicSmemBytes;
  return (int)cudaOccupancyMaxActiveClusters(
      clusters, reinterpret_cast<const void*>(k), &cfg);
}
