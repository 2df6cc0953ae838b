// Streaming multi-pivot count: out[b, p] = #{ m : keys[b, m] <= piv[b, p] }.
//
// Replaces the Pallas TPU kernel tombo_tpu/ops/rescale.py _count_le_pallas
// (_count_le_kernel), the inner pass of the exact Theil-Sen median: each
// selection round counts the order-preserving int32 pair-slope keys of
// every read against up to 32 pivots in one pass over the key buffer.
//
// What bounds it on an H100: bytes.  A 512-read fit at N 1024 holds
// 512 x 523,776 int32 keys (1.07 GB) and each round reads them once, while
// it does only 2 integer operations per key and pivot.  The design streams
// the keys with 16-byte loads, neighbouring threads on neighbouring
// addresses, over a grid of (chunk of keys, read) blocks large enough to
// keep every SM's loads in flight; the pivots sit in registers, each thread
// counts in registers, and a warp shuffle plus one shared-memory and one
// global integer atomicAdd per pivot and block merge the counts.  Integer
// counts make the result exact in any order.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int CT = 256;                 // threads per block
constexpr long long CHUNK = CT * 4 * 16;  // keys per block

template <int NP>
__global__ void __launch_bounds__(CT) count_le_kernel(
    const int* __restrict__ keys, long long M, const int* __restrict__ piv,
    int P, int* __restrict__ out) {
  __shared__ int bc[NP];
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  int pv[NP];
#pragma unroll
  for (int p = 0; p < NP; ++p)
    pv[p] = p < P ? piv[(size_t)b * P + p] : INT_MIN;
  if (tid < NP) bc[tid] = 0;
  __syncthreads();

  int cnt[NP];
#pragma unroll
  for (int p = 0; p < NP; ++p) cnt[p] = 0;

  const int* row = keys + (size_t)b * M;
  const long long start = (long long)blockIdx.x * CHUNK;
  const long long end = start + CHUNK < M ? start + CHUNK : M;
  if ((M & 3) == 0) {
    // rows start 16-byte aligned when M is a multiple of 4
    const int4* row4 = reinterpret_cast<const int4*>(row);
    for (long long i = start / 4 + tid; i < end / 4; i += CT) {
      int4 k = __ldg(row4 + i);
#pragma unroll
      for (int p = 0; p < NP; ++p)
        cnt[p] += (k.x <= pv[p]) + (k.y <= pv[p]) + (k.z <= pv[p]) +
                  (k.w <= pv[p]);
    }
  } else {
    for (long long i = start + tid; i < end; i += CT) {
      int k = __ldg(row + i);
#pragma unroll
      for (int p = 0; p < NP; ++p) cnt[p] += (k <= pv[p]);
    }
  }

#pragma unroll
  for (int p = 0; p < NP; ++p) {
    int c = cnt[p];
    for (int o = 16; o > 0; o >>= 1) c += __shfl_down_sync(0xffffffffu, c, o);
    if ((tid & 31) == 0 && c) atomicAdd(&bc[p], c);
  }
  __syncthreads();
  if (tid < P && tid < NP && bc[tid]) atomicAdd(&out[(size_t)b * P + tid], bc[tid]);
}

template <int NP>
int launch(const int* keys, long long M, const int* piv, int P, int B,
           int* out, cudaStream_t st) {
  dim3 grid((unsigned)((M + CHUNK - 1) / CHUNK), (unsigned)B);
  count_le_kernel<NP><<<grid, CT, 0, st>>>(keys, M, piv, P, out);
  return (int)cudaGetLastError();
}

}  // namespace

// out must be zeroed by the caller; returns the launch's cudaError_t
extern "C" int tombo_count_le(const int* keys, long long M, const int* piv,
                              int P, int B, int* out, void* stream) {
  if (P < 1 || P > 32 || B < 1 || M < 1 || B > 65535) return -1;
  cudaStream_t st = (cudaStream_t)stream;
  if (P <= 8) return launch<8>(keys, M, piv, P, B, out, st);
  if (P <= 16) return launch<16>(keys, M, piv, P, B, out, st);
  return launch<32>(keys, M, piv, P, B, out, st);
}
