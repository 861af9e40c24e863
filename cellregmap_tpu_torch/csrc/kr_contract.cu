// K1: Khatri-Rao contraction, f64, for sm_90a.
//
//   M[k, j, s] = sum_n U[n, k] * V[n, j] * G[n, s]      -> (K, p, S)
//
// Replaces: cellregmap_tpu/engine.py `_kr_contract` (and its callers
// `_khatri_rao_rotate`, `_e0_weighted_grams`, `_cross_weighted_grams`),
// which XLA ran as one (K, n) @ (n, p*S) matmul over a materialized
// Khatri-Rao operand, cell-blocked to bound the TPU's f64 limb expansion.
//
// What bounds it on the H100: operations.  At the scan's headline shape
// (n=2000, K=R=1010, p=C=10, S=512) the T contraction does 2nKpS = 2.1e10
// f64 flop on 16 MB of input and 41 MB of output: ~250 flop per byte, far
// above the f64 ridge point (67 TFLOP/s FP64 tensor core / 3.35 TB/s = 20).
//
// Design: a tiled GEMM C = U^T B with B = (V o G) of shape (n, p*S) that
// is never written to device memory.  Each 64 x 64 output tile loops over
// n in chunks of 16; per chunk the block stages U[n-chunk, k-tile] in
// shared memory and forms B[n, (j,s)] = V[n, j] * G[n, s] as it loads the
// B tile into shared memory, so the 8 n p S bytes of the materialized
// operand (82 MB at the headline) never touch HBM.  Each of 256 threads
// accumulates a 4 x 4 register micro-tile with FMA (strided by 16, so the
// shared-memory reads are conflict-free broadcasts).  Loads of U and G are
// coalesced along k and s.  This is the simple, correct version: no DMMA
// (mma.sync.m8n8k4.f64), no cp.async/TMA pipeline yet.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int BM = 64;   // k tile
constexpr int BN = 64;   // (j, s) column tile
constexpr int BK = 16;   // cell (n) chunk
constexpr int TPB = 256; // 16 x 16 threads, 4 x 4 outputs each
constexpr int TM = 4;
constexpr int TN = 4;

__global__ void __launch_bounds__(TPB)
kr_contract_kernel(const double* __restrict__ U, const double* __restrict__ V,
                   const double* __restrict__ G, double* __restrict__ M,
                   int n, int K, int p, int S) {
  __shared__ double As[BK][BM];  // As[kk][m] = U[n0 + kk, k0 + m]
  __shared__ double Bs[BK][BN];  // Bs[kk][c] = V[n0 + kk, j] * G[n0 + kk, s]
  const int PS = p * S;
  const int k0 = blockIdx.y * BM;
  const int c0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  double acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0;

  for (int n0 = 0; n0 < n; n0 += BK) {
    for (int i = tid; i < BK * BM; i += TPB) {
      const int kk = i / BM, m = i % BM;
      const int nn = n0 + kk, k = k0 + m;
      As[kk][m] = (nn < n && k < K) ? U[(int64_t)nn * K + k] : 0.0;
    }
    for (int i = tid; i < BK * BN; i += TPB) {
      const int kk = i / BN, c = i % BN;
      const int nn = n0 + kk, cc = c0 + c;
      double b = 0.0;
      if (nn < n && cc < PS) {
        const int j = cc / S;
        const int s = cc - j * S;
        b = V[(int64_t)nn * p + j] * G[(int64_t)nn * S + s];
      }
      Bs[kk][c] = b;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      double a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fma(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int k = k0 + ty + 16 * i;
    if (k >= K) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = c0 + tx + 16 * j;
      if (c < PS) M[(int64_t)k * PS + c] = acc[i][j];
    }
  }
}

}  // namespace

// U (n, K), V (n, p), G (n, S), M (K, p, S): all row-major f64 on the card.
// Launches on `stream`; returns cudaGetLastError().
extern "C" int crm_kr_contract(const double* U, const double* V,
                               const double* G, double* M, int n, int K,
                               int p, int S, cudaStream_t stream) {
  const dim3 grid((p * S + BN - 1) / BN, (K + BM - 1) / BM);
  kr_contract_kernel<<<grid, TPB, 0, stream>>>(U, V, G, M, n, K, p, S);
  return (int)cudaGetLastError();
}
