// K4: best-rho rotation of the score factor, f64, for sm_90a.
//
//   At[s, q, c] = sum_r V[k_s, r, q] * T[r, c, s]        -> (S, R, C)
//
// V (nrho, R, R) holds the per-rho eigenvectors, T (R, C, S) the
// Khatri-Rao rotated score factor (K1's output layout), k_s the variant's
// best rho.
//
// Replaces: cellregmap_tpu/engine.py `interaction_batch` lines 672-688,
// which on the TPU ran as a masked sum over ALL nrho rotations
// (nrho x 2 R^2 C S flop) because the gathered form's thin (R, R) @ (R, C)
// products tile-padded the MXU.  Here each variant is rotated once, at its
// own k_s: 2 R^2 C S flop, 1/nrho of the JAX form.
//
// What bounds it on the H100: operations.  At the headline (R=1010, C=10,
// S=512) it does 1.0e10 flop; its inputs are V (90 MB for 11 rho), T and
// At (41 MB each).  The catch is reuse: each variant reads all of its
// V[k_s] (8 MB), i.e. 4 GB of V reads per batch, which only the 50 MB L2
// can serve at speed.
//
// Design: one block per (variant, 128-wide q tile, 16-wide c block).  The
// block walks r in chunks of 32, staging T[r-chunk, c-block, s] in shared
// memory; each thread owns one output row q, reads V[k_s, r, q] coalesced
// along q, and keeps 16 accumulators in registers (FMA).  The wrapper
// passes the variants in k_best order (`order`), so blocks that share one
// V[k] are scheduled together and hit it in L2.  Simple and correct: no
// DMMA tiles, no cp.async/TMA staging yet.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int QT = 128;  // q tile, one thread per output row
constexpr int RC = 32;   // r chunk staged in shared memory
constexpr int CB = 16;   // c block held in registers

__global__ void __launch_bounds__(QT)
best_rho_rotate_kernel(const double* __restrict__ V,
                       const double* __restrict__ T,
                       const int64_t* __restrict__ k_best,
                       const int64_t* __restrict__ order,
                       double* __restrict__ At, int R, int C, int S) {
  __shared__ double Ts[RC][CB];
  const int s = (int)order[blockIdx.y];
  const int q = blockIdx.x * QT + threadIdx.x;
  const int c0 = blockIdx.z * CB;
  const double* Vk = V + k_best[s] * (int64_t)R * R;

  double acc[CB];
#pragma unroll
  for (int cc = 0; cc < CB; ++cc) acc[cc] = 0.0;

  for (int r0 = 0; r0 < R; r0 += RC) {
    for (int i = threadIdx.x; i < RC * CB; i += QT) {
      const int rr = i / CB, cc = i % CB;
      const int r = r0 + rr, c = c0 + cc;
      Ts[rr][cc] = (r < R && c < C) ? T[((int64_t)r * C + c) * S + s] : 0.0;
    }
    __syncthreads();
    if (q < R) {
      const int rmax = min(RC, R - r0);
      for (int rr = 0; rr < rmax; ++rr) {
        const double v = Vk[(int64_t)(r0 + rr) * R + q];
#pragma unroll
        for (int cc = 0; cc < CB; ++cc) acc[cc] = fma(v, Ts[rr][cc], acc[cc]);
      }
    }
    __syncthreads();
  }

  if (q < R) {
    double* out = At + ((int64_t)s * R + q) * C;
#pragma unroll
    for (int cc = 0; cc < CB; ++cc)
      if (c0 + cc < C) out[c0 + cc] = acc[cc];
  }
}

}  // namespace

// V (nrho, R, R), T (R, C, S), k_best (S,) int64, order (S,) int64 (a
// permutation of the variants), At (S, R, C): row-major on the card.
// Launches on `stream`; returns cudaGetLastError().
extern "C" int crm_best_rho_rotate(const double* V, const double* T,
                                   const int64_t* k_best,
                                   const int64_t* order, double* At, int R,
                                   int C, int S, cudaStream_t stream) {
  const dim3 grid((R + QT - 1) / QT, S, (C + CB - 1) / CB);
  best_rho_rotate_kernel<<<grid, QT, 0, stream>>>(V, T, k_best, order, At, R,
                                                  C, S);
  return (int)cudaGetLastError();
}
