// K5: per-variant score statistic, f64, for sm_90a.
//
// For variant s at its best rho k_s, with cov = v0 Sigma + v1 I expressed in
// the eigenbasis (eigenvalues Sb = S[k_s]) and omega = v0 Sb / (v1 + v0 Sb):
//
//   u^T K0^{-1} v = (u^T v - sum_r omega_r u_r v_r) / v1   for u, v in
//   the columns of [A | X | y], A = At[s] (R, C), X = [W_t, g_t] (R, p+1);
//   B   = (XKX + ridge)^{-1} [XKy | AKX^T]                 (p+1 Cholesky)
//   APy = AKy - AKX B[:, 0],   APA = AKA - AKX B[:, 1:]
//   Q   = 1/2 ||APy||^2,       Wmat = 1/4 (APA + APA^T)
//
// Replaces: cellregmap_tpu/engine.py `score_test_core` as vmapped by
// `interaction_batch`'s `per_snp` (davies branch), lines 234-265, 736-793.
//
// What bounds it on the H100: bytes.  Per variant it reads its (R, C)
// score factor and the R-long rows of its best rho (41 MB in all at the
// headline R=1010, C=10, S=512) and does ~2 R (C+p+2)^2 / 2 flop, a few
// flop per byte.  Its real limit at this size is latency: one block per
// variant walks R serially.
//
// Design: one 256-thread block per (variant, gene); the gene-batched scan
// runs every gene of a tile in one launch, the phenotype's operands offset
// by gene and the genotype's shared, the score factor At_slots[slot[g, s],
// s] read where K4 put it (the genes of a variant that share a best rho
// read one copy from L2).  The block streams the rows of
// [A | W_t | g_t | y_t] through shared memory in chunks of 16 and
// accumulates the omega-weighted Gram of those m = C + p + 2 columns in
// registers, each thread owning up to NACC of its m(m+1)/2 entries.  Two
// instantiations: the narrow one (8 entries a thread: m <= 63, p + 1 <= 8)
// wherever it fits, and the wide one (19: m <= 98, p + 1 <= 33, so C = 64
// with 32 covariates).  Every array of the block lives in dynamic shared
// memory (the full m x m Gram at m = 98 is 77 KB, past the 48 KB a block
// gets without cudaFuncSetAttribute).  The small algebra then runs in
// shared memory: the complement subtraction and 1/v1 scaling, a ridge
// (rcond 1e-12 * max(max|diag|, 1)) Cholesky of the (p+1)^2 system by a
// warp (lane 0 the pivot, the lanes the column below it: serial on one
// thread it would be (p+1)^3 / 6 steps at p + 1 = 33), the 1 + C
// triangular solves on one thread each, and APA, Q and the symmetrised
// Wmat in parallel over the C^2 entries.  Everything is f64.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int NT = 256;    // threads per block (one block per variant)
constexpr int RC = 16;     // rows per shared-memory chunk

// The two instantiations: m = C + p + 2 columns of [A | X | y], each
// thread owning NACC of the m(m+1)/2 Gram entries.
//   narrow: m <= 63, p + 1 <= 8   (NACC = 8)
//   wide:   m <= 98, p + 1 <= 33  (NACC = 19: 4851 entries)
constexpr int NACC_NARROW = 8, NACC_WIDE = 19;

// Shared memory of a block, in doubles: the row chunks and then the Gram
// (m x m, full), the chunk's omega, the (p+1)^2 system, [XKy | AKX^T],
// AKX and APy.
__host__ __device__ inline int smem_words(int C, int p) {
  const int m = C + p + 2, p1 = p + 1;
  const int buf = m * m > RC * m ? m * m : RC * m;
  return buf + RC + p1 * p1 + p1 * (C + 1) + C * p1 + C;
}

template <int NACC>
__global__ void __launch_bounds__(NT)
score_core_kernel(const double* __restrict__ Sv, const double* __restrict__ WGt,
                  const double* __restrict__ yt, const double* __restrict__ At,
                  const double* __restrict__ WW, const double* __restrict__ Wy,
                  const double* __restrict__ Wg, const double* __restrict__ gg,
                  const double* __restrict__ gy, const double* __restrict__ AW,
                  const double* __restrict__ Ag, const double* __restrict__ Ay,
                  const double* __restrict__ AtA,
                  const int64_t* __restrict__ k_best,
                  const double* __restrict__ v0s,
                  const double* __restrict__ v1s,
                  const int64_t* __restrict__ slot, double* __restrict__ Qout,
                  double* __restrict__ Wout, int nrho, int R, int C, int p,
                  int S) {
  extern __shared__ __align__(16) unsigned char score_dyn[];
  const int p1 = p + 1;
  const int m = C + p1 + 1;
  double* buf = reinterpret_cast<double*>(score_dyn);  // chunks, then Gram
  double* om = buf + (m * m > RC * m ? m * m : RC * m);
  double* sA = om + RC;         // [p1][p1]: XKX, then its Cholesky factor
  double* sB = sA + p1 * p1;    // [p1][C + 1]: [XKy | AKX^T], then solved
  double* sAKX = sB + p1 * (C + 1);  // [C][p1]
  double* sAPy = sAKX + C * p1;      // [C]
  const int nb = C + 1;

  // the gene axis: the phenotype's operands and the outputs by gene
  const int64_t gi = blockIdx.y;
  yt += gi * nrho * R;
  slot += gi * S;
  Wy += gi * p;
  gy += gi * S;
  Ay += gi * C * (int64_t)S;
  k_best += gi * S;
  v0s += gi * S;
  v1s += gi * S;
  Qout += gi * S;
  Wout += gi * S * (int64_t)C * C;

  const int s = blockIdx.x;
  const int tid = threadIdx.x;
  const int xo = C;       // first X column of [A | X | y]
  const int yo = C + p1;  // the y column
  const int nent = m * (m + 1) / 2;
  const int ps = p + S;   // row length of the rotated [W | G] stack
  const int64_t k = k_best[s];
  const double v0 = v0s[s];
  const double v1 = v1s[s];
  const double* Sk = Sv + k * R;
  const double* WGk = WGt + k * (int64_t)R * ps;
  const double* yk = yt + k * R;
  const double* Ak = At + (slot[s] * S + s) * (int64_t)R * C;

  // this thread's Gram entries (i >= j) at triangular index i(i+1)/2 + j
  int ei[NACC], ej[NACC];
  double acc[NACC];
#pragma unroll
  for (int t = 0; t < NACC; ++t) {
    const int e = tid + t * NT;
    int i = (int)((sqrt(8.0 * e + 1.0) - 1.0) * 0.5);
    while (i * (i + 1) / 2 > e) --i;
    while ((i + 1) * (i + 2) / 2 <= e) ++i;
    ei[t] = e < nent ? i : 0;
    ej[t] = e < nent ? e - i * (i + 1) / 2 : 0;
    acc[t] = 0.0;
  }

  for (int r0 = 0; r0 < R; r0 += RC) {
    const int rows = min(RC, R - r0);
    for (int idx = tid; idx < rows * m; idx += NT) {
      const int rr = idx / m;
      const int col = idx - rr * m;
      const int64_t r = r0 + rr;
      double v;
      if (col < C) {
        v = Ak[r * C + col];
      } else if (col < C + p) {
        v = WGk[r * ps + (col - C)];
      } else if (col == C + p) {
        v = WGk[r * ps + p + s];
      } else {
        v = yk[r];
      }
      buf[rr * m + col] = v;
    }
    if (tid < rows) {
      const double sb = Sk[r0 + tid];
      om[tid] = (v0 * sb) / (v1 + v0 * sb);
    }
    __syncthreads();
    for (int rr = 0; rr < rows; ++rr) {
      const double w = om[rr];
      const double* row = buf + rr * m;
#pragma unroll
      for (int t = 0; t < NACC; ++t)
        acc[t] = fma(w * row[ei[t]], row[ej[t]], acc[t]);
    }
    __syncthreads();
  }

  // the weighted Gram, full symmetric, at buf[i * m + j]
#pragma unroll
  for (int t = 0; t < NACC; ++t) {
    if (tid + t * NT < nent) {
      buf[ei[t] * m + ej[t]] = acc[t];
      buf[ej[t] * m + ei[t]] = acc[t];
    }
  }
  __syncthreads();

  // K0^{-1} forms: (full-space Gram - weighted eigenbasis Gram) / v1
  for (int idx = tid; idx < p1 * p1; idx += NT) {
    const int i = idx / p1, j = idx - i * p1;
    double xx;
    if (i < p && j < p) xx = WW[i * p + j];
    else if (i < p) xx = Wg[(int64_t)i * S + s];
    else if (j < p) xx = Wg[(int64_t)j * S + s];
    else xx = gg[s];
    sA[i * p1 + j] = (xx - buf[(xo + i) * m + xo + j]) / v1;
  }
  if (tid < p1) {
    const double xy = tid < p ? Wy[tid] : gy[s];
    sB[tid * nb] = (xy - buf[(xo + tid) * m + yo]) / v1;
  }
  for (int idx = tid; idx < C * p1; idx += NT) {
    const int c = idx / p1, i = idx - c * p1;
    const double ax = i < p ? AW[((int64_t)c * p + i) * S + s]
                            : Ag[(int64_t)c * S + s];
    const double v = (ax - buf[c * m + xo + i]) / v1;
    sAKX[c * p1 + i] = v;
    sB[i * nb + 1 + c] = v;
  }
  for (int c = tid; c < C; c += NT)
    sAPy[c] = (Ay[(int64_t)c * S + s] - buf[c * m + yo]) / v1;
  __syncthreads();

  // ridge + Cholesky of the (p+1)^2 system, lower factor in place, by
  // warp 0: lane 0 the diagonal, the lanes the column below it
  if (tid < 32) {
    double dmax = 0.0;
    for (int i = 0; i < p1; ++i) dmax = fmax(dmax, fabs(sA[i * p1 + i]));
    const double ridge = 1e-12 * fmax(dmax, 1.0);
    if (tid < p1) sA[tid * p1 + tid] += ridge;
    __syncwarp();
    for (int j = 0; j < p1; ++j) {
      if (tid == 0) {
        double d = sA[j * p1 + j];
        for (int l = 0; l < j; ++l) d -= sA[j * p1 + l] * sA[j * p1 + l];
        sA[j * p1 + j] = sqrt(d);
      }
      __syncwarp();
      const double d = sA[j * p1 + j];
      for (int i = j + 1 + tid; i < p1; i += 32) {
        double v = sA[i * p1 + j];
        for (int l = 0; l < j; ++l) v -= sA[i * p1 + l] * sA[j * p1 + l];
        sA[i * p1 + j] = v / d;
      }
      __syncwarp();
    }
  }
  __syncthreads();

  // B = A^{-1} [XKy | AKX^T], one right-hand side per thread
  for (int t = tid; t < 1 + C; t += NT) {
    for (int i = 0; i < p1; ++i) {
      double v = sB[i * nb + t];
      for (int l = 0; l < i; ++l) v -= sA[i * p1 + l] * sB[l * nb + t];
      sB[i * nb + t] = v / sA[i * p1 + i];
    }
    for (int i = p1 - 1; i >= 0; --i) {
      double v = sB[i * nb + t];
      for (int l = i + 1; l < p1; ++l) v -= sA[l * p1 + i] * sB[l * nb + t];
      sB[i * nb + t] = v / sA[i * p1 + i];
    }
  }
  __syncthreads();

  // APA in place of the Gram's A block (each entry read and written by one
  // thread), APy in place of AKy
  for (int idx = tid; idx < C * C; idx += NT) {
    const int c = idx / C, d = idx - c * C;
    double v = (AtA[((int64_t)c * C + d) * S + s] - buf[c * m + d]) / v1;
    for (int i = 0; i < p1; ++i) v -= sAKX[c * p1 + i] * sB[i * nb + 1 + d];
    buf[c * m + d] = v;
  }
  for (int c = tid; c < C; c += NT) {
    double v = sAPy[c];
    for (int i = 0; i < p1; ++i) v -= sAKX[c * p1 + i] * sB[i * nb];
    sAPy[c] = v;
  }
  __syncthreads();

  for (int idx = tid; idx < C * C; idx += NT) {
    const int c = idx / C, d = idx - c * C;
    Wout[((int64_t)s * C + c) * C + d] =
        0.25 * (buf[c * m + d] + buf[d * m + c]);
  }
  if (tid == 0) {
    double q = 0.0;
    for (int c = 0; c < C; ++c) q += sAPy[c] * sAPy[c];
    Qout[s] = 0.5 * q;
  }
}

}  // namespace

// Shared by the genes: Sv (nrho, R), WGt (nrho, R, p+S), WW (p, p), Wg
// (p, S), gg (S,), AW (C, p, S), Ag (C, S), AtA (C, C, S), At (m, S, R, C)
// K4's slots.  Per gene: yt (genes, nrho, R), Wy (genes, p), gy (genes,
// S), Ay (genes, C, S), k_best (genes, S) int64, v0, v1 (genes, S), slot
// (genes, S) int64 in [0, m) -> Q (genes, S), Wmat (genes, S, C, C).
// Row-major f64 on the card; C + p + 2 <= 98, p + 1 <= 33, genes <= 65535
// (a single phenotype is genes = 1).  Launches on `stream`; returns
// cudaGetLastError().
extern "C" int crm_score_core(const double* Sv, const double* WGt,
                              const double* yt, const double* At,
                              const double* WW, const double* Wy,
                              const double* Wg, const double* gg,
                              const double* gy, const double* AW,
                              const double* Ag, const double* Ay,
                              const double* AtA, const int64_t* k_best,
                              const double* v0, const double* v1,
                              const int64_t* slot, double* Q, double* Wmat,
                              int nrho, int R, int C, int p, int S,
                              int genes, cudaStream_t stream) {
  const dim3 grid(S, genes);
  // the narrow instantiation where it fits, else the wide one
  const bool wide = C + p + 2 > 63 || p + 1 > 8;
  auto kernel = wide ? score_core_kernel<NACC_WIDE>
                     : score_core_kernel<NACC_NARROW>;
  const int smem = (int)sizeof(double) * smem_words(C, p);
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, NT, smem, stream>>>(Sv, WGt, yt, At, WW, Wy, Wg, gg, gy, AW,
                                     Ag, Ay, AtA, k_best, v0, v1, slot, Q,
                                     Wmat, nrho, R, C, p, S);
  return (int)cudaGetLastError();
}
