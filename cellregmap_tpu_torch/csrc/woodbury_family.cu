// K9: the Woodbury family evaluator of the effect sizes, f32 and f64, for
// sm_90a.
//
// Per variant s, the rotated columns c_r = [Ua_r (C) | UB_r (pB) | ug_r |
// uy_r] (q = C + pB + 2 of them, r < Rk) and the complement Gram comp_s
// (q x q); per point (s, l), delta = sigmoid(logit) and rho
// (cellregmap_tpu/models/lmm.py:435-602):
//
//   m_r = (1 - delta) ((1 - rho) Lam_r) + delta,   cvec = (1 - delta) rho,
//   Mi = sum_r c_r c_r^T / m_r + comp_s / delta,
//   J = Mi o (w w^T) + diag(1..1, 0..0),   w = [sqrt(cvec) x C, 1 x (p + 1)],
//
// and the Cholesky of J (p = pB + 1 covariates [B, g], the last row y):
// its first C pivots give det(I + cvec H), the next p the GLS normal
// matrix's determinant, the last one the GLS residual rss.
//
//   lml entry: f64 with the ridge rcond * max(max|diag J|, 1) on all of J,
//     f32 with none; logdet D = sum_r log m_r + (n - Rk) log delta
//     + logdet cap; REML lml = -(nu log(2 pi rss / nu) + logdet D + logdet A
//     - logdet X^TX + nu) / 2 (nu = n - p), ML -(n log(2 pi rss / n)
//     + logdet D + n) / 2; in f32 a point with rss_raw <= 8 tiny_f32 or a
//     non-finite lml is -inf.
//   beta entry (f64): the same factorization, but the ridge (rcond *
//     max(max|diag A|, 1)) goes on the covariate block A of the Schur
//     complement left after the first C columns, as
//     `_family_blocks_matrix` ridges A; then beta = A^-1 b from the
//     factor's last row and rss_raw = the last trailing entry.
//
// A failed factorization (a pivot <= 0 or NaN) is NaN throughout, as the
// JAX engine's Cholesky returns it.
//
// Replaces: cellregmap_tpu/models/lmm.py `_family_eval_batch` and
// `_family_blocks_matrix`, which XLA ran as chunk-scanned batched GEMMs
// over materialized weighted columns (S, chunk, Rk, q) plus a batched
// Cholesky of the (S, L, q, q) blocks.
//
// What bounds it on the H100: operations.  Per point the Gram's upper
// triangle is Rk q (q + 1) flop (0.55 MFLOP at Rk = 1000, q = 23); a
// headline betas batch (512 variants) evaluates ~1000 points a variant.
// Design: one 256-thread block per (variant, group of P points).  The
// block stages 32-row chunks of the variant's columns (Ua and ug gathered
// from the Khatri-Rao layout, UB and uy from their single copies) and the
// P points' weights in shared memory; each thread owns a few (pair (i, j),
// run of PT points) items and keeps their sums in registers, so one
// product c_i c_j feeds PT FMAs.  P shrinks as q grows (q <= 44: PT = 4 and
// 4 items a thread; q <= 128: PT = 1 and 36 items).  In the epilogue the
// sums become J in shared memory, a group of points at a time, and each
// warp factors one point's J (right-looking, lanes over the trailing
// block) and writes its lml (and beta, rss).
#include <cuda_runtime.h>
#include <algorithm>
#include <cfloat>
#include <cmath>
#include <cstdint>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int NT = 256;
constexpr int NWARP = NT / 32;
constexpr int RC = 32;        // Rk rows staged per chunk
constexpr int MAXP = 32;      // points per block
constexpr int MAXQ = 128;     // columns [Ua | UB, g | y]
constexpr int EPI_BYTES = 96 * 1024;  // epilogue matrices of one group

template <class T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

template <class T>
__device__ __forceinline__ T tiny_of() {
  return sizeof(T) == 4 ? (T)FLT_MIN : (T)DBL_MIN;
}

// One point's epilogue on the calling warp: J (q x q, lower triangle
// row-major in shared memory) is factored in place; lane 0 writes lml (and
// beta, rss).
template <class T>
__device__ void point_epilogue(T* J, int q, int C, int p, T rcond, T dl,
                               T logm, T ld_xx, int n, int Rk, bool reml,
                               bool want_beta, T* lml_out, T* beta_out,
                               T* rss_out) {
  const int lane = threadIdx.x % 32;
  const bool f32 = sizeof(T) == 4;
  if (!want_beta && !f32) {
    T dmax = 0;
    for (int i = 0; i < q; ++i) dmax = fmax(dmax, fabs(J[i * q + i]));
    __syncwarp();
    if (lane == 0)
      for (int i = 0; i < q; ++i) J[i * q + i] += rcond * fmax(dmax, (T)1);
    __syncwarp();
  }
  T ld_cap = 0, ld_a = 0, rss_raw = 0;
  for (int k = 0; k < q; ++k) {
    if (want_beta && k == C) {
      // ridge the covariate block of the Schur complement
      T dmax = 0;
      for (int i = C; i < C + p; ++i) dmax = fmax(dmax, fabs(J[i * q + i]));
      __syncwarp();
      if (lane == 0)
        for (int i = C; i < C + p; ++i)
          J[i * q + i] += rcond * fmax(dmax, (T)1);
      __syncwarp();
    }
    const T d = J[k * q + k];
    if (want_beta && k == q - 1) {
      rss_raw = d;
      break;
    }
    const T piv = sqrt(d > 0 ? d : (T)-1);   // NaN where the factor fails
    if (k < C) ld_cap += log(piv);
    else if (k < q - 1) ld_a += log(piv);
    else rss_raw = piv * piv;
    __syncwarp();
    if (lane == 0) J[k * q + k] = piv;
    for (int i = k + 1 + lane; i < q; i += 32) J[i * q + k] /= piv;
    __syncwarp();
    for (int i = k + 1; i < q; ++i) {
      const T lik = J[i * q + k];
      for (int j = k + 1 + lane; j <= i; j += 32)
        J[i * q + j] -= lik * J[j * q + k];
    }
    __syncwarp();
  }
  if (lane != 0) return;
  if (want_beta) {
    // back substitution A^T beta = z, z the factor's last row, in place
    T* z = J + (q - 1) * q + C;
    for (int a = p - 1; a >= 0; --a) {
      T v = z[a];
      for (int b = a + 1; b < p; ++b) v -= J[(C + b) * q + C + a] * z[b];
      z[a] = v / J[(C + a) * q + C + a];
      beta_out[a] = z[a];
    }
  }
  const T tiny = tiny_of<T>();
  const T rss = rss_raw < tiny ? tiny : rss_raw;   // keeps a NaN
  const T two_pi = (T)6.283185307179586;
  const T logdet_d = logm + (T)(n - Rk) * log(dl) + (T)2 * ld_cap;
  T lml;
  if (reml) {
    const T nu = (T)(n - p);
    lml = (T)-0.5 * (nu * log(two_pi * rss / nu) + logdet_d + (T)2 * ld_a -
                     ld_xx + nu);
  } else {
    lml = (T)-0.5 * ((T)n * log(two_pi * rss / (T)n) + logdet_d + (T)n);
  }
  if (f32 && !want_beta &&
      (rss_raw <= (T)8 * (T)FLT_MIN || !isfinite(lml)))
    lml = -INFINITY;
  *lml_out = lml;
  if (want_beta) *rss_out = rss;
}

template <class T, int PT, int ITEMS>
__global__ void __launch_bounds__(NT)
family_kernel(const T* __restrict__ logits, const T* __restrict__ rho,
              const T* __restrict__ Ua, const T* __restrict__ UB,
              const T* __restrict__ ug, const T* __restrict__ uy,
              const T* __restrict__ comp, const T* __restrict__ Lam,
              const T* __restrict__ ld_xx, T* __restrict__ lml_out,
              T* __restrict__ beta_out, T* __restrict__ rss_out, T rcond,
              int n, int S, int L, int Rk, int C, int pB, int P, int G,
              int nblk, int reml, int want_beta) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  __shared__ T dl_sh[MAXP], omd_sh[MAXP], omr_sh[MAXP], cv_sh[MAXP],
      i1_sh[MAXP];
  const int s = blockIdx.x / nblk;
  const int l0 = (blockIdx.x % nblk) * P;
  const int np = min(P, L - l0);                 // the block's real points
  const int q = C + pB + 2, p = pB + 1;
  const int npairs = q * (q + 1) / 2;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x < P) {
    // points past L repeat the last one and are never written
    const int64_t at = (int64_t)s * L + l0 + min((int)threadIdx.x, np - 1);
    const T dl = (T)1 / ((T)1 + exp(-logits[at]));
    dl_sh[threadIdx.x] = dl;
    omd_sh[threadIdx.x] = (T)1 - dl;
    omr_sh[threadIdx.x] = (T)1 - rho[at];
    cv_sh[threadIdx.x] = ((T)1 - dl) * rho[at];
    i1_sh[threadIdx.x] = (T)1 / dl;
  }

  // items: (pair (i >= j), run st of PT points), packed st << 16 | i << 8 | j
  int code[ITEMS];
  T acc[ITEMS][PT];
#pragma unroll
  for (int a = 0; a < ITEMS; ++a) {
    const int k = threadIdx.x + a * NT;
    code[a] = -1;
    if (k < npairs * (P / PT)) {
      int pi = k % npairs, i = 0;
      while (pi > i) pi -= ++i;
      code[a] = (k / npairs) << 16 | i << 8 | pi;
    }
#pragma unroll
    for (int t = 0; t < PT; ++t) acc[a][t] = 0;
  }
  __syncthreads();

  T* cs = sm;               // [RC][q] the chunk's columns
  T* ws = sm + RC * q;      // [P][RC] the points' weights 1 / m
  for (int r0 = 0; r0 < Rk; r0 += RC) {
    const int nr = min(RC, Rk - r0);
    for (int e = threadIdx.x; e < RC * q; e += NT) {
      const int rr = e / q, col = e - rr * q;
      const int64_t r = r0 + rr;
      T v = 0;
      if (rr < nr) {
        if (col < C) v = Ua[(r * C + col) * S + s];
        else if (col < C + pB) v = UB[r * pB + col - C];
        else if (col == C + pB) v = ug[r * S + s];
        else v = uy[r];
      }
      cs[e] = v;
    }
    for (int e = threadIdx.x; e < P * RC; e += NT) {
      const int l = e / RC, rr = e - l * RC;
      ws[e] = rr < nr ? (T)1 / (omd_sh[l] * (omr_sh[l] * Lam[r0 + rr]) +
                                dl_sh[l])
                      : (T)0;
    }
    __syncthreads();
    for (int rr = 0; rr < nr; ++rr) {
      const T* c = cs + rr * q;
#pragma unroll
      for (int a = 0; a < ITEMS; ++a) {
        if (code[a] < 0) continue;
        const int i = (code[a] >> 8) & 0xff, j = code[a] & 0xff;
        const T cij = c[i] * c[j];
        const T* w = ws + (code[a] >> 16) * PT * RC + rr;
#pragma unroll
        for (int t = 0; t < PT; ++t) acc[a][t] += cij * w[t * RC];
      }
    }
    __syncthreads();
  }

  // epilogue, a group of G points at a time: J into shared memory, then a
  // warp per point
  const int qq = q * q;
  for (int g0 = 0; g0 < np; g0 += G) {
    const int ng = min(G, np - g0);
#pragma unroll
    for (int a = 0; a < ITEMS; ++a) {
      if (code[a] < 0) continue;
      const int i = (code[a] >> 8) & 0xff, j = code[a] & 0xff;
      const T cij = comp[((int64_t)s * q + i) * q + j];
#pragma unroll
      for (int t = 0; t < PT; ++t) {
        const int l = (code[a] >> 16) * PT + t;
        if (l < g0 || l >= g0 + ng) continue;
        const T sw = sqrt(cv_sh[l]);
        const T wij = (i < C ? sw : (T)1) * (j < C ? sw : (T)1);
        T v = (acc[a][t] + cij * i1_sh[l]) * wij;
        if (i == j && i < C) v += (T)1;
        sm[(l - g0) * qq + i * q + j] = v;
      }
    }
    __syncthreads();
    for (int lg = warp; lg < ng; lg += NWARP) {
      const int l = g0 + lg;
      T logm = 0;
      for (int r = lane; r < Rk; r += 32)
        logm += log(omd_sh[l] * (omr_sh[l] * Lam[r]) + dl_sh[l]);
      logm = warp_sum(logm);
      const int64_t at = (int64_t)s * L + l0 + l;
      point_epilogue<T>(sm + lg * qq, q, C, p, rcond, dl_sh[l], logm,
                        ld_xx[s], n, Rk, reml != 0, want_beta != 0,
                        lml_out + at, beta_out + at * p, rss_out + at);
    }
    __syncthreads();
  }
}

template <class T>
int launch(const T* logits, const T* rho, const T* Ua, const T* UB,
           const T* ug, const T* uy, const T* comp, const T* Lam,
           const T* ld_xx, T* lml, T* beta, T* rss, double rcond, int n,
           int S, int L, int Rk, int C, int pB, int reml, int want_beta,
           cudaStream_t stream) {
  const int q = C + pB + 2;
  const int npairs = q * (q + 1) / 2;
  if (q > MAXQ || C < 1 || pB < 0) return (int)cudaErrorInvalidValue;
  // points per block: as many as the items of a thread allow
  const bool narrow = npairs <= 4 * NT;
  const int PT = narrow ? 4 : 1;
  int P = narrow ? 4 * (4 * NT / npairs) : 36 * NT / npairs;
  P = std::max(PT, std::min(P, std::min(MAXP, (L + PT - 1) / PT * PT)));
  const int nblk = (L + P - 1) / P;
  const size_t qq = (size_t)q * q * sizeof(T);
  int G = P;
  while (G > 1 && G * qq > (size_t)EPI_BYTES) --G;
  const size_t stage = (size_t)(RC * q + P * RC) * sizeof(T);
  const size_t smem = stage > G * qq ? stage : G * qq;
  auto kernel = narrow ? family_kernel<T, 4, 4> : family_kernel<T, 1, 36>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<S * nblk, NT, smem, stream>>>(
      logits, rho, Ua, UB, ug, uy, comp, Lam, ld_xx, lml, beta, rss,
      (T)rcond, n, S, L, Rk, C, pB, P, G, nblk, reml, want_beta);
  return (int)cudaGetLastError();
}

}  // namespace

// logits, rho (S, L), Ua (Rk, C, S), UB (Rk, pB), ug (Rk, S), uy (Rk,),
// comp (S, q, q), Lam (Rk,), ld_xx (S,) -> lml (S, L) and, with want_beta,
// beta (S, L, pB + 1) and rss (S, L) (else unused).  Row-major on the card,
// f32 (the lml entry only) or f64; q = C + pB + 2 <= 128.  Launches on
// `stream`; returns a cudaError_t.
extern "C" int crm_woodbury_family_f32(
    const float* logits, const float* rho, const float* Ua, const float* UB,
    const float* ug, const float* uy, const float* comp, const float* Lam,
    const float* ld_xx, float* lml, float* beta, float* rss, double rcond,
    int n, int S, int L, int Rk, int C, int pB, int reml, int want_beta,
    cudaStream_t stream) {
  return launch<float>(logits, rho, Ua, UB, ug, uy, comp, Lam, ld_xx, lml,
                       beta, rss, rcond, n, S, L, Rk, C, pB, reml, want_beta,
                       stream);
}

extern "C" int crm_woodbury_family_f64(
    const double* logits, const double* rho, const double* Ua,
    const double* UB, const double* ug, const double* uy, const double* comp,
    const double* Lam, const double* ld_xx, double* lml, double* beta,
    double* rss, double rcond, int n, int S, int L, int Rk, int C, int pB,
    int reml, int want_beta, cudaStream_t stream) {
  return launch<double>(logits, rho, Ua, UB, ug, uy, comp, Lam, ld_xx, lml,
                        beta, rss, rcond, n, S, L, Rk, C, pB, reml, want_beta,
                        stream);
}
