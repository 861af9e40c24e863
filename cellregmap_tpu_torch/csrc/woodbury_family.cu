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
//   beta entry: the same factorization, but the ridge (rcond *
//     max(max|diag A|, 1)) goes on the covariate block A of the Schur
//     complement left after the first C columns, as
//     `_family_blocks_matrix` ridges A; then beta = A^-1 b from the
//     factor's last row and rss_raw = the last trailing entry.  In f32
//     (the float32 context's final fit, :576-588) the capacitance block
//     I + cvec H also takes + 1e-6 I, and the lml is masked as above.
//
// A failed factorization (a pivot <= 0 or NaN) is NaN throughout, as the
// JAX engine's Cholesky returns it.
//
// Replaces: cellregmap_tpu/models/lmm.py `_family_eval_batch` and
// `_family_blocks_matrix`, which XLA ran as chunk-scanned batched GEMMs
// over materialized weighted columns (S, chunk, Rk, q) plus a batched
// Cholesky of the (S, L, q, q) blocks.
//
// What bounds it on the H100: operations.  Per point the Gram's lower
// triangle is Rk q (q + 1) flop (0.55 MFLOP at Rk = 1000, q = 23); a
// headline betas batch (512 variants) evaluates ~900 points a variant, 5
// of its 9 calls in f32 over 176 points.
//
// Design: two launches a call.
// * The Gram, a tiled product a variant on the FP64 tensor cores
//   (dmma.cuh, mma.sync m16n8k8): G_s[pair, l] = sum_r P_s[r, pair]
//   W_s[r, l], M = q (q + 1) / 2 pairs, N = the call's points, K = Rk.  A
//   block is a (32 WM pairs) x (8 NTW WN points) tile of one variant, its
//   WM x WN warps each a 32 x 8 NTW sub-tile (two blocks an SM).  The
//   variant's columns (and Lam) stream through a cp.async ring of 32-row
//   chunks, three deep where shared memory allows (Ua and ug gathered
//   from the Khatri-Rao layout; two deep measured 0.92 against 0.54 ms a
//   32-point f64 call).  One chunk ahead of the product, the chunk's
//   columns are widened to f64 and the weights 1 / m_r of the block's
//   points made (in the call's precision, as the plain version rounds
//   them); the A fragments are the pair products c_i c_j (rounded once),
//   made as they are loaded.  f32 calls widen their operands into the same
//   f64 product: the tensor cores' FP64 rate equals the FP32 rate of the
//   CUDA cores on this card (67 TFLOP/s), and the f32 Gram then carries one
//   rounding (to f32, as it is stored) instead of Rk of them, so its lml is
//   at least as close to the f64 one as the plain f32 version's.  The sums
//   go to a scratch (variants x L x pairs, in the call's precision), a
//   chunk of variants at a time when the call is larger than the scratch.
// * The epilogue, a warp a point.  Up to q = 32 a lane a row of J, in
//   shared memory column-major, the factor's columns broadcast by
//   shuffles; past it J's packed lower triangle in shared memory, the
//   right-looking Cholesky with lanes over the trailing block.  The
//   ridges, the pivot sums and the back substitution for beta are
//   warp-parallel; sum log m over the lanes.
#include <cuda_runtime.h>
#include <algorithm>
#include <cfloat>
#include <cmath>
#include <cstdint>

#include "async_copy.cuh"
#include "dmma.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int RC = 32;              // Rk rows a chunk
constexpr int MAXQ = 162;           // columns [Ua | UB, g | y]
constexpr int MAX_WARPS = 8;        // of a Gram block
constexpr int EPI_WARPS = 8;        // of an epilogue block, at most
constexpr int EPI_BYTES = 224 * 1024;  // the epilogue block's packed J

template <class T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

template <class T>
__device__ __forceinline__ T warp_max(T v) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmax(v, __shfl_xor_sync(FULL, v, off));
  return v;
}

template <class T>
__device__ __forceinline__ T tiny_of() {
  return sizeof(T) == 4 ? (T)FLT_MIN : (T)DBL_MIN;
}

__host__ __device__ __forceinline__ int tri(int i) { return i * (i + 1) / 2; }

template <class T>
__device__ __forceinline__ void cp_async_elem(T* smem, const T* gmem) {
  if constexpr (sizeof(T) == 4)
    cp_async4(smem, gmem);
  else
    cp_async8(smem, gmem);
}

template <class T>
__device__ __forceinline__ T rcp_rn(T x) {
  if constexpr (sizeof(T) == 4)
    return __frcp_rn(x);
  else
    return __drcp_rn(x);
}

// The Gram of pairs [m0, m0 + 32 WM) (blockIdx.y) at points [n0, n0 + 8 NTW
// WN) (blockIdx.z) of variant s0 + blockIdx.x, into
// gram[(blockIdx.x L + l) npairs + pair].
template <class T, int NTW>
__global__ void __launch_bounds__(32 * MAX_WARPS, 2)
family_gram_kernel(const T* __restrict__ logits, const T* __restrict__ rho,
                   const T* __restrict__ Ua, const T* __restrict__ UB,
                   const T* __restrict__ ug, const T* __restrict__ uy,
                   const T* __restrict__ Lam, T* __restrict__ gram, int S,
                   int L, int Rk, int C, int pB, int WM, int s0, int cst) {
  extern __shared__ __align__(16) unsigned char fg_dyn[];
  const int q = C + pB + 2, npairs = tri(q), QL = q + 1;   // + Lam
  const int nth = blockDim.x, WN = nth / 32 / WM;
  const int BM = 32 * WM, BN = 8 * NTW * WN;
  // leading dimensions 4 mod 16 doubles: a half-warp's fragment loads fall
  // in distinct banks
  const int LDC = (q + 15) / 16 * 16 + 4, LDW = (BN + 15) / 16 * 16 + 4;
  const int sl = blockIdx.x, s = s0 + sl;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.z * BN;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp % WM, wn = warp / WM;

  double* Wt = reinterpret_cast<double*>(fg_dyn);   // [2][RC][LDW]
  double* cd = Wt + 2 * RC * LDW;                    // [2][RC][LDC]
  T* cs = reinterpret_cast<T*>(cd + 2 * RC * LDC);   // [cst][RC][QL]
  T* pdl = cs + cst * RC * QL;                         // [BN] delta
  T* pomd = pdl + BN;                                // [BN] 1 - delta
  T* pomr = pomd + BN;                               // [BN] 1 - rho
  int* ptab = reinterpret_cast<int*>(pomr + BN);     // [BM] i << 16 | j

  for (int m = tid; m < BM; m += nth) {
    const int pidx = m0 + m;
    int code = 0;   // pairs past npairs take (0, 0) and are never written
    if (pidx < npairs) {
      int i = (int)((sqrt(8.0 * pidx + 1.0) - 1.0) * 0.5);
      while (tri(i) > pidx) --i;
      while (tri(i + 1) <= pidx) ++i;
      code = i << 16 | (pidx - tri(i));
    }
    ptab[m] = code;
  }
  for (int nn = tid; nn < BN; nn += nth) {
    // points past L repeat the last one and are never written
    const int64_t at = (int64_t)s * L + min(n0 + nn, L - 1);
    const T dl = (T)1 / ((T)1 + exp(-logits[at]));
    pdl[nn] = dl;
    pomd[nn] = (T)1 - dl;
    pomr[nn] = (T)1 - rho[at];
  }

  auto load_cols = [&](int b, int chunk) {
    const int r0 = chunk * RC;
    T* dst = cs + b * RC * QL;
    for (int e = tid; e < RC * QL; e += nth) {
      const int r = e / QL, col = e - r * QL;
      const int64_t row = r0 + r;
      if (row < Rk) {
        const T* src = col < C        ? Ua + (row * C + col) * S + s
                       : col < C + pB ? UB + row * pB + col - C
                       : col == C + pB ? ug + row * S + s
                       : col == q - 1  ? uy + row
                                       : Lam + row;
        cp_async_elem(dst + e, src);
      } else {
        dst[e] = (T)0;
      }
    }
  };
  // the chunk's columns in f64 and the weights 1 / m of the block's points
  // (a thread a point, in the call's precision), from its staged columns
  const int wn_pt = tid % BN, wn_r0 = tid / BN, wn_step = nth / BN;
  auto build = [&](int bc, int b) {
    const T* c = cs + bc * RC * QL;
    double* cb = cd + b * RC * LDC;
    double* Wb = Wt + b * RC * LDW;
    for (int e = tid; e < RC * q; e += nth) {
      const int r = e / q, col = e - r * q;
      cb[r * LDC + col] = (double)c[r * QL + col];
    }
    const T om = pomd[wn_pt], orh = pomr[wn_pt], dl = pdl[wn_pt];
    for (int r = wn_r0; r < RC; r += wn_step)
      Wb[r * LDW + wn_pt] = (double)rcp_rn(om * (orh * c[r * QL + q]) + dl);
  };

  double acc[2][NTW][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.0;

  // chunk c's columns land in buffer c % cst cst chunks ahead; its f64
  // columns and weights are made in buffer c % 2 one chunk ahead of the
  // product that reads them
  const int chunks = (Rk + RC - 1) / RC;
  for (int c = 0; c < cst; ++c) {
    if (c < chunks) load_cols(c, c);
    cp_async_commit();
  }
  if (cst == 3)
    cp_async_wait<2>();
  else
    cp_async_wait<1>();
  __syncthreads();
  build(0, 0);
  // the lane's pairs: A fragment rows mt 16 + g + 8 h of the warp's 32
  int ci[2][2], cj[2][2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int code = ptab[wm * 32 + mt * 16 + g + 8 * h];
      ci[mt][h] = code >> 16;
      cj[mt][h] = code & 0xffff;
    }
  for (int c = 0; c < chunks; ++c) {
    if (cst == 3)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();
    if (c + cst < chunks) load_cols(c % cst, c + cst);
    cp_async_commit();
    if (c + 1 < chunks) build((c + 1) % cst, (c + 1) % 2);
    const double* cb = cd + (c % 2) * RC * LDC;
    const double* Wb = Wt + (c % 2) * RC * LDW + wn * NTW * 8;
#pragma unroll
    for (int k0 = 0; k0 < RC; k0 += 8) {
      // A: the pair products c_i c_j (rounded once), made as loaded
      double a[2][4], bf[NTW][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const double* row = cb + (k0 + t + 4 * (e >> 1)) * LDC;
          a[mt][e] = row[ci[mt][e & 1]] * row[cj[mt][e & 1]];
        }
#pragma unroll
      for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          bf[nt][e] = Wb[(k0 + t + 4 * e) * LDW + nt * 8 + g];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < NTW; ++nt)
          dmma_m16n8k8(acc[mt][nt], a[mt], bf[nt]);
    }
  }

  // d[i] of tile (mt, nt): pair mt 16 + g + 8 (i >> 1), point nt 8 + 2t +
  // (i & 1)
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int pair = m0 + wm * 32 + mt * 16 + g + 8 * (i >> 1);
        const int l = n0 + wn * NTW * 8 + nt * 8 + 2 * t + (i & 1);
        if (pair < npairs && l < L)
          gram[((int64_t)sl * L + l) * npairs + pair] = (T)acc[mt][nt][i];
      }
}

// One point's epilogue on the calling warp: J (q x q, packed lower
// triangle in shared memory) is factored in place; lane 0 writes lml (and
// beta, rss).
template <class T>
__device__ void point_epilogue(T* J, int q, int C, int p, T rcond, T dl,
                               T logm, T ld_xx, int n, int Rk, bool reml,
                               bool want_beta, T* lml_out, T* beta_out,
                               T* rss_out) {
  const int lane = threadIdx.x % 32;
  const bool f32 = sizeof(T) == 4;
  // J_ii += rcond max(max_i |J_ii|, 1) for lo <= i < hi
  auto ridge = [&](int lo, int hi) {
    T dmax = 0;
    for (int i = lo + lane; i < hi; i += 32)
      dmax = fmax(dmax, fabs(J[tri(i) + i]));
    dmax = warp_max(dmax);
    __syncwarp();
    const T rg = rcond * fmax(dmax, (T)1);
    for (int i = lo + lane; i < hi; i += 32) J[tri(i) + i] += rg;
    __syncwarp();
  };
  if (!want_beta && !f32) ridge(0, q);
  T ld_cap = 0, ld_a = 0, rss_raw = 0;
  for (int k = 0; k < q; ++k) {
    // the beta entry ridges the covariate block of the Schur complement
    if (want_beta && k == C) ridge(C, C + p);
    const T d = J[tri(k) + k];
    if (want_beta && k == q - 1) {
      rss_raw = d;
      break;
    }
    const T piv = sqrt(d > 0 ? d : (T)-1);   // NaN where the factor fails
    if (k < C) ld_cap += log(piv);
    else if (k < q - 1) ld_a += log(piv);
    else rss_raw = piv * piv;
    __syncwarp();
    if (lane == 0) J[tri(k) + k] = piv;
    for (int i = k + 1 + lane; i < q; i += 32) J[tri(i) + k] /= piv;
    __syncwarp();
    for (int i = k + 1; i < q; ++i) {
      const T lik = J[tri(i) + k];
      for (int j = k + 1 + lane; j <= i; j += 32)
        J[tri(i) + j] -= lik * J[tri(j) + k];
    }
    __syncwarp();
  }
  if (want_beta) {
    // A^T beta = z, z the factor's last row: column-oriented back
    // substitution over the lanes
    T* z = J + tri(q - 1) + C;
    for (int a = p - 1; a >= 0; --a) {
      const T ba = z[a] / J[tri(C + a) + C + a];
      __syncwarp();
      if (lane == 0) {
        z[a] = ba;
        beta_out[a] = ba;
      }
      for (int b = lane; b < a; b += 32) z[b] -= J[tri(C + a) + C + b] * ba;
      __syncwarp();
    }
  }
  if (lane != 0) return;
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
  if (f32 && (rss_raw <= (T)8 * (T)FLT_MIN || !isfinite(lml)))
    lml = -INFINITY;
  *lml_out = lml;
  if (want_beta) *rss_out = rss;
}

// a warp per point of variants [s0, s0 + ns): J from the Gram's sums, then
// its factorization
template <class T>
__global__ void __launch_bounds__(32 * EPI_WARPS)
family_epilogue_kernel(const T* __restrict__ logits,
                       const T* __restrict__ rho,
                       const T* __restrict__ gram,
                       const T* __restrict__ comp, const T* __restrict__ Lam,
                       const T* __restrict__ ld_xx, T* __restrict__ lml_out,
                       T* __restrict__ beta_out, T* __restrict__ rss_out,
                       T rcond, int n, int L, int Rk, int C, int pB, int s0,
                       int ns, int reml, int want_beta) {
  extern __shared__ __align__(16) unsigned char fe_dyn[];
  const int q = C + pB + 2, npairs = tri(q), p = pB + 1;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t pt = (int64_t)blockIdx.x * (blockDim.x / 32) + warp;
  if (pt >= (int64_t)ns * L) return;
  const int s = s0 + (int)(pt / L);
  const int64_t at = (int64_t)s * L + pt % L;
  const bool f32 = sizeof(T) == 4;
  T* J = reinterpret_cast<T*>(fe_dyn) + (int64_t)warp * npairs;
  const T dl = (T)1 / ((T)1 + exp(-logits[at]));
  const T omd = (T)1 - dl, omr = (T)1 - rho[at];
  const T sw = sqrt(omd * rho[at]), i1 = (T)1 / dl;
  const T* gp = gram + pt * npairs;
  const T* cp = comp + (int64_t)s * q * q;
  for (int i = 0; i < q; ++i) {
    const T wi = i < C ? sw : (T)1;
    for (int j = lane; j <= i; j += 32) {
      T v = (gp[tri(i) + j] + cp[i * q + j] * i1) * (wi * (j < C ? sw : (T)1));
      if (i == j && i < C) {
        v += (T)1;
        if (f32 && want_beta) v += (T)1e-6;  // the f32 capacitance ridge
      }
      J[tri(i) + j] = v;
    }
  }
  T logm = 0;
  for (int r = lane; r < Rk; r += 32) logm += log(omd * (omr * Lam[r]) + dl);
  logm = warp_sum(logm);
  __syncwarp();
  point_epilogue<T>(J, q, C, p, rcond, dl, logm, ld_xx[s], n, Rk, reml != 0,
                    want_beta != 0, lml_out + at, beta_out + at * p,
                    rss_out + at);
}

// q <= 32: a warp a point with a lane a row of J, the rows in shared memory
// column-major ([j][lane]: no bank conflicts), the factor's columns
// broadcast by shuffles; the same factorization and results as
// point_epilogue.
template <class T>
__global__ void __launch_bounds__(32 * EPI_WARPS)
family_epilogue_rows_kernel(const T* __restrict__ logits,
                            const T* __restrict__ rho,
                            const T* __restrict__ gram,
                            const T* __restrict__ comp,
                            const T* __restrict__ Lam,
                            const T* __restrict__ ld_xx,
                            T* __restrict__ lml_out, T* __restrict__ beta_out,
                            T* __restrict__ rss_out, T rcond, int n, int L,
                            int Rk, int C, int pB, int s0, int ns, int reml,
                            int want_beta) {
  extern __shared__ __align__(16) unsigned char fr_dyn[];
  const int q = C + pB + 2, p = pB + 1;
  const int warp = threadIdx.x / 32, i = threadIdx.x % 32;
  const int64_t pt = (int64_t)blockIdx.x * (blockDim.x / 32) + warp;
  if (pt >= (int64_t)ns * L) return;
  const int s = s0 + (int)(pt / L);
  const int64_t at = (int64_t)s * L + pt % L;
  T* J = reinterpret_cast<T*>(fr_dyn) + warp * 32 * q;   // J[j * 32 + i]
  const bool f32 = sizeof(T) == 4;
  const T dl = (T)1 / ((T)1 + exp(-logits[at]));
  const T omd = (T)1 - dl, omr = (T)1 - rho[at];
  const T sw = sqrt(omd * rho[at]), i1 = (T)1 / dl;
  if (i < q) {
    const T* gp = gram + pt * tri(q) + tri(i);
    const T* cp = comp + ((int64_t)s * q + i) * q;
    const T wi = i < C ? sw : (T)1;
    for (int j = 0; j <= i; ++j) {
      T v = (gp[j] + cp[j] * i1) * (wi * (j < C ? sw : (T)1));
      if (i == j && i < C) {
        v += (T)1;
        if (f32 && want_beta) v += (T)1e-6;  // the f32 capacitance ridge
      }
      J[j * 32 + i] = v;
    }
  }
  T logm = 0;
  for (int r = i; r < Rk; r += 32) logm += log(omd * (omr * Lam[r]) + dl);
  logm = warp_sum(logm);
  __syncwarp();
  // J_ii += rcond max(max_i |J_ii|, 1) for lo <= i < hi
  auto ridge = [&](int lo, int hi) {
    const bool mine = i >= lo && i < hi;
    const T dmax = warp_max(mine ? fabs(J[i * 32 + i]) : (T)0);
    if (mine) J[i * 32 + i] += rcond * fmax(dmax, (T)1);
    __syncwarp();
  };
  if (!want_beta && !f32) ridge(0, q);
  T ld_cap = 0, ld_a = 0, rss_raw = 0;
  for (int k = 0; k < q; ++k) {
    // the beta entry ridges the covariate block of the Schur complement
    if (want_beta && k == C) ridge(C, C + p);
    const T d = __shfl_sync(FULL, J[k * 32 + (i < q ? i : 0)], k);
    if (want_beta && k == q - 1) {
      rss_raw = d;
      break;
    }
    const T piv = sqrt(d > 0 ? d : (T)-1);   // NaN where the factor fails
    if (k < C) ld_cap += log(piv);
    else if (k < q - 1) ld_a += log(piv);
    else rss_raw = piv * piv;
    T l = 0;
    if (i > k && i < q) {
      l = J[k * 32 + i] / piv;
      J[k * 32 + i] = l;
    }
    if (i == k) J[k * 32 + k] = piv;
    for (int j = k + 1; j < q; ++j) {
      const T lj = __shfl_sync(FULL, l, j);
      if (i >= j && i < q) J[j * 32 + i] -= l * lj;
    }
    __syncwarp();
  }
  if (want_beta) {
    // A^T beta = z, z the factor's last row (lane b holds z_b): column-
    // oriented back substitution
    T z = i < p ? J[(C + i) * 32 + q - 1] : (T)0;
    for (int a = p - 1; a >= 0; --a) {
      const T ba = __shfl_sync(FULL, z, a) / J[(C + a) * 32 + C + a];
      if (i == a) beta_out[at * p + a] = ba;
      if (i < a) z -= J[(C + i) * 32 + C + a] * ba;
    }
  }
  if (i != 0) return;
  const T tiny = tiny_of<T>();
  const T rss = rss_raw < tiny ? tiny : rss_raw;   // keeps a NaN
  const T two_pi = (T)6.283185307179586;
  const T logdet_d = logm + (T)(n - Rk) * log(dl) + (T)2 * ld_cap;
  T lml;
  if (reml) {
    const T nu = (T)(n - p);
    lml = (T)-0.5 * (nu * log(two_pi * rss / nu) + logdet_d + (T)2 * ld_a -
                     ld_xx[s] + nu);
  } else {
    lml = (T)-0.5 * ((T)n * log(two_pi * rss / (T)n) + logdet_d + (T)n);
  }
  if (f32 && (rss_raw <= (T)8 * (T)FLT_MIN || !isfinite(lml)))
    lml = -INFINITY;
  lml_out[at] = lml;
  if (want_beta) rss_out[at] = rss;
}

template <class T>
int launch(const T* logits, const T* rho, const T* Ua, const T* UB,
           const T* ug, const T* uy, const T* comp, const T* Lam,
           const T* ld_xx, T* lml, T* beta, T* rss, T* scratch, double rcond,
           int n, int S, int L, int Rk, int C, int pB, int reml,
           int want_beta, int chunk, cudaStream_t stream) {
  const int q = C + pB + 2;
  const int npairs = tri(q);
  if (q > MAXQ || C < 1 || pB < 0 || chunk < 1)
    return (int)cudaErrorInvalidValue;
  // the Gram's tile: 8 NTW points a warp, WN warps along the points, and
  // the most warps WM along the pairs that pad the pairs by <= 5%
  const int NTW = L <= 8 ? 1 : L <= 16 ? 2 : 4;
  const int WN = std::min(2, (L + 8 * NTW - 1) / (8 * NTW));
  auto padded = [&](int wm) {
    return (npairs + 32 * wm - 1) / (32 * wm) * (32 * wm);
  };
  int WM = 1;
  for (int wm = 1; wm * WN <= MAX_WARPS; ++wm)
    if (padded(wm) * 20 <= npairs * 21 || padded(wm) < padded(WM)) WM = wm;
  const int BM = 32 * WM, BN = 8 * NTW * WN;
  const int LDC = (q + 15) / 16 * 16 + 4, LDW = (BN + 15) / 16 * 16 + 4;
  // a column ring of three chunks where it fits, else two
  auto gram_bytes_at = [&](int cst) {
    return sizeof(double) * 2 * RC * (LDC + LDW) +
           sizeof(T) * (cst * RC * (q + 1) + 3 * BN) + sizeof(int) * BM;
  };
  const int cst = gram_bytes_at(3) <= 232448 ? 3 : 2;
  const size_t gram_bytes = gram_bytes_at(cst);
  auto gram_kernel = NTW == 1   ? family_gram_kernel<T, 1>
                     : NTW == 2 ? family_gram_kernel<T, 2>
                                : family_gram_kernel<T, 4>;
  // the epilogue: a lane a row up to 32 columns, else a packed triangle a
  // warp
  const bool rows = q <= 32;
  const size_t point_bytes = sizeof(T) * (rows ? 32 * q : npairs);
  const int epi_warps =
      (int)std::max<size_t>(1, std::min<size_t>(EPI_WARPS,
                                                EPI_BYTES / point_bytes));
  const size_t epi_bytes = epi_warps * point_bytes;
  auto epi_kernel =
      rows ? family_epilogue_rows_kernel<T> : family_epilogue_kernel<T>;
  // the shared-memory limits past the default 48 KB
  auto raise = [](auto kernel, size_t bytes) {
    return bytes <= 48 * 1024
               ? 0
               : (int)cudaFuncSetAttribute(
                     kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                     (int)bytes);
  };
  int err = raise(gram_kernel, gram_bytes);
  if (!err) err = raise(epi_kernel, epi_bytes);
  if (err) return err;
  for (int s0 = 0; s0 < S; s0 += chunk) {
    const int ns = std::min(chunk, S - s0);
    const dim3 tiles(ns, (npairs + BM - 1) / BM, (L + BN - 1) / BN);
    const dim3 warps(32 * WM * WN);
    gram_kernel<<<tiles, warps, gram_bytes, stream>>>(
        logits, rho, Ua, UB, ug, uy, Lam, scratch, S, L, Rk, C, pB, WM, s0,
        cst);
    err = (int)cudaGetLastError();
    if (err) return err;
    const dim3 points((unsigned)(((int64_t)ns * L + epi_warps - 1) /
                                 epi_warps));
    const dim3 lanes(32 * epi_warps);
    epi_kernel<<<points, lanes, epi_bytes, stream>>>(
        logits, rho, scratch, comp, Lam, ld_xx, lml, beta, rss, (T)rcond, n,
        L, Rk, C, pB, s0, ns, reml, want_beta);
    err = (int)cudaGetLastError();
    if (err) return err;
  }
  return 0;
}

}  // namespace

// logits, rho (S, L), Ua (Rk, C, S), UB (Rk, pB), ug (Rk, S), uy (Rk,),
// comp (S, q, q), Lam (Rk,), ld_xx (S,) -> lml (S, L) and, with want_beta,
// beta (S, L, pB + 1) and rss (S, L) (else unused); scratch: chunk L q (q +
// 1) / 2 elements, the Gram of `chunk` variants at a time.  Row-major on
// the card, f32 or f64; q = C + pB + 2 <= 162.
// Launches on `stream`; returns a cudaError_t.
extern "C" int crm_woodbury_family_f32(
    const float* logits, const float* rho, const float* Ua, const float* UB,
    const float* ug, const float* uy, const float* comp, const float* Lam,
    const float* ld_xx, float* lml, float* beta, float* rss, float* scratch,
    double rcond, int n, int S, int L, int Rk, int C, int pB, int reml,
    int want_beta, int chunk, cudaStream_t stream) {
  return launch<float>(logits, rho, Ua, UB, ug, uy, comp, Lam, ld_xx, lml,
                       beta, rss, scratch, rcond, n, S, L, Rk, C, pB, reml,
                       want_beta, chunk, stream);
}

extern "C" int crm_woodbury_family_f64(
    const double* logits, const double* rho, const double* Ua,
    const double* UB, const double* ug, const double* uy, const double* comp,
    const double* Lam, const double* ld_xx, double* lml, double* beta,
    double* rss, double* scratch, double rcond, int n, int S, int L, int Rk,
    int C, int pB, int reml, int want_beta, int chunk, cudaStream_t stream) {
  return launch<double>(logits, rho, Ua, UB, ug, uy, comp, Lam, ld_xx, lml,
                        beta, rss, scratch, rcond, n, S, L, Rk, C, pB, reml,
                        want_beta, chunk, stream);
}
