// K8: the fast association scan's closed-form alternative lmls, f64 and
// f32, for sm_90a.
//
// At the null's fixed delta, with eigenvalues S_r, rotated covariates W_r
// (p columns), phenotype y_r and candidates G_rs (r < R), and the
// complements (CWW, cWy, cyy, CWG, cGy, cGG) (cellregmap_tpu/models/
// lmm.py:863-909 `fast_scan`):
//
//   d_r = (1 - delta) S_r + delta,  w_r = 1 / d_r,
//   A = sum_r w_r W_r W_r^T + CWW / delta,  b = sum_r w_r W_r y_r
//   + cWy / delta,  yy = sum_r w_r y_r^2 + cyy / delta,
//   U_s = sum_r w_r W_r G_rs + CWG_s / delta,  cgg_s = sum_r w_r G_rs^2
//   + cGG_s / delta,  cgy_s = sum_r w_r y_r G_rs + cGy_s / delta,
//   schur = cgg - U^T A^-1 U,  resid = cgy - b^T A^-1 U,
//   beta_g = resid / schur,  beta_W = A^-1 b - A^-1 U beta_g,
//   rss = max(yy - b^T A^-1 b - resid^2 / schur, tiny),
//   lml = -(n log(2 pi rss / n) + sum_r log d_r + (n - R) log delta + n) / 2,
//
// with A^-1 through the ridge Cholesky of `sym_pseudo_solve` (rcond 1e-12 *
// max(max|diag|, 1)).
//
// Replaces: cellregmap_tpu/engine.py `fast_scan_kernel` (:1132-1151) after
// its rotations, which XLA ran as a handful of (p, R) x (R, S) products and
// elementwise passes with a shared (p x p) solve.
//
// What bounds it on the H100: bytes.  It reads the (R, S) rotated
// candidates once (4 MB at R = 1010, S = 512) and does ~2 (p + 2) flop per
// element.  Design: a 256-thread block per 32 variants; lane l of every
// warp takes variant l, and warp w the rows r = w mod 8, so that a warp
// reads 32 neighbouring entries of a row of the row-major Gt (coalesced)
// and the p + 2 sums stay in registers.  The eight warps' partial sums
// meet in shared memory; warp 0 then reduces the variant-independent A, b,
// yy and logdet D (lanes over r, an xor-shuffle tree), factors A on every
// lane and finishes its 32 variants.  The wide instantiation (16 < p <=
// 32), whose p x p factor no lane can hold, reduces those terms with the
// whole block (threads over the sums) into shared memory, where warp 0
// factors A and every lane's solves read it.
//
// The gene axis (cellregmap_tpu/engine.py `fast_scan_multigene_kernel`,
// :1176-1206): many phenotypes against one covariance family, each gene
// at its own null's best rho and delta.  The rotated candidates depend on
// the rho alone, so they come once per distinct best rho of the tile (a
// "slot": S, Wt, CWW, Gt, CWG and cGG carry a leading slot axis), and
// each gene brings its delta, yt, cWy, cyy and cGy and the index of its
// slot.  The host orders the genes by slot.  A block takes (32 variants,
// slot, chunk of GC of the slot's genes): it streams the slot's rows once,
// in chunks of 64 rows whose per-gene weights 1 / ((1 - delta_g) S_r +
// delta_g) and y_r w_r are formed in shared memory, and each lane holds
// its variant's GC (p + 2) sums in registers, so that one read of a G
// entry feeds every gene of the chunk.  Then warp w finishes gene w of the
// chunk: its variant-independent sums over r, the Cholesky and the 32
// variants' epilogues.  The chunks of a slot run side by side and read
// the same rows of Gt, from device memory once per slot and from L2 after.
//
// The float32 context (`fast_scan_kernel` on an f32 context): both
// kernels are templates on the operand type T; T = float (p <= 16)
// makes every sum, the Cholesky, the rank-1 update and the lml f32, as
// the reference computes them on f32 tensors, the null's delta rounded to
// f32 (`crm_fast_scan_f32`, `crm_fast_scan_genes_f32`).
#include <cuda_runtime.h>
#include <cfloat>
#include <cstdint>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int NT = 256;
constexpr int NWARP = NT / 32;

// Loops over the covariates run to the compile-time PMAX and skip what lies
// outside [lo, hi), so the small arrays are indexed statically.
#define SMALL_FOR(i, lo, hi) \
  for (int i = 0; i < PMAX; ++i) \
    if (i >= (lo) && i < (hi))

template <class T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

// x = A^-1 v through the lower Cholesky factor L of A
template <class T, int PMAX>
__device__ void solve(const T (&L)[PMAX][PMAX], const T* v, T* x, int p) {
  SMALL_FOR(i, 0, p) {
    T t = v[i];
    SMALL_FOR(k, 0, i) t -= L[i][k] * x[k];
    x[i] = t / L[i][i];
  }
  for (int i = PMAX - 1; i >= 0; --i) {
    if (i >= p) continue;
    T t = x[i];
    SMALL_FOR(k, i + 1, p) t -= L[k][i] * x[k];
    x[i] = t / L[i][i];
  }
}

// max(x, tiny) that keeps a NaN, as torch.clamp and jnp.maximum do
__device__ __forceinline__ double clamp_tiny(double x) {
  return x < DBL_MIN ? DBL_MIN : x;
}
__device__ __forceinline__ float clamp_tiny(float x) {
  return x < FLT_MIN ? FLT_MIN : x;
}


// ---------------------------------------------------------------------------
// The wide instantiation (16 < p <= 32): a lane cannot hold the p x p
// factor, so the variant-independent terms are reduced by the whole block
// (threads over the p(p+1)/2 + p + 2 sums, rows serial) into shared
// memory, warp 0 factors A there (lane 0 the pivot, the lanes the column
// below it), and each lane's solves read the factor from shared memory.
// ---------------------------------------------------------------------------
constexpr int WIDE_P = 32;
template <int V> struct PC { static constexpr int value = V; };

// words of the block's terms: L (p x p), b, A^-1 b (p each), yy, logdet D
__host__ __device__ inline int gls_words(int p) { return p * p + 2 * p + 2; }

// The block's GLS terms of one (rho, delta) into g (every thread calls).
__device__ void block_gls(const double* So, const double* Wo,
                          const double* yv, const double* CWo,
                          const double* cWy, double cyy, double delta, int n,
                          int R, int p, double* g) {
  const int tid = threadIdx.x;
  const int ntri = p * (p + 1) / 2, ne = ntri + p + 2;
  double *L = g, *b = L + p * p, *aib = b + p, *sc = aib + p;
  for (int e = tid; e < ne; e += NT) {
    int i = -1, j = 0;
    if (e < ntri) {
      i = 0;
      while ((i + 1) * (i + 2) / 2 <= e) ++i;
      j = e - i * (i + 1) / 2;
    }
    double acc = 0.0;
    for (int r = 0; r < R; ++r) {
      const double d = (1.0 - delta) * So[r] + delta;
      const double w = 1.0 / d;
      const double* x = Wo + (int64_t)r * p;
      if (i >= 0) acc += x[i] * w * x[j];
      else if (e < ntri + p) acc += x[e - ntri] * w * yv[r];
      else if (e == ntri + p) acc += yv[r] * yv[r] * w;
      else acc += log(d);
    }
    if (i >= 0) L[i * p + j] = acc + CWo[i * p + j] / delta;
    else if (e < ntri + p) b[e - ntri] = acc + cWy[e - ntri] / delta;
    else if (e == ntri + p) sc[0] = acc + cyy / delta;
    else sc[1] = acc + (n - R) * log(delta);
  }
  __syncthreads();
  if (tid < 32) {
    double dmax = 0.0;
    for (int i = 0; i < p; ++i) dmax = fmax(dmax, fabs(L[i * p + i]));
    const double ridge = 1e-12 * fmax(dmax, 1.0);
    for (int jj = 0; jj < p; ++jj) {
      if (tid == 0) {
        double dj = L[jj * p + jj] + ridge;
        for (int k = 0; k < jj; ++k) dj -= L[jj * p + k] * L[jj * p + k];
        L[jj * p + jj] = sqrt(dj);
      }
      __syncwarp();
      const double dj = L[jj * p + jj];
      for (int i = jj + 1 + tid; i < p; i += 32) {
        double v = L[i * p + jj];
        for (int k = 0; k < jj; ++k) v -= L[i * p + k] * L[jj * p + k];
        L[i * p + jj] = v / dj;
      }
      __syncwarp();
    }
    if (tid == 0) {  // A^-1 b
      for (int i = 0; i < p; ++i) {
        double t = b[i];
        for (int k = 0; k < i; ++k) t -= L[i * p + k] * aib[k];
        aib[i] = t / L[i * p + i];
      }
      for (int i = p - 1; i >= 0; --i) {
        double t = aib[i];
        for (int k = i + 1; k < p; ++k) t -= L[k * p + i] * aib[k];
        aib[i] = t / L[i * p + i];
      }
    }
  }
  __syncthreads();
}

// One variant's results from its sums (U, cgg, cgy, complements added)
// and the block's terms g; z a lane's scratch of p doubles.
__device__ void finish_wide(const double* g, const double* U, double cg,
                            double cy, double* z, int n, int p,
                            double* lml, double* bg, double* bW,
                            double* scale) {
  const double *L = g, *b = L + p * p, *aib = b + p, *sc = aib + p;
  for (int i = 0; i < p; ++i) {
    double t = U[i];
    for (int k = 0; k < i; ++k) t -= L[i * p + k] * z[k];
    z[i] = t / L[i * p + i];
  }
  for (int i = p - 1; i >= 0; --i) {
    double t = z[i];
    for (int k = i + 1; k < p; ++k) t -= L[k * p + i] * z[k];
    z[i] = t / L[i * p + i];
  }
  double uau = 0.0, bau = 0.0, bab = 0.0;
  for (int i = 0; i < p; ++i) {
    uau += U[i] * z[i];
    bau += b[i] * z[i];
    bab += b[i] * aib[i];
  }
  const double schur = cg - uau;
  const double resid = cy - bau;
  const double beta_g = resid / schur;
  for (int i = 0; i < p; ++i) bW[i] = aib[i] - z[i] * beta_g;
  const double rss = clamp_tiny(sc[0] - bab - resid * resid / schur);
  *scale = rss / n;
  *bg = beta_g;
  *lml = -0.5 * (n * log(6.283185307179586 * *scale) + sc[1] + n);
}

template <class T, int PMAX>
__global__ void __launch_bounds__(NT)
fast_scan_kernel(const T* __restrict__ Sv, const T* __restrict__ Wt,
                 const T* __restrict__ yt,
                 const T* __restrict__ CWW,
                 const T* __restrict__ cWy,
                 const T* __restrict__ cyy,
                 const T* __restrict__ Gt,
                 const T* __restrict__ CWG,
                 const T* __restrict__ cGy,
                 const T* __restrict__ cGG, T* __restrict__ lml_out,
                 T* __restrict__ bg_out, T* __restrict__ bW_out,
                 T* __restrict__ scale_out, T delta, int n, int R,
                 int p, int S) {
  // each warp's partial sums over its slice of r, per variant (lane), in
  // dynamic shared memory (the wide instantiation's block terms after)
  extern __shared__ __align__(16) unsigned char fs_dyn[];
  auto part = reinterpret_cast<T (*)[PMAX + 2][32]>(fs_dyn);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int s = blockIdx.x * 32 + lane;

  // the variant's sums over the warp's r: a warp reads 32 neighbouring Gt
  // entries of a row
  T U[PMAX], cgg = T(0), cgy = T(0);
  SMALL_FOR(j, 0, p) U[j] = T(0);
  if (s < S) {
    for (int r = warp; r < R; r += NWARP) {
      const T w = T(1) / ((T(1) - delta) * Sv[r] + delta);
      const T g = Gt[(int64_t)r * S + s];
      const T gw = g * w;
      const T* x = Wt + (int64_t)r * p;
      SMALL_FOR(j, 0, p) U[j] += x[j] * gw;
      cgg += g * gw;
      cgy += yt[r] * gw;
    }
  }
  SMALL_FOR(j, 0, p) part[warp][j][lane] = U[j];
  part[warp][PMAX][lane] = cgg;
  part[warp][PMAX + 1][lane] = cgy;
  __syncthreads();
  if constexpr (PMAX > 16) {
    double* gw = reinterpret_cast<double*>(fs_dyn) + NWARP * (PMAX + 2) * 32;
    block_gls(Sv, Wt, yt, CWW, cWy, cyy[0], delta, n, R, p, gw);
    if (warp != 0 || s >= S) return;
    SMALL_FOR(j, 0, p) {
      double v = 0.0;
      for (int w = 0; w < NWARP; ++w) v += part[w][j][lane];
      U[j] = v + CWG[(int64_t)j * S + s] / delta;
    }
    cgg = cGG[s] / delta;
    cgy = cGy[s] / delta;
    for (int w = 0; w < NWARP; ++w) {
      cgg += part[w][PMAX][lane];
      cgy += part[w][PMAX + 1][lane];
    }
    double z[PMAX];
    finish_wide(gw, U, cgg, cgy, z, n, p, lml_out + s, bg_out + s,
                bW_out + (int64_t)s * p, scale_out + s);
    return;
  }
  if (warp != 0) return;

  // warp 0: the variant-independent A, b, yy and logdet D (lanes over r,
  // an xor-shuffle tree), A's ridge Cholesky and A^-1 b on every lane
  T A[PMAX][PMAX], b[PMAX], yyw = T(0), logd = T(0);
  SMALL_FOR(i, 0, p) {
    b[i] = T(0);
    SMALL_FOR(j, 0, i + 1) A[i][j] = T(0);
  }
  for (int r = lane; r < R; r += 32) {
    const T d = (T(1) - delta) * Sv[r] + delta;
    const T w = T(1) / d;
    const T* x = Wt + (int64_t)r * p;
    const T yv = yt[r];
    SMALL_FOR(i, 0, p) {
      const T xw = x[i] * w;
      SMALL_FOR(j, 0, i + 1) A[i][j] += xw * x[j];
      b[i] += xw * yv;
    }
    yyw += yv * yv * w;
    logd += log(d);
  }
  SMALL_FOR(i, 0, p) {
    SMALL_FOR(j, 0, i + 1)
      A[i][j] = warp_sum(A[i][j]) + CWW[i * p + j] / delta;
    b[i] = warp_sum(b[i]) + cWy[i] / delta;
  }
  yyw = warp_sum(yyw) + cyy[0] / delta;
  logd = warp_sum(logd) + (T)(n - R) * log(delta);
  T dmax = T(0);
  SMALL_FOR(i, 0, p) dmax = fmax(dmax, fabs(A[i][i]));
  const T ridge = T(1e-12) * fmax(dmax, T(1));
  SMALL_FOR(j, 0, p) {
    T dj = A[j][j] + ridge;
    SMALL_FOR(k, 0, j) dj -= A[j][k] * A[j][k];
    dj = sqrt(dj);
    A[j][j] = dj;
    SMALL_FOR(i, j + 1, p) {
      T v = A[i][j];
      SMALL_FOR(k, 0, j) v -= A[i][k] * A[j][k];
      A[i][j] = v / dj;
    }
  }
  T aib[PMAX], z[PMAX];
  solve<T, PMAX>(A, b, aib, p);
  if (s >= S) return;

  // the variant's epilogue: the slices' sums, then the rank-1 update
  SMALL_FOR(j, 0, p) {
    T v = T(0);
    for (int w = 0; w < NWARP; ++w) v += part[w][j][lane];
    U[j] = v + CWG[(int64_t)j * S + s] / delta;
  }
  cgg = cGG[s] / delta;
  cgy = cGy[s] / delta;
  for (int w = 0; w < NWARP; ++w) {
    cgg += part[w][PMAX][lane];
    cgy += part[w][PMAX + 1][lane];
  }
  solve<T, PMAX>(A, U, z, p);
  T uau = T(0), bau = T(0), bab = T(0);
  SMALL_FOR(i, 0, p) {
    uau += U[i] * z[i];
    bau += b[i] * z[i];
    bab += b[i] * aib[i];
  }
  const T schur = cgg - uau;
  const T resid = cgy - bau;
  const T beta_g = resid / schur;
  SMALL_FOR(i, 0, p) bW_out[(int64_t)s * p + i] = aib[i] - z[i] * beta_g;
  const T rss = clamp_tiny(yyw - bab - resid * resid / schur);
  const T scale = rss / (T)n;
  bg_out[s] = beta_g;
  scale_out[s] = scale;
  lml_out[s] = T(-0.5) * ((T)n * log(T(6.283185307179586) * scale) + logd +
                          (T)n);
}

// ---------------------------------------------------------------------------
// gene axis: a block per (32 variants, slot, chunk of the slot's genes)
// ---------------------------------------------------------------------------
constexpr int RCH = 64;  // eigen rows of a chunk's shared weights

// genes of a chunk: the per-lane sums GC (PMAX + 2) in registers, the
// warps' partials GC (PMAX + 2) 32 NWARP doubles in shared memory (<= 36 KB)
template <int PMAX> struct GeneChunk {
  static constexpr int GC = PMAX <= 2 ? 4 : (PMAX <= 4 ? 2 : 1);
};

// dynamic shared memory of a block: the warps' partial sums, and the wide
// instantiation's block terms; raises the kernel's limit where needed
template <class T, int PMAX, class F>
int dyn_smem(F kernel, int gc, int p, int* bytes) {
  *bytes = (int)sizeof(T) *
           (NWARP * gc * (PMAX + 2) * 32 + (PMAX > 16 ? gls_words(p) : 0));
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, *bytes);
}

template <class T, int PMAX>
__global__ void __launch_bounds__(NT)
fast_scan_genes_kernel(const T* __restrict__ delta,
                       const T* __restrict__ Sv,
                       const T* __restrict__ Wt,
                       const T* __restrict__ yt,
                       const T* __restrict__ CWW,
                       const T* __restrict__ cWy,
                       const T* __restrict__ cyy,
                       const T* __restrict__ Gt,
                       const T* __restrict__ CWG,
                       const T* __restrict__ cGy,
                       const T* __restrict__ cGG,
                       const int* __restrict__ order,
                       const int* __restrict__ starts,
                       T* __restrict__ lml_out,
                       T* __restrict__ bg_out,
                       T* __restrict__ bW_out,
                       T* __restrict__ scale_out, int n, int R, int p,
                       int S) {
  constexpr int GC = GeneChunk<PMAX>::GC;
  extern __shared__ __align__(16) unsigned char fs_dyn[];
  auto part = reinterpret_cast<T (*)[GC][PMAX + 2][32]>(fs_dyn);
  __shared__ T wsh[GC][RCH], ywsh[GC][RCH];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int sl = blockIdx.y;
  const int s = blockIdx.x * 32 + lane;
  // the slot's shared operands
  const T* So = Sv + (int64_t)sl * R;
  const T* Wo = Wt + (int64_t)sl * R * p;
  const T* Go = Gt + (int64_t)sl * R * S;
  const int g_end = starts[sl + 1];
  const int c0 = starts[sl] + blockIdx.z * GC;
  if (c0 >= g_end) return;  // the slot has fewer chunks: the whole block
  const int ng = min(GC, g_end - c0);
  T U[GC][PMAX], cgg[GC], cgy[GC];
#pragma unroll
  for (int gi = 0; gi < GC; ++gi) {
    SMALL_FOR(j, 0, p) U[gi][j] = T(0);
    cgg[gi] = T(0);
    cgy[gi] = T(0);
  }
  for (int r0 = 0; r0 < R; r0 += RCH) {
    const int rows = min(RCH, R - r0);
    // the chunk's weights and weighted phenotype, per gene (0 past ng)
    for (int idx = threadIdx.x; idx < GC * RCH; idx += NT) {
      const int gi = idx / RCH, rr = idx - gi * RCH;
      T w = T(0), yw = T(0);
      if (gi < ng && rr < rows) {
        const int g = order[c0 + gi];
        const T dg = delta[g];
        w = T(1) / ((T(1) - dg) * So[r0 + rr] + dg);
        yw = yt[(int64_t)g * R + r0 + rr] * w;
      }
      wsh[gi][rr] = w;
      ywsh[gi][rr] = yw;
    }
    __syncthreads();
    if (s < S) {
      for (int rr = warp; rr < rows; rr += NWARP) {
        const int r = r0 + rr;
        const T g = Go[(int64_t)r * S + s];
        const T* x = Wo + (int64_t)r * p;
        T xr[PMAX];
        SMALL_FOR(j, 0, p) xr[j] = x[j];
#pragma unroll
        for (int gi = 0; gi < GC; ++gi) {
          const T gw = g * wsh[gi][rr];
          SMALL_FOR(j, 0, p) U[gi][j] += xr[j] * gw;
          cgg[gi] += g * gw;
          cgy[gi] += g * ywsh[gi][rr];
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int gi = 0; gi < GC; ++gi) {
    SMALL_FOR(j, 0, p) part[warp][gi][j][lane] = U[gi][j];
    part[warp][gi][PMAX][lane] = cgg[gi];
    part[warp][gi][PMAX + 1][lane] = cgy[gi];
  }
  __syncthreads();

  if constexpr (PMAX > 16) {  // GC = 1: the block's gene, as above
    const int g = order[c0];
    const double dg = delta[g];
    double* gw =
        reinterpret_cast<double*>(fs_dyn) + NWARP * GC * (PMAX + 2) * 32;
    block_gls(So, Wo, yt + (int64_t)g * R, CWW + (int64_t)sl * p * p,
              cWy + (int64_t)g * p, cyy[g], dg, n, R, p, gw);
    if (warp != 0 || s >= S) return;
    const double* CGo = CWG + (int64_t)sl * p * S;
    double Us[PMAX], z[PMAX];
    SMALL_FOR(j, 0, p) {
      double v = 0.0;
      for (int w = 0; w < NWARP; ++w) v += part[w][0][j][lane];
      Us[j] = v + CGo[(int64_t)j * S + s] / dg;
    }
    double cg = cGG[(int64_t)sl * S + s] / dg;
    double cy = cGy[(int64_t)g * S + s] / dg;
    for (int w = 0; w < NWARP; ++w) {
      cg += part[w][0][PMAX][lane];
      cy += part[w][0][PMAX + 1][lane];
    }
    const int64_t gs = (int64_t)g * S + s;
    finish_wide(gw, Us, cg, cy, z, n, p, lml_out + gs, bg_out + gs,
                bW_out + gs * p, scale_out + gs);
    return;
  }
  // warp w finishes gene w of the chunk
  if (warp < ng) {
    const int gi = warp;
    const int g = order[c0 + gi];
    const T dg = delta[g];
    const T* yg = yt + (int64_t)g * R;
    T A[PMAX][PMAX], b[PMAX], yyw = T(0), logd = T(0);
    SMALL_FOR(i, 0, p) {
      b[i] = T(0);
      SMALL_FOR(j, 0, i + 1) A[i][j] = T(0);
    }
    for (int r = lane; r < R; r += 32) {
      const T d = (T(1) - dg) * So[r] + dg;
      const T w = T(1) / d;
      const T* x = Wo + (int64_t)r * p;
      const T yv = yg[r];
      SMALL_FOR(i, 0, p) {
        const T xw = x[i] * w;
        SMALL_FOR(j, 0, i + 1) A[i][j] += xw * x[j];
        b[i] += xw * yv;
      }
      yyw += yv * yv * w;
      logd += log(d);
    }
    const T* CWo = CWW + (int64_t)sl * p * p;
    SMALL_FOR(i, 0, p) {
      SMALL_FOR(j, 0, i + 1)
        A[i][j] = warp_sum(A[i][j]) + CWo[i * p + j] / dg;
      b[i] = warp_sum(b[i]) + cWy[(int64_t)g * p + i] / dg;
    }
    yyw = warp_sum(yyw) + cyy[g] / dg;
    logd = warp_sum(logd) + (T)(n - R) * log(dg);
    T dmax = T(0);
    SMALL_FOR(i, 0, p) dmax = fmax(dmax, fabs(A[i][i]));
    const T ridge = T(1e-12) * fmax(dmax, T(1));
    SMALL_FOR(j, 0, p) {
      T dj = A[j][j] + ridge;
      SMALL_FOR(k, 0, j) dj -= A[j][k] * A[j][k];
      dj = sqrt(dj);
      A[j][j] = dj;
      SMALL_FOR(i, j + 1, p) {
        T v = A[i][j];
        SMALL_FOR(k, 0, j) v -= A[i][k] * A[j][k];
        A[i][j] = v / dj;
      }
    }
    T aib[PMAX], z[PMAX], Us[PMAX];
    solve<T, PMAX>(A, b, aib, p);
    if (s < S) {
      const T* CGo = CWG + (int64_t)sl * p * S;
      SMALL_FOR(j, 0, p) {
        T v = T(0);
        for (int w = 0; w < NWARP; ++w) v += part[w][gi][j][lane];
        Us[j] = v + CGo[(int64_t)j * S + s] / dg;
      }
      T cg = cGG[(int64_t)sl * S + s] / dg;
      T cy = cGy[(int64_t)g * S + s] / dg;
      for (int w = 0; w < NWARP; ++w) {
        cg += part[w][gi][PMAX][lane];
        cy += part[w][gi][PMAX + 1][lane];
      }
      solve<T, PMAX>(A, Us, z, p);
      T uau = T(0), bau = T(0), bab = T(0);
      SMALL_FOR(i, 0, p) {
        uau += Us[i] * z[i];
        bau += b[i] * z[i];
        bab += b[i] * aib[i];
      }
      const T schur = cg - uau;
      const T resid = cy - bau;
      const T beta_g = resid / schur;
      const int64_t gs = (int64_t)g * S + s;
      SMALL_FOR(i, 0, p) bW_out[gs * p + i] = aib[i] - z[i] * beta_g;
      const T rss = clamp_tiny(yyw - bab - resid * resid / schur);
      const T scale = rss / (T)n;
      bg_out[gs] = beta_g;
      scale_out[gs] = scale;
      lml_out[gs] = T(-0.5) * ((T)n * log(T(6.283185307179586) * scale) +
                               logd + (T)n);
    }
  }
}

}  // namespace

// S (R,), Wt (R, p), yt (R,), CWW (p, p), cWy (p,), cyy (1,), Gt (R, S),
// CWG (p, S), cGy (S,), cGG (S,) -> lml, beta_g (S,), beta_W (S, p),
// scale (S,).
// Row-major f64 on the card; 1 <= p <= 32.  Launches on `stream`; returns
// cudaGetLastError().
extern "C" int crm_fast_scan(const double* Sv, const double* Wt,
                             const double* yt, const double* CWW,
                             const double* cWy, const double* cyy,
                             const double* Gt, const double* CWG,
                             const double* cGy, const double* cGG,
                             double* lml, double* beta_g, double* beta_W,
                             double* scale, double delta, int n, int R, int p,
                             int S, cudaStream_t stream) {
  auto launch = [&](auto kernel, auto pmax) {
    int smem;
    const int err =
        dyn_smem<double, decltype(pmax)::value>(kernel, 1, p, &smem);
    if (err) return err;
    const int blocks = (S + 31) / 32;
    kernel<<<blocks, NT, smem, stream>>>(Sv, Wt, yt, CWW, cWy, cyy, Gt, CWG,
                                         cGy, cGG, lml, beta_g, beta_W,
                                         scale, delta, n, R, p, S);
    return (int)cudaGetLastError();
  };
  if (p <= 2) return launch(fast_scan_kernel<double, 2>, PC<2>());
  if (p <= 4) return launch(fast_scan_kernel<double, 4>, PC<4>());
  if (p <= 16) return launch(fast_scan_kernel<double, 16>, PC<16>());
  return launch(fast_scan_kernel<double, WIDE_P>, PC<WIDE_P>());
}

// The gene axis.  Per slot (m distinct best rho): S (m, R), Wt (m, R, p),
// CWW (m, p, p), Gt (m, R, S), CWG (m, p, S), cGG (m, S); per gene: delta
// (genes,), yt (genes, R), cWy (genes, p), cyy (genes,), cGy (genes, S);
// order (genes,) int32, the genes ordered by slot, and starts (m + 1,)
// int32, slot k's genes being order[starts[k] .. starts[k + 1]);
// max_genes the most genes of a slot -> lml, beta_g, scale (genes, S),
// beta_W (genes, S, p).  Row-major f64 on the card; 1 <= p <= 32, m <=
// 65535.  Launches on `stream`; returns cudaGetLastError().
extern "C" int crm_fast_scan_genes(const double* delta, const double* Sv,
                                   const double* Wt, const double* yt,
                                   const double* CWW, const double* cWy,
                                   const double* cyy, const double* Gt,
                                   const double* CWG, const double* cGy,
                                   const double* cGG, const int* order,
                                   const int* starts, double* lml,
                                   double* beta_g, double* beta_W,
                                   double* scale, int n, int R, int p, int S,
                                   int m, int max_genes,
                                   cudaStream_t stream) {
  auto launch = [&](auto kernel, auto pmax) {
    constexpr int PM = decltype(pmax)::value;
    constexpr int gc = GeneChunk<PM>::GC;
    int smem;
    const int err = dyn_smem<double, PM>(kernel, gc, p, &smem);
    if (err) return err;
    const dim3 grid((S + 31) / 32, m, (max_genes + gc - 1) / gc);
    kernel<<<grid, NT, smem, stream>>>(delta, Sv, Wt, yt, CWW, cWy, cyy, Gt,
                                       CWG, cGy, cGG, order, starts, lml,
                                       beta_g, beta_W, scale, n, R, p, S);
    return (int)cudaGetLastError();
  };
  if (p <= 2) return launch(fast_scan_genes_kernel<double, 2>, PC<2>());
  if (p <= 4) return launch(fast_scan_genes_kernel<double, 4>, PC<4>());
  if (p <= 16) return launch(fast_scan_genes_kernel<double, 16>, PC<16>());
  return launch(fast_scan_genes_kernel<double, WIDE_P>, PC<WIDE_P>());
}

// The float32 context: the operands and results of crm_fast_scan in f32
// (delta rounded to f32), 1 <= p <= 16.
extern "C" int crm_fast_scan_f32(const float* Sv, const float* Wt,
                                 const float* yt, const float* CWW,
                                 const float* cWy, const float* cyy,
                                 const float* Gt, const float* CWG,
                                 const float* cGy, const float* cGG,
                                 float* lml, float* beta_g, float* beta_W,
                                 float* scale, double delta, int n, int R,
                                 int p, int S, cudaStream_t stream) {
  if (p < 1 || p > 16) return (int)cudaErrorInvalidValue;
  auto launch = [&](auto kernel, auto pmax) {
    int smem;
    const int err =
        dyn_smem<float, decltype(pmax)::value>(kernel, 1, p, &smem);
    if (err) return err;
    const int blocks = (S + 31) / 32;
    kernel<<<blocks, NT, smem, stream>>>(Sv, Wt, yt, CWW, cWy, cyy, Gt, CWG,
                                         cGy, cGG, lml, beta_g, beta_W,
                                         scale, (float)delta, n, R, p, S);
    return (int)cudaGetLastError();
  };
  if (p <= 2) return launch(fast_scan_kernel<float, 2>, PC<2>());
  if (p <= 4) return launch(fast_scan_kernel<float, 4>, PC<4>());
  return launch(fast_scan_kernel<float, 16>, PC<16>());
}

// The float32 context's gene axis: the operands and results of
// crm_fast_scan_genes in f32 (order and starts as there), 1 <= p <= 16.
extern "C" int crm_fast_scan_genes_f32(const float* delta, const float* Sv,
                                       const float* Wt, const float* yt,
                                       const float* CWW, const float* cWy,
                                       const float* cyy, const float* Gt,
                                       const float* CWG, const float* cGy,
                                       const float* cGG, const int* order,
                                       const int* starts, float* lml,
                                       float* beta_g, float* beta_W,
                                       float* scale, int n, int R, int p,
                                       int S, int m, int max_genes,
                                       cudaStream_t stream) {
  if (p < 1 || p > 16) return (int)cudaErrorInvalidValue;
  auto launch = [&](auto kernel, auto pmax) {
    constexpr int PM = decltype(pmax)::value;
    constexpr int gc = GeneChunk<PM>::GC;
    int smem;
    const int err = dyn_smem<float, PM>(kernel, gc, p, &smem);
    if (err) return err;
    const dim3 grid((S + 31) / 32, m, (max_genes + gc - 1) / gc);
    kernel<<<grid, NT, smem, stream>>>(delta, Sv, Wt, yt, CWW, cWy, cyy, Gt,
                                       CWG, cGy, cGG, order, starts, lml,
                                       beta_g, beta_W, scale, n, R, p, S);
    return (int)cudaGetLastError();
  };
  if (p <= 2) return launch(fast_scan_genes_kernel<float, 2>, PC<2>());
  if (p <= 4) return launch(fast_scan_genes_kernel<float, 4>, PC<4>());
  return launch(fast_scan_genes_kernel<float, 16>, PC<16>());
}
