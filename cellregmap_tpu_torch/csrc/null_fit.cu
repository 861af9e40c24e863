// K10: the profiled fits over the rho grid, one per rho point, f64, for
// sm_90a.
//
// Per rho point o, with eigenvalues S_r, rotated covariates X_r (p columns)
// and phenotype y_r (r < R) and the complements (Cxx, cxy, cyy), the lml at
// delta (cellregmap_tpu/models/lmm.py:52-76,115-133 `lml_at_delta_eig`):
//
//   d_r = (1 - delta) S_r + delta,  A = sum_r X_r X_r^T / d_r + Cxx / delta,
//   b = sum_r X_r y_r / d_r + cxy / delta,  yDy = sum_r y_r^2 / d_r
//   + cyy / delta,  logdet D = sum_r log d_r + (n - R) log delta,
//   beta = (A + ridge)^{-1} b,  rss = max(yDy - b.beta, tiny),
//   REML: lml = -(nu log(2 pi rss/nu) + logdet D + logdet A - logdet X^TX
//          + nu) / 2, nu = n - p;   ML: lml = -(n log(2 pi rss/n)
//          + logdet D + n) / 2,
//
// maximized as `fit_delta_eig` does (:211-251, :333-351): the lml on a grid
// of n_grid logit(delta) points (torch.linspace's values), its argmax (a
// NaN wins, as argmax's), n_iters golden-section steps in the bracket of
// the neighbouring grid points, and the final fit at the best point.
// `restricted` selects REML (the interaction's `mean_fit_kernel`) or ML
// (the association's null fit); the ridge is rcond 1e-12 * max(max|diag|,
// 1), as `sym_pseudo_solve_and_logdet`'s.
//
// Replaces: cellregmap_tpu/engine.py `_fit_over_rho` (:268-289) as run by
// `null_association_kernel` (:865-872) and `mean_fit_kernel` (:849-859):
// a vmap over rho of 2 + n_grid + n_iters sequential tiny fits.
//
// What bounds it on the H100: latency.  The work is (n_grid + n_iters + 3)
// reductions over R per rho (~0.02 GFLOP at R = 1010, p = 1), but the
// golden-section steps are sequential.  Design: one 256-thread block per
// rho point, in two instantiations.
//
// Narrow (p <= 16): the grid points are spread over the block's 8 warps
// (lanes over r, an xor-shuffle tree, the (p x p) algebra on every lane);
// then warp 0 runs the golden section alone, lane 0's objective value
// deciding each step for the whole warp.
//
// Wide (16 < p <= 64, the aggregate environment at many contexts, where
// p = rank[W, E] + 1): per-lane (p x p) arrays would spill, so the normal
// equations live in shared memory (packed lower triangle, 16.6 KB at
// p = 64).  Every objective evaluation reduces over R with the whole
// block: the rows stream through shared memory in chunks of 16, each
// thread owning up to 9 of the p (p + 1) / 2 + p + 2 sums in registers.
// The ridge Cholesky runs right-looking in shared memory (one column a
// step, the trailing update over the block), the triangular solves and
// the lml on thread 0.  An evaluation is one block's work, so the wide
// fit runs as three launches: logdet(X^T X) per rho (REML), one block per
// (grid point, rho) for the grid (the grid's evaluations are independent:
// they fill the card), then one block per rho for the argmax, the golden
// section and the final fit, each golden-section decision read from
// shared memory so that the whole block follows one control flow.  The
// grid values and the logdets pass through a scratch buffer of nrho
// (genes n_grid + 1) doubles.
//
// The gene axis (the gene-batched association scans: many phenotypes, one
// covariance family): the phenotype's operands (yt, cxy, cyy) and the fits
// carry a leading gene axis, the eigenvalues, the rotated covariates and
// their complement (S, Xt, Cxx) are shared.  Each instantiation takes the
// genes as one more grid axis, so that one call is one launch of each of
// its kernels for every gene: narrow, a block per (rho, gene); wide, the
// logdets of X^T X once per rho (no phenotype enters them), the grid a
// block per (grid point, rho, gene), the golden section a block per (rho,
// gene).  A single phenotype is genes = 1.
#include <cuda_runtime.h>
#include <cfloat>
#include <cstdint>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int NT = 256;
constexpr int MAX_GRID = 1024;
constexpr double INVPHI = 0.6180339887498949;
constexpr double INVPHI2 = 0.3819660112501051;

// Loops over the covariates run to the compile-time PMAX and skip what lies
// outside [lo, hi), so the small arrays are indexed statically.
#define SMALL_FOR(i, lo, hi) \
  for (int i = 0; i < PMAX; ++i) \
    if (i >= (lo) && i < (hi))

__device__ __forceinline__ double warp_sum(double v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

__device__ double sigmoid(double x) { return 1.0 / (1.0 + exp(-x)); }

__device__ double logit_at(double lo, double hi, int K, int k) {
  if (K == 1) return lo;
  const double step = (hi - lo) / (double)(K - 1);
  return k < K / 2 ? lo + step * (double)k
                   : hi - step * (double)(K - 1 - k);
}

// ridge Cholesky of a full symmetric (p x p) matrix given by its lower
// triangle, in place; returns logdet
template <int PMAX>
__device__ double ridge_chol(double (&A)[PMAX][PMAX], int p) {
  double dmax = 0.0;
  SMALL_FOR(i, 0, p) dmax = fmax(dmax, fabs(A[i][i]));
  const double ridge = 1e-12 * fmax(dmax, 1.0);
  double logdet = 0.0;
  SMALL_FOR(j, 0, p) {
    double d = A[j][j] + ridge;
    SMALL_FOR(k, 0, j) d -= A[j][k] * A[j][k];
    d = sqrt(d);
    A[j][j] = d;
    logdet += log(d);
    SMALL_FOR(i, j + 1, p) {
      double v = A[i][j];
      SMALL_FOR(k, 0, j) v -= A[i][k] * A[j][k];
      A[i][j] = v / d;
    }
  }
  return 2.0 * logdet;
}

struct Rho {
  const double* S;    // (R,)
  const double* X;    // (R, p)
  const double* y;    // (R,)
  const double* Cxx;  // (p, p)
  const double* cxy;  // (p,)
  double cyy;
  int R, p, n;
  bool reml;
  double ld_xx;
};

// The fit at delta, on every lane of the calling warp: returns the lml and
// fills beta (p,), scale and rss
template <int PMAX>
__device__ double fit_at(const Rho& o, double delta, double* beta,
                         double& scale, double& rss) {
  const int lane = threadIdx.x % 32;
  const int p = o.p;
  double A[PMAX][PMAX], b[PMAX], yDy = 0.0, logd = 0.0;
  SMALL_FOR(i, 0, p) {
    b[i] = 0.0;
    SMALL_FOR(j, 0, i + 1) A[i][j] = 0.0;
  }
  for (int r = lane; r < o.R; r += 32) {
    const double d = (1.0 - delta) * o.S[r] + delta;
    const double w = 1.0 / d;
    const double* x = o.X + (int64_t)r * p;
    const double yv = o.y[r];
    SMALL_FOR(i, 0, p) {
      const double xw = x[i] * w;
      SMALL_FOR(j, 0, i + 1) A[i][j] += xw * x[j];
      b[i] += xw * yv;
    }
    yDy += yv * yv * w;
    logd += log(d);
  }
  SMALL_FOR(i, 0, p) {
    SMALL_FOR(j, 0, i + 1)
      A[i][j] = warp_sum(A[i][j]) + o.Cxx[i * p + j] / delta;
    b[i] = warp_sum(b[i]) + o.cxy[i] / delta;
  }
  yDy = warp_sum(yDy) + o.cyy / delta;
  const double logdet_d = warp_sum(logd) + (o.n - o.R) * log(delta);
  const double logdet_a = ridge_chol<PMAX>(A, p);
  SMALL_FOR(i, 0, p) {
    double v = b[i];
    SMALL_FOR(k, 0, i) v -= A[i][k] * beta[k];
    beta[i] = v / A[i][i];
  }
  for (int i = PMAX - 1; i >= 0; --i) {
    if (i >= p) continue;
    double v = beta[i];
    SMALL_FOR(k, i + 1, p) v -= A[k][i] * beta[k];
    beta[i] = v / A[i][i];
  }
  double bb = 0.0;
  SMALL_FOR(i, 0, p) bb += b[i] * beta[i];
  rss = fmax(yDy - bb, DBL_MIN);
  const double two_pi = 6.283185307179586;
  if (o.reml) {
    const double nu = o.n - p;
    scale = rss / nu;
    return -0.5 * (nu * log(two_pi * scale) + logdet_d + logdet_a - o.ld_xx +
                   nu);
  }
  scale = rss / o.n;
  return -0.5 * (o.n * log(two_pi * scale) + logdet_d + o.n);
}

// the objective at logit x, lane 0's value on every lane
template <int PMAX>
__device__ double objective(const Rho& o, double x) {
  double beta[PMAX], scale, rss;
  const double v = fit_at<PMAX>(o, sigmoid(x), beta, scale, rss);
  return __shfl_sync(FULL, v, 0);
}

template <int PMAX>
__global__ void __launch_bounds__(NT)
null_fit_kernel(const double* __restrict__ Sv, const double* __restrict__ Xt,
                const double* __restrict__ yt, const double* __restrict__ Cxx,
                const double* __restrict__ cxy,
                const double* __restrict__ cyy, double* __restrict__ lml_out,
                double* __restrict__ delta_out, double* __restrict__ beta_out,
                double* __restrict__ scale_out, double* __restrict__ v0_out,
                double* __restrict__ v1_out, double* __restrict__ rss_out,
                double lo, double hi, int n_grid, int n_iters, int n, int R,
                int p, int reml) {
  __shared__ double vals[MAX_GRID];
  __shared__ double ld_sh;
  const int ro = blockIdx.x;
  // the phenotype's problem (gene, rho): its operands and its fit
  const int64_t gr = (int64_t)blockIdx.y * gridDim.x + ro;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  Rho o;
  o.S = Sv + (int64_t)ro * R;
  o.X = Xt + (int64_t)ro * R * p;
  o.y = yt + gr * R;
  o.Cxx = Cxx + (int64_t)ro * p * p;
  o.cxy = cxy + gr * p;
  o.cyy = cyy[gr];
  o.R = R;
  o.p = p;
  o.n = n;
  o.reml = reml != 0;
  o.ld_xx = 0.0;

  // logdet(Xt^T Xt + Cxx): delta-independent (REML only)
  if (o.reml && warp == 0) {
    double G[PMAX][PMAX];
    SMALL_FOR(i, 0, p) SMALL_FOR(j, 0, i + 1) G[i][j] = 0.0;
    for (int r = lane; r < R; r += 32) {
      const double* x = o.X + (int64_t)r * p;
      SMALL_FOR(i, 0, p) SMALL_FOR(j, 0, i + 1) G[i][j] += x[i] * x[j];
    }
    SMALL_FOR(i, 0, p)
    SMALL_FOR(j, 0, i + 1) G[i][j] = warp_sum(G[i][j]) + o.Cxx[i * p + j];
    const double ld = ridge_chol<PMAX>(G, p);
    if (lane == 0) ld_sh = ld;
  }
  __syncthreads();
  if (o.reml) o.ld_xx = ld_sh;

  // the grid, spread over the warps
  for (int k = warp; k < n_grid; k += NT / 32) {
    const double v = objective<PMAX>(o, logit_at(lo, hi, n_grid, k));
    if (lane == 0) vals[k] = v;
  }
  __syncthreads();
  if (warp != 0) return;

  // argmax (a NaN wins and stops the scan, as torch's and jnp's argmax)
  int kb = 0;
  double best = vals[0];
  for (int k = 1; k < n_grid && !isnan(best); ++k) {
    const double v = vals[k];
    if (isnan(v) || v > best) {
      best = v;
      kb = k;
    }
  }
  double a = logit_at(lo, hi, n_grid, max(kb - 1, 0));
  double b = logit_at(lo, hi, n_grid, min(kb + 1, n_grid - 1));

  // golden section (models/lmm.py `_golden`)
  double h = b - a;
  double x1 = a + INVPHI2 * h, x2 = a + INVPHI * h;
  double f1 = objective<PMAX>(o, x1), f2 = objective<PMAX>(o, x2);
  for (int it = 0; it < n_iters; ++it) {
    const bool left = f1 > f2;
    a = left ? a : x1;
    b = left ? x2 : b;
    h = b - a;
    const double x1n = left ? a + INVPHI2 * h : x2;
    const double x2n = left ? x1 : a + INVPHI * h;
    const double fe = objective<PMAX>(o, left ? x1n : x2n);
    const double f1n = left ? fe : f2;
    f2 = left ? f1 : fe;
    f1 = f1n;
    x1 = x1n;
    x2 = x2n;
  }
  const double delta = sigmoid(f1 > f2 ? x1 : x2);

  double beta[PMAX], scale, rss;
  const double lml = fit_at<PMAX>(o, delta, beta, scale, rss);
  if (lane == 0) {
    lml_out[gr] = lml;
    delta_out[gr] = delta;
    SMALL_FOR(i, 0, p) beta_out[gr * p + i] = beta[i];
    scale_out[gr] = scale;
    v0_out[gr] = scale * (1 - delta);
    v1_out[gr] = scale * delta;
    rss_out[gr] = rss;
  }
}

// ---------------------------------------------------------------------------
// wide instantiation: 16 < p <= 64, the algebra in shared memory
// ---------------------------------------------------------------------------
constexpr int WMAX = 64;                                // p of the wide kernel
constexpr int WTRI = WMAX * (WMAX + 1) / 2;
constexpr int WACC = (WTRI + WMAX + 2 + NT - 1) / NT;   // sums a thread
constexpr int WRC = 16;                                 // rows a chunk

struct Wide {
  double A[WTRI];          // packed lower triangle: A[i (i + 1) / 2 + j]
  double b[WMAX], z[WMAX];
  double X[WRC * WMAX], y[WRC], w[WRC], ld[WRC];
  double yDy, logd, val;
};

__device__ __forceinline__ int tri(int i, int j) { return i * (i + 1) / 2 + j; }

// The normal equations of one rho point at delta (gram: the unweighted
// Gram X^T X + Cxx instead) into sh.A, sh.b, sh.yDy, sh.logd: the whole
// block reduces over R, complements added.  Ends with a barrier.
__device__ void wide_sums(const Rho& o, double delta, bool gram, Wide& sh) {
  const int tid = threadIdx.x, p = o.p;
  const int ntri = p * (p + 1) / 2, nent = ntri + p + 2;
  int ei[WACC], ej[WACC];
  double acc[WACC];
#pragma unroll
  for (int t = 0; t < WACC; ++t) {
    const int e = tid + t * NT;
    int i = 0, j = 0;
    if (e < ntri) {
      i = (int)((sqrt(8.0 * e + 1.0) - 1.0) * 0.5);
      while (tri(i, 0) > e) --i;
      while (tri(i + 1, 0) <= e) ++i;
      j = e - tri(i, 0);
    } else if (e < ntri + p) {
      i = e - ntri;          // b_i: X_i against y
      j = -1;
    } else {
      i = e - ntri - p - 2;  // -2: y^2, -1: log d
      j = -2;
    }
    ei[t] = i;
    ej[t] = e < nent ? j : -3;
    acc[t] = 0.0;
  }
  for (int r0 = 0; r0 < o.R; r0 += WRC) {
    const int rows = min(WRC, o.R - r0);
    for (int idx = tid; idx < rows * p; idx += NT)
      sh.X[idx] = o.X[(int64_t)r0 * p + idx];
    if (tid < rows) {
      const double d = (1.0 - delta) * o.S[r0 + tid] + delta;
      sh.y[tid] = o.y[r0 + tid];
      sh.w[tid] = gram ? 1.0 : 1.0 / d;
      sh.ld[tid] = log(d);
    }
    __syncthreads();
    for (int rr = 0; rr < rows; ++rr) {
      const double* x = sh.X + rr * p;
      const double w = sh.w[rr], yv = sh.y[rr];
#pragma unroll
      for (int t = 0; t < WACC; ++t) {
        const int i = ei[t], j = ej[t];
        if (j >= 0) acc[t] += x[i] * w * x[j];
        else if (j == -1) acc[t] += x[i] * w * yv;
        else if (j == -2) acc[t] += i == -2 ? yv * yv * w : sh.ld[rr];
      }
    }
    __syncthreads();
  }
  const double ic = gram ? 1.0 : 1.0 / delta;
#pragma unroll
  for (int t = 0; t < WACC; ++t) {
    const int i = ei[t], j = ej[t];
    if (j >= 0) sh.A[tri(i, j)] = acc[t] + o.Cxx[i * p + j] * ic;
    else if (j == -1) sh.b[i] = acc[t] + o.cxy[i] * ic;
    else if (j == -2 && i == -2) sh.yDy = acc[t] + o.cyy * ic;
    else if (j == -2) sh.logd = acc[t] + (o.n - o.R) * log(delta);
  }
  __syncthreads();
}

// ridge Cholesky of sh.A in place (right-looking, over the block); returns
// logdet on every thread.  Starts and ends with the block in step.
__device__ double wide_chol(int p, Wide& sh) {
  const int tid = threadIdx.x;
  if (tid == 0) {
    double dmax = 0.0;
    for (int i = 0; i < p; ++i) dmax = fmax(dmax, fabs(sh.A[tri(i, i)]));
    const double ridge = 1e-12 * fmax(dmax, 1.0);
    for (int i = 0; i < p; ++i) sh.A[tri(i, i)] += ridge;
  }
  __syncthreads();
  for (int j = 0; j < p; ++j) {
    if (tid == 0) sh.A[tri(j, j)] = sqrt(sh.A[tri(j, j)]);
    __syncthreads();
    const double d = sh.A[tri(j, j)];
    for (int i = j + 1 + tid; i < p; i += NT) sh.A[tri(i, j)] /= d;
    __syncthreads();
    // trailing update of the lower triangle: rows i > j, columns j < k <= i
    const int m = p - j - 1;
    for (int idx = tid; idx < m * (m + 1) / 2; idx += NT) {
      int a = (int)((sqrt(8.0 * idx + 1.0) - 1.0) * 0.5);
      while (a * (a + 1) / 2 > idx) --a;
      while ((a + 1) * (a + 2) / 2 <= idx) ++a;
      const int i = j + 1 + a, k = j + 1 + idx - a * (a + 1) / 2;
      sh.A[tri(i, k)] -= sh.A[tri(i, j)] * sh.A[tri(k, j)];
    }
    __syncthreads();
  }
  double logdet = 0.0;
  for (int i = 0; i < p; ++i) logdet += log(sh.A[tri(i, i)]);
  return 2.0 * logdet;
}

// The fit at delta: lml (every thread), beta in sh.z, scale and rss on
// thread 0.
__device__ double wide_fit(const Rho& o, double delta, Wide& sh,
                           double& scale, double& rss) {
  const int p = o.p;
  wide_sums(o, delta, false, sh);
  const double logdet_a = wide_chol(p, sh);
  if (threadIdx.x == 0) {
    for (int i = 0; i < p; ++i) {
      double v = sh.b[i];
      for (int k = 0; k < i; ++k) v -= sh.A[tri(i, k)] * sh.z[k];
      sh.z[i] = v / sh.A[tri(i, i)];
    }
    for (int i = p - 1; i >= 0; --i) {
      double v = sh.z[i];
      for (int k = i + 1; k < p; ++k) v -= sh.A[tri(k, i)] * sh.z[k];
      sh.z[i] = v / sh.A[tri(i, i)];
    }
    double bb = 0.0;
    for (int i = 0; i < p; ++i) bb += sh.b[i] * sh.z[i];
    rss = fmax(sh.yDy - bb, DBL_MIN);
    const double two_pi = 6.283185307179586;
    if (o.reml) {
      const double nu = o.n - p;
      scale = rss / nu;
      sh.val = -0.5 * (nu * log(two_pi * scale) + sh.logd + logdet_a -
                       o.ld_xx + nu);
    } else {
      scale = rss / o.n;
      sh.val = -0.5 * (o.n * log(two_pi * scale) + sh.logd + o.n);
    }
  }
  __syncthreads();
  const double v = sh.val;
  __syncthreads();
  return v;
}

__device__ double wide_objective(const Rho& o, double x, Wide& sh) {
  double scale, rss;
  return wide_fit(o, sigmoid(x), sh, scale, rss);
}

// the operands of rho point ro and phenotype problem gr = gene nrho + ro
// (logdet(X^T X) left at 0)
__device__ Rho wide_rho(const double* Sv, const double* Xt, const double* yt,
                        const double* Cxx, const double* cxy,
                        const double* cyy, int ro, int64_t gr, int n, int R,
                        int p, int reml) {
  Rho o;
  o.S = Sv + (int64_t)ro * R;
  o.X = Xt + (int64_t)ro * R * p;
  o.y = yt + gr * R;
  o.Cxx = Cxx + (int64_t)ro * p * p;
  o.cxy = cxy + gr * p;
  o.cyy = cyy[gr];
  o.R = R;
  o.p = p;
  o.n = n;
  o.reml = reml != 0;
  o.ld_xx = 0.0;
  return o;
}

// logdet(Xt^T Xt + Cxx) of each rho point (delta-independent; REML)
__global__ void __launch_bounds__(NT)
null_fit_wide_ldxx_kernel(const double* __restrict__ Sv,
                          const double* __restrict__ Xt,
                          const double* __restrict__ yt,
                          const double* __restrict__ Cxx,
                          const double* __restrict__ cxy,
                          const double* __restrict__ cyy,
                          double* __restrict__ ldxx, int n, int R, int p) {
  __shared__ Wide sh;
  // gene 0's phenotype: the Gram pass reads no phenotype sum
  const Rho o = wide_rho(Sv, Xt, yt, Cxx, cxy, cyy, blockIdx.x, blockIdx.x,
                         n, R, p, 1);
  wide_sums(o, 0.5, true, sh);
  const double ld = wide_chol(p, sh);
  if (threadIdx.x == 0) ldxx[blockIdx.x] = ld;
}

// the objective at grid point blockIdx.x of rho point blockIdx.y, gene
// blockIdx.z
__global__ void __launch_bounds__(NT)
null_fit_wide_grid_kernel(const double* __restrict__ Sv,
                          const double* __restrict__ Xt,
                          const double* __restrict__ yt,
                          const double* __restrict__ Cxx,
                          const double* __restrict__ cxy,
                          const double* __restrict__ cyy,
                          const double* __restrict__ ldxx,
                          double* __restrict__ vals, double lo, double hi,
                          int n_grid, int n, int R, int p, int reml) {
  __shared__ Wide sh;
  const int k = blockIdx.x, ro = blockIdx.y;
  const int64_t gr = (int64_t)blockIdx.z * gridDim.y + ro;
  Rho o = wide_rho(Sv, Xt, yt, Cxx, cxy, cyy, ro, gr, n, R, p, reml);
  if (o.reml) o.ld_xx = ldxx[ro];
  const double v = wide_objective(o, logit_at(lo, hi, n_grid, k), sh);
  if (threadIdx.x == 0) vals[gr * n_grid + k] = v;
}

// the argmax of the grid of rho point blockIdx.x, gene blockIdx.y, the
// golden section and the final fit
__global__ void __launch_bounds__(NT)
null_fit_wide_kernel(const double* __restrict__ Sv,
                     const double* __restrict__ Xt,
                     const double* __restrict__ yt,
                     const double* __restrict__ Cxx,
                     const double* __restrict__ cxy,
                     const double* __restrict__ cyy,
                     const double* __restrict__ ldxx,
                     const double* __restrict__ vals,
                     double* __restrict__ lml_out,
                     double* __restrict__ delta_out,
                     double* __restrict__ beta_out,
                     double* __restrict__ scale_out,
                     double* __restrict__ v0_out, double* __restrict__ v1_out,
                     double* __restrict__ rss_out, double lo, double hi,
                     int n_grid, int n_iters, int n, int R, int p, int reml) {
  __shared__ Wide sh;
  const int ro = blockIdx.x;
  const int64_t gr = (int64_t)blockIdx.y * gridDim.x + ro;
  Rho o = wide_rho(Sv, Xt, yt, Cxx, cxy, cyy, ro, gr, n, R, p, reml);
  if (o.reml) o.ld_xx = ldxx[ro];
  const double* vr = vals + gr * n_grid;

  // argmax (a NaN wins and stops the scan), on every thread
  int kb = 0;
  double best = vr[0];
  for (int k = 1; k < n_grid && !isnan(best); ++k) {
    const double v = vr[k];
    if (isnan(v) || v > best) {
      best = v;
      kb = k;
    }
  }
  double a = logit_at(lo, hi, n_grid, max(kb - 1, 0));
  double b = logit_at(lo, hi, n_grid, min(kb + 1, n_grid - 1));

  double h = b - a;
  double x1 = a + INVPHI2 * h, x2 = a + INVPHI * h;
  double f1 = wide_objective(o, x1, sh), f2 = wide_objective(o, x2, sh);
  for (int it = 0; it < n_iters; ++it) {
    const bool left = f1 > f2;
    a = left ? a : x1;
    b = left ? x2 : b;
    h = b - a;
    const double x1n = left ? a + INVPHI2 * h : x2;
    const double x2n = left ? x1 : a + INVPHI * h;
    const double fe = wide_objective(o, left ? x1n : x2n, sh);
    const double f1n = left ? fe : f2;
    f2 = left ? f1 : fe;
    f1 = f1n;
    x1 = x1n;
    x2 = x2n;
  }
  const double delta = sigmoid(f1 > f2 ? x1 : x2);
  double scale, rss;
  const double lml = wide_fit(o, delta, sh, scale, rss);
  if (threadIdx.x == 0) {
    lml_out[gr] = lml;
    delta_out[gr] = delta;
    for (int i = 0; i < p; ++i) beta_out[gr * p + i] = sh.z[i];
    scale_out[gr] = scale;
    v0_out[gr] = scale * (1 - delta);
    v1_out[gr] = scale * delta;
    rss_out[gr] = rss;
  }
}

}  // namespace

// S (nrho, R), Xt (nrho, R, p), Cxx (nrho, p, p) shared; yt (genes, nrho,
// R), cxy (genes, nrho, p), cyy (genes, nrho) per gene -> lml, delta
// (genes, nrho), beta (genes, nrho, p), scale, v0, v1, rss (genes, nrho);
// scratch: nrho (genes n_grid + 1) doubles (the wide instantiation's).
// Row-major f64 on the card; 1 <= p <= 64 (the wide instantiation above
// 16), n_grid <= 1024, genes <= 65535 (a single phenotype is genes = 1).
// Launches on `stream`; returns cudaGetLastError() after each launch.
extern "C" int crm_null_fit(const double* Sv, const double* Xt,
                            const double* yt, const double* Cxx,
                            const double* cxy, const double* cyy, double* lml,
                            double* delta, double* beta, double* scale,
                            double* v0, double* v1, double* rss,
                            double* scratch, double lo, double hi,
                            int n_grid, int n_iters, int n, int nrho, int R,
                            int p, int reml, int genes, cudaStream_t stream) {
  if (p > 16) {
    double* ldxx = scratch;                  // (nrho,)
    double* vals = scratch + nrho;           // (genes, nrho, n_grid)
    if (reml) {
      null_fit_wide_ldxx_kernel<<<nrho, NT, 0, stream>>>(
          Sv, Xt, yt, Cxx, cxy, cyy, ldxx, n, R, p);
      const int err = (int)cudaGetLastError();
      if (err) return err;
    }
    const dim3 grid(n_grid, nrho, genes);
    null_fit_wide_grid_kernel<<<grid, NT, 0, stream>>>(
        Sv, Xt, yt, Cxx, cxy, cyy, ldxx, vals, lo, hi, n_grid, n, R, p, reml);
    const int err = (int)cudaGetLastError();
    if (err) return err;
    const dim3 fits(nrho, genes);
    null_fit_wide_kernel<<<fits, NT, 0, stream>>>(
        Sv, Xt, yt, Cxx, cxy, cyy, ldxx, vals, lml, delta, beta, scale, v0,
        v1, rss, lo, hi, n_grid, n_iters, n, R, p, reml);
    return (int)cudaGetLastError();
  }
  auto kernel = p <= 2   ? null_fit_kernel<2>
                : p <= 4 ? null_fit_kernel<4>
                         : null_fit_kernel<16>;
  const dim3 grid(nrho, genes);
  kernel<<<grid, NT, 0, stream>>>(Sv, Xt, yt, Cxx, cxy, cyy, lml, delta, beta,
                                  scale, v0, v1, rss, lo, hi, n_grid, n_iters,
                                  n, R, p, reml);
  return (int)cudaGetLastError();
}
