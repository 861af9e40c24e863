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
// reductions over R per rho (~0.02 GFLOP at R = 1010), but the
// golden-section steps are sequential.  Design: one 256-thread block per
// rho point.  The grid points are spread over the block's 8 warps (lanes
// over r, an xor-shuffle tree, the (p x p) algebra on every lane); then
// warp 0 runs the golden section alone, lane 0's objective value deciding
// each step for the whole warp.
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
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  Rho o;
  o.S = Sv + (int64_t)ro * R;
  o.X = Xt + (int64_t)ro * R * p;
  o.y = yt + (int64_t)ro * R;
  o.Cxx = Cxx + (int64_t)ro * p * p;
  o.cxy = cxy + (int64_t)ro * p;
  o.cyy = cyy[ro];
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
    lml_out[ro] = lml;
    delta_out[ro] = delta;
    SMALL_FOR(i, 0, p) beta_out[(int64_t)ro * p + i] = beta[i];
    scale_out[ro] = scale;
    v0_out[ro] = scale * (1 - delta);
    v1_out[ro] = scale * delta;
    rss_out[ro] = rss;
  }
}

}  // namespace

// S (nrho, R), Xt (nrho, R, p), yt (nrho, R), Cxx (nrho, p, p), cxy
// (nrho, p), cyy (nrho,) -> lml, delta (nrho,), beta (nrho, p), scale, v0,
// v1, rss (nrho,).  Row-major f64 on the card; 1 <= p <= 16,
// n_grid <= 1024.  Launches on `stream`; returns cudaGetLastError().
extern "C" int crm_null_fit(const double* Sv, const double* Xt,
                            const double* yt, const double* Cxx,
                            const double* cxy, const double* cyy, double* lml,
                            double* delta, double* beta, double* scale,
                            double* v0, double* v1, double* rss, double lo,
                            double hi, int n_grid, int n_iters, int n,
                            int nrho, int R, int p, int reml,
                            cudaStream_t stream) {
  auto kernel = p <= 2   ? null_fit_kernel<2>
                : p <= 4 ? null_fit_kernel<4>
                         : null_fit_kernel<16>;
  kernel<<<nrho, NT, 0, stream>>>(Sv, Xt, yt, Cxx, cxy, cyy, lml, delta, beta,
                                  scale, v0, v1, rss, lo, hi, n_grid, n_iters,
                                  n, R, p, reml);
  return (int)cudaGetLastError();
}
