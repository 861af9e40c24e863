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
// golden-section steps are sequential.  Design: 256-thread blocks, in two
// instantiations.
//
// Narrow (p <= 16): the grid points are spread over the block's 8 warps
// (lanes over r, an xor-shuffle tree, the (p x p) algebra on every lane);
// then warp 0 runs the golden section alone, lane 0's objective value
// deciding each step for the whole warp.
//
// Wide (16 < p <= 128, the aggregate environment at many contexts, where
// p = rank[W, E] + 1; the card's envelope needs 97): the normal equations
// of one evaluation are one FP64 tensor-core product, the packed lower
// triangle of [X | y]^T diag(w) [X | y] (the m16n8 tiles of the lower
// triangle spread over 8 warps, dmma.cuh's mma.sync m16n8k8, the A
// fragment scaled by w = 1 / d_r as it is loaded, the rows through a
// cp.async ring of 32-row chunks).  The bordered matrix [[A + ridge, b],
// [b^T, yDy]] is then factored right-looking with its entries in
// registers, one barrier a column: its first p pivots give logdet A, the
// last the residual rss, so an objective evaluation needs no solve (beta,
// a back substitution over one warp, is the final fit's alone).  The fit
// runs as n_iters + 6 launches:
// * logdet(X^T X) a block a rho point (REML), and the grid a block a (grid
//   point, rho): the grid's evaluations are independent and fill the card;
// * the golden section one launch a step, each evaluation spread over up
//   to NSPLIT = 12 blocks of its rho point (11 rho x 12 = 132 blocks at
//   the headline): a block writes its rows' partial sums to a scratch, and
//   the next step's blocks each gather them (in block order), factor, and
//   make the golden-section decision, then write their partial sums at
//   the next point; the last launch is the final fit.  The sequence of
//   points and decisions is the reference's exactly.
//   Measured (scripts/profile_wide_fit.py and profile_kernel_ab.py, an
//   H100 80GB HBM3 at 700 W, p = 52, R = 2000, 60 golden steps): one
//   block an evaluation spent 226k cycles in its pass over R (63 chunks,
//   ~3.6k cycles each: as many with the products taken out or with 64-row
//   chunks, a third fewer with the loads taken out; each chunk made its
//   own weights on its path) and 81k in a factorization that took
//   sqrt and log on every column: 162 us an evaluation, 10.2 ms for the
//   golden section.  Spread over 12 blocks, with each stretch's weights
//   made first and the logs taken after the loop, a step costs 24k cycles
//   of partial sums and 60k of gathering and factoring: 3.9 ms for the 63
//   steps, 6.3 ms for the fit (83.2 ms before).
//
// The gene axis (the gene-batched association scans: many phenotypes, one
// covariance family): the phenotype's operands (yt, cxy, cyy) and the fits
// carry a leading gene axis, the eigenvalues, the rotated covariates and
// their complement (S, Xt, Cxx) are shared.  Each instantiation takes the
// genes as one more grid axis, so that one call's launches serve every
// gene: narrow, a block per (rho, gene); wide, the
// logdets of X^T X once per rho (no phenotype enters them), the grid a
// block per (grid point, rho, gene), the golden section's steps up to
// NSPLIT blocks per (rho, gene), the final fit a block per (rho, gene).
// A single phenotype is genes = 1.
#include <cuda_runtime.h>
#include <algorithm>
#include <cfloat>
#include <cstdint>

#include "async_copy.cuh"
#include "dmma.cuh"

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
// wide instantiation: 16 < p <= 128, every evaluation a tensor-core product
// ---------------------------------------------------------------------------
constexpr int NW = NT / 32;    // warps of a wide block
constexpr int WMAX = 128;      // p of the wide kernels
constexpr int WQ = WMAX + 1;   // columns [X | y]
constexpr int WRC = 32;        // rows a staged chunk
constexpr int WSTAGES = 3;     // chunks in flight
constexpr int WSEG = 2048;     // rows whose weights are made at once

// The shapes of one evaluation at p covariates: q = p + 1 columns [X | y],
// staged W = q rounded up to 16 wide with leading dimension LD = W + 4
// (4 mod 16 doubles: a half-warp's fragment loads fall in distinct banks);
// the lower-triangle m16n8 tiles of the (q x q) Gram, tpw a warp; the
// matrix in shared memory with the odd leading dimension LDM.
struct WideGeom {
  int q, W, LD, LDM, NN, ntiles, tpw;
};

__host__ __device__ inline WideGeom wide_geom(int p) {
  WideGeom s;
  s.q = p + 1;
  s.W = (s.q + 15) / 16 * 16;
  s.LD = s.W + 4;
  s.LDM = s.q | 1;
  s.NN = (s.q + 7) / 8;
  s.ntiles = 0;
  for (int mt = 0; mt * 16 < s.q; ++mt)
    s.ntiles += s.NN < 2 * mt + 2 ? s.NN : 2 * mt + 2;
  s.tpw = (s.ntiles + NW - 1) / NW;
  return s;
}

// the calling warp's tiles (m16 row mt, n8 column nt), in (mt, nt) order,
// consecutive tiles of one row sharing their A fragment
template <int TMAX>
struct Tiles {
  int m[TMAX], n[TMAX], cnt;
};

template <int TMAX>
__device__ Tiles<TMAX> warp_tiles(const WideGeom& s) {
  Tiles<TMAX> tl;
  const int first = (threadIdx.x / 32) * s.tpw;
  tl.cnt = max(0, min(s.tpw, s.ntiles - first));
#pragma unroll
  for (int u = 0; u < TMAX; ++u) {
    int f = first + u, mt = 0;
    if (u < tl.cnt) {
      while (f >= min(s.NN, 2 * mt + 2)) {
        f -= min(s.NN, 2 * mt + 2);
        ++mt;
      }
    }
    tl.m[u] = mt;
    tl.n[u] = u < tl.cnt ? f : 0;
  }
  return tl;
}

// the entries a thread owns in the Cholesky: the packed lower triangle's
// entries tid + u NT, (i, k) as i << 8 | k (-1 past the triangle)
template <int TMAX>
__host__ __device__ constexpr int ent_of() {
  return TMAX <= 3 ? 9 : TMAX <= 6 ? 19 : 33;   // q <= 64, 96, 129
}

template <int TMAX>
struct Owned {
  int code[ent_of<TMAX>()];
};

template <int TMAX>
__device__ Owned<TMAX> owned_entries(const WideGeom& s) {
  Owned<TMAX> ow;
  const int ntri = s.q * (s.q + 1) / 2;
#pragma unroll
  for (int u = 0; u < ent_of<TMAX>(); ++u) {
    const int f = threadIdx.x + u * NT;
    int i = 0;
    if (f < ntri) {
      i = (int)((sqrt(8.0 * f + 1.0) - 1.0) * 0.5);
      while (i * (i + 1) / 2 > f) --i;
      while ((i + 1) * (i + 2) / 2 <= f) ++i;
    }
    ow.code[u] = f < ntri ? i << 8 | (f - i * (i + 1) / 2) : -1;
  }
  return ow;
}

#ifdef NULL_FIT_CLOCKS
// scripts/profile_wide_fit.py's build: clock64 sections of block (0, 0,
// 0)'s golden-section steps, summed: the previous point's factorization
// (its partial sums gathered), this point's partial sums
__device__ unsigned long long nf_clocks[2];
#define NF_CLOCK(k)                                                      \
  if (threadIdx.x == 0 && blockIdx.x == 0 && blockIdx.y == 0 &&         \
      blockIdx.z == 0) {                                                 \
    const long long now = clock64();                                     \
    atomicAdd(&nf_clocks[k], (unsigned long long)(now - nf_t0));         \
    nf_t0 = now;                                                         \
  }
#else
#define NF_CLOCK(k)
#endif

struct WideSh {
  double red[2][NW];   // the warps' partial sums of log d, max |diag|
  double d[WQ];        // the Cholesky's pivots, squared
  double z[WQ];        // L^{-1} b, then beta
  double val[3];       // lml (or logdet), scale, rss
};

// doubles of the packed lower triangle of the (q x q) sums
__host__ __device__ inline int npack_of(const WideGeom& s) {
  return s.q * (s.q + 1) / 2;
}

// The sums of one evaluation at delta over rows [r0, r1): the packed lower
// triangle of [X | y]^T diag(w) [X | y] into dst (shared or global memory),
// w = 1 / d_r (1 where gram).  One DMMA product over chunks of 32 rows
// through a cp.async ring, the A fragment scaled by w as it is loaded; the
// weights (and log d_r) of WSEG rows at a time are made first, over the
// whole block (made a chunk at a time, their divisions and logarithms
// held each chunk back: scripts/profile_wide_fit.py).  Returns sum log d_r
// over the rows on every thread; starts and ends with the block in step.
template <int TMAX>
__device__ double wide_sums(const Rho& o, const WideGeom& gm,
                            const Tiles<TMAX>& tl, double delta, bool gram,
                            int r0, int r1, double* sm, WideSh& sh,
                            double* dst) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int p = o.p, q = gm.q, LD = gm.LD, W = gm.W;
  double* wseg = sm + WSTAGES * WRC * LD;   // [WSEG]
  double logd = 0.0;
  // the thread's first staged element (row, column) and its stride
  const int r_first = tid / W, c_first = tid - r_first * W;
  const int r_step = NT / W, c_step = NT - r_step * W;
  int s0 = r0, s1 = r0;   // the segment

  auto load = [&](int b, int chunk) {
    const int rc = s0 + chunk * WRC;
    double* st = sm + b * WRC * LD;
    for (int r = r_first, c = c_first; r < WRC;) {
      const int row = rc + r;
      double* d = st + r * LD + c;
      if (row < s1 && c < q)
        cp_async8(d, c < p ? o.X + (int64_t)row * p + c : o.y + row);
      else
        *d = 0.0;
      r += r_step;
      c += c_step;
      if (c >= W) {
        c -= W;
        ++r;
      }
    }
  };

  double acc[TMAX][4];
#pragma unroll
  for (int u = 0; u < TMAX; ++u)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[u][i] = 0.0;

  for (; s0 < r1; s0 = s1) {
    s1 = min(r1, s0 + WSEG);
    const int chunks = (s1 - s0 + WRC - 1) / WRC;
    for (int r = tid; r < chunks * WRC; r += NT) {
      double w = 0.0;   // rows past the segment: X is staged as 0
      if (s0 + r < s1) {
        const double d = (1.0 - delta) * o.S[s0 + r] + delta;
        w = gram ? 1.0 : 1.0 / d;
        if (!gram) logd += log(d);
      }
      wseg[r] = w;
    }
#pragma unroll
    for (int c = 0; c < WSTAGES - 1; ++c) {
      if (c < chunks) load(c, c);
      cp_async_commit();
    }
    for (int c = 0; c < chunks; ++c) {
      cp_async_wait<WSTAGES - 2>();
      __syncthreads();
      const int next = c + WSTAGES - 1;
      if (next < chunks) load(next % WSTAGES, next);
      cp_async_commit();
      const int b = c % WSTAGES;
      const double* st = sm + b * WRC * LD;
      const double* wv = wseg + c * WRC;
#pragma unroll
      for (int k0 = 0; k0 < WRC; k0 += 8) {
        const double wk[2] = {wv[k0 + t], wv[k0 + t + 4]};
        double a[4], bf[2];
        int cur = -1;
#pragma unroll
        for (int u = 0; u < TMAX; ++u) {
          if (u >= tl.cnt) break;
          const int mt = tl.m[u], nt = tl.n[u];
          if (mt != cur) {
#pragma unroll
            for (int e = 0; e < 4; ++e)
              a[e] = st[(k0 + t + 4 * (e >> 1)) * LD + mt * 16 + g +
                        8 * (e & 1)] * wk[e >> 1];
            cur = mt;
          }
#pragma unroll
          for (int e = 0; e < 2; ++e)
            bf[e] = st[(k0 + t + 4 * e) * LD + nt * 8 + g];
          dmma_m16n8k8(acc[u], a, bf);
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();
  }
  // d[i] of tile (mt, nt) is row mt 16 + g + 8 (i >> 1), column nt 8 + 2t
  // + (i & 1); every entry of the lower triangle lies in one tile
#pragma unroll
  for (int u = 0; u < TMAX; ++u) {
    if (u >= tl.cnt) break;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = tl.m[u] * 16 + g + 8 * (i >> 1);
      const int col = tl.n[u] * 8 + 2 * t + (i & 1);
      if (row < q && col <= row) dst[row * (row + 1) / 2 + col] = acc[u][i];
    }
  }
  logd = warp_sum(logd);
  if (lane == 0) sh.red[0][warp] = logd;
  __syncthreads();
  double s = 0.0;
  for (int w = 0; w < NW; ++w) s += sh.red[0][w];
  return s;
}

// The lml at delta from the evaluation's sums: the thread's entries of the
// bordered matrix [[A + ridge, b], [b^T, yDy]] are the sum of `nsrc` packed
// vectors src + s stride (shared or global memory; added in the order of
// s) and the complements (Cxx, cxy, cyy over delta); logd is sum_r log d_r.
// The matrix is factored right-looking with its entries in registers (each
// thread its own, `ow`) and one barrier a column: the column's owners
// publish it in M (shared, q x LDM), the others update from it with the
// pivot's reciprocal.  The first p pivots give logdet A (their logs taken
// once, after the loop), the last the residual rss = yDy - b^T A^{-1} b;
// M ends with the factor's unscaled columns.
// mode 0: logdet(X^T X + Cxx) (no 1/delta); mode 1: the lml; mode 2: the
// lml, scale and rss, and beta in sh.z.  Returns the same value on every
// thread; starts and ends with the block in step.
template <int TMAX>
__device__ double wide_factor(const Rho& o, const WideGeom& gm,
                              const Owned<TMAX>& ow, double delta, int mode,
                              const double* src, int nsrc, int64_t stride,
                              double logd, double* M, WideSh& sh,
                              double& scale, double& rss) {
  constexpr int ENT = ent_of<TMAX>();
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int p = o.p, q = gm.q, LDM = gm.LDM;
  const bool gram = mode == 0;
  double v[ENT], dmax = 0.0;
#pragma unroll
  for (int u = 0; u < ENT; ++u) v[u] = 0.0;
  // the sources in order, all of a source's entries in flight at once
#pragma unroll 2
  for (int s = 0; s < nsrc; ++s) {
    const double* ss = src + s * stride + tid;
#pragma unroll
    for (int u = 0; u < ENT; ++u)
      if (ow.code[u] >= 0) v[u] += ss[u * NT];
  }
#pragma unroll
  for (int u = 0; u < ENT; ++u) {
    const int code = ow.code[u], i = code >> 8, k = code & 0xff;
    if (code < 0) continue;
    const double c = i < p ? o.Cxx[i * p + k] : k < p ? o.cxy[k] : o.cyy;
    v[u] += gram ? c : c / delta;
    if (i == k && i < p) dmax = fmax(dmax, fabs(v[u]));
  }
  for (int off = 16; off > 0; off >>= 1)
    dmax = fmax(dmax, __shfl_xor_sync(FULL, dmax, off));
  if (lane == 0) sh.red[1][warp] = dmax;
  __syncthreads();
  dmax = 0.0;
  for (int w = 0; w < NW; ++w) dmax = fmax(dmax, sh.red[1][w]);
  // the ridge (sym_pseudo_solve_and_logdet's) on A's diagonal
  const double ridge = 1e-12 * fmax(dmax, 1.0);
#pragma unroll
  for (int u = 0; u < ENT; ++u) {
    const int code = ow.code[u], i = code >> 8, k = code & 0xff;
    if (code >= 0 && i == k && i < p) v[u] += ridge;
  }

  for (int j = 0; j < q; ++j) {
#pragma unroll
    for (int u = 0; u < ENT; ++u) {
      const int code = ow.code[u];
      if (code >= 0 && (code & 0xff) == j) M[(code >> 8) * LDM + j] = v[u];
    }
    __syncthreads();
    if (j == q - 1) break;
    const double rd = 1.0 / M[j * LDM + j];
#pragma unroll
    for (int u = 0; u < ENT; ++u) {
      const int code = ow.code[u], i = code >> 8, k = code & 0xff;
      if (code >= 0 && k > j)
        v[u] -= M[i * LDM + j] * rd * M[k * LDM + j];
    }
  }
  // the pivots (NaN where the factorization fails, as the JAX engine's
  // Cholesky), logdet A, the lml, then beta = L^{-T} z, z = L^{-1} b the
  // factor's last row (L[i][j] = M[i][j] / sqrt(d_j)), by a column-oriented
  // back substitution over warp 0's lanes
  if (warp == 0) {
    double la = 0.0;
    for (int j = lane; j < p; j += 32) {
      const double d = M[j * LDM + j];
      sh.d[j] = sqrt(d > 0 ? d : -1.0);
      la += log(sh.d[j]);
    }
    la = 2.0 * warp_sum(la);
    const double rss_raw = M[p * LDM + p];
    const double rs = rss_raw < DBL_MIN ? DBL_MIN : rss_raw;   // keeps NaN
    const double two_pi = 6.283185307179586;
    const double logdet_d = logd + (o.n - o.R) * log(delta);
    double sc, lml;
    if (o.reml) {
      const double nu = o.n - p;
      sc = rs / nu;
      lml = -0.5 * (nu * log(two_pi * sc) + logdet_d + la - o.ld_xx + nu);
    } else {
      sc = rs / o.n;
      lml = -0.5 * (o.n * log(two_pi * sc) + logdet_d + o.n);
    }
    if (lane == 0) {
      sh.val[0] = gram ? la : lml;
      sh.val[1] = sc;
      sh.val[2] = rs;
    }
    if (mode == 2) {
      __syncwarp();
      for (int a = lane; a < p; a += 32) sh.z[a] = M[p * LDM + a] / sh.d[a];
      __syncwarp();
      for (int a = p - 1; a >= 0; --a) {
        const double ba = sh.z[a] / sh.d[a];
        __syncwarp();
        if (lane == 0) sh.z[a] = ba;
        for (int b = lane; b < a; b += 32)
          sh.z[b] -= M[a * LDM + b] / sh.d[b] * ba;
        __syncwarp();
      }
    }
  }
  __syncthreads();
  scale = sh.val[1];
  rss = sh.val[2];
  const double out = sh.val[0];
  __syncthreads();
  return out;
}

// One evaluation on one block: the sums over all R rows into shared memory
// (the packed triangle, then the matrix M after it), then the factor.
template <int TMAX>
__device__ double wide_eval(const Rho& o, const WideGeom& gm,
                            const Tiles<TMAX>& tl, const Owned<TMAX>& ow,
                            double delta, int mode, double* sm, WideSh& sh,
                            double& scale, double& rss) {
  const int npack = (npack_of(gm) + 1) / 2 * 2;
  const double logd =
      wide_sums<TMAX>(o, gm, tl, delta, mode == 0, 0, o.R, sm, sh, sm);
  return wide_factor<TMAX>(o, gm, ow, delta, mode, sm, 1, 0, logd,
                           sm + npack, sh, scale, rss);
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

// doubles of dynamic shared memory: the chunk ring (and its weights), then
// the same space as the packed sums and the (q x LDM) matrix
__host__ __device__ inline int wide_smem_doubles(const WideGeom& s) {
  const int ring = WSTAGES * WRC * s.LD + WSEG;
  const int mat = (npack_of(s) + 1) / 2 * 2 + s.q * s.LDM;
  return ring > mat ? ring : mat;
}

// logdet(Xt^T Xt + Cxx) of each rho point (delta-independent; REML)
template <int TMAX>
__global__ void __launch_bounds__(NT)
null_fit_wide_ldxx_kernel(const double* __restrict__ Sv,
                          const double* __restrict__ Xt,
                          const double* __restrict__ yt,
                          const double* __restrict__ Cxx,
                          const double* __restrict__ cxy,
                          const double* __restrict__ cyy,
                          double* __restrict__ ldxx, int n, int R, int p) {
  extern __shared__ __align__(16) unsigned char nf_ldxx_dyn[];
  __shared__ WideSh sh;
  double* sm = reinterpret_cast<double*>(nf_ldxx_dyn);
  const WideGeom gm = wide_geom(p);
  // gene 0's phenotype: the Gram pass reads no phenotype sum
  const Rho o = wide_rho(Sv, Xt, yt, Cxx, cxy, cyy, blockIdx.x, blockIdx.x,
                         n, R, p, 1);
  double scale, rss;
  const double ld =
      wide_eval<TMAX>(o, gm, warp_tiles<TMAX>(gm), owned_entries<TMAX>(gm),
                      0.5, 0, sm, sh, scale, rss);
  if (threadIdx.x == 0) ldxx[blockIdx.x] = ld;
}

// the objective at grid point blockIdx.x of rho point blockIdx.y, gene
// blockIdx.z
template <int TMAX>
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
  extern __shared__ __align__(16) unsigned char nf_grid_dyn[];
  __shared__ WideSh sh;
  double* sm = reinterpret_cast<double*>(nf_grid_dyn);
  const WideGeom gm = wide_geom(p);
  const int k = blockIdx.x, ro = blockIdx.y;
  const int64_t gr = (int64_t)blockIdx.z * gridDim.y + ro;
  Rho o = wide_rho(Sv, Xt, yt, Cxx, cxy, cyy, ro, gr, n, R, p, reml);
  if (o.reml) o.ld_xx = ldxx[ro];
  double scale, rss;
  const double v = wide_eval<TMAX>(
      o, gm, warp_tiles<TMAX>(gm), owned_entries<TMAX>(gm),
      sigmoid(logit_at(lo, hi, n_grid, k)), 1, sm, sh, scale, rss);
  if (threadIdx.x == 0) vals[gr * n_grid + k] = v;
}

// The golden section (models/lmm.py `_golden`), one evaluation a launch,
// each spread over gridDim.x blocks of its (rho, gene): launch `step`
// factors the previous step's point from its partial sums (every block the
// same, in the same order), makes the golden-section decision, and writes
// this step's partial sums over its share of the rows.  Step 0 takes the
// grid's argmax and evaluates x1, step 1 x2, steps 2 .. n_iters + 1 the
// iterations' new points, step n_iters + 2 the final fit's point; the
// state (the bracket, both points and values, the pending iteration) and
// the partial sums alternate between two buffers by the step's parity.
constexpr int NSPLIT = 12;   // blocks an evaluation, at most
constexpr int NSTATE = 10;   // a, b, x1, x2, f1, f2, x1n, x2n, left, delta

template <int TMAX>
__global__ void __launch_bounds__(NT)
null_fit_golden_step_kernel(const double* __restrict__ Sv,
                            const double* __restrict__ Xt,
                            const double* __restrict__ yt,
                            const double* __restrict__ Cxx,
                            const double* __restrict__ cxy,
                            const double* __restrict__ cyy,
                            const double* __restrict__ ldxx,
                            const double* __restrict__ vals,
                            double* __restrict__ part,
                            double* __restrict__ state, double lo,
                            double hi, int n_grid, int n_iters, int n, int R,
                            int p, int reml, int step) {
  extern __shared__ __align__(16) unsigned char nf_step_dyn[];
  __shared__ WideSh sh;
  double* sm = reinterpret_cast<double*>(nf_step_dyn);
  const WideGeom gm = wide_geom(p);
  const int nsplit = gridDim.x, split = blockIdx.x, ro = blockIdx.y;
  const int nrho = gridDim.y;
  const int64_t gr = (int64_t)blockIdx.z * nrho + ro;
  const int64_t problems = (int64_t)gridDim.z * nrho;
  Rho o = wide_rho(Sv, Xt, yt, Cxx, cxy, cyy, ro, gr, n, R, p, reml);
  if (o.reml) o.ld_xx = ldxx[ro];
  const int nsum = npack_of(gm) + 1;                  // the sums, log d
  const int64_t pstride = (int64_t)nsplit * nsum;     // a problem's
  double* part_now = part + ((step & 1) * problems + gr) * pstride;
  const double* st_prev =
      state + (((step + 1) & 1) * problems + gr) * NSTATE;
  double* st_now = state + ((step & 1) * problems + gr) * NSTATE;
#ifdef NULL_FIT_CLOCKS
  long long nf_t0 = clock64();
#endif

  double a, b, x1, x2, f1 = 0.0, f2 = 0.0, x1n = 0.0, x2n = 0.0, x;
  bool left = false;
  if (step == 0) {
    // argmax (a NaN wins and stops the scan), on every thread
    const double* vr = vals + gr * n_grid;
    int kb = 0;
    double best = vr[0];
    for (int k = 1; k < n_grid && !isnan(best); ++k) {
      const double v = vr[k];
      if (isnan(v) || v > best) {
        best = v;
        kb = k;
      }
    }
    a = logit_at(lo, hi, n_grid, max(kb - 1, 0));
    b = logit_at(lo, hi, n_grid, min(kb + 1, n_grid - 1));
    const double h = b - a;
    x1 = a + INVPHI2 * h;
    x2 = a + INVPHI * h;
    x = x1;
  } else {
    a = st_prev[0];
    b = st_prev[1];
    x1 = st_prev[2];
    x2 = st_prev[3];
    f1 = st_prev[4];
    f2 = st_prev[5];
    x1n = st_prev[6];
    x2n = st_prev[7];
    left = st_prev[8] != 0.0;
    const double dl = st_prev[9];
    const double* part_prev =
        part + (((step + 1) & 1) * problems + gr) * pstride;
    double logd = 0.0;
    for (int s = 0; s < nsplit; ++s) logd += part_prev[s * nsum + nsum - 1];
    double scale, rss;
    const double f = wide_factor<TMAX>(o, gm, owned_entries<TMAX>(gm), dl, 1,
                                       part_prev, nsplit, nsum, logd, sm, sh,
                                       scale, rss);
    if (step == 1) {
      f1 = f;
      x = x2;
    } else if (step == 2) {
      f2 = f;
    } else {
      // the pending iteration's new point was evaluated
      const double f1n = left ? f : f2;
      f2 = left ? f1 : f;
      f1 = f1n;
      x1 = x1n;
      x2 = x2n;
    }
    if (step >= 2) {
      if (step - 2 < n_iters) {
        left = f1 > f2;
        a = left ? a : x1;
        b = left ? x2 : b;
        const double h = b - a;
        x1n = left ? a + INVPHI2 * h : x2;
        x2n = left ? x1 : a + INVPHI * h;
        x = left ? x1n : x2n;
      } else {
        x = f1 > f2 ? x1 : x2;   // the final fit's point
      }
    }
  }
  NF_CLOCK(0)
  const double dl = sigmoid(x);
  if (split == 0 && threadIdx.x == 0) {
    const double vs[NSTATE] = {a,   b,   x1,  x2,           f1,
                               f2,  x1n, x2n, left ? 1.0 : 0.0, dl};
    for (int i = 0; i < NSTATE; ++i) st_now[i] = vs[i];
  }
  // this block's rows
  const int per = (R + nsplit - 1) / nsplit;
  const int r0 = min(R, split * per), r1 = min(R, r0 + per);
  const double logd = wide_sums<TMAX>(o, gm, warp_tiles<TMAX>(gm), dl, false,
                                      r0, r1, sm, sh, part_now + split * nsum);
  if (threadIdx.x == 0) part_now[split * nsum + nsum - 1] = logd;
  NF_CLOCK(1)
}

// the final fit at the last step's point, from its partial sums
template <int TMAX>
__global__ void __launch_bounds__(NT)
null_fit_final_kernel(const double* __restrict__ Sv,
                      const double* __restrict__ Xt,
                      const double* __restrict__ yt,
                      const double* __restrict__ Cxx,
                      const double* __restrict__ cxy,
                      const double* __restrict__ cyy,
                      const double* __restrict__ ldxx,
                      const double* __restrict__ part,
                      const double* __restrict__ state, int nsplit, int last,
                      double* __restrict__ lml_out,
                      double* __restrict__ delta_out,
                      double* __restrict__ beta_out,
                      double* __restrict__ scale_out,
                      double* __restrict__ v0_out, double* __restrict__ v1_out,
                      double* __restrict__ rss_out, int n, int R, int p,
                      int reml) {
  extern __shared__ __align__(16) unsigned char nf_final_dyn[];
  __shared__ WideSh sh;
  double* sm = reinterpret_cast<double*>(nf_final_dyn);
  const WideGeom gm = wide_geom(p);
  const int ro = blockIdx.x;
  const int64_t gr = (int64_t)blockIdx.y * gridDim.x + ro;
  const int64_t problems = (int64_t)gridDim.y * gridDim.x;
  Rho o = wide_rho(Sv, Xt, yt, Cxx, cxy, cyy, ro, gr, n, R, p, reml);
  if (o.reml) o.ld_xx = ldxx[ro];
  const int nsum = npack_of(gm) + 1;
  const double* pp = part + ((last & 1) * problems + gr) * nsplit * nsum;
  const double delta = state[((last & 1) * problems + gr) * NSTATE + 9];
  double logd = 0.0;
  for (int s = 0; s < nsplit; ++s) logd += pp[s * nsum + nsum - 1];
  double scale, rss;
  const double lml = wide_factor<TMAX>(o, gm, owned_entries<TMAX>(gm), delta,
                                       2, pp, nsplit, nsum, logd, sm, sh,
                                       scale, rss);
  for (int i = threadIdx.x; i < p; i += NT) beta_out[gr * p + i] = sh.z[i];
  if (threadIdx.x == 0) {
    lml_out[gr] = lml;
    delta_out[gr] = delta;
    scale_out[gr] = scale;
    v0_out[gr] = scale * (1 - delta);
    v1_out[gr] = scale * delta;
    rss_out[gr] = rss;
  }
}

// the blocks of one golden-section evaluation: about 64 rows each, at most
// NSPLIT
inline int golden_split(int R) { return std::min(NSPLIT, (R + 63) / 64); }

// scratch doubles of a wide fit: the logdets (nrho), the grid's values
// (genes nrho n_grid), the golden section's partial sums and states (two
// buffers each)
inline int64_t wide_scratch(int p, int nrho, int R, int n_grid, int genes) {
  const int64_t problems = (int64_t)genes * nrho;
  return nrho + problems * n_grid +
         2 * problems * (golden_split(R) * (int64_t)(npack_of(wide_geom(p)) +
                                                     1) + NSTATE);
}

// the launches of a wide fit, at TMAX tiles a warp: logdet(X^T X) (REML),
// the grid, the golden section's n_iters + 3 steps, the final fit
template <int TMAX>
int launch_wide(const double* Sv, const double* Xt, const double* yt,
                const double* Cxx, const double* cxy, const double* cyy,
                double* lml, double* delta, double* beta, double* scale,
                double* v0, double* v1, double* rss, double* scratch,
                double lo, double hi, int n_grid, int n_iters, int n,
                int nrho, int R, int p, int reml, int genes,
                cudaStream_t stream) {
  auto ldxx_kernel = null_fit_wide_ldxx_kernel<TMAX>;
  auto grid_kernel = null_fit_wide_grid_kernel<TMAX>;
  auto step_kernel = null_fit_golden_step_kernel<TMAX>;
  auto final_kernel = null_fit_final_kernel<TMAX>;
  // the shared-memory limit (at WMAX), raised once a process
  static const int most =
      (int)sizeof(double) * wide_smem_doubles(wide_geom(WMAX));
  static const int err_set =
      (int)cudaFuncSetAttribute(ldxx_kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                most) |
      (int)cudaFuncSetAttribute(grid_kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                most) |
      (int)cudaFuncSetAttribute(step_kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                most) |
      (int)cudaFuncSetAttribute(final_kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                most);
  if (err_set) return err_set;
  const int bytes = (int)sizeof(double) * wide_smem_doubles(wide_geom(p));
  const int64_t problems = (int64_t)genes * nrho;
  double* ldxx = scratch;                  // (nrho,)
  double* vals = ldxx + nrho;              // (genes, nrho, n_grid)
  double* state = vals + problems * n_grid;        // (2, genes, nrho, NSTATE)
  double* part = state + 2 * problems * NSTATE;    // (2, genes, nrho, split,
                                                   //  npack + 1)
  int err;
  if (reml) {
    const dim3 rhos(nrho);
    ldxx_kernel<<<rhos, NT, bytes, stream>>>(Sv, Xt, yt, Cxx, cxy, cyy, ldxx,
                                            n, R, p);
    if ((err = (int)cudaGetLastError())) return err;
  }
  const dim3 grid(n_grid, nrho, genes);
  grid_kernel<<<grid, NT, bytes, stream>>>(Sv, Xt, yt, Cxx, cxy, cyy, ldxx,
                                           vals, lo, hi, n_grid, n, R, p,
                                           reml);
  if ((err = (int)cudaGetLastError())) return err;
  const int nsplit = golden_split(R);
  const dim3 splits(nsplit, nrho, genes);
  for (int step = 0; step <= n_iters + 2; ++step) {
    step_kernel<<<splits, NT, bytes, stream>>>(Sv, Xt, yt, Cxx, cxy, cyy,
                                               ldxx, vals, part, state, lo,
                                               hi, n_grid, n_iters, n, R, p,
                                               reml, step);
    if ((err = (int)cudaGetLastError())) return err;
  }
  const dim3 fits(nrho, genes);
  final_kernel<<<fits, NT, bytes, stream>>>(Sv, Xt, yt, Cxx, cxy, cyy, ldxx,
                                            part, state, nsplit, n_iters + 2,
                                            lml, delta, beta, scale, v0, v1,
                                            rss, n, R, p, reml);
  return (int)cudaGetLastError();
}

}  // namespace

// The scratch doubles crm_null_fit needs at these shapes.
extern "C" long long crm_null_fit_scratch(int p, int nrho, int R, int n_grid,
                                          int genes) {
  return p > 16 ? wide_scratch(p, nrho, R, n_grid, genes) : 1;
}

// S (nrho, R), Xt (nrho, R, p), Cxx (nrho, p, p) shared; yt (genes, nrho,
// R), cxy (genes, nrho, p), cyy (genes, nrho) per gene -> lml, delta
// (genes, nrho), beta (genes, nrho, p), scale, v0, v1, rss (genes, nrho);
// scratch: crm_null_fit_scratch's doubles (the wide instantiation's).
// Row-major f64 on the card; 1 <= p <= 128 (the wide instantiation above
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
    const int tpw = wide_geom(p).tpw;
    auto launch = tpw <= 3 ? launch_wide<3>
                  : tpw <= 6 ? launch_wide<6>
                             : launch_wide<12>;
    return launch(Sv, Xt, yt, Cxx, cxy, cyy, lml, delta, beta, scale, v0, v1,
                  rss, scratch, lo, hi, n_grid, n_iters, n, nrho, R, p, reml,
                  genes, stream);
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

#ifdef NULL_FIT_CLOCKS
// the summed clock64 sections (then zeroed): see nf_clocks
extern "C" int crm_null_fit_clocks(unsigned long long* out) {
  int err = (int)cudaMemcpyFromSymbol(out, nf_clocks, sizeof(nf_clocks));
  const unsigned long long zero[2] = {0, 0};
  if (!err) err = (int)cudaMemcpyToSymbol(nf_clocks, zero, sizeof(zero));
  return err;
}
#endif
