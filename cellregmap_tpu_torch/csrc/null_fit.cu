// K10: the profiled fits over the rho grid, one per rho point, f64 (and
// an f32 instantiation for the float32 context, at the end of the file),
// for sm_90a.
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
// Narrow (p <= 16; the association's null fits at p = 1, the aggregate
// environment's at p = rank[B] + 1, 12 at 10 contexts): every evaluation
// runs on a whole 256-thread block, on the problem's rows staged in shared
// memory (resident where the rows and their weights fit in CRM_NF_SMEM_KB,
// else a two-stage cp.async ring of CRM_NF_CHUNK rows).  A pass over the
// rows: the weights 1 / d_r a thread a few rows, the packed lower triangle
// of [X | y]^T diag(w) [X | y] in 2 x 2 (p <= 4) or 4 x 4 register tiles,
// each tile's rows split over a power-of-two number of row groups, one
// reduction (xor shuffles within a warp's segment, the warps' partials in
// shared memory), then the bordered matrix factored on warp 0 (a
// __syncwarp a column; at p = 1 in registers), as the wide factor does.
// An evaluation is a chain of dependent steps, so what sets its time is
// latency, and an f64 logarithm is long: the weights take a branch-free
// reciprocal (async_copy.cuh's rcp_nr), sum log d_r is one running
// product a thread with its exponent carried apart (one log a pass, not
// one a row), the lml's logs are one call on the factoring warp, a lane
// each (lanes that took them on different paths would take them one
// after another), its terms added in the reference's order (the lml's
// profile over delta can be flat to rounding, where the argmax follows
// the last bits), and while warp 0 factors, the last warp makes the
// golden section's next point under either decision, so that the
// decision only selects.  2-3 block barriers a pass.  Three launches:
// logdet(X^T X) a block a rho point (REML); the grid a block per (tile of
// at least 8 grid points, rho, gene), or at p = 1 with several genes per
// (tile of points, rho, tile of up to 16 genes); the golden section and
// the final fit a block per (rho, gene), every thread keeping the same
// bracket.  p = 1 makes its weights in the row loop and solves its 2 x 2
// in registers: against the 2 x 2 tiles' path 0.203 against 0.255 device
// ms at the headline (scripts/profile_wide_fit.py, H100 80GB HBM3, 700 W).
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
// gene: narrow, the grid a block per (tile of grid points, rho, gene),
// the golden section a block per (rho, gene); at p = 1 (an intercept
// alone, the usual gene-batched null fit) the grid a block per (tile of
// points, rho, tile of up to 16 genes), whose pass a point makes each
// row's weight once for the whole tile (16 genes x 11 rho, R = 1000: the
// grid 0.141 against 0.311 device ms a gene a block, the same script and
// card); wide, the
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
constexpr int MAX_F32_GRID = 1024;  // grid points of the float32 context
constexpr double INVPHI = 0.6180339887498949;
constexpr double INVPHI2 = 0.3819660112501051;

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
__device__ Rho rho_of(const double* Sv, const double* Xt, const double* yt,
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
  const Rho o = rho_of(Sv, Xt, yt, Cxx, cxy, cyy, blockIdx.x, blockIdx.x,
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
  Rho o = rho_of(Sv, Xt, yt, Cxx, cxy, cyy, ro, gr, n, R, p, reml);
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
  Rho o = rho_of(Sv, Xt, yt, Cxx, cxy, cyy, ro, gr, n, R, p, reml);
  if (o.reml) o.ld_xx = ldxx[ro];
  const int nsum = npack_of(gm) + 1;                  // the sums, log d
  const int64_t pstride = (int64_t)nsplit * nsum;     // a problem's
  double* part_now = part + ((step & 1) * problems + gr) * pstride;
  const double* st_prev =
      state + (((step + 1) & 1) * problems + gr) * NSTATE;
  double* st_now = state + ((step & 1) * problems + gr) * NSTATE;

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
  Rho o = rho_of(Sv, Xt, yt, Cxx, cxy, cyy, ro, gr, n, R, p, reml);
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

// ---------------------------------------------------------------------------
// narrow instantiation: p <= 16, every evaluation on the whole block
// ---------------------------------------------------------------------------
// Resident rows: a (rho, gene) problem's rows are staged once, in shared
// memory, when they fit in CRM_NF_SMEM_KB; else every evaluation streams
// them in chunks of CRM_NF_CHUNK rows through a two-stage cp.async ring.
#ifndef CRM_NF_SMEM_KB
#define CRM_NF_SMEM_KB 200
#endif
#ifndef CRM_NF_CHUNK
#define CRM_NF_CHUNK 128
#endif
// genes a block of the gene-tiled grid (p = 1), at most
#ifndef CRM_NF_GENE_TILE
#define CRM_NF_GENE_TILE 16
#endif
constexpr int NMAX = 16;                   // p of the narrow kernels
constexpr int NQ = NMAX + 1;               // columns [X | y]
constexpr int NTRI = NQ * (NQ + 1) / 2;    // the bordered matrix's triangle
constexpr int NPART = 256;                 // the tiles' partial sums

// The shapes of one evaluation at p covariates and R rows: the lower
// triangle of the (q x q) sums of [X | y], q = p + 1, in ts x ts tiles (2
// up to p = 4, else 4), a tile's rows split over ng row groups (a power of
// two, tile-major: a warp's lanes are one tile's groups, reduced by xor
// shuffles, or 32 / ng tiles' aligned segments of groups); a staged row
// is [X | y | zeros | S], ldr = qt ts + 1 doubles (odd: consecutive rows
// fall in distinct banks).
struct NarrowGeom {
  int q, ts, qt, ntiles, ng, nsub, ldr;
  bool resident;
};

__host__ __device__ inline NarrowGeom narrow_geom(int p, int R) {
  NarrowGeom g;
  g.q = p + 1;
  g.ts = p <= 4 ? 2 : 4;
  g.qt = (g.q + g.ts - 1) / g.ts;
  g.ntiles = g.qt * (g.qt + 1) / 2;
  g.ng = 1;
  while (2 * g.ng * g.ntiles <= NT) g.ng *= 2;
  g.nsub = g.ng > 32 ? g.ng / 32 : 1;
  g.ldr = g.qt * g.ts + 1;
  g.resident = (int64_t)R * (g.ldr + 1) * 8 <= (int64_t)CRM_NF_SMEM_KB * 1024;
  return g;
}

// doubles of dynamic shared memory: the rows and their weights, resident
// or two chunks and one chunk's weights
__host__ __device__ inline int narrow_smem_doubles(const NarrowGeom& g,
                                                   int R) {
  return g.resident ? R * (g.ldr + 1)
                    : (2 * g.ldr + 1) * CRM_NF_CHUNK;
}

constexpr double LN2 = 0.6931471805599453;

struct NarrowSh {
  double part[NPART];            // the tiles' sums, per warp of groups
  double M[NQ * NQ];             // the bordered matrix (leading dim. q)
  double cxx[NMAX * NMAX], cxy[NMAX], cyy;   // the complements
  double red[NT / 32][2];        // the warps' products of d: mantissa,
                                 // exponent
  double val[3];                 // lml (or logdet), scale, rss
  double spec[2][6];             // the golden section's next point, per
                                 // decision: a, b, x1n, x2n, x, delta
  double beta[NMAX];
  int tri[NTRI];                 // the triangle's (i << 8 | k), by column
};

// rows [r0, r1) of the problem into st ([X | y | zeros | S] a row), by
// cp.async; the caller commits
__device__ void narrow_stage(const Rho& o, const NarrowGeom& g, int r0,
                             int r1, double* st) {
  const int cnt = (r1 - r0) * g.ldr;
  for (int f = threadIdx.x; f < cnt; f += NT) {
    const int r = f / g.ldr, c = f - r * g.ldr, row = r0 + r;
    if (c < o.p)
      cp_async8(st + f, o.X + (int64_t)row * o.p + c);
    else if (c == o.p)
      cp_async8(st + f, o.y + row);
    else if (c == g.ldr - 1)
      cp_async8(st + f, o.S + row);
    else
      st[f] = 0.0;
  }
}

// Once a block: the triangle's entries in column order, the complements
// in shared memory, and the resident rows staged.  Ends in step.
__device__ void narrow_setup(const Rho& o, const NarrowGeom& g, double* dyn,
                             NarrowSh& sh) {
  const int tid = threadIdx.x, p = o.p, q = g.q;
  for (int f = tid; f < q * (q + 1) / 2; f += NT) {
    int k = 0, off = 0;
    while (f >= off + q - k) off += q - k++;
    sh.tri[f] = (k + f - off) << 8 | k;
  }
  for (int f = tid; f < p * p; f += NT) sh.cxx[f] = o.Cxx[f];
  for (int f = tid; f < p; f += NT) sh.cxy[f] = o.cxy[f];
  if (tid == 0) sh.cyy = o.cyy;
  if (g.resident) {
    narrow_stage(o, g, 0, o.R, dyn);
    cp_async_commit();
    cp_async_wait_all();
  }
  __syncthreads();
}

// m * 2^e with m brought back to [1, 2), e growing by its exponent: the
// d_r's running product, whose log is taken once a pass (a log a row, or
// a thread, would sit on the pass's path); a zero, infinite or NaN m
// makes e NaN
__device__ __forceinline__ void renorm(double& m, double& e) {
  const long long bits = __double_as_longlong(m);
  const long long ex = ((bits >> 52) & 0x7ff) - 1023;
  m = __longlong_as_double((bits & 0x800fffffffffffffLL) | (1023LL << 52));
  e += (ex == 1024 || ex == -1023) ? __longlong_as_double(0x7ff8000000000000LL)
                                   : (double)ex;
}

// d into the running product (m, e), renormalized every 8 factors
__device__ __forceinline__ void log_factor(double d, double& m, double& e,
                                           int& n) {
  m *= d;
  if (++n == 8) {
    renorm(m, e);
    n = 0;
  }
}

// The sums of nrows staged rows st with weights wv into the thread's tile
// accumulators (a tile's row group).
template <int TS>
__device__ void narrow_rows(const double* st, const double* wv, int nrows,
                            const NarrowGeom& g, int tile_a, int tile_b,
                            int grp, double (&acc)[TS * TS]) {
  const int ldr = g.ldr;
  const double* xi = st + tile_a * TS;
  const double* xj = st + tile_b * TS;
#pragma unroll 2
  for (int r = grp; r < nrows; r += g.ng) {
    const double w = wv[r];
    double u[TS], v[TS];
#pragma unroll
    for (int e = 0; e < TS; ++e) {
      u[e] = xi[r * ldr + e] * w;
      v[e] = xj[r * ldr + e];
    }
#pragma unroll
    for (int e = 0; e < TS; ++e)
#pragma unroll
      for (int f = 0; f < TS; ++f) acc[e * TS + f] += u[e] * v[f];
  }
}

// p = 1 (one 2 x 2 tile, rows over every thread): the weights made in the
// row loop
__device__ void narrow_rows1(const double* st, int nrows, double delta,
                             bool gram, double (&acc)[4], double& pm,
                             double& pe, int& nprod) {
#pragma unroll 4
  for (int r = threadIdx.x; r < nrows; r += NT) {
    const double x = st[r * 3], y = st[r * 3 + 1], s = st[r * 3 + 2];
    const double d = (1.0 - delta) * s + delta;
    const double w = gram ? 1.0 : rcp_nr(d);
    const double u0 = x * w, u1 = y * w;
    acc[0] += u0 * x;
    acc[1] += u0 * y;
    acc[2] += u1 * x;
    acc[3] += u1 * y;
    log_factor(d, pm, pe, nprod);
  }
}

// the weights w_r = 1 / d_r of nrows staged rows into wv (1 where gram),
// d_r into the running product, rows over every thread
__device__ void narrow_weights(const double* st, int nrows, int ldr,
                               double delta, bool gram, double* wv,
                               double& pm, double& pe, int& nprod) {
#pragma unroll 4
  for (int r = threadIdx.x; r < nrows; r += NT) {
    const double d = (1.0 - delta) * st[r * ldr + ldr - 1] + delta;
    wv[r] = gram ? 1.0 : rcp_nr(d);
    log_factor(d, pm, pe, nprod);
  }
}

// The lml from logdet A's pivots (`pivot`: lane l's own, l < p), the
// residual rss and the warps' products of d, on warp 0; the value on lane
// 0.  Its logs are one call, a lane each and all at once (lanes of one
// warp that called log on different paths would take them one after
// another): lanes 0..p-1 the pivots (REML or gram), lane p log(2 pi
// scale), lane p + 1 log d's mantissa (its exponent added), lane p + 2 log
// delta; then the terms are added in the reference's order
// (models/lmm.py `lml_at_delta_eig`), so that on a flat profile the two
// round alike.  mode 0 (gram): logdet A alone.
__device__ __forceinline__ double narrow_lml(const Rho& o, int p, bool gram,
                                             double pivot, double rs,
                                             double delta,
                                             const NarrowSh& sh) {
  const int lane = threadIdx.x % 32;
  const double nn = o.reml ? o.n - p : o.n;
  double arg = 1.0, add = 0.0;
  if (lane < p)
    arg = pivot > 0 ? pivot : -1.0;   // NaN where not positive, as the
                                      // JAX engine's Cholesky
  else if (lane == p)
    arg = 6.283185307179586 * (rs / nn);
  else if (lane == p + 1) {
    double m = 1.0, e = 0.0;
    for (int w = 0; w < NT / 32; ++w) {
      m *= sh.red[w][0];
      e += sh.red[w][1];
    }
    arg = m;
    add = e * LN2;
  } else if (lane == p + 2) {
    arg = delta;
  }
  const double v = log(arg) + add;
  double la = lane < p ? v : 0.0;
  for (int off = 1; off < p; off <<= 1) la += __shfl_xor_sync(FULL, la, off);
  const double l2pi = __shfl_sync(FULL, v, p);
  const double logd = __shfl_sync(FULL, v, p + 1);
  const double ldel = __shfl_sync(FULL, v, p + 2);
  if (gram) return la;
  const double logdet_d = logd + (o.n - o.R) * ldel;
  return o.reml ? -0.5 * (nn * l2pi + logdet_d + la - o.ld_xx + nn)
                : -0.5 * (nn * l2pi + logdet_d + nn);
}

// p = 1, warp 0: the 2 x 2 bordered matrix [[A + ridge, b], [b, yDy]] from
// tile 0's partial sums and the complements (over delta; as they are
// where gram), solved in registers on every lane.  Lane 0 writes the lml
// (mode 0: logdet A), scale and rss to sh.val, and beta to sh.beta in
// mode 2.
__device__ void narrow_finish1(const Rho& o, const NarrowGeom& g,
                               double delta, double invd, int mode,
                               NarrowSh& sh) {
  const bool gram = mode == 0;
  double A = 0.0, b = 0.0, c = 0.0;
  for (int s = 0; s < g.nsub; ++s) {
    A += sh.part[s * 4];
    b += sh.part[s * 4 + 2];
    c += sh.part[s * 4 + 3];
  }
  A += gram ? sh.cxx[0] : sh.cxx[0] * invd;
  b += gram ? sh.cxy[0] : sh.cxy[0] * invd;
  c += gram ? sh.cyy : sh.cyy * invd;
  // the ridge (sym_pseudo_solve_and_logdet's)
  const double D = A + 1e-12 * fmax(fabs(A), 1.0);
  const double rss_raw = c - b * (1.0 / D) * b;
  const double rs = rss_raw < DBL_MIN ? DBL_MIN : rss_raw;   // keeps NaN
  const double lml = narrow_lml(o, 1, gram, D, rs, delta, sh);
  if (threadIdx.x == 0) {
    sh.val[0] = lml;
    sh.val[1] = rs / (o.reml ? o.n - 1 : o.n);
    sh.val[2] = rs;
    if (mode == 2) sh.beta[0] = b / D;
  }
}

// Warp 0 (p > 1): the bordered matrix [[A + ridge, b], [b^T, yDy]] from
// the tiles' partial sums and the complements (over delta; as they are
// where gram), factored right-looking in shared memory (a __syncwarp a
// column): the first p pivots give logdet A, the last the residual rss =
// yDy - b^T A^{-1} b.  Writes the lml (mode 0: logdet(X^T X + Cxx)),
// scale and rss to sh.val, and beta to sh.beta in mode 2.
template <int TS>
__device__ void narrow_finish(const Rho& o, const NarrowGeom& g,
                              double delta, double invd, int mode,
                              NarrowSh& sh) {
  const int lane = threadIdx.x % 32, p = o.p, q = g.q;
  const int ntri = q * (q + 1) / 2;
  const bool gram = mode == 0;
  double dmax = 0.0;
  for (int f = lane; f < ntri; f += 32) {
    const int c = sh.tri[f], i = c >> 8, k = c & 0xff;
    const int a = i / TS, b = k / TS;
    const double* pt =
        sh.part + ((a * (a + 1) / 2 + b) * g.nsub) * TS * TS +
        (i - a * TS) * TS + (k - b * TS);
    double v = 0.0;
    for (int s = 0; s < g.nsub; ++s) v += pt[s * TS * TS];
    const double c0 = i < p ? sh.cxx[i * p + k] : k < p ? sh.cxy[k] : sh.cyy;
    v += gram ? c0 : c0 * invd;
    sh.M[i * q + k] = v;
    if (i == k && i < p) dmax = fmax(dmax, fabs(v));
  }
  for (int off = 16; off > 0; off >>= 1)
    dmax = fmax(dmax, __shfl_xor_sync(FULL, dmax, off));
  __syncwarp();
  // the ridge (sym_pseudo_solve_and_logdet's) on A's diagonal
  if (lane < p) sh.M[lane * q + lane] += 1e-12 * fmax(dmax, 1.0);
  __syncwarp();
  int off = 0;
  for (int j = 0; j < q - 1; ++j) {
    off += q - j;          // the entries of columns 0..j
    const double rd = 1.0 / sh.M[j * q + j];
    for (int f = off + lane; f < ntri; f += 32) {
      const int c = sh.tri[f], i = c >> 8, k = c & 0xff;
      sh.M[i * q + k] -= sh.M[i * q + j] * rd * sh.M[k * q + j];
    }
    __syncwarp();
  }
  const double rss_raw = sh.M[p * q + p];
  const double rs = rss_raw < DBL_MIN ? DBL_MIN : rss_raw;   // keeps NaN
  const double lml = narrow_lml(
      o, p, gram, lane < p ? sh.M[lane * q + lane] : 0.0, rs, delta, sh);
  if (lane == 0) {
    sh.val[0] = lml;
    sh.val[1] = rs / (o.reml ? o.n - p : o.n);
    sh.val[2] = rs;
    // beta = L^{-T} (D^{-1} L^{-1} b) by a back substitution (L[i][j] =
    // M[i][j] / D_j, L^{-1} b = M[p][:p])
    if (mode == 2) {
      for (int j = p - 1; j >= 0; --j) {
        const double dj = sh.M[j * q + j];
        double v = sh.M[p * q + j] / dj;
        for (int k = j + 1; k < p; ++k) v -= sh.M[k * q + j] / dj * sh.beta[k];
        sh.beta[j] = v;
      }
    }
  }
}

// One evaluation at delta on the whole block: the weights (a thread a few
// rows; the d_r's running product for sum log d_r), the sums of the packed
// triangle in tiles (a thread a tile's row group), one reduction (xor
// shuffles, then the warps' partials in shared memory), the factorization
// on warp 0 (p = 1: in registers).  mode 0: logdet(X^T X + Cxx); 1: the
// lml; 2: the lml, scale, rss and beta (sh.beta).  `side()` runs on the
// last warp's lane 0 while warp 0 factors.  Returns the same value on
// every thread; starts and ends with the block in step.
template <int TS, class Side = void (*)()>
__device__ double narrow_eval(const Rho& o, const NarrowGeom& g,
                              double delta, int mode, double* dyn,
                              NarrowSh& sh, double& scale, double& rss,
                              const Side& side = [] {}) {
  const int tid = threadIdx.x, warp = tid / 32;
  const bool gram = mode == 0;
  const bool fused = g.ntiles == 1;   // p = 1: rows over every thread
  const double invd = 1.0 / delta;    // off the factorization's path
  const int tile = tid / g.ng, grp = tid - tile * g.ng;
  int ta = 0;
  while ((ta + 1) * (ta + 2) / 2 <= tile) ++ta;
  const int tb = tile - ta * (ta + 1) / 2;
  const bool active = tile < g.ntiles;
  double acc[TS * TS];
#pragma unroll
  for (int e = 0; e < TS * TS; ++e) acc[e] = 0.0;
  double pm = 1.0, pe = 0.0;
  int nprod = 0;
  // the rows staged at st
  auto rows = [&](const double* st, double* wv, int nrows) {
    if constexpr (TS == 2) {
      if (fused) {
        narrow_rows1(st, nrows, delta, gram, acc, pm, pe, nprod);
        return;
      }
    }
    narrow_weights(st, nrows, g.ldr, delta, gram, wv, pm, pe, nprod);
    __syncthreads();
    if (active) narrow_rows<TS>(st, wv, nrows, g, ta, tb, grp, acc);
  };
  if (g.resident) {
    rows(dyn, dyn + o.R * g.ldr, o.R);
  } else {
    // chunks through a two-stage cp.async ring
    constexpr int CH = CRM_NF_CHUNK;
    double* buf[2] = {dyn, dyn + CH * g.ldr};
    double* wv = dyn + 2 * CH * g.ldr;
    const int nch = (o.R + CH - 1) / CH;
    narrow_stage(o, g, 0, min(o.R, CH), buf[0]);
    cp_async_commit();
    for (int c = 0; c < nch; ++c) {
      const int r0 = c * CH, r1 = min(o.R, r0 + CH);
      if (c + 1 < nch) narrow_stage(o, g, r1, min(o.R, r1 + CH), buf[~c & 1]);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      rows(buf[c & 1], wv, r1 - r0);
      __syncthreads();
    }
  }
  // the tile's row groups (xor shuffles within their segment of the warp)
  // and the warp's product of d (mantissas in [1, 2): 32 of them stay in
  // range), side by side
  renorm(pm, pe);
  const int seg = g.ng < 32 ? g.ng : 32;
  for (int off = 16; off > 0; off >>= 1) {
    if (off < seg) {
#pragma unroll
      for (int e = 0; e < TS * TS; ++e)
        acc[e] += __shfl_xor_sync(FULL, acc[e], off);
    }
    pm *= __shfl_xor_sync(FULL, pm, off);
    pe += __shfl_xor_sync(FULL, pe, off);
  }
  if (active && (grp & 31) == 0) {
#pragma unroll
    for (int e = 0; e < TS * TS; ++e)
      sh.part[(tile * g.nsub + grp / 32) * TS * TS + e] = acc[e];
  }
  if (tid % 32 == 0) {
    renorm(pm, pe);
    sh.red[warp][0] = pm;
    sh.red[warp][1] = pe;
  }
  __syncthreads();
  if (warp == 0) {
    if (fused)
      narrow_finish1(o, g, delta, invd, mode, sh);
    else
      narrow_finish<TS>(o, g, delta, invd, mode, sh);
  }
  if (tid == 32 * (NT / 32 - 1)) side();   // the last warp's lane 0
  __syncthreads();
  scale = sh.val[1];
  rss = sh.val[2];
  return sh.val[0];
}

// logdet(Xt^T Xt + Cxx) of each rho point (delta-independent; REML), a
// block a rho point
template <int TS>
__global__ void __launch_bounds__(NT)
null_fit_narrow_ldxx_kernel(const double* __restrict__ Sv,
                            const double* __restrict__ Xt,
                            const double* __restrict__ yt,
                            const double* __restrict__ Cxx,
                            const double* __restrict__ cxy,
                            const double* __restrict__ cyy,
                            double* __restrict__ ldxx, int n, int R, int p) {
  extern __shared__ __align__(16) unsigned char nf_nldxx_dyn[];
  __shared__ NarrowSh sh;
  double* dyn = reinterpret_cast<double*>(nf_nldxx_dyn);
  const NarrowGeom g = narrow_geom(p, R);
  // gene 0's phenotype: the Gram pass reads no phenotype sum
  const Rho o = rho_of(Sv, Xt, yt, Cxx, cxy, cyy, blockIdx.x, blockIdx.x, n,
                       R, p, 1);
  narrow_setup(o, g, dyn, sh);
  double scale, rss;
  const double ld = narrow_eval<TS>(o, g, 0.5, 0, dyn, sh, scale, rss);
  if (threadIdx.x == 0) ldxx[blockIdx.x] = ld;
}

// the objective at the grid points of tile blockIdx.x (gpb points a tile)
// of rho point blockIdx.y, gene blockIdx.z, one after another on the
// staged rows (eight points a pass, each factored by a warp of its own,
// measured slower at p = 1: scripts/profile_wide_fit.py).  Its passes are
// latency-bound, so at p <= 4 the registers are held to 64 for four
// blocks an SM (16% off the 16 genes' grid; at p = 12 the spills cost
// more than the blocks gain)
template <int TS>
__global__ void __launch_bounds__(NT, TS == 2 ? 4 : 1)
null_fit_narrow_grid_kernel(const double* __restrict__ Sv,
                            const double* __restrict__ Xt,
                            const double* __restrict__ yt,
                            const double* __restrict__ Cxx,
                            const double* __restrict__ cxy,
                            const double* __restrict__ cyy,
                            const double* __restrict__ ldxx,
                            double* __restrict__ vals, double lo, double hi,
                            int n_grid, int gpb, int n, int R, int p,
                            int reml) {
  extern __shared__ __align__(16) unsigned char nf_ngrid_dyn[];
  __shared__ NarrowSh sh;
  double* dyn = reinterpret_cast<double*>(nf_ngrid_dyn);
  const NarrowGeom g = narrow_geom(p, R);
  const int ro = blockIdx.y;
  const int64_t gr = (int64_t)blockIdx.z * gridDim.y + ro;
  Rho o = rho_of(Sv, Xt, yt, Cxx, cxy, cyy, ro, gr, n, R, p, reml);
  if (o.reml) o.ld_xx = ldxx[ro];
  narrow_setup(o, g, dyn, sh);
  const int k0 = blockIdx.x * gpb, k1 = min(n_grid, k0 + gpb);
  for (int k = k0; k < k1; ++k) {
    double scale, rss;
    const double v = narrow_eval<TS>(
        o, g, sigmoid(logit_at(lo, hi, n_grid, k)), 1, dyn, sh, scale, rss);
    if (threadIdx.x == 0) vals[gr * n_grid + k] = v;
  }
}

// The grid of a tile of genes at p = 1 (the gene-batched association null
// fits, an intercept alone): the grid points of tile blockIdx.x of rho
// point blockIdx.y for genes [blockIdx.z gt, + gt), one pass over the rows
// a point for all of the tile's genes.  The weights, sum log d_r and
// x^T W x depend on delta alone, so a row's weight is made once and feeds
// each gene's two sums (x^T W y_g, y_g^T W y_g); one reduction of the
// tile's 2 gt + 1 sums, then lane g of warp 0 finishes gene g's lml as
// the per-gene path's p = 1 does (the same sums in the same order: the
// same values).  The rows x, S and the tile's phenotypes stay resident.
// The partial sums are double-buffered by the point's parity: one block
// barrier a point.
constexpr int GTMAX = CRM_NF_GENE_TILE;

__global__ void __launch_bounds__(NT)
null_fit_narrow_grid_genes_kernel(const double* __restrict__ Sv,
                                  const double* __restrict__ Xt,
                                  const double* __restrict__ yt,
                                  const double* __restrict__ Cxx,
                                  const double* __restrict__ cxy,
                                  const double* __restrict__ cyy,
                                  const double* __restrict__ ldxx,
                                  double* __restrict__ vals, double lo,
                                  double hi, int n_grid, int gpb, int n,
                                  int R, int gt, int genes, int reml) {
  extern __shared__ __align__(16) unsigned char nf_ngenes_dyn[];
  __shared__ double part[2][NT / 32][2 * GTMAX + 1];
  __shared__ double red[2][NT / 32][2];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int ro = blockIdx.y, nrho = gridDim.y;
  const int g0 = blockIdx.z * gt, ng = min(gt, genes - g0);
  double* sx = reinterpret_cast<double*>(nf_ngenes_dyn);   // x (R)
  double* ss = sx + R;                                      // S (R)
  double* sy = ss + R;                                      // y (ng, R)
  for (int r = tid; r < R; r += NT) {
    cp_async8(sx + r, Xt + (int64_t)ro * R + r);
    cp_async8(ss + r, Sv + (int64_t)ro * R + r);
  }
  for (int f = tid; f < ng * R; f += NT) {
    const int g = f / R, r = f - g * R;
    cp_async8(sy + f, yt + ((int64_t)(g0 + g) * nrho + ro) * R + r);
  }
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  // lane g of warp 0: gene g0 + g's complements
  const int64_t gr = (int64_t)(g0 + min(lane, ng - 1)) * nrho + ro;
  const double cxx0 = Cxx[ro], cxy0 = cxy[gr], cyy0 = cyy[gr];
  const double ld_xx = reml ? ldxx[ro] : 0.0;
  const double nn = reml ? n - 1 : n;

  const int k0 = blockIdx.x * gpb, k1 = min(n_grid, k0 + gpb);
  for (int k = k0; k < k1; ++k) {
    const int buf = k & 1;
    const double delta = sigmoid(logit_at(lo, hi, n_grid, k));
    const double invd = 1.0 / delta;
    double A = 0.0, b[GTMAX], c[GTMAX];
#pragma unroll
    for (int g = 0; g < GTMAX; ++g) b[g] = c[g] = 0.0;
    double pm = 1.0, pe = 0.0;
    int nprod = 0;
    for (int r = tid; r < R; r += NT) {
      const double x = sx[r], d = (1.0 - delta) * ss[r] + delta;
      const double w = rcp_nr(d), u0 = x * w;
      A += u0 * x;
#pragma unroll
      for (int g = 0; g < GTMAX; ++g) {
        if (g < ng) {
          const double y = sy[g * R + r], u1 = y * w;
          b[g] += u1 * x;
          c[g] += u1 * y;
        }
      }
      log_factor(d, pm, pe, nprod);
    }
    renorm(pm, pe);
    for (int off = 16; off > 0; off >>= 1) {
      A += __shfl_xor_sync(FULL, A, off);
#pragma unroll
      for (int g = 0; g < GTMAX; ++g) {
        if (g < ng) {
          b[g] += __shfl_xor_sync(FULL, b[g], off);
          c[g] += __shfl_xor_sync(FULL, c[g], off);
        }
      }
      pm *= __shfl_xor_sync(FULL, pm, off);
      pe += __shfl_xor_sync(FULL, pe, off);
    }
    if (lane == 0) {
      part[buf][warp][0] = A;
#pragma unroll
      for (int g = 0; g < GTMAX; ++g) {
        if (g < ng) {
          part[buf][warp][1 + 2 * g] = b[g];
          part[buf][warp][2 + 2 * g] = c[g];
        }
      }
      renorm(pm, pe);
      red[buf][warp][0] = pm;
      red[buf][warp][1] = pe;
    }
    __syncthreads();
    if (warp == 0 && lane < ng) {
      double Aw = 0.0, bw = 0.0, cw = 0.0, m = 1.0, e = 0.0;
      for (int w = 0; w < NT / 32; ++w) {
        Aw += part[buf][w][0];
        bw += part[buf][w][1 + 2 * lane];
        cw += part[buf][w][2 + 2 * lane];
        m *= red[buf][w][0];
        e += red[buf][w][1];
      }
      Aw += cxx0 * invd;
      bw += cxy0 * invd;
      cw += cyy0 * invd;
      // the ridge (sym_pseudo_solve_and_logdet's), the lml's terms in the
      // reference's order (narrow_lml's)
      const double D = Aw + 1e-12 * fmax(fabs(Aw), 1.0);
      const double rss_raw = cw - bw * (1.0 / D) * bw;
      const double rs = rss_raw < DBL_MIN ? DBL_MIN : rss_raw;
      const double la = log(D > 0 ? D : -1.0);
      const double l2pi = log(6.283185307179586 * (rs / nn));
      const double logd = log(m) + e * LN2;
      const double logdet_d = logd + (n - R) * log(delta);
      vals[((int64_t)(g0 + lane) * nrho + ro) * n_grid + k] =
          reml ? -0.5 * (nn * l2pi + logdet_d + la - ld_xx + nn)
               : -0.5 * (nn * l2pi + logdet_d + nn);
    }
  }
}

// The grid's argmax, the golden section (models/lmm.py `_golden`) and the
// final fit of problem (rho blockIdx.x, gene blockIdx.y), every
// evaluation on the whole block; every thread keeps the same bracket.
template <int TS>
__global__ void __launch_bounds__(NT)
null_fit_narrow_golden_kernel(
    const double* __restrict__ Sv, const double* __restrict__ Xt,
    const double* __restrict__ yt, const double* __restrict__ Cxx,
    const double* __restrict__ cxy, const double* __restrict__ cyy,
    const double* __restrict__ ldxx, const double* __restrict__ vals,
    double* __restrict__ lml_out, double* __restrict__ delta_out,
    double* __restrict__ beta_out, double* __restrict__ scale_out,
    double* __restrict__ v0_out, double* __restrict__ v1_out,
    double* __restrict__ rss_out, double lo, double hi, int n_grid,
    int n_iters, int n, int R, int p, int reml) {
  extern __shared__ __align__(16) unsigned char nf_ngold_dyn[];
  __shared__ NarrowSh sh;
  double* dyn = reinterpret_cast<double*>(nf_ngold_dyn);
  const NarrowGeom g = narrow_geom(p, R);
  const int ro = blockIdx.x;
  const int64_t gr = (int64_t)blockIdx.y * gridDim.x + ro;
  Rho o = rho_of(Sv, Xt, yt, Cxx, cxy, cyy, ro, gr, n, R, p, reml);
  if (o.reml) o.ld_xx = ldxx[ro];
  narrow_setup(o, g, dyn, sh);

  // argmax (a NaN wins and stops the scan, as torch's and jnp's argmax)
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
  double a = logit_at(lo, hi, n_grid, max(kb - 1, 0));
  double b = logit_at(lo, hi, n_grid, min(kb + 1, n_grid - 1));

  // step 0 evaluates x1, step 1 x2, steps 2 .. n_iters + 1 the
  // iterations' new points, step n_iters + 2 is the final fit: one call
  // site of the evaluation.  While warp 0 factors a step's sums, the last
  // warp makes the next step's point under either decision (with its
  // delta, 1 / delta and log delta), so that the decision only selects.
  const double h = b - a;
  double x1 = a + INVPHI2 * h, x2 = a + INVPHI * h;
  double f1 = 0.0, f2 = 0.0, x1n = 0.0, x2n = 0.0;
  double scale, rss, lml, delta;
  double dl = sigmoid(x1);
  bool left = false;
  for (int step = 0;; ++step) {
    const bool last = step == n_iters + 2;
    // the point after this step's: spec[1] if the decision is "left"
    // (f1 > f2), else spec[0]
    auto next = [&] {
      auto put = [&](int k, double na, double nb, double n1, double n2,
                     double nx) {
        const double v[6] = {na, nb, n1, n2, nx, sigmoid(nx)};
        for (int e = 0; e < 6; ++e) sh.spec[k][e] = v[e];
      };
      if (last) return;
      if (step == 0) {
        put(0, a, b, x1n, x2n, x2);
        put(1, a, b, x1n, x2n, x2);
        return;
      }
      // the bracket's points once this step's value is in
      const double y1 = step == 1 ? x1 : x1n, y2 = step == 1 ? x2 : x2n;
      if (step - 1 < n_iters) {
        for (int k = 0; k < 2; ++k) {
          const bool l = k == 1;
          const double na = l ? a : y1, nb = l ? y2 : b, hh = nb - na;
          const double n1 = l ? na + INVPHI2 * hh : y2;
          const double n2 = l ? y1 : na + INVPHI * hh;
          put(k, na, nb, n1, n2, l ? n1 : n2);
        }
      } else {   // the final fit's point
        put(0, a, b, x1n, x2n, y2);
        put(1, a, b, x1n, x2n, y1);
      }
    };
    const double f = narrow_eval<TS>(o, g, dl, last ? 2 : 1, dyn, sh,
                                     scale, rss, next);
    if (last) {
      lml = f;
      delta = dl;
      break;
    }
    if (step == 0) {
      f1 = f;
    } else if (step == 1) {
      f2 = f;
    } else {   // the pending iteration's new point was evaluated
      const double f1n = left ? f : f2;
      f2 = left ? f1 : f;
      f1 = f1n;
      x1 = x1n;
      x2 = x2n;
    }
    const int k = step == 0 ? 0 : f1 > f2;
    const double* sp = sh.spec[k];
    if (step > 0 && step - 1 < n_iters) {
      left = k == 1;
      a = sp[0];
      b = sp[1];
      x1n = sp[2];
      x2n = sp[3];
    }
    dl = sp[5];
  }

  for (int i = threadIdx.x; i < p; i += NT) beta_out[gr * p + i] = sh.beta[i];
  if (threadIdx.x == 0) {
    lml_out[gr] = lml;
    delta_out[gr] = delta;
    scale_out[gr] = scale;
    v0_out[gr] = scale * (1 - delta);
    v1_out[gr] = scale * delta;
    rss_out[gr] = rss;
  }
}

// grid points a block of the narrow grid kernel: at least 8 (a block's
// staging shared by several evaluations), and no more than ~1056 blocks
// (8 an SM) over the problems' grid points
inline int narrow_gpb(int64_t problems, int n_grid) {
  const int64_t gpb = std::max<int64_t>(8, (problems * n_grid + 1055) / 1056);
  return (int)std::min<int64_t>(n_grid, gpb);
}

// genes a block of the gene-tiled grid at p = 1: the genes in as few tiles
// of at most CRM_NF_GENE_TILE as they take, evened out, where the rows x,
// S and a tile's phenotypes fit in CRM_NF_SMEM_KB; 0 (a gene a block)
// elsewhere
inline int narrow_gene_tile(int p, int R, int genes) {
  if (p != 1 || genes < 2) return 0;
  const int64_t room = (int64_t)CRM_NF_SMEM_KB * 1024 / (8 * (int64_t)R) - 2;
  const int64_t most = std::min<int64_t>(GTMAX, room);
  if (most < 2) return 0;
  const int64_t tiles = (genes + most - 1) / most;
  return (int)((genes + tiles - 1) / tiles);
}

// scratch doubles of a narrow fit: the logdets (nrho), the grid's values
// (genes nrho n_grid)
inline int64_t narrow_scratch(int nrho, int n_grid, int genes) {
  return nrho + (int64_t)genes * nrho * n_grid;
}

// the launches of a narrow fit, at TS-wide tiles: logdet(X^T X) (REML),
// the grid, the golden section with the final fit
template <int TS>
int launch_narrow(const double* Sv, const double* Xt, const double* yt,
                  const double* Cxx, const double* cxy, const double* cyy,
                  double* lml, double* delta, double* beta, double* scale,
                  double* v0, double* v1, double* rss, double* scratch,
                  double lo, double hi, int n_grid, int n_iters, int n,
                  int nrho, int R, int p, int reml, int genes,
                  cudaStream_t stream) {
  auto ldxx_kernel = null_fit_narrow_ldxx_kernel<TS>;
  auto grid_kernel = null_fit_narrow_grid_kernel<TS>;
  auto golden_kernel = null_fit_narrow_golden_kernel<TS>;
  auto genes_kernel = null_fit_narrow_grid_genes_kernel;
  // the shared-memory limit, raised once a process
  static const int err_set =
      (int)cudaFuncSetAttribute(ldxx_kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                CRM_NF_SMEM_KB * 1024) |
      (int)cudaFuncSetAttribute(grid_kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                CRM_NF_SMEM_KB * 1024) |
      (int)cudaFuncSetAttribute(genes_kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                CRM_NF_SMEM_KB * 1024) |
      (int)cudaFuncSetAttribute(golden_kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                CRM_NF_SMEM_KB * 1024);
  if (err_set) return err_set;
  const NarrowGeom g = narrow_geom(p, R);
  const int bytes = (int)sizeof(double) * narrow_smem_doubles(g, R);
  double* ldxx = scratch;            // (nrho,)
  double* vals = ldxx + nrho;        // (genes, nrho, n_grid)
  int err;
  if (reml) {
    const dim3 rhos(nrho);
    ldxx_kernel<<<rhos, NT, bytes, stream>>>(Sv, Xt, yt, Cxx, cxy, cyy, ldxx,
                                            n, R, p);
    if ((err = (int)cudaGetLastError())) return err;
  }
  const int gt = narrow_gene_tile(p, R, genes);
  if (gt) {
    const int tiles = (genes + gt - 1) / gt;
    const int gpb = narrow_gpb((int64_t)tiles * nrho, n_grid);
    const dim3 grid((n_grid + gpb - 1) / gpb, nrho, tiles);
    const int gbytes = (int)sizeof(double) * (2 + gt) * R;
    genes_kernel<<<grid, NT, gbytes, stream>>>(Sv, Xt, yt, Cxx, cxy, cyy,
                                               ldxx, vals, lo, hi, n_grid,
                                               gpb, n, R, gt, genes, reml);
  } else {
    const int gpb = narrow_gpb((int64_t)genes * nrho, n_grid);
    const dim3 grid((n_grid + gpb - 1) / gpb, nrho, genes);
    grid_kernel<<<grid, NT, bytes, stream>>>(Sv, Xt, yt, Cxx, cxy, cyy, ldxx,
                                             vals, lo, hi, n_grid, gpb, n, R,
                                             p, reml);
  }
  if ((err = (int)cudaGetLastError())) return err;
  const dim3 fits(nrho, genes);
  golden_kernel<<<fits, NT, bytes, stream>>>(Sv, Xt, yt, Cxx, cxy, cyy, ldxx,
                                             vals, lml, delta, beta, scale,
                                             v0, v1, rss, lo, hi, n_grid,
                                             n_iters, n, R, p, reml);
  return (int)cudaGetLastError();
}


// ---------------------------------------------------------------------------
// The float32 context: `fit_delta_eig` in f32 arithmetic (the association's
// null fits on an f32 context, engine.py:865-873 and its gene axis
// :1154-1174, every tensor f32): the grid's logits torch.linspace's f32
// values, the sigmoid, the sums, the factorization and the lml in f32, the
// golden section's state in f32, the rss floored at tiny(f32).  ML only
// (the association is the float32 context's only caller of K10: the
// aggregate environment's REML fit refuses it), p + 1 <= 16.
//
// A failed f32 factorization (the ridge is below f32's resolution, and
// cancellation in the complement Gram Cxx can leave A indefinite at small
// delta) is a NaN lml, as in the reference, but a NaN grid point never
// wins the grid's argmax: the reference's argmax takes it and that rho's
// fit is NaN.
//
// The narrow design on f32 rows, in two launches:
// * the grid (null_fit_f32_grid_kernel): a block per (tile of gpb grid
//   points, rho, tile of genes: up to CRM_NF_GENE_TILE at p = 1, one
//   above), its rows (S, X and the tile's phenotypes) staged in shared
//   memory once (resident where they fit CRM_NF_SMEM_KB, else read where
//   they lie), a warp a point: the lanes over the rows, the sums in
//   registers, an xor-shuffle tree, then the point's fit on the lanes; at
//   p = 1 a row's weight and d are made once for the tile's genes (x^T W
//   x and sum log d depend on delta alone) and lane g finishes gene g, so
//   a gene's values are the same in any tile.  The values go to the
//   scratch, so that 11 rho x 256 points fill the card;
// * the argmax, the golden section and the final fit
//   (null_fit_f32_golden_kernel): a block per (rho, gene) of NF32_GT
//   threads, its rows staged the same way; every evaluation runs over all
//   of them, the threads over the rows, an xor-shuffle tree, and across
//   the warps one barrier (their partial sums double-buffered by the
//   evaluation's parity, every thread adding them in warp order); every
//   thread factors the same sums in the same order, so every thread keeps
//   the same bracket and no decision is broadcast.  One warp a problem,
//   the shuffles alone, is slower: the golden section 0.355 against 0.111
//   device ms at the Ls scanner's 11 rho (64 threads 0.206, 128 0.136, 512
//   0.118; scripts/profile_null_fit_f32.py, H100 80GB HBM3, 700 W), as a
//   lane then takes 32 of the 1000 rows.
// sum log d_r is a running product of the d_r with its exponent carried
// apart (frexpf every LOG32_GROUP rows) and one log a thread, the weights
// the correctly rounded reciprocal (__frcp_rn, 1 / d's value).
// ---------------------------------------------------------------------------
constexpr int NF32_GT = 256;  // threads of a golden-section block
constexpr int LOG32_GROUP = 4;  // d's multiplied between renormalizations
constexpr float F32_INVPHI = 0.6180339887498949f;
constexpr float F32_INVPHI2 = 0.3819660112501051f;

template <int Q>
struct F32Geom {
  static constexpr int TRI = Q * (Q + 1) / 2;  // packed lower triangle
  static constexpr int NE = TRI + 1;           // and sum log d
};

__device__ __forceinline__ int f32_tri(int i, int j) {
  return i * (i + 1) / 2 + j;
}

// One problem's f32 operands at its rho point.
struct F32Rho {
  const float *S, *X, *y;  // (R,), (R, p), (R,)
  const float *Cxx, *cxy;  // (p, p), (p,)
  float cyy;
  int R, p;
};

__device__ __forceinline__ float f32_sigmoid(float x) {
  return 1.0f / (1.0f + exp(-x));
}

// torch.linspace's f32 value k of K points on [lo, hi]
__device__ __forceinline__ float f32_logit_at(float lo, float hi, int K,
                                              int k) {
  if (K == 1) return lo;
  const float step = (hi - lo) / (float)(K - 1);
  return k < K / 2 ? lo + step * (float)k : hi - step * (float)(K - 1 - k);
}

// The ML fit at delta from the full sums `tot`: the complements added,
// the ridge Cholesky of A (`sym_pseudo_solve_and_logdet`'s, rcond 1e-12),
// beta, rss = max(yDy - b.beta, tiny) and the lml (models/lmm.py:52-76,
// 115-133 in f32)
template <int Q>
__device__ float f32_finish(const F32Rho& pr, float delta, const float* tot,
                            int n, float (&beta)[Q], float& rss) {
  const int p = pr.p;
  float L[Q][Q], b[Q];
#pragma unroll
  for (int i = 0; i < Q; ++i) {
    if (i >= p) continue;
#pragma unroll
    for (int j = 0; j <= i; ++j)
      L[i][j] = tot[f32_tri(i, j)] + pr.Cxx[i * p + j] / delta;
    b[i] = tot[f32_tri(p, i)] + pr.cxy[i] / delta;
  }
  const float yDy = tot[f32_tri(p, p)] + pr.cyy / delta;
  float dmax = 0.0f;
#pragma unroll
  for (int i = 0; i < Q; ++i)
    if (i < p) dmax = fmax(dmax, fabs(L[i][i]));
  const float ridge = 1e-12f * fmax(dmax, 1.0f);
#pragma unroll
  for (int j = 0; j < Q; ++j) {
    if (j >= p) continue;
    float dj = L[j][j] + ridge;
#pragma unroll
    for (int k = 0; k < j; ++k) dj -= L[j][k] * L[j][k];
    dj = sqrt(dj);
    L[j][j] = dj;
#pragma unroll
    for (int i = j + 1; i < Q; ++i) {
      if (i >= p) continue;
      float v = L[i][j];
#pragma unroll
      for (int k = 0; k < j; ++k) v -= L[i][k] * L[j][k];
      L[i][j] = v / dj;
    }
  }
#pragma unroll
  for (int i = 0; i < Q; ++i) {
    if (i >= p) continue;
    float v = b[i];
#pragma unroll
    for (int k = 0; k < i; ++k) v -= L[i][k] * beta[k];
    beta[i] = v / L[i][i];
  }
#pragma unroll
  for (int i = Q - 1; i >= 0; --i) {
    if (i >= p) continue;
    float v = beta[i];
#pragma unroll
    for (int k = i + 1; k < Q; ++k)
      if (k < p) v -= L[k][i] * beta[k];
    beta[i] = v / L[i][i];
  }
  float bb = 0.0f;
#pragma unroll
  for (int i = 0; i < Q; ++i)
    if (i < p) bb += b[i] * beta[i];
  const float raw = yDy - bb;
  rss = raw < FLT_MIN ? FLT_MIN : raw;  // keeps a NaN
  const float logdet_d =
      tot[F32Geom<Q>::NE - 1] + (float)(n - pr.R) * log(delta);
  const float scale = rss / (float)n;
  return -0.5f * ((float)n * log(6.283185307179586f * scale) + logdet_d +
                  (float)n);
}

// The rows' d multiplied into m 2^e, m's exponent moved into e every
// LOG32_GROUP factors (d >= sigmoid(-18) and an eigenvalue: four stay in
// f32's range); a zero, infinite or NaN d stays in m, as its log in the
// reference's sum
struct LogProd32 {
  float m = 1.0f;
  int e = 0, k = 0;
  __device__ void add(float d) {
    m *= d;
    if (++k == LOG32_GROUP) {
      int x;
      m = frexpf(m, &x);
      e += x;
      k = 0;
    }
  }
  __device__ float log_sum() const {
    return log(m) + (float)e * 0.6931471805599453f;
  }
};

// The sums of rows r0, r0 + stride, ... < R at delta: the packed lower
// triangle of [X | y]^T diag(w) [X | y] (column p is y) and sum log d_r
template <int Q>
__device__ void f32_rows(const F32Rho& pr, float delta, int r0, int stride,
                         float (&acc)[F32Geom<Q>::NE]) {
  constexpr int NE = F32Geom<Q>::NE;
  const int p = pr.p, q = p + 1;
#pragma unroll
  for (int e = 0; e < NE; ++e) acc[e] = 0.0f;
  LogProd32 lp;
  for (int r = r0; r < pr.R; r += stride) {
    const float d = (1.0f - delta) * pr.S[r] + delta;
    const float w = __frcp_rn(d);
    float x[Q];
#pragma unroll
    for (int j = 0; j < Q; ++j)
      x[j] = j < p ? pr.X[(int64_t)r * p + j] : (j == p ? pr.y[r] : 0.0f);
#pragma unroll
    for (int i = 0; i < Q; ++i) {
      if (i >= q) continue;
      const float xw = x[i] * w;
#pragma unroll
      for (int j = 0; j <= i; ++j) acc[f32_tri(i, j)] += xw * x[j];
    }
    lp.add(d);
  }
  acc[NE - 1] = lp.log_sum();
}

template <int Q>
__device__ __forceinline__ void f32_warp_tree(float (&acc)[F32Geom<Q>::NE]) {
#pragma unroll
  for (int e = 0; e < F32Geom<Q>::NE; ++e)
    for (int off = 16; off > 0; off >>= 1)
      acc[e] += __shfl_xor_sync(FULL, acc[e], off);
}

// a problem tile's rows in shared memory: [S | X (R p) | y (ng R)],
// resident where they fit; returns the tile's pointers (the tensors'
// where the rows are not staged) and the phenotypes' stride
struct F32Tile {
  const float *S, *X, *y;
  int64_t ystride;
};

__device__ F32Tile f32_stage(float* sm, bool resident, const float* S,
                             const float* X, const float* y, int64_t ystride,
                             int R, int p, int ng) {
  if (!resident) return F32Tile{S, X, y, ystride};
  const int nt = blockDim.x, tid = threadIdx.x;
  for (int f = tid; f < R; f += nt) cp_async4(sm + f, S + f);
  for (int f = tid; f < R * p; f += nt) cp_async4(sm + R + f, X + f);
  for (int f = tid; f < ng * R; f += nt) {
    const int c = f / R, r = f - c * R;
    cp_async4(sm + R + R * p + f, y + c * ystride + r);
  }
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  return F32Tile{sm, sm + R, sm + R + R * p, R};
}

__host__ __device__ inline bool f32_resident(int R, int p, int ng) {
  return (int64_t)sizeof(float) * R * (1 + p + ng) <=
         (int64_t)CRM_NF_SMEM_KB * 1024;
}

// The objective at the grid points of tile blockIdx.x (gpb points a tile)
// of rho point blockIdx.y for genes [blockIdx.z gt, + gt), a warp a point,
// into vals (genes, nrho, n_grid)
template <int Q>
__global__ void __launch_bounds__(NT)
null_fit_f32_grid_kernel(const float* __restrict__ Sv,
                         const float* __restrict__ Xt,
                         const float* __restrict__ yt,
                         const float* __restrict__ Cxx,
                         const float* __restrict__ cxy,
                         const float* __restrict__ cyy,
                         float* __restrict__ vals, float lo, float hi,
                         int n_grid, int gpb, int n, int nrho, int R, int p,
                         int gt, int genes) {
  extern __shared__ __align__(16) unsigned char nf32_grid_dyn[];
  constexpr int NE = F32Geom<Q>::NE;
  const int o = blockIdx.y, g0 = blockIdx.z * gt, ng = min(gt, genes - g0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const F32Tile tl = f32_stage(
      reinterpret_cast<float*>(nf32_grid_dyn), f32_resident(R, p, gt),
      Sv + (int64_t)o * R, Xt + (int64_t)o * R * p,
      yt + ((int64_t)g0 * nrho + o) * R, (int64_t)nrho * R, R, p, ng);
  // gene g0 + c's operands at its rho point
  auto rho_pr = [&](int c) {
    const int64_t go = (int64_t)(g0 + c) * nrho + o;
    F32Rho pr;
    pr.S = tl.S;
    pr.X = tl.X;
    pr.y = tl.y + c * tl.ystride;
    pr.Cxx = Cxx + (int64_t)o * p * p;
    pr.cxy = cxy + go * p;
    pr.cyy = cyy[go];
    pr.R = R;
    pr.p = p;
    return pr;
  };
  const int k0 = blockIdx.x * gpb, k1 = min(n_grid, k0 + gpb);
  for (int k = k0 + warp; k < k1; k += NT / 32) {
    const float dk = f32_sigmoid(f32_logit_at(lo, hi, n_grid, k));
    float bt[Q], rss;
    if constexpr (Q == 2) {
      // p = 1: x^T W x and sum log d once, each gene's x^T W y and y^T W
      // y, in the order of f32_rows' sums
      float A = 0.0f, b[GTMAX], c[GTMAX];
#pragma unroll
      for (int g = 0; g < GTMAX; ++g) b[g] = c[g] = 0.0f;
      LogProd32 lp;
      for (int r = lane; r < R; r += 32) {
        const float d = (1.0f - dk) * tl.S[r] + dk;
        const float w = __frcp_rn(d), x = tl.X[r], xw = x * w;
        A += xw * x;
#pragma unroll
        for (int g = 0; g < GTMAX; ++g) {
          if (g < ng) {
            const float y = tl.y[g * tl.ystride + r], yw = y * w;
            b[g] += yw * x;
            c[g] += yw * y;
          }
        }
        lp.add(d);
      }
      float ld = lp.log_sum();
      for (int off = 16; off > 0; off >>= 1) {
        A += __shfl_xor_sync(FULL, A, off);
        ld += __shfl_xor_sync(FULL, ld, off);
#pragma unroll
        for (int g = 0; g < GTMAX; ++g) {
          if (g < ng) {
            b[g] += __shfl_xor_sync(FULL, b[g], off);
            c[g] += __shfl_xor_sync(FULL, c[g], off);
          }
        }
      }
      float tot[NE] = {A, 0.0f, 0.0f, ld};
#pragma unroll
      for (int g = 0; g < GTMAX; ++g) {
        if (g == lane) {
          tot[1] = b[g];
          tot[2] = c[g];
        }
      }
      if (lane < ng) {
        const float v = f32_finish<Q>(rho_pr(lane), dk, tot, n, bt, rss);
        vals[((int64_t)(g0 + lane) * nrho + o) * n_grid + k] = v;
      }
    } else {
      const F32Rho pr = rho_pr(0);
      float acc[NE];
      f32_rows<Q>(pr, dk, lane, 32, acc);
      f32_warp_tree<Q>(acc);
      if (lane == 0)
        vals[((int64_t)g0 * nrho + o) * n_grid + k] =
            f32_finish<Q>(pr, dk, acc, n, bt, rss);
    }
  }
}

// The grid's argmax, the golden section and the final fit of problem (rho
// blockIdx.x, gene blockIdx.y)
template <int Q>
__global__ void __launch_bounds__(NF32_GT)
null_fit_f32_golden_kernel(const float* __restrict__ Sv,
                           const float* __restrict__ Xt,
                           const float* __restrict__ yt,
                           const float* __restrict__ Cxx,
                           const float* __restrict__ cxy,
                           const float* __restrict__ cyy,
                           const float* __restrict__ vals,
                           float* __restrict__ lml,
                           float* __restrict__ delta_out,
                           float* __restrict__ beta,
                           float* __restrict__ scale, float* __restrict__ v0,
                           float* __restrict__ v1, float* __restrict__ rss_out,
                           float lo, float hi, int n_grid, int n_iters, int n,
                           int nrho, int R, int p) {
  extern __shared__ __align__(16) unsigned char nf32_gold_dyn[];
  constexpr int NE = F32Geom<Q>::NE, NW = NF32_GT / 32;
  __shared__ float part[2][NW][NE];  // the warps' sums, by parity
  const int o = blockIdx.x, g = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t go = (int64_t)g * nrho + o;
  const F32Tile tl = f32_stage(
      reinterpret_cast<float*>(nf32_gold_dyn), f32_resident(R, p, 1),
      Sv + (int64_t)o * R, Xt + (int64_t)o * R * p, yt + go * R, 0, R, p, 1);
  F32Rho pr;
  pr.S = tl.S;
  pr.X = tl.X;
  pr.y = tl.y;
  pr.Cxx = Cxx + (int64_t)o * p * p;
  pr.cxy = cxy + go * p;
  pr.cyy = cyy[go];
  pr.R = R;
  pr.p = p;

  // the first maximum, a NaN (a failed factorization) never winning: on
  // every warp, the lanes over the points
  const float* vr = vals + go * n_grid;
  float best = -INFINITY;
  int kb = n_grid;
  for (int k = lane; k < n_grid; k += 32) {
    const float v = vr[k];
    if (v > best) {
      best = v;
      kb = k;
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    const float ob = __shfl_xor_sync(FULL, best, off);
    const int ok = __shfl_xor_sync(FULL, kb, off);
    if (ob > best || (ob == best && ok < kb)) {
      best = ob;
      kb = ok;
    }
  }
  if (kb == n_grid) kb = 0;  // no point above -inf: the first

  // the sums of one evaluation over every row, the same on every thread
  int parity = 0;
  auto sums = [&](float d, float (&tot)[NE]) {
    f32_rows<Q>(pr, d, threadIdx.x, NF32_GT, tot);
    f32_warp_tree<Q>(tot);
    const int buf = parity;
    parity ^= 1;
    if (lane == 0)
#pragma unroll
      for (int e = 0; e < NE; ++e) part[buf][warp][e] = tot[e];
    __syncthreads();
#pragma unroll
    for (int e = 0; e < NE; ++e) {
      float v = 0.0f;
      for (int w = 0; w < NW; ++w) v += part[buf][w][e];
      tot[e] = v;
    }
  };
  auto evaluate = [&](float d) {
    float tot[NE], bt[Q], rss;
    sums(d, tot);
    return f32_finish<Q>(pr, d, tot, n, bt, rss);
  };

  // the golden section (models/lmm.py `_golden` in f32)
  float a = f32_logit_at(lo, hi, n_grid, kb > 0 ? kb - 1 : 0);
  float b = f32_logit_at(lo, hi, n_grid, kb + 1 < n_grid ? kb + 1 : kb);
  float h = b - a;
  float x1 = a + F32_INVPHI2 * h, x2 = a + F32_INVPHI * h;
  float f1 = evaluate(f32_sigmoid(x1)), f2 = evaluate(f32_sigmoid(x2));
  for (int it = 0; it < n_iters; ++it) {
    const bool left = f1 > f2;
    if (left) b = x2;
    else a = x1;
    h = b - a;
    const float x1n = left ? a + F32_INVPHI2 * h : x2;
    const float x2n = left ? x1 : a + F32_INVPHI * h;
    const float fe = evaluate(f32_sigmoid(left ? x1n : x2n));
    const float f1n = left ? fe : f2;
    const float f2n = left ? f1 : fe;
    x1 = x1n;
    x2 = x2n;
    f1 = f1n;
    f2 = f2n;
  }
  const float dbest = f32_sigmoid(f1 > f2 ? x1 : x2);
  float tot[NE], bt[Q], rss;
  sums(dbest, tot);
  const float lbest = f32_finish<Q>(pr, dbest, tot, n, bt, rss);
  if (threadIdx.x == 0) {
    const float sc = rss / (float)n;
    lml[go] = lbest;
    delta_out[go] = dbest;
    scale[go] = sc;
    v0[go] = sc * (1.0f - dbest);
    v1[go] = sc * dbest;
    rss_out[go] = rss;
    for (int j = 0; j < p; ++j) beta[go * p + j] = bt[j];
  }
}

// genes a block of the f32 grid: at p = 1 the genes in as few tiles of at
// most CRM_NF_GENE_TILE as they take, evened out; one above
inline int f32_gene_tile(int p, int genes) {
  if (p != 1) return 1;
  const int tiles = (genes + GTMAX - 1) / GTMAX;
  return (genes + tiles - 1) / tiles;
}

// the launches of an f32 fit at Q = p + 1 rounded up: the grid, then the
// golden section with the final fit
template <int Q>
int launch_f32(const float* Sv, const float* Xt, const float* yt,
               const float* Cxx, const float* cxy, const float* cyy,
               float* lml, float* delta, float* beta, float* scale, float* v0,
               float* v1, float* rss, float* vals, float lo, float hi,
               int n_grid, int n_iters, int n, int nrho, int R, int p,
               int genes, cudaStream_t stream) {
  auto grid_kernel = null_fit_f32_grid_kernel<Q>;
  auto golden_kernel = null_fit_f32_golden_kernel<Q>;
  static const int err_set =
      (int)cudaFuncSetAttribute(grid_kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                CRM_NF_SMEM_KB * 1024) |
      (int)cudaFuncSetAttribute(golden_kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                CRM_NF_SMEM_KB * 1024);
  if (err_set) return err_set;
  const int gt = f32_gene_tile(p, genes), tiles = (genes + gt - 1) / gt;
  // grid points a block: at least a warp's each, and about four blocks an
  // SM over the call's points
  const int64_t points = (int64_t)tiles * nrho * n_grid;
  const int gpb = (int)std::min<int64_t>(
      n_grid, std::max<int64_t>(NT / 32, (points + 527) / 528));
  const dim3 grid((n_grid + gpb - 1) / gpb, nrho, tiles);
  const int gbytes = f32_resident(R, p, gt)
                         ? (int)sizeof(float) * R * (1 + p + gt) : 0;
  grid_kernel<<<grid, NT, gbytes, stream>>>(Sv, Xt, yt, Cxx, cxy, cyy, vals,
                                            lo, hi, n_grid, gpb, n, nrho, R,
                                            p, gt, genes);
  int err = (int)cudaGetLastError();
  if (err) return err;
  const dim3 fits(nrho, genes);
  const int bytes = f32_resident(R, p, 1)
                        ? (int)sizeof(float) * R * (2 + p) : 0;
  golden_kernel<<<fits, NF32_GT, bytes, stream>>>(
      Sv, Xt, yt, Cxx, cxy, cyy, vals, lml, delta, beta, scale, v0, v1, rss,
      lo, hi, n_grid, n_iters, n, nrho, R, p);
  return (int)cudaGetLastError();
}

}  // namespace

// The scratch doubles crm_null_fit needs at these shapes.
extern "C" long long crm_null_fit_scratch(int p, int nrho, int R, int n_grid,
                                          int genes) {
  return p > 16 ? wide_scratch(p, nrho, R, n_grid, genes)
                : narrow_scratch(nrho, n_grid, genes);
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
  auto launch = p <= 4 ? launch_narrow<2> : launch_narrow<4>;
  return launch(Sv, Xt, yt, Cxx, cxy, cyy, lml, delta, beta, scale, v0, v1,
                rss, scratch, lo, hi, n_grid, n_iters, n, nrho, R, p, reml,
                genes, stream);
}

// The float32 context: the operands of crm_null_fit in f32 -> the fits
// in f32; ML only, 1 <= p + 1 <= 16, n_grid <= 1024, genes <= 65535;
// scratch: genes nrho n_grid floats (the grid's values).  Two launches on
// `stream`; returns cudaGetLastError() after each.
extern "C" int crm_null_fit_f32(const float* Sv, const float* Xt,
                                const float* yt, const float* Cxx,
                                const float* cxy, const float* cyy,
                                float* lml, float* delta, float* beta,
                                float* scale, float* v0, float* v1,
                                float* rss, float* scratch, double lo,
                                double hi, int n_grid, int n_iters, int n,
                                int nrho, int R, int p, int genes,
                                cudaStream_t stream) {
  if (p < 1 || p + 1 > 16 || n_grid < 1 || n_grid > MAX_F32_GRID)
    return (int)cudaErrorInvalidValue;
  auto launch = p + 1 <= 2   ? launch_f32<2>
                : p + 1 <= 4 ? launch_f32<4>
                : p + 1 <= 8 ? launch_f32<8>
                             : launch_f32<16>;
  return launch(Sv, Xt, yt, Cxx, cxy, cyy, lml, delta, beta, scale, v0, v1,
                rss, scratch, (float)lo, (float)hi, n_grid, n_iters, n, nrho,
                R, p, genes, stream);
}
