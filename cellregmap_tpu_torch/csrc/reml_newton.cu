// K3 (and the Newton half of K7): safeguarded Newton on the analytic
// derivative of the profiled lml, f64, for sm_90a.
//
// A problem is one (variant s, rho point o): eigenvalues S_or, rotated
// covariates W_or, genotype g_ors and phenotype y_or (r < R), plus the
// complement Grams.  At delta, with d_r = (1 - delta) S_r + delta, the three
// weight families w1 = 1/d, we2 = e w1^2, we3 = e2 w1^3 (e = 1 - S,
// e2 = e^2) with complement weights 1/delta, 1/delta^2, 1/delta^3 give the
// normal equations (A_f, b_f, q_f) of X = [W, g]; from them (component
// form of cellregmap_tpu/engine.py `_derivs`, :538-601)
//
//   beta = A1^{-1} b1, rss = q1 - b1.beta, beta' = A1^{-1} (A2 beta - b2),
//   rss'  = -q2 + 2 b2.beta - beta.A2 beta,
//   rss'' = 2 q3 - 4 b3.beta + 2 b2.beta' - 2 beta.A2 beta'
//           + 2 beta.A3 beta,
//   REML: L' = -(nu u + ld' - tr(A1^{-1} A2)) / 2,
//         L'' = -(nu (rss''/rss - u^2) + ld'' + 2 tr(A1^{-1} A3)
//                 - tr((A1^{-1} A2)^2)) / 2,    u = rss'/rss, nu = n - p - 1
//   ML:   L' = -(n u + ld') / 2, L'' = -(n (rss''/rss - u^2) + ld'') / 2
//         (no logdet(A) terms, :1026-1028),
//
// with ld' = sum e w1 + (n - R)/delta, ld'' = -sum e2 w1^2 - (n - R)/delta^2,
// and one safeguarded Newton step on logit(delta) inside the bracket
// (:608-626, inclusive bounds).  Two entry points:
//
//   crm_reml_localize (stages 1b + 2, :628-670): one block per variant, one
//     warp per rho point.  `steps` steps from the bracket midpoint on the
//     tensors rounded to f32 when round32 (f64 arithmetic on f32-rounded
//     tensors: the reference's type promotion), then one f64 REML lml at
//     the localized delta on the unrounded tensors (rss <= 128 eps q there
//     cannot win, :655), and the argmax over rho inside the block.
//   crm_reml_converge (stage 3, :672-734; association refit, :991-1062):
//     one warp per variant at its rho k_best (0 when null), `steps` steps
//     on the unrounded tensors from x0 (the bracket midpoint when null)
//     inside the GRID bracket, then the final lml: REML floors rss at
//     128 eps q (:724), ML at tiny only (:1056).
//
// Replaces: the XLA programs of those stages, which materialize the three
// (S, nrho, R) weight families and their reductions for every step.
//
// What bounds it on the H100: latency.  Per step a problem reads its R
// rows (Gt strided by S, W, y and S shared by the variants) and does
// ~20 R flop (p = 1): 0.9 GFLOP and 45 MB of Gt per step at the headline,
// a few hundredths of a ms each.  The reductions over R run across a warp
// (lanes over r, then an xor-shuffle tree); the (p+1)^2 algebra runs on
// every lane, and lane 0's iterate is broadcast so the lanes stay in step.
// State x/lo/hi stays in registers across the steps; nothing but the
// results is written.
#include <cuda_runtime.h>
#include <cfloat>
#include <cstdint>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int LOC_MAX_WARPS = 16;  // rho points a localize block holds
constexpr int CONV_WARPS = 4;      // variants a converge block holds

// Loops over the small dimension run to the compile-time P1MAX and skip
// what lies outside [lo, hi): after unrolling, every array of the (p+1)^2
// algebra is indexed statically and can live in registers.
#define SMALL_FOR(i, lo, hi) \
  for (int i = 0; i < P1MAX; ++i) \
    if (i >= (lo) && i < (hi))

template <int P1MAX> struct Cfg {
  static constexpr int TRI = P1MAX * (P1MAX + 1) / 2;
  static constexpr int NE = TRI + P1MAX + 1;  // A (lower), b, q
};

__device__ __forceinline__ int tri(int i, int j) {
  return i * (i + 1) / 2 + j;
}

__device__ __forceinline__ double rnd(double v, bool r32) {
  return r32 ? (double)(float)v : v;
}

__device__ __forceinline__ double warp_sum(double v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

__device__ double sigmoid(double x) { return 1.0 / (1.0 + exp(-x)); }

// One problem's rows and complements.
struct Problem {
  const double* S;    // (R,) eigenvalues of its rho
  const double* WG;   // (R, p + nS) rotated [W | G] of its rho
  const double* y;    // (R,) rotated phenotype of its rho
  int s, p, ps, R;
  double cyy;         // complements, already rounded when round32
  const double* CWW;  // (p, p)
  const double* CWy;  // (p,)
  double cgg, cgy;
  const double* CWg;  // (p, nS) column s
  int nS;
  bool r32;
};

// Normal equations (NF families) of one problem at delta, summed over the
// warp: acc[f] = [A lower (TRI) | b (P1MAX) | q], plus sum e w1,
// sum e2 w1^2 (NF == 3) or sum log d (NF == 1).  Every lane returns the
// full sums, complements included.
template <int P1MAX, int NF>
__device__ void normal_eqs(const Problem& pb, double delta,
                           double (&acc)[NF][Cfg<P1MAX>::NE],
                           double& ex1, double& ex2) {
  constexpr int NE = Cfg<P1MAX>::NE, TRI = Cfg<P1MAX>::TRI;
  const int lane = threadIdx.x % 32;
  const int p = pb.p, p1 = p + 1;
  const bool r32 = pb.r32;
  for (int f = 0; f < NF; ++f)
    for (int e = 0; e < NE; ++e) acc[f][e] = 0.0;
  ex1 = 0.0;
  ex2 = 0.0;
  for (int r = lane; r < pb.R; r += 32) {
    const double* row = pb.WG + (int64_t)r * pb.ps;
    const double Sr = pb.S[r];
    const double yv = pb.y[r];
    const double g = row[p + pb.s];
    const double d = (1.0 - delta) * rnd(Sr, r32) + delta;
    const double w1 = 1.0 / d;
    double wf[NF];
    wf[0] = w1;
    if constexpr (NF == 3) {
      const double e = rnd(1.0 - Sr, r32);
      const double e2 = rnd((1.0 - Sr) * (1.0 - Sr), r32);
      wf[1] = e * w1 * w1;
      wf[2] = e2 * w1 * w1 * w1;
      ex1 += w1 * e;
      ex2 += w1 * w1 * e2;
    } else {
      ex1 += log(d);
    }
    // columns x = [W, g] and y; the products are rounded where the
    // reference's tensor sets are
    SMALL_FOR(i, 0, p1) {
      const double xi = i < p ? row[i] : g;
      SMALL_FOR(j, 0, i + 1) {
        const double xj = j < p ? row[j] : g;
        const double v = rnd(xi * xj, r32);
        for (int f = 0; f < NF; ++f) acc[f][tri(i, j)] += wf[f] * v;
      }
      const double v = rnd(xi * yv, r32);
      for (int f = 0; f < NF; ++f) acc[f][TRI + i] += wf[f] * v;
    }
    const double v = rnd(yv * yv, r32);
    for (int f = 0; f < NF; ++f) acc[f][NE - 1] += wf[f] * v;
  }
  for (int f = 0; f < NF; ++f)
    for (int e = 0; e < NE; ++e) acc[f][e] = warp_sum(acc[f][e]);
  ex1 = warp_sum(ex1);
  ex2 = warp_sum(ex2);
  // complement terms, weight 1/delta^(f+1)
  double ic = 1.0 / delta;
  const double i1 = ic;
  for (int f = 0; f < NF; ++f) {
    SMALL_FOR(i, 0, p1) {
      SMALL_FOR(j, 0, i + 1) {
        const double c = i < p ? pb.CWW[i * p + j]
                               : (j < p ? pb.CWg[(int64_t)j * pb.nS + pb.s]
                                        : pb.cgg);
        acc[f][tri(i, j)] += rnd(c, r32) * ic;
      }
      const double cb = i < p ? pb.CWy[i] : pb.cgy;
      acc[f][TRI + i] += rnd(cb, r32) * ic;
    }
    acc[f][NE - 1] += pb.cyy * ic;
    ic *= i1;
  }
}

// Ridge Cholesky of the lower components in place (ops/linalg.py
// unrolled_chol_factor); a failed factorization leaves NaN, as there.
template <int P1MAX>
__device__ void chol(double (&L)[P1MAX][P1MAX], const double* A, int p1) {
  double dmax = A[0];
  SMALL_FOR(i, 1, p1) dmax = fmax(dmax, A[tri(i, i)]);
  const double ridge = 1e-12 * fmax(dmax, 1.0);
  SMALL_FOR(i, 0, p1) {
    SMALL_FOR(j, 0, i + 1) {
      double v = A[tri(i, j)];
      if (i == j) v += ridge;
      SMALL_FOR(k, 0, j) v -= L[i][k] * L[j][k];
      L[i][j] = i == j ? sqrt(v) : v / L[j][j];
    }
  }
}

template <int P1MAX>
__device__ void chol_solve(const double (&L)[P1MAX][P1MAX], const double* b,
                           double* x, int p1) {
  SMALL_FOR(i, 0, p1) {
    double v = b[i];
    SMALL_FOR(k, 0, i) v -= L[i][k] * x[k];
    x[i] = v / L[i][i];
  }
  for (int i = P1MAX - 1; i >= 0; --i) {
    if (i >= p1) continue;
    double v = x[i];
    SMALL_FOR(k, i + 1, p1) v -= L[k][i] * x[k];
    x[i] = v / L[i][i];
  }
}

// symmetric matvec on lower components
template <int P1MAX>
__device__ void sym_mv(const double* A, const double* x, double* out, int p1) {
  SMALL_FOR(i, 0, p1) {
    double v = 0.0;
    SMALL_FOR(k, 0, p1) v += A[i >= k ? tri(i, k) : tri(k, i)] * x[k];
    out[i] = v;
  }
}

// (L', L'') of the profiled objective at delta
template <int P1MAX, bool REML>
__device__ void derivs(const Problem& pb, double delta, int n, double& Lp,
                       double& Lpp) {
  constexpr int NE = Cfg<P1MAX>::NE, TRI = Cfg<P1MAX>::TRI;
  const int p1 = pb.p + 1;
  double acc[3][NE], sum_ew, sum_e2w2;
  normal_eqs<P1MAX, 3>(pb, delta, acc, sum_ew, sum_e2w2);
  const double *A1 = acc[0], *A2 = acc[1], *A3 = acc[2];
  const double *b1 = acc[0] + TRI, *b2 = acc[1] + TRI, *b3 = acc[2] + TRI;
  const double q1 = acc[0][NE - 1], q2 = acc[1][NE - 1], q3 = acc[2][NE - 1];
  double L[P1MAX][P1MAX], beta[P1MAX], A2b[P1MAX], A3b[P1MAX], t[P1MAX],
      beta_p[P1MAX], A2bp[P1MAX];
  chol<P1MAX>(L, A1, p1);
  chol_solve<P1MAX>(L, b1, beta, p1);
  double rss = q1;
  SMALL_FOR(j, 0, p1) rss -= b1[j] * beta[j];
  rss = fmax(rss, DBL_MIN);
  sym_mv<P1MAX>(A2, beta, A2b, p1);
  sym_mv<P1MAX>(A3, beta, A3b, p1);
  SMALL_FOR(j, 0, p1) t[j] = A2b[j] - b2[j];
  chol_solve<P1MAX>(L, t, beta_p, p1);
  sym_mv<P1MAX>(A2, beta_p, A2bp, p1);
  double s_b2b = 0, s_bA2b = 0, s_b3b = 0, s_b2bp = 0, s_bA2bp = 0,
         s_bA3b = 0;
  SMALL_FOR(j, 0, p1) {
    s_b2b += b2[j] * beta[j];
    s_bA2b += beta[j] * A2b[j];
    s_b3b += b3[j] * beta[j];
    s_b2bp += b2[j] * beta_p[j];
    s_bA2bp += beta[j] * A2bp[j];
    s_bA3b += beta[j] * A3b[j];
  }
  const double rss_p = -q2 + 2 * s_b2b - s_bA2b;
  const double rss_pp =
      2 * q3 - 4 * s_b3b + 2 * s_b2bp - 2 * s_bA2bp + 2 * s_bA3b;
  const int nR = n - pb.R;
  const double i1 = 1.0 / delta;
  const double ld_p = sum_ew + nR * i1;
  const double ld_pp = -sum_e2w2 - nR * (i1 * i1);
  const double u = rss_p / rss;
  if (!REML) {
    Lp = -0.5 * (n * u + ld_p);
    Lpp = -0.5 * (n * (rss_pp / rss - u * u) + ld_pp);
    return;
  }
  // trace terms through the columns of A1^{-1}: Ainv[i][k] = (A1^{-1})_ik
  double Ainv[P1MAX][P1MAX];
  SMALL_FOR(kc, 0, p1) {
    double ecol[P1MAX], col[P1MAX];
    SMALL_FOR(i, 0, p1) ecol[i] = i == kc ? 1.0 : 0.0;
    chol_solve<P1MAX>(L, ecol, col, p1);
    SMALL_FOR(i, 0, p1) Ainv[i][kc] = col[i];
  }
  auto full = [&](const double* A, int i, int j) {
    return A[i >= j ? tri(i, j) : tri(j, i)];
  };
  double tr2 = 0, tr3 = 0, tr2sq = 0;
  double T2[P1MAX][P1MAX];
  SMALL_FOR(i, 0, p1) {
    SMALL_FOR(j, 0, p1) {
      double v = 0;
      SMALL_FOR(k, 0, p1) v += Ainv[i][k] * full(A2, k, j);
      T2[i][j] = v;
    }
  }
  SMALL_FOR(i, 0, p1) {
    tr2 += T2[i][i];
    SMALL_FOR(k, 0, p1) tr3 += Ainv[i][k] * full(A3, k, i);
    SMALL_FOR(j, 0, p1) tr2sq += T2[i][j] * T2[j][i];
  }
  const double nu = n - p1;
  Lp = -0.5 * (nu * u + ld_p - tr2);
  Lpp = -0.5 * (nu * (rss_pp / rss - u * u) + ld_pp + 2 * tr3 - tr2sq);
}

// `steps` safeguarded Newton steps; lane 0's iterate is the warp's
template <int P1MAX, bool REML>
__device__ void newton(const Problem& pb, int n, int steps, double& x,
                       double& lo, double& hi) {
  for (int it = 0; it < steps; ++it) {
    const double delta = sigmoid(x);
    double Lp, Lpp;
    derivs<P1MAX, REML>(pb, delta, n, Lp, Lpp);
    const double g = delta * (1 - delta);
    const double Lx_p = Lp * g;
    const double Lx_pp = Lpp * g * g + Lp * g * (1 - 2 * delta);
    const double lo2 = Lx_p > 0 ? x : lo;
    const double hi2 = Lx_p > 0 ? hi : x;
    const double xn = x - Lx_p / Lx_pp;
    // inclusive bounds: at convergence xn == x == a bracket end
    const bool ok = Lx_pp < 0 && xn >= lo2 && xn <= hi2 && isfinite(xn);
    x = __shfl_sync(FULL, ok ? xn : 0.5 * (lo2 + hi2), 0);
    lo = __shfl_sync(FULL, lo2, 0);
    hi = __shfl_sync(FULL, hi2, 0);
  }
}

// The fit at delta: (lml, rss, beta) with the objective's rss floor
template <int P1MAX, bool REML, bool FLOOR_Q>
__device__ double fit_at(const Problem& pb, double delta, int n, double ld_xx,
                         double* beta, double& rss_out, bool& rss_bad) {
  constexpr int NE = Cfg<P1MAX>::NE, TRI = Cfg<P1MAX>::TRI;
  const int p1 = pb.p + 1;
  double acc[1][NE], logd, unused;
  normal_eqs<P1MAX, 1>(pb, delta, acc, logd, unused);
  double L[P1MAX][P1MAX];
  chol<P1MAX>(L, acc[0], p1);
  chol_solve<P1MAX>(L, acc[0] + TRI, beta, p1);
  const double q = acc[0][NE - 1];
  double rss = q;
  SMALL_FOR(j, 0, p1) rss -= acc[0][TRI + j] * beta[j];
  rss_bad = rss <= 128 * DBL_EPSILON * q;
  if (FLOOR_Q) rss = fmax(rss, 128 * DBL_EPSILON * q);
  rss = fmax(rss, DBL_MIN);
  rss_out = rss;
  const double two_pi = 6.283185307179586;
  const double logdet_d = logd + (n - pb.R) * log(delta);
  if (!REML) return -0.5 * (n * log(two_pi * rss / n) + logdet_d + n);
  double logdet_a = 0;
  SMALL_FOR(i, 0, p1) logdet_a += log(L[i][i]);
  logdet_a *= 2;
  const double nu = n - p1;
  return -0.5 * (nu * log(two_pi * rss / nu) + logdet_d + logdet_a - ld_xx +
                 nu);
}

__device__ Problem make_problem(const double* Sv, const double* WGt,
                                const double* yt, const double* CWW,
                                const double* CWy, const double* Cyy,
                                const double* CWg, const double* Cgy,
                                const double* Cgg, int o, int s, int R, int p,
                                int nS, bool r32) {
  Problem pb;
  pb.ps = p + nS;
  pb.S = Sv + (int64_t)o * R;
  pb.WG = WGt + (int64_t)o * R * pb.ps;
  pb.y = yt + (int64_t)o * R;
  pb.s = s;
  pb.p = p;
  pb.R = R;
  pb.nS = nS;
  pb.r32 = r32;
  pb.CWW = CWW;
  pb.CWy = CWy;
  pb.CWg = CWg;
  pb.cyy = rnd(Cyy[0], r32);
  pb.cgg = Cgg[s];
  pb.cgy = Cgy[s];
  return pb;
}

template <int P1MAX>
__global__ void __launch_bounds__(32 * LOC_MAX_WARPS)
localize_kernel(const double* __restrict__ Sv, const double* __restrict__ WGt,
                const double* __restrict__ yt, const double* __restrict__ CWW,
                const double* __restrict__ CWy, const double* __restrict__ Cyy,
                const double* __restrict__ CWg, const double* __restrict__ Cgy,
                const double* __restrict__ Cgg,
                const double* __restrict__ ld_xx,
                const double* __restrict__ br_lo,
                const double* __restrict__ br_hi, double* __restrict__ x_out,
                double* __restrict__ lml_out, int64_t* __restrict__ k_best,
                int n, int nrho, int R, int p, int nS, int steps, int r32) {
  __shared__ double lml_sh[LOC_MAX_WARPS];
  // the gene axis: phenotype operands and outputs offset by gene
  const int64_t gi = blockIdx.y;
  yt += gi * nrho * R;
  CWy += gi * p;
  Cyy += gi;
  Cgy += gi * nS;
  br_lo += gi * nS * nrho;
  br_hi += gi * nS * nrho;
  x_out += gi * nS * nrho;
  lml_out += gi * nS * nrho;
  k_best += gi * nS;
  const int s = blockIdx.x;
  const int o = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int64_t so = (int64_t)s * nrho + o;
  double lo = br_lo[so], hi = br_hi[so];
  double x = 0.5 * (lo + hi);
  // stage 1b: Newton on the (possibly f32-rounded) tensors
  Problem pb = make_problem(Sv, WGt, yt, CWW, CWy, Cyy, CWg, Cgy, Cgg, o, s,
                            R, p, nS, r32 != 0);
  newton<P1MAX, true>(pb, n, steps, x, lo, hi);
  // stage 2: one f64 evaluation on the unrounded tensors
  pb = make_problem(Sv, WGt, yt, CWW, CWy, Cyy, CWg, Cgy, Cgg, o, s, R, p,
                    nS, false);
  double beta[P1MAX], rss;
  bool bad;
  double lml = fit_at<P1MAX, true, false>(pb, sigmoid(x), n, ld_xx[s], beta,
                                          rss, bad);
  // noise-floor or NaN evaluations must not win the rho argmax (:664-666)
  if (bad || !isfinite(lml)) lml = -INFINITY;
  if (lane == 0) {
    x_out[so] = x;
    lml_out[so] = lml;
    lml_sh[o] = lml;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int kb = 0;
    double best = lml_sh[0];
    for (int k = 1; k < nrho; ++k)
      if (lml_sh[k] > best) {  // the first maximum wins, as argmax's
        best = lml_sh[k];
        kb = k;
      }
    k_best[s] = kb;
  }
}

template <int P1MAX, bool REML>
__global__ void __launch_bounds__(32 * CONV_WARPS)
converge_kernel(const double* __restrict__ Sv, const double* __restrict__ WGt,
                const double* __restrict__ yt, const double* __restrict__ CWW,
                const double* __restrict__ CWy, const double* __restrict__ Cyy,
                const double* __restrict__ CWg, const double* __restrict__ Cgy,
                const double* __restrict__ Cgg,
                const double* __restrict__ ld_xx,
                const int64_t* __restrict__ k_best,
                const double* __restrict__ x0,
                const double* __restrict__ br_lo,
                const double* __restrict__ br_hi,
                double* __restrict__ delta_out, double* __restrict__ lml_out,
                double* __restrict__ scale_out, double* __restrict__ beta_out,
                int n, int nrho, int R, int p, int nS, int steps) {
  const int64_t gi = blockIdx.y;  // the gene axis, as in localize_kernel
  yt += gi * nrho * R;
  CWy += gi * p;
  Cyy += gi;
  Cgy += gi * nS;
  br_lo += gi * nS * nrho;
  br_hi += gi * nS * nrho;
  if (k_best) k_best += gi * nS;
  if (x0) x0 += gi * nS * nrho;
  delta_out += gi * nS;
  lml_out += gi * nS;
  scale_out += gi * nS;
  beta_out += gi * nS * (p + 1);
  const int s = blockIdx.x * CONV_WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (s >= nS) return;  // whole warps only: no block-wide barrier here
  const int o = k_best ? (int)k_best[s] : 0;
  const int64_t so = (int64_t)s * nrho + o;
  double lo = br_lo[so], hi = br_hi[so];
  double x = x0 ? x0[so] : 0.5 * (lo + hi);
  const Problem pb = make_problem(Sv, WGt, yt, CWW, CWy, Cyy, CWg, Cgy, Cgg,
                                  o, s, R, p, nS, false);
  newton<P1MAX, REML>(pb, n, steps, x, lo, hi);
  const double delta = sigmoid(x);
  double beta[P1MAX], rss;
  bool bad;
  const double lml = fit_at<P1MAX, REML, REML>(
      pb, delta, n, REML ? ld_xx[s] : 0.0, beta, rss, bad);
  if (lane == 0) {
    delta_out[s] = delta;
    lml_out[s] = lml;
    scale_out[s] = rss / (REML ? (double)(n - p - 1) : (double)n);
    SMALL_FOR(j, 0, p + 1) beta_out[(int64_t)s * (p + 1) + j] = beta[j];
  }
}

}  // namespace

// Operands: Sv (nrho, R), WGt (nrho, R, p + nS), CWW (p, p), CWg (p, nS),
// Cgg (nS,), ld_xx (nS,) (REML), shared by the genes; yt (genes, nrho, R),
// CWy (genes, p), Cyy (genes,), Cgy (genes, nS), br_lo/br_hi (genes, nS,
// nrho) per gene: row-major f64 on the card, 1 <= p + 1 <= 16, genes <=
// 65535 (a single phenotype is genes = 1).  Launch on `stream`; return
// cudaGetLastError().

// -> x, lml_all (genes, nS, nrho), k_best (genes, nS) int64; nrho <= 16.
extern "C" int crm_reml_localize(const double* Sv, const double* WGt,
                                 const double* yt, const double* CWW,
                                 const double* CWy, const double* Cyy,
                                 const double* CWg, const double* Cgy,
                                 const double* Cgg, const double* ld_xx,
                                 const double* br_lo, const double* br_hi,
                                 double* x, double* lml_all, int64_t* k_best,
                                 int n, int nrho, int R, int p, int nS,
                                 int genes, int steps, int round32,
                                 cudaStream_t stream) {
  auto kernel = p + 1 <= 2   ? localize_kernel<2>
                : p + 1 <= 4 ? localize_kernel<4>
                             : localize_kernel<16>;
  const dim3 grid(nS, genes);
  kernel<<<grid, 32 * nrho, 0, stream>>>(Sv, WGt, yt, CWW, CWy, Cyy, CWg, Cgy,
                                       Cgg, ld_xx, br_lo, br_hi, x, lml_all,
                                       k_best, n, nrho, R, p, nS, steps,
                                       round32);
  return (int)cudaGetLastError();
}

// k_best (genes, nS) int64 or null (rho 0), x0 (genes, nS, nrho) or null
// (bracket midpoint) -> delta, lml, scale (genes, nS), beta (genes, nS,
// p + 1); ld_xx may be null when reml == 0.
extern "C" int crm_reml_converge(const double* Sv, const double* WGt,
                                 const double* yt, const double* CWW,
                                 const double* CWy, const double* Cyy,
                                 const double* CWg, const double* Cgy,
                                 const double* Cgg, const double* ld_xx,
                                 const int64_t* k_best, const double* x0,
                                 const double* br_lo, const double* br_hi,
                                 double* delta, double* lml, double* scale,
                                 double* beta, int n, int nrho, int R, int p,
                                 int nS, int genes, int steps, int reml,
                                 cudaStream_t stream) {
  auto kernel = reml ? (p + 1 <= 2   ? converge_kernel<2, true>
                        : p + 1 <= 4 ? converge_kernel<4, true>
                                     : converge_kernel<16, true>)
                     : (p + 1 <= 2   ? converge_kernel<2, false>
                        : p + 1 <= 4 ? converge_kernel<4, false>
                                     : converge_kernel<16, false>);
  const int blocks = (nS + CONV_WARPS - 1) / CONV_WARPS;
  const dim3 grid(blocks, genes);
  kernel<<<grid, 32 * CONV_WARPS, 0, stream>>>(
      Sv, WGt, yt, CWW, CWy, Cyy, CWg, Cgy, Cgg, ld_xx, k_best, x0, br_lo,
      br_hi, delta, lml, scale, beta, n, nrho, R, p, nS, steps);
  return (int)cudaGetLastError();
}
