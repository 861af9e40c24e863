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
//   crm_reml_localize (stages 1b + 2, :628-670): a warp per (gene,
//     variant, rho) problem, a block per rho point and tile of variants
//     and genes whose shared rows it stages (p + 1 < LOC_GEMM_MIN_P1; from
//     there the product route below, the same steps in another order of
//     sums).  `steps` steps from the bracket midpoint on the tensors
//     rounded to f32 when round32 (f64 arithmetic on f32-rounded tensors:
//     the reference's type promotion), then one f64 REML lml at the
//     localized delta on the unrounded tensors (rss <= 128 eps q there
//     cannot win, :655), and the argmax over rho (a kernel of its own,
//     the first maximum winning).
//   crm_reml_converge (stage 3, :672-734; association refit, :991-1062):
//     a warp per (gene, variant) problem at its rho k_best (0 when null),
//     a block per rho and tile of that rho's problems (listed on the
//     card) whose shared rows it stages; `steps` steps on the unrounded
//     tensors from x0 (the bracket midpoint when null) inside the GRID
//     bracket, then the final lml: REML floors rss at 128 eps q (:724),
//     ML at tiny only (:1056).  Its f32 entry (crm_reml_converge_f32, the
//     float32 context) runs the same kernels on f32 rows.
//
// Replaces: the XLA programs of those stages, which materialize the three
// (S, nrho, R) weight families and their reductions for every step.
//
// What bounds it on the H100: latency.  Per step a problem reads its R
// rows (its genotype column of the rotated [W | G], strided by p + S; W,
// y and S shared by the variants) and does ~20 R flop (p = 1): 0.9 GFLOP
// and 45 MB of rows per step at the headline, a few hundredths of a ms
// each.  The reductions over R run across a warp (lanes over r, then an
// xor-shuffle tree); the (p+1)^2 algebra runs on every lane, and lane 0's
// iterate is broadcast so the lanes stay in step.  State x/lo/hi stays in
// registers across the steps; nothing but the results is written.  Both
// the register localize and the converge stage the rows a block's
// problems share in shared memory, so that the strided genotype is read
// once a block (and chunk), along the variants, not once a problem and
// step; the localize also makes the f32 roundings of the products that no
// phenotype or no genotype enters once a block.
//
// Instantiations: p + 1 <= 2, 4 (localize and converge) and 16 (converge)
// keep each lane's sums and algebra in registers.  The wide converge
// (p + 1 <= 33: up to 3 x 595 sums a problem) gives each warp a workspace
// in dynamic shared memory: each lane owns 4 x 4 blocks of the sums and
// accumulates them over the staged rows, and the algebra (the factor,
// A1^{-1} by columns, the trace terms) runs there with the lanes over
// rows, columns or entries.  The localize from p + 1 = LOC_GEMM_MIN_P1 up
// is the product route (below): most of its sums are one product a rho on
// the FP64 tensor cores, and the same workspace algebra is its epilogue.
// The float32 context's localize (crm_reml_localize_f32, at the end) is
// the register localize on f32 rows up to p + 1 = 4, and from 5 (to 16)
// its sums split over warps that meet in the same workspace algebra, in
// f32 (the helpers above take their arithmetic type as a parameter).
#include <cuda_runtime.h>
#include <algorithm>
#include <cfloat>
#include <cstdint>
#include <type_traits>

#include "async_copy.cuh"
#include "dmma.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
#ifndef CRM_LOC_MAX_WARPS  // the emulated tests build some with fewer
#define CRM_LOC_MAX_WARPS 16
#endif
constexpr int LOC_MAX_WARPS = CRM_LOC_MAX_WARPS;  // of a register localize

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
__device__ __forceinline__ float rnd(float v, bool) { return v; }

// rows whose d's product one log takes (d >= sigmoid(-18) ~ 1.5e-8 and
// an eigenvalue, so that the product of 8 stays within f64's range)
constexpr int LOG_GROUP = 8;

template <class A>
__device__ __forceinline__ A warp_sum(A v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

// in the arithmetic type A: double, or float (the float32 context's
// localizing steps)
template <class A>
__device__ A sigmoid(A x) { return A(1) / (A(1) + exp(-x)); }

// A row's fields as the Newton steps' tensors hold them: e = 1 - S, e^2
// and the products of two row values; on f64 rows rounded to f32 when r32
// (the reference's f32-rounded tensors), on f32 rows (the float32
// context) the f32 values the reference forms from its f32 tensors
__device__ __forceinline__ double one_minus(double S, bool r32) {
  return rnd(1.0 - S, r32);
}
__device__ __forceinline__ double e_sq(double S, bool r32) {
  return rnd((1.0 - S) * (1.0 - S), r32);
}
__device__ __forceinline__ double prod(double a, double b, bool r32) {
  return rnd(a * b, r32);
}
__device__ __forceinline__ float one_minus(float S, bool) { return 1.0f - S; }
__device__ __forceinline__ float e_sq(float S, bool) {
  const float e = 1.0f - S;
  return e * e;
}
__device__ __forceinline__ float prod(float a, float b, bool) { return a * b; }

// a row's weight 1 / d in the arithmetic type A from rows of type T: on
// f64 rows the division; the f32 steps' the correctly rounded reciprocal
// (__frcp_rn, the division's value); the f64 evaluation of f32 rows the
// branch-free reciprocal (rcp_nr, ~1 ulp)
template <class A, class T>
__device__ __forceinline__ A weight(A d) {
  if constexpr (std::is_same<T, double>::value) return A(1) / d;
  else if constexpr (std::is_same<A, float>::value) return __frcp_rn(d);
  else return rcp_nr(d);
}

// the smallest normal value of the arithmetic type: the derivatives' rss
// floor (the reference's clamp at tiny of its arithmetic)
template <class A> struct Tiny;
template <> struct Tiny<double> { static constexpr double v = DBL_MIN; };
template <> struct Tiny<float> { static constexpr float v = FLT_MIN; };

// One problem's complements (its rows are staged by the kernel that runs
// it), in the operand type T (float: the float32 context's converge, the
// values widened to f64 where they are read).
template <class T>
struct ProblemT {
  int s, p, R, nS;
  double cyy;    // complements, already rounded when round32
  const T* CWW;  // (p, p)
  const T* CWy;  // (p,)
  double cgg, cgy;
  const T* CWg;  // (p, nS) column s
  bool r32;
};
using Problem = ProblemT<double>;

// The complement terms of the normal equations acc[f] = [A lower (TRI) |
// b (P1MAX) | q] of NF families, weight 1/delta^(f+1).
template <int P1MAX, int NF, class A, class PB>
__device__ void ne_complements(const PB& pb, A delta,
                               A (&acc)[NF][Cfg<P1MAX>::NE]) {
  constexpr int NE = Cfg<P1MAX>::NE, TRI = Cfg<P1MAX>::TRI;
  const int p = pb.p, p1 = p + 1;
  const bool r32 = pb.r32;
  A ic = A(1) / delta;
  const A i1 = ic;
  for (int f = 0; f < NF; ++f) {
    SMALL_FOR(i, 0, p1) {
      SMALL_FOR(j, 0, i + 1) {
        const double c = i < p ? pb.CWW[i * p + j]
                               : (j < p ? pb.CWg[(int64_t)j * pb.nS + pb.s]
                                        : pb.cgg);
        acc[f][tri(i, j)] += A(rnd(c, r32)) * ic;
      }
      const double cb = i < p ? pb.CWy[i] : pb.cgy;
      acc[f][TRI + i] += A(rnd(cb, r32)) * ic;
    }
    acc[f][NE - 1] += A(pb.cyy) * ic;
    ic *= i1;
  }
}

// The complements and the warp's sum of normal equations whose rows each
// lane has accumulated: acc[f] = [A lower (TRI) | b (P1MAX) | q], plus
// sum e w1, sum e2 w1^2 (NF == 3) or sum log d (NF == 1).  Every lane
// returns the full sums, complements included.
template <int P1MAX, int NF, class A, class PB>
__device__ void ne_finish(const PB& pb, A delta, A (&acc)[NF][Cfg<P1MAX>::NE],
                          A& ex1, A& ex2) {
  for (int f = 0; f < NF; ++f)
    for (int e = 0; e < Cfg<P1MAX>::NE; ++e) acc[f][e] = warp_sum(acc[f][e]);
  ex1 = warp_sum(ex1);
  ex2 = warp_sum(ex2);
  ne_complements<P1MAX, NF, A>(pb, delta, acc);
}

// Ridge Cholesky of the lower components in place (ops/linalg.py
// unrolled_chol_factor); a failed factorization leaves NaN, as there.
template <int P1MAX, class T>
__device__ void chol(T (&L)[P1MAX][P1MAX], const T* A, int p1) {
  T dmax = A[0];
  SMALL_FOR(i, 1, p1) dmax = fmax(dmax, A[tri(i, i)]);
  const T ridge = T(1e-12) * fmax(dmax, T(1));
  SMALL_FOR(i, 0, p1) {
    SMALL_FOR(j, 0, i + 1) {
      T v = A[tri(i, j)];
      if (i == j) v += ridge;
      SMALL_FOR(k, 0, j) v -= L[i][k] * L[j][k];
      L[i][j] = i == j ? sqrt(v) : v / L[j][j];
    }
  }
}

template <int P1MAX, class T>
__device__ void chol_solve(const T (&L)[P1MAX][P1MAX], const T* b, T* x,
                           int p1) {
  SMALL_FOR(i, 0, p1) {
    T v = b[i];
    SMALL_FOR(k, 0, i) v -= L[i][k] * x[k];
    x[i] = v / L[i][i];
  }
  for (int i = P1MAX - 1; i >= 0; --i) {
    if (i >= p1) continue;
    T v = x[i];
    SMALL_FOR(k, i + 1, p1) v -= L[k][i] * x[k];
    x[i] = v / L[i][i];
  }
}

// symmetric matvec on lower components
template <int P1MAX, class T>
__device__ void sym_mv(const T* A, const T* x, T* out, int p1) {
  SMALL_FOR(i, 0, p1) {
    T v = T(0);
    SMALL_FOR(k, 0, p1) v += A[i >= k ? tri(i, k) : tri(k, i)] * x[k];
    out[i] = v;
  }
}

// the rss floors of the f64 context (fmax) and of the float32 context's
// converge, which keep a NaN (a failed factorization's residual), as the
// plain versions' torch.clamp / torch.maximum and the reference's
// jnp.maximum do; eps and ml_tiny are the context's (engine.py:724, :1056)
template <class T> struct Floors;
template <> struct Floors<double> {
  static constexpr bool keep_nan = false;
  static constexpr double eps = DBL_EPSILON, ml_tiny = DBL_MIN;
};
template <> struct Floors<float> {
  static constexpr bool keep_nan = true;
  static constexpr double eps = FLT_EPSILON, ml_tiny = FLT_MIN;
};
template <class FL, class A>
__device__ __forceinline__ A floor_at(A x, A floor) {
  if constexpr (FL::keep_nan) return x < floor ? floor : x;
  return fmax(x, floor);
}

// (L', L'') of the profiled objective at delta from the three families'
// normal equations (ne_finish's sums), in the arithmetic type A (the rss
// floored at tiny of A, a NaN kept where FL keeps it)
template <int P1MAX, bool REML, class FL = Floors<double>, class A,
          class PB>
__device__ void derivs_sums(const PB& pb, A delta, int n,
                            const A (&acc)[3][Cfg<P1MAX>::NE], A sum_ew,
                            A sum_e2w2, A& Lp, A& Lpp) {
  constexpr int NE = Cfg<P1MAX>::NE, TRI = Cfg<P1MAX>::TRI;
  const int p1 = pb.p + 1;
  const A *A1 = acc[0], *A2 = acc[1], *A3 = acc[2];
  const A *b1 = acc[0] + TRI, *b2 = acc[1] + TRI, *b3 = acc[2] + TRI;
  const A q1 = acc[0][NE - 1], q2 = acc[1][NE - 1], q3 = acc[2][NE - 1];
  A L[P1MAX][P1MAX], beta[P1MAX], A2b[P1MAX], A3b[P1MAX], t[P1MAX],
      beta_p[P1MAX], A2bp[P1MAX];
  chol<P1MAX>(L, A1, p1);
  chol_solve<P1MAX>(L, b1, beta, p1);
  A rss = q1;
  SMALL_FOR(j, 0, p1) rss -= b1[j] * beta[j];
  rss = floor_at<FL>(rss, Tiny<A>::v);
  sym_mv<P1MAX>(A2, beta, A2b, p1);
  sym_mv<P1MAX>(A3, beta, A3b, p1);
  SMALL_FOR(j, 0, p1) t[j] = A2b[j] - b2[j];
  chol_solve<P1MAX>(L, t, beta_p, p1);
  sym_mv<P1MAX>(A2, beta_p, A2bp, p1);
  A s_b2b = 0, s_bA2b = 0, s_b3b = 0, s_b2bp = 0, s_bA2bp = 0, s_bA3b = 0;
  SMALL_FOR(j, 0, p1) {
    s_b2b += b2[j] * beta[j];
    s_bA2b += beta[j] * A2b[j];
    s_b3b += b3[j] * beta[j];
    s_b2bp += b2[j] * beta_p[j];
    s_bA2bp += beta[j] * A2bp[j];
    s_bA3b += beta[j] * A3b[j];
  }
  const A rss_p = -q2 + A(2) * s_b2b - s_bA2b;
  const A rss_pp = A(2) * q3 - A(4) * s_b3b + A(2) * s_b2bp -
                   A(2) * s_bA2bp + A(2) * s_bA3b;
  const A nR = A(n - pb.R);
  const A i1 = A(1) / delta;
  const A ld_p = sum_ew + nR * i1;
  const A ld_pp = -sum_e2w2 - nR * (i1 * i1);
  const A u = rss_p / rss;
  if (!REML) {
    Lp = A(-0.5) * (A(n) * u + ld_p);
    Lpp = A(-0.5) * (A(n) * (rss_pp / rss - u * u) + ld_pp);
    return;
  }
  // trace terms through the columns of A1^{-1}: Ainv[i][k] = (A1^{-1})_ik
  A Ainv[P1MAX][P1MAX];
  SMALL_FOR(kc, 0, p1) {
    A ecol[P1MAX], col[P1MAX];
    SMALL_FOR(i, 0, p1) ecol[i] = i == kc ? A(1) : A(0);
    chol_solve<P1MAX>(L, ecol, col, p1);
    SMALL_FOR(i, 0, p1) Ainv[i][kc] = col[i];
  }
  auto full = [&](const A* M, int i, int j) {
    return M[i >= j ? tri(i, j) : tri(j, i)];
  };
  A tr2 = 0, tr3 = 0, tr2sq = 0;
  A T2[P1MAX][P1MAX];
  SMALL_FOR(i, 0, p1) {
    SMALL_FOR(j, 0, p1) {
      A v = 0;
      SMALL_FOR(k, 0, p1) v += Ainv[i][k] * full(A2, k, j);
      T2[i][j] = v;
    }
  }
  SMALL_FOR(i, 0, p1) {
    tr2 += T2[i][i];
    SMALL_FOR(k, 0, p1) tr3 += Ainv[i][k] * full(A3, k, i);
    SMALL_FOR(j, 0, p1) tr2sq += T2[i][j] * T2[j][i];
  }
  const A nu = A(n - p1);
  Lp = A(-0.5) * (nu * u + ld_p - tr2);
  Lpp = A(-0.5) * (nu * (rss_pp / rss - u * u) + ld_pp + A(2) * tr3 - tr2sq);
}

// ---------------------------------------------------------------------------
// The wide algebra (p + 1 <= 33): the normal equations of three families
// (up to 3 x 595 sums) and their algebra do not fit in a lane's
// registers, so a warp works in a shared-memory workspace, the lanes over
// rows, columns or entries.  The localize's product route (its epilogue)
// and the wide converge (below) put their sums there.
// ---------------------------------------------------------------------------
constexpr int WRC = 32;    // rows whose weights a converge warp makes at once
constexpr int WIDE_P1MAX = 33;  // p + 1 of the widest instantiation
// shared memory an SM gives one block (of its 228 KB): a localize
// epilogue block takes as many warps as their workspaces fit (10 at p + 1
// = 25, 6 at 33), up to WIDE_LOC_WARPS
constexpr int SMEM_BLOCK = 227 * 1024 - 1024;
constexpr int WIDE_LOC_WARPS = 12;

__host__ __device__ inline int wide_ne(int p1) {
  return p1 * (p1 + 1) / 2 + p1 + 1;
}

// in the arithmetic type A (float: the float32 context's localizing
// steps)
template <class A = double>
struct WideWs {
  A *wf, *acc, *L, *Ainv, *T2, *vec, *rd;
  int p1, ne;
};

// the workspace of one warp's algebra, in values of A, at p + 1 = p1
__host__ __device__ inline int epi_words(int p1) {
  return 3 * wide_ne(p1) + p1 * (p1 + 1) / 2 + 2 * p1 * p1 + 7 * p1;
}

template <class A>
__device__ WideWs<A> wide_ws(A* base, int p1) {
  WideWs<A> w;
  w.p1 = p1;
  w.ne = wide_ne(p1);
  w.wf = nullptr;                         // the converge's row weights
  w.acc = base;                           // [3][ne]: A lower, b, q
  w.L = w.acc + 3 * w.ne;                 // lower triangle of the factor
  w.Ainv = w.L + p1 * (p1 + 1) / 2;       // [p1][p1]
  w.T2 = w.Ainv + p1 * p1;                // [p1][p1]
  w.vec = w.T2 + p1 * p1;                 // 6 vectors of p1
  w.rd = w.vec + 6 * p1;                  // 1 / L[i][i]
  return w;
}
// ridge Cholesky of family 0's A into ws.L (the order of chol above),
// the lanes over the rows of each column; ws.rd the reciprocals of its
// diagonal, so that the solves multiply (a division is a long dependent
// sequence on the card; the solves' chains would wait on p1 of them)
template <class T>
__device__ void chol_wide(const WideWs<T>& ws) {
  const int lane = threadIdx.x % 32, p1 = ws.p1;
  const T* A = ws.acc;
  T* L = ws.L;
  T dmax = A[0];
  for (int i = 1; i < p1; ++i) dmax = fmax(dmax, A[tri(i, i)]);
  const T ridge = T(1e-12) * fmax(dmax, T(1));
  for (int j = 0; j < p1; ++j) {
    if (lane == 0) {
      T v = A[tri(j, j)] + ridge;
      for (int k = 0; k < j; ++k) v -= L[tri(j, k)] * L[tri(j, k)];
      L[tri(j, j)] = sqrt(v);
      ws.rd[j] = T(1) / L[tri(j, j)];
    }
    __syncwarp();
    for (int i = j + 1 + lane; i < p1; i += 32) {
      T v = A[tri(i, j)];
      for (int k = 0; k < j; ++k) v -= L[tri(i, k)] * L[tri(j, k)];
      L[tri(i, j)] = v * ws.rd[j];
    }
    __syncwarp();
  }
}

// X = A^{-1} V through ws.L and ws.rd for nb <= NB columns at once, v(i, c)
// the right-hand side and out(i, c, value) the solution's sink, on the
// whole warp: the lanes over the rows (row lane, and lane + 32 at p1 =
// 33), the columns in registers, each substitution step's pivot
// broadcast by a shuffle.  (One lane's substitution through a column in
// shared memory made each of its ~p1^2 steps wait on the load of the
// element the step before stored: ~20k cycles a solve at p1 = 25 on an
// H100 80GB HBM3.)
template <int NB, class T, class Vf, class Of>
__device__ void solve_warp(const WideWs<T>& ws, int nb, Vf v, Of out) {
  const int lane = threadIdx.x % 32, p1 = ws.p1;
  const int r0 = lane, r1 = lane + 32;
  const T* L = ws.L;
  T t0[NB], t1[NB];
#pragma unroll
  for (int c = 0; c < NB; ++c) {
    t0[c] = c < nb && r0 < p1 ? v(r0, c) : T(0);
    t1[c] = c < nb && r1 < p1 ? v(r1, c) : T(0);
  }
  for (int k = 0; k < p1; ++k) {  // L y = v, by columns of L
    const T rk = ws.rd[k];
    const T l0 = r0 > k && r0 < p1 ? L[tri(r0, k)] : T(0);
    const T l1 = r1 > k && r1 < p1 ? L[tri(r1, k)] : T(0);
#pragma unroll
    for (int c = 0; c < NB; ++c) {
      const T xk = (k < 32 ? __shfl_sync(FULL, t0[c], k)
                                : __shfl_sync(FULL, t1[c], k - 32)) * rk;
      if (r0 == k) t0[c] = xk;
      else if (r0 > k) t0[c] -= l0 * xk;
      if (r1 == k) t1[c] = xk;
      else if (r1 > k) t1[c] -= l1 * xk;
    }
  }
  for (int k = p1 - 1; k >= 0; --k) {  // L^T x = y, by rows of L
    const T rk = ws.rd[k];
    const T l0 = r0 < k ? L[tri(k, r0)] : T(0);
    const T l1 = r1 < k ? L[tri(k, r1)] : T(0);
#pragma unroll
    for (int c = 0; c < NB; ++c) {
      const T xk = (k < 32 ? __shfl_sync(FULL, t0[c], k)
                                : __shfl_sync(FULL, t1[c], k - 32)) * rk;
      if (r0 == k) t0[c] = xk;
      else if (r0 < k) t0[c] -= l0 * xk;
      if (r1 == k) t1[c] = xk;
      else if (r1 < k) t1[c] -= l1 * xk;
    }
  }
#pragma unroll
  for (int c = 0; c < NB; ++c) {
    if (c < nb && r0 < p1) out(r0, c, t0[c]);
    if (c < nb && r1 < p1) out(r1, c, t1[c]);
  }
  __syncwarp();
}

// out = A x for family f's symmetric A; the lanes over rows
template <class T>
__device__ void sym_mv_wide(const WideWs<T>& ws, int f, const T* x, T* out) {
  const int lane = threadIdx.x % 32, p1 = ws.p1;
  const T* A = ws.acc + f * ws.ne;
  for (int i = lane; i < p1; i += 32) {
    T v = T(0);
    for (int k = 0; k < p1; ++k) v += A[i >= k ? tri(i, k) : tri(k, i)] * x[k];
    out[i] = v;
  }
  __syncwarp();
}

// a . b over p1 entries, on every lane
template <class T>
__device__ T dot_wide(const T* a, const T* b, int p1) {
  const int lane = threadIdx.x % 32;
  T v = T(0);
  for (int i = lane; i < p1; i += 32) v += a[i] * b[i];
  return warp_sum(v);
}

// C = A B for (p1 x p1) operands on the FP64 tensor cores, the whole warp:
// a(r, k), b(k, c) the operands' entries, out(r, c, value) the sink; tiles
// of 16 x 8, 8 deep, zero past p1 (the loops are warp-uniform, as mma.sync
// needs)
template <class T = double, class Af, class Bf, class Of>
__device__ void warp_gemm(int p1, Af af, Bf bf, Of out) {
  const int lane = threadIdx.x % 32;
  if constexpr (std::is_same<T, float>::value) {
    // f32 (the float32 context's steps, p1 <= 16): a lane an entry at a
    // time, in the order of the k sums
    for (int e = lane; e < p1 * p1; e += 32) {
      const int r = e / p1, c = e - r * p1;
      float v = 0.0f;
      for (int k = 0; k < p1; ++k) v += af(r, k) * bf(k, c);
      out(r, c, v);
    }
  } else {
    const int g = lane >> 2, tq = lane & 3;
    for (int m0 = 0; m0 < p1; m0 += 16)
      for (int n0 = 0; n0 < p1; n0 += 8) {
        double d[4] = {0.0, 0.0, 0.0, 0.0};
        for (int k0 = 0; k0 < p1; k0 += 8) {
          double a[4], b[2];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int r = m0 + g + 8 * (i & 1), c = k0 + tq + 4 * (i >> 1);
            a[i] = r < p1 && c < p1 ? af(r, c) : 0.0;
          }
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int k = k0 + tq + 4 * i, c = n0 + g;
            b[i] = k < p1 && c < p1 ? bf(k, c) : 0.0;
          }
          dmma_m16n8k8(d, a, b);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = m0 + g + 8 * (i >> 1), c = n0 + 2 * tq + (i & 1);
          if (r < p1 && c < p1) out(r, c, d[i]);
        }
      }
  }
  __syncwarp();
}

// (L', L'') from the three families' normal equations in ws.acc (the
// algebra of derivs above, the lanes over rows, columns or entries)
template <bool REML, class FL = Floors<double>, class T>
__device__ void derivs_tail_wide(const WideWs<T>& ws, int R, int n, T delta,
                                 T sum_ew, T sum_e2w2, T& Lp, T& Lpp) {
  const int lane = threadIdx.x % 32;
  const int p1 = ws.p1, ne = ws.ne, ntri = p1 * (p1 + 1) / 2;
  const T *b1 = ws.acc + ntri, *b2 = ws.acc + ne + ntri,
          *b3 = ws.acc + 2 * ne + ntri;
  const T q1 = ws.acc[ne - 1], q2 = ws.acc[2 * ne - 1],
          q3 = ws.acc[3 * ne - 1];
  T *beta = ws.vec, *A2b = beta + p1, *A3b = A2b + p1, *t = A3b + p1,
         *beta_p = t + p1, *A2bp = beta_p + p1;
  chol_wide(ws);
  solve_warp<1>(ws, 1, [&](int i, int) { return b1[i]; },
                [&](int i, int, T x) { beta[i] = x; });
  const T rss = floor_at<FL>(q1 - dot_wide(b1, beta, p1), Tiny<T>::v);
  sym_mv_wide(ws, 1, beta, A2b);
  sym_mv_wide(ws, 2, beta, A3b);
  for (int j = lane; j < p1; j += 32) t[j] = A2b[j] - b2[j];
  __syncwarp();
  solve_warp<1>(ws, 1, [&](int i, int) { return t[i]; },
                [&](int i, int, T x) { beta_p[i] = x; });
  sym_mv_wide(ws, 1, beta_p, A2bp);
  const T s_b2b = dot_wide(b2, beta, p1);
  const T s_bA2b = dot_wide(beta, A2b, p1);
  const T s_b3b = dot_wide(b3, beta, p1);
  const T s_b2bp = dot_wide(b2, beta_p, p1);
  const T s_bA2bp = dot_wide(beta, A2bp, p1);
  const T s_bA3b = dot_wide(beta, A3b, p1);
  const T rss_p = -q2 + T(2) * s_b2b - s_bA2b;
  const T rss_pp = T(2) * q3 - T(4) * s_b3b + T(2) * s_b2bp -
                   T(2) * s_bA2bp + T(2) * s_bA3b;
  const T nR = T(n - R);
  const T i1 = T(1) / delta;
  const T ld_p = sum_ew + nR * i1;
  const T ld_pp = -sum_e2w2 - nR * (i1 * i1);
  const T u = rss_p / rss;
  if (!REML) {
    Lp = T(-0.5) * (T(n) * u + ld_p);
    Lpp = T(-0.5) * (T(n) * (rss_pp / rss - u * u) + ld_pp);
    return;
  }
  // A1^{-1} = X^T X with X = L^{-1} (a lane a column of X, forward from
  // its diagonal: half a solve), then T2 = A1^{-1} A2, both products on
  // the tensor cores; X is held in T2's storage until then
  T *Ainv = ws.Ainv, *T2 = ws.T2, *X = ws.T2;
  for (int kc = lane; kc < p1; kc += 32) {
    for (int i = 0; i < kc; ++i) X[i * p1 + kc] = T(0);
    X[kc * p1 + kc] = ws.rd[kc];
    for (int i = kc + 1; i < p1; ++i) {
      T t = T(0);
      for (int k = kc; k < i; ++k) t -= ws.L[tri(i, k)] * X[k * p1 + kc];
      X[i * p1 + kc] = t * ws.rd[i];
    }
  }
  __syncwarp();
  warp_gemm<T>(
      p1, [&](int r, int c) { return X[c * p1 + r]; },
      [&](int k, int c) { return X[k * p1 + c]; },
      [&](int r, int c, T v) { Ainv[r * p1 + c] = v; });
  const T *A2 = ws.acc + ne, *A3 = ws.acc + 2 * ne;
  auto full = [&](const T* M, int i, int j) {
    return M[i >= j ? tri(i, j) : tri(j, i)];
  };
  T tr2 = 0, tr3 = 0, tr2sq = 0;
  warp_gemm<T>(
      p1, [&](int r, int c) { return Ainv[r * p1 + c]; },
      [&](int k, int c) { return full(A2, k, c); },
      [&](int r, int c, T v) { T2[r * p1 + c] = v; });
  for (int i = lane; i < p1; i += 32) {
    tr2 += T2[i * p1 + i];
    for (int k = 0; k < p1; ++k) tr3 += Ainv[i * p1 + k] * full(A3, k, i);
  }
  for (int e = lane; e < p1 * p1; e += 32) {
    const int i = e / p1, j = e - i * p1;
    tr2sq += T2[i * p1 + j] * T2[j * p1 + i];
  }
  tr2 = warp_sum(tr2);
  tr3 = warp_sum(tr3);
  tr2sq = warp_sum(tr2sq);
  __syncwarp();
  const T nu = T(n - p1);
  Lp = T(-0.5) * (nu * u + ld_p - tr2);
  Lpp = T(-0.5) * (nu * (rss_pp / rss - u * u) + ld_pp + T(2) * tr3 - tr2sq);
}

// The fit at delta from family 0's normal equations in ws.acc and
// logd = sum log d: (lml, rss, beta in ws.vec) with the objective's rss
// floor, on every lane
template <bool REML, bool FLOOR_Q, class FL = Floors<double>>
__device__ double fit_tail_wide(const WideWs<>& ws, int R, double delta, int n,
                                double ld_xx, double logd, double& rss_out,
                                bool& rss_bad) {
  const int lane = threadIdx.x % 32;
  const int p1 = ws.p1, ntri = p1 * (p1 + 1) / 2;
  chol_wide(ws);
  double* beta = ws.vec;
  solve_warp<1>(ws, 1, [&](int i, int) { return ws.acc[ntri + i]; },
                [&](int i, int, double x) { beta[i] = x; });
  const double q = ws.acc[ws.ne - 1];
  double rss = q - dot_wide(ws.acc + ntri, beta, p1);
  rss_bad = rss <= 128 * FL::eps * q;
  if (FLOOR_Q) rss = floor_at<FL>(rss, 128 * FL::eps * q);
  rss = floor_at<FL>(rss, DBL_MIN);
  rss_out = rss;
  const double two_pi = 6.283185307179586;
  const double logdet_d = logd + (n - R) * log(delta);
  if (!REML) return -0.5 * (n * log(two_pi * rss / n) + logdet_d + n);
  double logdet_a = 0;
  for (int i = 0; i < p1; ++i) logdet_a += log(ws.L[tri(i, i)]);
  logdet_a *= 2;
  const double nu = n - p1;
  return -0.5 * (nu * log(two_pi * rss / nu) + logdet_d + logdet_a - ld_xx +
                 nu);
}

// One safeguarded Newton step on logit(delta) from (L', L'') at delta =
// sigmoid(x); lane 0's iterate is the warp's
template <class A>
__device__ void newton_update(A delta, A Lp, A Lpp, A& x, A& lo, A& hi) {
  const A g = delta * (A(1) - delta);
  const A Lx_p = Lp * g;
  const A Lx_pp = Lpp * g * g + Lp * g * (A(1) - A(2) * delta);
  const A lo2 = Lx_p > A(0) ? x : lo;
  const A hi2 = Lx_p > A(0) ? hi : x;
  const A xn = x - Lx_p / Lx_pp;
  // inclusive bounds: at convergence xn == x == a bracket end
  const bool ok = Lx_pp < A(0) && xn >= lo2 && xn <= hi2 && isfinite(xn);
  x = __shfl_sync(FULL, ok ? xn : A(0.5) * (lo2 + hi2), 0);
  lo = __shfl_sync(FULL, lo2, 0);
  hi = __shfl_sync(FULL, hi2, 0);
}

// The fit at delta from its normal equations (ne_finish's sums, logd =
// sum log d): (lml, rss, beta) with the objective's rss floor (FL's: the
// context's eps and, ML, tiny)
template <int P1MAX, bool REML, bool FLOOR_Q, class FL = Floors<double>,
          class PB>
__device__ double fit_sums(const PB& pb, double delta, int n,
                           double ld_xx, const double (&acc)[1][Cfg<P1MAX>::NE],
                           double logd, double* beta, double& rss_out,
                           bool& rss_bad) {
  constexpr int NE = Cfg<P1MAX>::NE, TRI = Cfg<P1MAX>::TRI;
  const int p1 = pb.p + 1;
  double L[P1MAX][P1MAX];
  chol<P1MAX>(L, acc[0], p1);
  chol_solve<P1MAX>(L, acc[0] + TRI, beta, p1);
  const double q = acc[0][NE - 1];
  double rss = q;
  SMALL_FOR(j, 0, p1) rss -= acc[0][TRI + j] * beta[j];
  rss_bad = rss <= 128 * FL::eps * q;
  if (FLOOR_Q) rss = floor_at<FL>(rss, 128 * FL::eps * q);
  rss = floor_at<FL>(rss, REML ? DBL_MIN : FL::ml_tiny);
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

template <class T>
__device__ ProblemT<T> make_problem(const T* CWW, const T* CWy, const T* Cyy,
                                    const T* CWg, const T* Cgy, const T* Cgg,
                                    int s, int R, int p, int nS, bool r32) {
  ProblemT<T> pb;
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
// The register localize (p + 1 < LOC_GEMM_MIN_P1): a block per (tile of
// VT consecutive variants, rho point, tile of GC genes), a warp per
// (variant, gene) problem of the tile, VT GC <= LOC_MAX_WARPS.  The rows
// that the tile's problems share are staged in shared memory, and every
// warp then reads them from there: the rho's S and W, each variant's g,
// each gene's y, and the fields derived from them, S, e, e2 and the W W
// products (shared by all the problems) and each gene's W y and y y
// products (shared by the tile's variants), and, where they fit, each
// variant's g W and g g products (shared by the tile's genes).  The
// products are rounded to f32 there, once a block, where the Newton steps
// round them (round32), instead of once a problem and step; g y, and g W
// and g g where they are not staged, are formed (and rounded) in the
// sums.  The lanes run over the rows with the sums in registers, then the
// xor-shuffle tree and the (p+1)^2 algebra, as in the converge kernel, so
// every value is the one a per-problem loop over the rows computes, in
// the same order.  Where every row fits the block's shared memory (LOC_G:
// one gene and 16 variants, p = 1, R <= 1024; LOC_PRODUCTS, the variants'
// products staged too: 16 genes and 4 variants, 6-7% faster there), the
// rows are staged straight from the tensors twice, for the Newton steps
// and, unrounded, for the final evaluation, and the passes between need
// no barrier and no copy; else (LOC_CHUNKED: 10 000 cells) a chunk of rch
// rows at a time by cp.async into two alternating raw buffers, the next
// chunk in flight while the warps sum the current one.  The argmax over
// rho is loc_argmax_kernel, over the block's outputs (no limit on the rho
// points).
//
// The float32 context (T = float, p + 1 <= 4; the screen's stages 1b and
// 2, engine.py:628-670 on an f32 context) runs the same kernel on f32
// rows: the fields are staged as f32 (S, e = 1 - S, e^2 and the products
// the f32 values the reference forms), so twice the rows fit a block
// (LOC_PRODUCTS with 16 variants up to R = 1056); the Newton steps' weights,
// sums, algebra and state are f32, from the f32-rounded bracket midpoint;
// the final evaluation is f64 on the same staged rows, widened as they
// are loaded (no second staging), its sum log d a log a LOG_GROUP rows, and
// an rss at or below 128 eps(f32) q there cannot win the argmax (:655).
#ifndef CRM_LOC_SMEM_KB  // the emulated tests build some with less, so
#define CRM_LOC_SMEM_KB 227  // that their small R reaches every layout
#endif
constexpr int LOC_SMEM = CRM_LOC_SMEM_KB * 1024;  // of a localize block

// warps of a register localize block: LOC_MAX_WARPS at 128 registers a
// thread, but 8 for the f32 instantiation at p + 1 <= 4, whose f32 step
// sums and f64 evaluation sums need up to 255 (none spilled)
template <class T, int P1MAX>
__host__ __device__ constexpr int loc_warps() {
  return std::is_same<T, float>::value && P1MAX > 2 && LOC_MAX_WARPS > 8
             ? 8 : LOC_MAX_WARPS;
}

// how the localize stages its rows
enum LocStaging { LOC_CHUNKED = 0, LOC_G = 1, LOC_PRODUCTS = 2 };

// the derived fields, in units of rch values: [S, e, e2 | W W products |
// per gene (GC): y, W y (p), y y]
__host__ __device__ inline int loc_fields(int p, int gc) {
  return 3 + p * (p + 1) / 2 + gc * (p + 2);
}
// a raw buffer, in units of rch values: [S | W (p) | g (VT) | y (GC)];
// resident, after the fields, LOC_G: [W (p) | g (VT)], LOC_PRODUCTS: [g
// (VT) | per variant: g W (p), g g]
__host__ __device__ inline int loc_raw(int p, int vt, int gc) {
  return 1 + p + vt + gc;
}
__host__ __device__ inline int loc_resident(int p, int vt, int layout) {
  return layout == LOC_PRODUCTS ? vt * (p + 2) : p + vt;
}

// cp.async of one value of the operand type
__device__ __forceinline__ void cp_async_val(double* s, const double* g) {
  cp_async8(s, g);
}
__device__ __forceinline__ void cp_async_val(float* s, const float* g) {
  cp_async4(s, g);
}

// rows [0, R) of rho o from the tensors, resident: the fields (rounded
// when r32), then the tile's g at gv and W at gv - p rch, or with
// `products` the variants' g W and g g (rounded) after the g
template <class T>
__device__ void loc_stage(T* sm, T* gv, int rch, const T* __restrict__ Sv,
                          const T* __restrict__ WGt,
                          const T* __restrict__ yt, int o, int R, int p,
                          int nS, int nrho, int s0, int nv, int vt, int g0,
                          int ng, bool products, bool r32) {
  const int nt = blockDim.x, tid = threadIdx.x;
  const int ps = p + nS, ntri = p * (p + 1) / 2;
  const T* Wo = WGt + (int64_t)o * R * ps;
  for (int r = tid; r < R; r += nt) {
    const T Sr = Sv[(int64_t)o * R + r];
    sm[r] = rnd(Sr, r32);
    sm[rch + r] = one_minus(Sr, r32);
    sm[2 * rch + r] = e_sq(Sr, r32);
    const T* row = Wo + (int64_t)r * ps;
    for (int i = 0; i < p; ++i) {
      if (!products) gv[(i - p) * rch + r] = row[i];
      for (int j = 0; j <= i; ++j)
        sm[(3 + tri(i, j)) * rch + r] = prod(row[i], row[j], r32);
    }
  }
  // the variants' genotype, each row's nv values contiguous
  for (int e = tid; e < R * nv; e += nt) {
    const int r = e / nv, v = e - r * nv;
    const T* row = Wo + (int64_t)r * ps;
    const T g = row[p + s0 + v];
    gv[v * rch + r] = g;
    if (!products) continue;
    T* f = gv + (vt + v * (p + 1)) * rch + r;
    for (int j = 0; j < p; ++j) f[j * rch] = prod(g, row[j], r32);
    f[p * rch] = prod(g, g, r32);
  }
  // the genes' phenotype, each gene's rows contiguous
  for (int e = tid; e < R * ng; e += nt) {
    const int c = e / R, r = e - c * R;
    const T* row = Wo + (int64_t)r * ps;
    const T y = yt[((int64_t)(g0 + c) * nrho + o) * R + r];
    T* f = sm + (3 + ntri + c * (p + 2)) * rch + r;
    f[0] = y;
    for (int j = 0; j < p; ++j) f[(1 + j) * rch] = prod(row[j], y, r32);
    f[(p + 1) * rch] = prod(y, y, r32);
  }
}

// f32 rows, resident LOC_G: the raw rows (S, each gene's y at its first
// field, the rho's W and the tile's g) by cp.async into their places, then
// the derived fields (e, e2 and the W W, W y and y y products) from shared
// memory: no global load sits on a thread's path
__device__ void loc_stage_g32(float* sm, float* gv, int rch,
                              const float* __restrict__ Sv,
                              const float* __restrict__ WGt,
                              const float* __restrict__ yt, int o, int R,
                              int p, int nS, int nrho, int s0, int nv, int g0,
                              int ng) {
  const int nt = blockDim.x, tid = threadIdx.x;
  const int ps = p + nS, ntri = p * (p + 1) / 2;
  const float* Wo = WGt + (int64_t)o * R * ps;
  for (int e = tid; e < R * (1 + ng); e += nt) {
    const int c = e / R, r = e - c * R;
    if (c == 0)
      cp_async4(sm + r, Sv + (int64_t)o * R + r);
    else
      cp_async4(sm + (3 + ntri + (c - 1) * (p + 2)) * rch + r,
                yt + ((int64_t)(g0 + c - 1) * nrho + o) * R + r);
  }
  // a row's W and the tile's g: p and nv values, contiguous in the row
  const int w = p + nv;
  for (int e = tid; e < R * w; e += nt) {
    const int r = e / w, j = e - r * w;
    cp_async4(gv + (j - p) * rch + r,
              Wo + (int64_t)r * ps + (j < p ? j : s0 + j));
  }
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  const float* W = gv - p * rch;
  for (int r = tid; r < R; r += nt) {
    const float e = 1.0f - sm[r];
    sm[rch + r] = e;
    sm[2 * rch + r] = e * e;
    for (int i = 0; i < p; ++i)
      for (int j = 0; j <= i; ++j)
        sm[(3 + tri(i, j)) * rch + r] = W[i * rch + r] * W[j * rch + r];
  }
  for (int e = tid; e < R * ng; e += nt) {
    const int c = e / R, r = e - c * R;
    float* f = sm + (3 + ntri + c * (p + 2)) * rch + r;
    const float y = f[0];
    for (int j = 0; j < p; ++j) f[(1 + j) * rch] = W[j * rch + r] * y;
    f[(p + 1) * rch] = y * y;
  }
}

// cp.async of rows [r0, r0 + rows) of rho o into the raw buffer
template <class T>
__device__ void loc_fetch(T* raw, int rch, const T* __restrict__ Sv,
                          const T* __restrict__ WGt,
                          const T* __restrict__ yt, int o, int r0,
                          int rows, int R, int p, int nS, int nrho, int s0,
                          int nv, int vt, int g0, int ng) {
  const int nt = blockDim.x, tid = threadIdx.x;
  const int ps = p + nS;
  const T* Wo = WGt + ((int64_t)o * R + r0) * ps;
  // S and the genes' y: rows contiguous
  for (int e = tid; e < rows * (1 + ng); e += nt) {
    const int c = e / rows, rr = e - c * rows;
    const T* src =
        c == 0 ? Sv + (int64_t)o * R + r0 + rr
               : yt + ((int64_t)(g0 + c - 1) * nrho + o) * R + r0 + rr;
    cp_async_val(raw + (c == 0 ? 0 : p + vt + c) * rch + rr, src);
  }
  // a row's W and the tile's g: p and nv values, at W's columns and the
  // variants' (contiguous)
  const int w = p + nv;
  for (int e = tid; e < rows * w; e += nt) {
    const int rr = e / w, j = e - rr * w;
    cp_async_val(raw + (1 + j) * rch + rr,
                 Wo + (int64_t)rr * ps + (j < p ? j : s0 + j));
  }
}

// the fields of a chunk's rows from its raw buffer (rounded when r32)
template <class T>
__device__ void loc_derive(T* sm, const T* raw, int rch, int rows, int p,
                           int vt, int ng, bool r32) {
  const int nt = blockDim.x, tid = threadIdx.x;
  const int ntri = p * (p + 1) / 2;
  const T* W = raw + rch;
  for (int rr = tid; rr < rows; rr += nt) {
    const T Sr = raw[rr];
    sm[rr] = rnd(Sr, r32);
    sm[rch + rr] = one_minus(Sr, r32);
    sm[2 * rch + rr] = e_sq(Sr, r32);
    for (int i = 0; i < p; ++i)
      for (int j = 0; j <= i; ++j)
        sm[(3 + tri(i, j)) * rch + rr] =
            prod(W[i * rch + rr], W[j * rch + rr], r32);
  }
  for (int e = tid; e < rows * ng; e += nt) {
    const int c = e / rows, rr = e - c * rows;
    const T y = raw[(1 + p + vt + c) * rch + rr];
    T* f = sm + (3 + ntri + c * (p + 2)) * rch + rr;
    f[0] = y;
    for (int j = 0; j < p; ++j) f[(1 + j) * rch] = prod(W[j * rch + rr], y, r32);
    f[(p + 1) * rch] = prod(y, y, r32);
  }
}

// a lane's staged rows [0, rows) into the sums of problem (v, c), in the
// arithmetic type A: the fields at sm, the tile's (vt) g at gv, and W at
// gv - p rch or, PRODUCTS, the variants' g W and g g after the g.  The f64
// evaluation of f32 rows (NF == 1) takes a log a LOG_GROUP rows' d.
template <int P1MAX, int NF, bool PRODUCTS, class A, class T>
__device__ void loc_rows(const T* sm, const T* gv, int rch, int rows, int p,
                         int vt, int v, int c, A delta, bool r32,
                         A (&acc)[NF][Cfg<P1MAX>::NE], A& ex1, A& ex2) {
  constexpr int NE = Cfg<P1MAX>::NE, TRI = Cfg<P1MAX>::TRI;
  constexpr bool GROUPED = NF == 1 && std::is_same<T, float>::value;
  const int p1 = p + 1, ntri = p * (p + 1) / 2;
  const T* fv = gv + v * rch;
  const T* fw = gv - p * rch;
  const T* gp = gv + (vt + v * p1) * rch;
  const T* fc = sm + (3 + ntri + c * (p + 2)) * rch;
  A dprod = A(1);
  int nprod = 0;
  for (int rr = threadIdx.x % 32; rr < rows; rr += 32) {
    const A d = (A(1) - delta) * A(sm[rr]) + delta;
    const A w1 = weight<A, T>(d);
    A wf[NF];
    wf[0] = w1;
    if constexpr (NF == 3) {
      const A e = sm[rch + rr];
      const A e2 = sm[2 * rch + rr];
      wf[1] = e * w1 * w1;
      wf[2] = e2 * w1 * w1 * w1;
      ex1 += w1 * e;
      ex2 += w1 * w1 * e2;
    } else if constexpr (GROUPED) {
      dprod *= d;
      if (++nprod == LOG_GROUP) {
        ex1 += log(dprod);
        dprod = A(1);
        nprod = 0;
      }
    } else {
      ex1 += log(d);
    }
    const T g = fv[rr], y = fc[rr];
    SMALL_FOR(i, 0, p1) {
      SMALL_FOR(j, 0, i + 1) {
        const A x =
            i < p      ? sm[(3 + tri(i, j)) * rch + rr]
            : PRODUCTS ? gp[j * rch + rr]
                       : prod(g, j < p ? fw[j * rch + rr] : g, r32);
        for (int f = 0; f < NF; ++f) acc[f][tri(i, j)] += wf[f] * x;
      }
      const A x = i < p ? fc[(1 + i) * rch + rr] : prod(g, y, r32);
      for (int f = 0; f < NF; ++f) acc[f][TRI + i] += wf[f] * x;
    }
    const A x = fc[(p + 1) * rch + rr];
    for (int f = 0; f < NF; ++f) acc[f][NE - 1] += wf[f] * x;
  }
  if constexpr (GROUPED) ex1 += log(dprod);
}

// the staged rows: the fields (f rch values), then, resident, W, the
// tile's g and its products (w rch values), or, chunked, two raw buffers
// (w each)
template <class T>
struct LocStage {
  T* sm;
  int rch, f, w, layout;
  __device__ T* raw(int c) const { return sm + (f + (c & 1) * w) * rch; }
};

// one pass of every problem of the block over the rows: its NF families'
// sums (the lanes' parts; ne_finish adds them up).  Resident: `stage`
// makes the fields (else they are there from an earlier pass).  Chunked:
// the chunks' raw rows are copied and their fields derived.
template <int P1MAX, int NF, class A, class T>
__device__ void loc_pass(const LocStage<T>& st, bool stage, bool active,
                         const T* Sv, const T* WGt, const T* yt, int o,
                         int R, int p, int nS, int nrho, int s0, int nv,
                         int vt, int g0, int ng, int v, int c, A delta,
                         bool r32, A (&acc)[NF][Cfg<P1MAX>::NE], A& ex1,
                         A& ex2) {
  for (int f = 0; f < NF; ++f)
    for (int e = 0; e < Cfg<P1MAX>::NE; ++e) acc[f][e] = A(0);
  ex1 = A(0);
  ex2 = A(0);
  const int rch = st.rch;
  if (st.layout != LOC_CHUNKED) {
    const bool products = st.layout == LOC_PRODUCTS;
    T* gv = st.sm + (st.f + (products ? 0 : p)) * rch;
    if (stage) {
      __syncthreads();  // every warp is done with the previous fields
      if constexpr (std::is_same<T, float>::value)  // LOC_G: see the launch
        loc_stage_g32(st.sm, gv, rch, Sv, WGt, yt, o, R, p, nS, nrho, s0,
                      nv, g0, ng);
      else
        loc_stage(st.sm, gv, rch, Sv, WGt, yt, o, R, p, nS, nrho, s0, nv,
                  vt, g0, ng, products, r32);
      __syncthreads();
    }
    if (active && products)
      loc_rows<P1MAX, NF, true>(st.sm, gv, rch, R, p, vt, v, c, delta, r32,
                                acc, ex1, ex2);
    else if (active)
      loc_rows<P1MAX, NF, false>(st.sm, gv, rch, R, p, vt, v, c, delta, r32,
                                 acc, ex1, ex2);
    return;
  }
  const int chunks = (R + rch - 1) / rch;
  __syncthreads();  // every warp is done with the last pass's raw rows
  loc_fetch(st.raw(0), rch, Sv, WGt, yt, o, 0, min(rch, R), R, p, nS, nrho,
            s0, nv, vt, g0, ng);
  cp_async_commit();
  for (int k = 0; k < chunks; ++k) {
    const int r0 = k * rch, rows = min(rch, R - r0);
    cp_async_wait<0>();
    __syncthreads();  // the chunk landed; every warp is done with the
                      // previous chunk's fields and raw rows
    if (k + 1 < chunks)  // the next chunk in flight during this one
      loc_fetch(st.raw(k + 1), rch, Sv, WGt, yt, o, r0 + rch,
                min(rch, R - r0 - rch), R, p, nS, nrho, s0, nv, vt, g0, ng);
    cp_async_commit();
    loc_derive(st.sm, st.raw(k), rch, rows, p, vt, ng, r32);
    __syncthreads();
    if (active)  // the fields, and W and g from the raw rows
      loc_rows<P1MAX, NF, false>(st.sm, st.raw(k) + (1 + p) * rch, rch,
                                 rows, p, vt, v, c, delta, r32, acc, ex1,
                                 ex2);
  }
}

// T: the operands' type, which is also the Newton steps' arithmetic (f64,
// or f32 on the float32 context); the final evaluation is f64
template <class T, int P1MAX>
__global__ void __launch_bounds__(32 * loc_warps<T, P1MAX>(), 1)
localize_kernel(const T* __restrict__ Sv, const T* __restrict__ WGt,
                const T* __restrict__ yt, const T* __restrict__ CWW,
                const T* __restrict__ CWy, const T* __restrict__ Cyy,
                const T* __restrict__ CWg, const T* __restrict__ Cgy,
                const T* __restrict__ Cgg, const T* __restrict__ ld_xx,
                const double* __restrict__ br_lo,
                const double* __restrict__ br_hi, double* __restrict__ x_out,
                double* __restrict__ lml_out, int n, int nrho, int R, int p,
                int nS, int genes, int steps, int r32, int vt, int gc,
                int rch, int layout) {
  extern __shared__ __align__(16) unsigned char loc_dyn[];
  const LocStage<T> st{reinterpret_cast<T*>(loc_dyn), rch, loc_fields(p, gc),
                       layout == LOC_CHUNKED ? loc_raw(p, vt, gc)
                                             : loc_resident(p, vt, layout),
                       layout};
  constexpr int NE = Cfg<P1MAX>::NE;
  using FL = Floors<T>;  // the context's floors
  const int s0 = blockIdx.x * vt, o = blockIdx.y, g0 = blockIdx.z * gc;
  const int nv = min(vt, nS - s0), ng = min(gc, genes - g0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int v = warp % vt, c = warp / vt;
  const bool active = v < nv && c < ng;
  const int s = s0 + min(v, nv - 1), gi = g0 + min(c, ng - 1);
  const int64_t so = ((int64_t)gi * nS + s) * nrho + o;
  T lo = T(br_lo[so]), hi = T(br_hi[so]);
  T x = T(0.5) * (lo + hi);
  // the problem's complements (gene gi, variant s); its rows are staged
  const ProblemT<T> pb32 =
      make_problem(CWW, CWy + (int64_t)gi * p, Cyy + gi, CWg,
                   Cgy + (int64_t)gi * nS, Cgg, s, R, p, nS, r32 != 0);
  // stage 1b: Newton on the (possibly f32-rounded) tensors
  for (int it = 0; it < steps; ++it) {
    const T delta = sigmoid(x);
    T acc[3][NE], ex1, ex2;
    loc_pass<P1MAX, 3>(st, it == 0, active, Sv, WGt, yt, o, R, p, nS, nrho,
                       s0, nv, vt, g0, ng, v, c, delta, r32 != 0, acc, ex1,
                       ex2);
    if (active) {
      ne_finish<P1MAX, 3>(pb32, delta, acc, ex1, ex2);
      T Lp, Lpp;
      derivs_sums<P1MAX, true, FL>(pb32, delta, n, acc, ex1, ex2, Lp, Lpp);
      newton_update(delta, Lp, Lpp, x, lo, hi);
    }
  }
  // stage 2: one f64 evaluation on the unrounded tensors
  ProblemT<T> pb = pb32;
  pb.r32 = false;
  pb.cyy = Cyy[gi];
  const double delta = sigmoid((double)x);
  double acc[1][NE], logd, unused;
  loc_pass<P1MAX, 1>(st, steps == 0 || r32, active, Sv, WGt, yt, o, R, p,
                     nS, nrho, s0, nv, vt, g0, ng, v, c, delta, false, acc,
                     logd, unused);
  if (!active) return;
  ne_finish<P1MAX, 1>(pb, delta, acc, logd, unused);
  double beta[P1MAX], rss;
  bool bad;
  double lml = fit_sums<P1MAX, true, false, FL>(pb, delta, n, ld_xx[s], acc,
                                                logd, beta, rss, bad);
  // noise-floor or NaN evaluations must not win the rho argmax (:664-666)
  if (bad || !isfinite(lml)) lml = -INFINITY;
  if (lane == 0) {
    x_out[so] = x;
    lml_out[so] = lml;
  }
}

// ---------------------------------------------------------------------------
// The product route of the localize (p + 1 >= LOC_GEMM_MIN_P1, up to 33).
//
// Of a problem's 3 x (p + 2)(p + 3)/2 weighted sums, those over the pairs of
// [W, y] (W W, W y, y y: 325 of 351 at p = 24) are, for every variant at
// one rho, the same row products P_o[r, ab] = rnd(x_a x_b) under the
// problem's own weights: sum_r w_f[s, o, r] P_o[r, ab].  So each Newton
// step is, per rho, one product of the (3 S x R) weights and the (R x
// npp) pairs on the FP64 tensor cores (loc_gemm_kernel; 2.1e10 flop a step
// at p = 24, 21 rho, 512 variants), with the weights made in the A
// fragments from the problem's delta and the staged eigenvalue rows (one
// division a (variant, row) for the three families) and P_o staged by a
// cp.async ring.  The p + 2 sums with the genotype (W g, g g, g y) and the
// log-determinant sums are a pass of their own (loc_gsums_kernel, a lane a
// variant, warps over the pairs).  The algebra of each problem and its
// safeguarded update are the epilogue (loc_epilogue_kernel, a warp a
// problem, the wide workspace code above).  P_o is formed once a call
// (rounded to f32 for the steps when round32, and unrounded for the final
// f64 evaluation), per gene of a gene-batched call; a gene's launches run
// one after another from crm_reml_localize, with no host between them.
// The scratch (P, the sums, the bracket state) is one allocation, sized by
// crm_reml_localize_workspace.  What bounds it: the pair product is
// operations on the tensor cores; the genotype's pass and the epilogue
// (the Cholesky's column steps, the substitutions) are latency, a warp a
// problem, with as many warps an SM as their workspaces fit.  Rounding
// points are those of the plain version: f64 arithmetic on f32-rounded S,
// e, e2, products and complements when round32; the order of the sums
// differs, and the substitutions multiply by 1 / L[i][i] where the plain
// version divides, and form A1^{-1} as X^T X with X = L^{-1}.
// ---------------------------------------------------------------------------
constexpr int LOC_GEMM_MIN_P1 = 5;  // p + 1 from which the route is taken
#ifndef CRM_LOC_GEMM_WARPS  // the emulated tests build with fewer
#define CRM_LOC_GEMM_WARPS 4
#endif
constexpr int GW = CRM_LOC_GEMM_WARPS;  // warps of a product block
constexpr int GV = 16 * GW;         // variants of a product block
constexpr int PT = 32;              // pairs of a product block
constexpr int GRC = 32;             // rows of a staged chunk
constexpr int GSTAGES = 3;          // chunks in flight
constexpr int LDP = PT + 4;         // 4 mod 16 doubles: no bank conflicts
constexpr int GPASS_WARPS = 8;      // warps of a genotype-pass block

__host__ __device__ inline int loc_npp(int p) {  // pairs of [W, y]
  return (p + 1) * (p + 2) / 2;
}
__host__ __device__ inline int loc_nppad(int p) {
  return (loc_npp(p) + PT - 1) / PT * PT;
}
__host__ __device__ inline int loc_gs(int p) {  // a problem's genotype sums
  return 3 * (p + 2) + 2;
}

// the scratch, in doubles
struct LocLayout {
  int64_t p32, p64, sum, gs, lo, hi, total;
};

inline LocLayout loc_layout(int nrho, int R, int p, int nS, bool r32) {
  LocLayout L;
  const int64_t np = (int64_t)nrho * R * loc_nppad(p);
  const int64_t probs = (int64_t)nS * nrho;
  L.p32 = 0;
  L.p64 = r32 ? np : 0;
  L.sum = r32 ? 2 * np : np;
  L.gs = L.sum + probs * 3 * loc_nppad(p);
  L.lo = L.gs + probs * loc_gs(p);
  L.hi = L.lo + probs;
  L.total = L.hi + probs;
  return L;
}

// P[o, r, e] = x_a x_b over the pairs e = tri(a, b) of [W, y] (zero past
// npp), rounded to f32 into P32 when r32 (P64 the unrounded products)
__global__ void loc_products_kernel(const double* __restrict__ WGt,
                                    const double* __restrict__ yt,
                                    double* __restrict__ P32,
                                    double* __restrict__ P64, int R, int p,
                                    int nS, int r32) {
  const int o = blockIdx.y;
  const int npp = loc_npp(p), nppad = loc_nppad(p);
  const int64_t total = (int64_t)R * nppad;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < total;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int r = (int)(i / nppad), e = (int)(i - (int64_t)r * nppad);
    double v = 0.0;
    if (e < npp) {
      int a = 0;
      while ((a + 1) * (a + 2) / 2 <= e) ++a;
      const int b = e - a * (a + 1) / 2;
      const double* row = WGt + ((int64_t)o * R + r) * (p + nS);
      const double yv = yt[(int64_t)o * R + r];
      v = (a < p ? row[a] : yv) * (b < p ? row[b] : yv);
    }
    const int64_t at = (int64_t)o * total + i;
    if (r32) {
      P32[at] = (double)(float)v;
      P64[at] = v;
    } else {
      P32[at] = v;
    }
  }
}

// the bracket state: x at the midpoint of each (s, o) problem's bracket
__global__ void loc_init_kernel(const double* __restrict__ br_lo,
                                const double* __restrict__ br_hi,
                                double* __restrict__ x,
                                double* __restrict__ lo,
                                double* __restrict__ hi, int64_t probs) {
  const int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (i >= probs) return;
  lo[i] = br_lo[i];
  hi[i] = br_hi[i];
  x[i] = 0.5 * (br_lo[i] + br_hi[i]);
}

// sum[o, s, f, e] = sum_r w_f(delta_so, S_or) P[o, r, e]: a block a (64
// variants, 32 pairs, rho), a warp 16 variants x NF families x 32 pairs
template <int NF>
__global__ void __launch_bounds__(32 * GW)
loc_gemm_kernel(const double* __restrict__ Sv, const double* __restrict__ P,
                const double* __restrict__ x, double* __restrict__ sum,
                int nrho, int R, int p, int nS, int r32) {
  __align__(16) __shared__ double ps[GSTAGES][GRC * LDP];
  __shared__ double srow[GSTAGES][3][GRC];  // S, e, e2 of the chunk's rows
  const int nppad = loc_nppad(p);
  const int e0 = blockIdx.x * PT;
  const int o = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int sw = blockIdx.y * GV + warp * 16;  // the warp's first variant
  const bool active = sw < nS;                 // warp-uniform
  const double* Po = P + (int64_t)o * R * nppad;
  const double* So = Sv + (int64_t)o * R;
  // the deltas of the warp's rows g and g + 8 (a variant past nS: any)
  double dl[2], om[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int sv = min(sw + g + 8 * h, nS - 1);
    dl[h] = sigmoid(x[(int64_t)sv * nrho + o]);
    om[h] = 1.0 - dl[h];
  }

  auto load = [&](int b, int chunk) {
    const int r0 = chunk * GRC;
    for (int i = threadIdx.x; i < GRC * PT / 2; i += 32 * GW) {
      const int rr = i / (PT / 2), c = 2 * (i - rr * (PT / 2));
      double* d = &ps[b][rr * LDP + c];
      if (r0 + rr < R) {
        cp_async16(d, Po + (int64_t)(r0 + rr) * nppad + e0 + c);
      } else {
        d[0] = 0.0;
        d[1] = 0.0;
      }
    }
    for (int rr = threadIdx.x; rr < GRC; rr += 32 * GW) {
      const double Sr = r0 + rr < R ? So[r0 + rr] : 1.0;  // e = 0 past R
      srow[b][0][rr] = rnd(Sr, r32);
      srow[b][1][rr] = rnd(1.0 - Sr, r32);
      srow[b][2][rr] = rnd((1.0 - Sr) * (1.0 - Sr), r32);
    }
  };

  double acc[NF][4][4];
#pragma unroll
  for (int f = 0; f < NF; ++f)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[f][nt][i] = 0.0;

  const int chunks = (R + GRC - 1) / GRC;
#pragma unroll
  for (int c = 0; c < GSTAGES - 1; ++c) {
    if (c < chunks) load(c, c);
    cp_async_commit();
  }
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait<GSTAGES - 2>();
    __syncthreads();
    const int next = c + GSTAGES - 1;
    if (next < chunks) load(next % GSTAGES, next);
    cp_async_commit();
    const int b = c % GSTAGES;
    if (!active) continue;
    const int steps = min(GRC, R - c * GRC);  // rows of the chunk
    for (int k8 = 0; k8 < steps; k8 += 8) {
      // A fragment i: variant row g + 8 (i & 1), eigen row k8 + t + 4 (i >> 1)
      double a[NF][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int rr = k8 + t + 4 * (i >> 1), h = i & 1;
        const double d = om[h] * srow[b][0][rr] + dl[h];
        const double w1 = 1.0 / d;
        a[0][i] = w1;
        if constexpr (NF == 3) {
          a[1][i] = srow[b][1][rr] * w1 * w1;
          a[2][i] = srow[b][2][rr] * w1 * w1 * w1;
        }
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const double bf[2] = {ps[b][(k8 + t) * LDP + nt * 8 + g],
                              ps[b][(k8 + t + 4) * LDP + nt * 8 + g]};
#pragma unroll
        for (int f = 0; f < NF; ++f) dmma_m16n8k8(acc[f][nt], a[f], bf);
      }
    }
  }
  cp_async_wait<0>();
  if (!active) return;
  // d[i]: variant row g + 8 (i >> 1), pair 2t + (i & 1) of tile nt
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = sw + g + 8 * (i >> 1);
    if (s >= nS) continue;
    double* out = sum + ((int64_t)o * nS + s) * 3 * nppad + e0;
#pragma unroll
    for (int f = 0; f < NF; ++f)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        out[f * nppad + nt * 8 + 2 * t + (i & 1)] = acc[f][nt][i];
  }
}

// The genotype's sums of a problem: sum_r w_f rnd(x_a g) for x_a = W_j
// (j < p), g, y, and sum e w1, sum e2 w1^2 (NF == 3) or sum log d: a block
// a (32 variants, rho), a lane a variant, warps over the pairs; a chunk's
// rows, genotypes and weights are staged in shared memory (each weight
// formed once), and the warps' partial log-determinant sums are added in
// warp order (no atomics).  (Holding all of a variant's pairs in registers
// with the warps over the rows instead was 2.2x slower on an H100 80GB
// HBM3 at 700 W: 162 registers left one block an SM, and each chunk's
// staging stood exposed.)
template <int NF>
__global__ void __launch_bounds__(32 * GPASS_WARPS)
loc_gsums_kernel(const double* __restrict__ Sv, const double* __restrict__ WGt,
                 const double* __restrict__ yt, const double* __restrict__ x,
                 double* __restrict__ gs, int nrho, int R, int p, int nS,
                 int r32) {
  constexpr int RCH = 32;                    // rows a chunk
  constexpr int EPT = (33 + 2 + GPASS_WARPS - 1) / GPASS_WARPS;  // pairs
  __shared__ double xs[RCH][34];             // [W, y] of the chunk's rows
  __shared__ double gv[RCH][32];             // g of the block's variants
  __shared__ double wt[NF][RCH][32];         // the weight families
  __shared__ double ex[2][GPASS_WARPS][32];
  const int o = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int s = blockIdx.x * 32 + lane;
  const int sl = min(s, nS - 1);
  const int ng = p + 2, ps = p + nS;
  const double dl = sigmoid(x[(int64_t)sl * nrho + o]);
  const double* So = Sv + (int64_t)o * R;
  const double* Wo = WGt + (int64_t)o * R * ps;
  double acc[NF][EPT], ex1 = 0.0, ex2 = 0.0;
#pragma unroll
  for (int f = 0; f < NF; ++f)
#pragma unroll
    for (int k = 0; k < EPT; ++k) acc[f][k] = 0.0;
  for (int r0 = 0; r0 < R; r0 += RCH) {
    const int rows = min(RCH, R - r0);
    for (int i = threadIdx.x; i < rows * (p + 1); i += blockDim.x) {
      const int rr = i / (p + 1), j = i - rr * (p + 1);
      xs[rr][j] = j < p ? Wo[(int64_t)(r0 + rr) * ps + j]
                        : yt[(int64_t)o * R + r0 + rr];
    }
    // a thread's (row, variant) pairs keep its lane's variant
    for (int rr = warp; rr < rows; rr += GPASS_WARPS) {
      const int r = r0 + rr;
      gv[rr][lane] = Wo[(int64_t)r * ps + p + sl];
      const double Sr = So[r];
      const double d = (1.0 - dl) * rnd(Sr, r32) + dl;
      const double w1 = 1.0 / d;
      wt[0][rr][lane] = w1;
      if constexpr (NF == 3) {
        const double e = rnd(1.0 - Sr, r32);
        const double e2 = rnd((1.0 - Sr) * (1.0 - Sr), r32);
        wt[1][rr][lane] = e * w1 * w1;
        wt[2][rr][lane] = e2 * w1 * w1 * w1;
        ex1 += w1 * e;
        ex2 += w1 * w1 * e2;
      } else {
        ex1 += log(d);
      }
    }
    __syncthreads();
    for (int rr = 0; rr < rows; ++rr) {
      const double gval = gv[rr][lane];
#pragma unroll
      for (int k = 0; k < EPT; ++k) {
        const int a = warp + GPASS_WARPS * k;
        if (a >= ng) break;
        const double xa = a < p ? xs[rr][a] : (a == p ? gval : xs[rr][p]);
        const double v = rnd(xa * gval, r32);
#pragma unroll
        for (int f = 0; f < NF; ++f) acc[f][k] += wt[f][rr][lane] * v;
      }
    }
    __syncthreads();
  }
  ex[0][warp][lane] = ex1;
  ex[1][warp][lane] = ex2;
  __syncthreads();
  if (s >= nS) return;
  double* out = gs + ((int64_t)o * nS + s) * loc_gs(p);
#pragma unroll
  for (int k = 0; k < EPT; ++k) {
    const int a = warp + GPASS_WARPS * k;
    if (a >= ng) break;
#pragma unroll
    for (int f = 0; f < NF; ++f) out[f * ng + a] = acc[f][k];
  }
  if (warp < 2) {  // the warps' partial log-determinant sums, in order
    double v = 0.0;
    for (int w = 0; w < GPASS_WARPS; ++w) v += ex[warp][w][lane];
    out[3 * ng + warp] = v;
  }
}

// The algebra of each (s, o) problem from its sums, a warp a problem:
// FINAL == false, one safeguarded Newton step of the REML objective on
// the bracket state (x, lo, hi); FINAL == true, the f64 REML lml at x
// (-inf where rss is at the noise floor or the lml is not finite).
template <bool FINAL>
__global__ void __launch_bounds__(32 * WIDE_LOC_WARPS)
loc_epilogue_kernel(const double* __restrict__ sum,
                    const double* __restrict__ gs,
                    const double* __restrict__ CWW,
                    const double* __restrict__ CWy,
                    const double* __restrict__ Cyy,
                    const double* __restrict__ CWg,
                    const double* __restrict__ Cgy,
                    const double* __restrict__ Cgg,
                    const double* __restrict__ ld_xx, double* __restrict__ x,
                    double* __restrict__ lo, double* __restrict__ hi,
                    double* __restrict__ lml_out, int n, int nrho, int R,
                    int p, int nS, int r32) {
  extern __shared__ __align__(16) unsigned char epi_dyn[];
  // the row a of each lower-triangle entry e = tri(a, b), once a block
  __shared__ unsigned char tri_row[WIDE_P1MAX * (WIDE_P1MAX + 1) / 2];
  constexpr int NF = FINAL ? 1 : 3;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int a = warp; a <= p; a += blockDim.x / 32)
    for (int b = lane; b <= a; b += 32) tri_row[tri(a, b)] = (unsigned char)a;
  __syncthreads();
  const int64_t pid = (int64_t)blockIdx.x * (blockDim.x / 32) + warp;
  if (pid >= (int64_t)nS * nrho) return;  // whole warps: no block barrier
  const int s = (int)(pid / nrho), o = (int)(pid - (int64_t)s * nrho);
  const int p1 = p + 1, ng = p + 2, nppad = loc_nppad(p);
  const WideWs<> ws = wide_ws(reinterpret_cast<double*>(epi_dyn) +
                                (int64_t)warp * epi_words(p1), p1);
  const int ne = ws.ne, ntri = p1 * (p1 + 1) / 2, ntw = p * (p + 1) / 2;
  const double* su = sum + ((int64_t)o * nS + s) * 3 * nppad;
  const double* gp = gs + ((int64_t)o * nS + s) * loc_gs(p);
  const double xv = x[pid];
  const double delta = sigmoid(xv);
  const double i1 = 1.0 / delta;
  // entry e of [A lower | b | q] over [W, g], y, complements included
#pragma unroll 4  // the loads of several entries in flight at once
  for (int e = lane; e < ne; e += 32) {
    double v[NF], c;
    if (e < ntri) {
      const int a = tri_row[e], b = e - a * (a + 1) / 2;
      if (a < p) {
        for (int f = 0; f < NF; ++f) v[f] = su[f * nppad + e];
        c = CWW[a * p + b];
      } else {
        for (int f = 0; f < NF; ++f) v[f] = gp[f * ng + b];  // W_b g, g g
        c = b < p ? CWg[(int64_t)b * nS + s] : Cgg[s];
      }
      c = rnd(c, r32);
    } else if (e < ntri + p1) {
      const int i = e - ntri;
      if (i < p) {
        for (int f = 0; f < NF; ++f) v[f] = su[f * nppad + ntw + i];
        c = CWy[i];
      } else {
        for (int f = 0; f < NF; ++f) v[f] = gp[f * ng + p + 1];  // g y
        c = Cgy[s];
      }
      c = rnd(c, r32);
    } else {
      for (int f = 0; f < NF; ++f) v[f] = su[f * nppad + ntw + p];  // y y
      c = rnd(Cyy[0], r32);
    }
    double ic = i1;
    for (int f = 0; f < NF; ++f) {
      ws.acc[f * ne + e] = v[f] + c * ic;
      ic *= i1;
    }
  }
  __syncwarp();
  const double ex1 = gp[3 * ng], ex2 = gp[3 * ng + 1];
  if constexpr (FINAL) {
    double rss;
    bool bad;
    double lml = fit_tail_wide<true, false>(ws, R, delta, n, ld_xx[s], ex1,
                                            rss, bad);
    if (bad || !isfinite(lml)) lml = -INFINITY;
    if (lane == 0) lml_out[pid] = lml;
  } else {
    double Lp, Lpp;
    derivs_tail_wide<true>(ws, R, n, delta, ex1, ex2, Lp, Lpp);
    if (lane == 0) {
      const double l = lo[pid], h = hi[pid];
      const double gsg = delta * (1 - delta);
      const double Lx_p = Lp * gsg;
      const double Lx_pp = Lpp * gsg * gsg + Lp * gsg * (1 - 2 * delta);
      const double lo2 = Lx_p > 0 ? xv : l;
      const double hi2 = Lx_p > 0 ? h : xv;
      const double xn = xv - Lx_p / Lx_pp;
      // inclusive bounds: at convergence xn == x == a bracket end
      const bool ok = Lx_pp < 0 && xn >= lo2 && xn <= hi2 && isfinite(xn);
      x[pid] = ok ? xn : 0.5 * (lo2 + hi2);
      lo[pid] = lo2;
      hi[pid] = hi2;
    }
  }
}

// k_best[s] = the first argmax over rho of lml[s, :]
__global__ void loc_argmax_kernel(const double* __restrict__ lml,
                                  int64_t* __restrict__ k_best, int nrho,
                                  int nS) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= nS) return;
  const double* l = lml + (int64_t)s * nrho;
  int kb = 0;
  double best = l[0];
  for (int k = 1; k < nrho; ++k)
    if (l[k] > best) {
      best = l[k];
      kb = k;
    }
  k_best[s] = kb;
}

// warps of an epilogue block at p + 1 = p1, as their workspaces fit
inline int epi_warps(int p1) {
  const int fit = SMEM_BLOCK / (int)(sizeof(double) * (size_t)epi_words(p1));
  return max(1, min(fit, WIDE_LOC_WARPS));
}

struct LocArgs {
  const double *Sv, *WGt, *yt, *CWW, *CWy, *Cyy, *CWg, *Cgy, *Cgg, *ld_xx,
      *br_lo, *br_hi;
  double *x, *lml;
  int64_t* k_best;
  int n, nrho, R, p, nS, steps, r32;
};

// one gene's localize by the product route
int localize_products(const LocArgs& a, double* work, cudaStream_t stream) {
  const LocLayout L = loc_layout(a.nrho, a.R, a.p, a.nS, a.r32 != 0);
  double *P32 = work + L.p32, *P64 = a.r32 ? work + L.p64 : P32;
  double *sum = work + L.sum, *gsum = work + L.gs, *lo = work + L.lo,
         *hi = work + L.hi;
  const int64_t probs = (int64_t)a.nS * a.nrho;
  const int nppad = loc_nppad(a.p), p1 = a.p + 1;
  int err;
  // 16 products a thread (a grid-stride loop)
  const dim3 prgrid((unsigned)(((int64_t)a.R * nppad + 4095) / 4096), a.nrho);
  auto products = loc_products_kernel;
  products<<<prgrid, 256, 0, stream>>>(a.WGt, a.yt, P32, P64, a.R, a.p, a.nS,
                                       a.r32);
  if ((err = (int)cudaGetLastError())) return err;
  const unsigned iblocks = (unsigned)((probs + 255) / 256);
  auto init = loc_init_kernel;
  init<<<iblocks, 256, 0, stream>>>(a.br_lo, a.br_hi, a.x, lo, hi, probs);
  if ((err = (int)cudaGetLastError())) return err;
  const dim3 ggrid(nppad / PT, (a.nS + GV - 1) / GV, a.nrho);
  const dim3 pgrid((a.nS + 31) / 32, a.nrho);
  const int ew = epi_warps(p1);
  const int ebytes = (int)sizeof(double) * ew * epi_words(p1);
  const unsigned eblocks = (unsigned)((probs + ew - 1) / ew);
  // the epilogues' shared-memory limit (epi_warps keeps a block within
  // SMEM_BLOCK at every width), raised once a process
  static const int set = [] {
    const int e = (int)cudaFuncSetAttribute(
        loc_epilogue_kernel<false>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BLOCK);
    return e ? e
             : (int)cudaFuncSetAttribute(
                   loc_epilogue_kernel<true>,
                   cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BLOCK);
  }();
  if ((err = set)) return err;
  for (int it = 0; it <= a.steps; ++it) {
    const bool fin = it == a.steps;  // then the f64 evaluation
    const double* P = fin ? P64 : P32;
    const int r32 = fin ? 0 : a.r32;
    auto gemm = fin ? loc_gemm_kernel<1> : loc_gemm_kernel<3>;
    auto gsums = fin ? loc_gsums_kernel<1> : loc_gsums_kernel<3>;
    auto epi = fin ? loc_epilogue_kernel<true> : loc_epilogue_kernel<false>;
    gemm<<<ggrid, 32 * GW, 0, stream>>>(a.Sv, P, a.x, sum, a.nrho, a.R, a.p,
                                        a.nS, r32);
    if ((err = (int)cudaGetLastError())) return err;
    gsums<<<pgrid, 32 * GPASS_WARPS, 0, stream>>>(
        a.Sv, a.WGt, a.yt, a.x, gsum, a.nrho, a.R, a.p, a.nS, r32);
    if ((err = (int)cudaGetLastError())) return err;
    epi<<<eblocks, 32 * ew, ebytes, stream>>>(
        sum, gsum, a.CWW, a.CWy, a.Cyy, a.CWg, a.Cgy, a.Cgg, a.ld_xx, a.x, lo,
        hi, a.lml, a.n, a.nrho, a.R, a.p, a.nS, r32);
    if ((err = (int)cudaGetLastError())) return err;
  }
  const unsigned ablocks = (unsigned)((a.nS + 127) / 128);
  auto argmax = loc_argmax_kernel;
  argmax<<<ablocks, 128, 0, stream>>>(a.lml, a.k_best, a.nrho, a.nS);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The converge (crm_reml_converge; stage 3, :672-734, and the association
// refit's Newton, :991-1062): a warp a problem, the (gene g, variant s)
// pair at its rho k_best[g, s] (rho 0 when null); a block a (rho k, tile
// of up to CONV_WARPS of the problems at k).  conv_lists_kernel lists each
// rho's problems i = g nS + s in ascending order, a block a rho (a ballot
// a warp and a prefix over the warps' counts: best_rho_rotate.cu's
// per-rho lists, for the problems instead of the variants), so that the
// grouping needs no host; a block reads its tile from the counts (rho
// order), and the blocks past the last tile (the grid is sized for the
// most tiles the problems could need) exit at once.  The block stages
// the rows its problems share: the rho's eigenvalues and W once, each
// problem's genotype column (the tile's variants ascending, read along
// the variants of a row, so that neighbours share a 32-byte sector where
// a warp a problem read one sector a value) and each of the tile's genes'
// phenotype once.  Every row stays resident where the tile's rows fit
// CONV_SMEM (two blocks an SM), staged once for all the steps and the
// final fit; else the rows pass in chunks through two cp.async buffers,
// the next chunk in flight while the warps sum the current one.  A call
// with no Newton steps (the refit's fits at the grid's ends) reads its
// one pass's rows where they lie (the tile's warps share them through
// L1), as staging them first serialised the copy and the sums.  A
// problem's iterate and bracket stay in registers; at p + 1 <= 2, where
// Newton steps run or the problems are few, two warps split its rows
// (conv_reduce adds their sums in one order, so that both take the same
// steps).  The sums run with the
// lanes over the staged rows: up to p + 1 = 16 in registers (the products
// in the localize's order, ne_finish's shuffle tree, derivs_sums'
// algebra); wide (p + 1 <= 33) each lane owns one or two 4 x 4 blocks of
// the column pairs of [W, g, y] and accumulates them over the rows from
// eight staged values a row and block (two shared-memory loads a sum
// before), and the algebra runs in the warp's workspace
// (derivs_tail_wide, fit_tail_wide).  The arithmetic is the plain
// version's: f64 on the unrounded tensors, REML's final rss floored at
// 128 eps q, ML's at tiny only.
//
// The float32 context (converge_kernel<float>, p + 1 <= 16: the screen's
// stage 3 and K7's Newton half on an f32 context, engine.py:672-734,
// :991-1062): the rows are staged as f32, so twice as many fit the block's
// CONV_SMEM; the products (W_i W_j, g W_j, g^2, W_j y, g y, y^2) and e =
// 1 - S, e^2 are the f32 values the reference forms, widened; the
// weights, sums, Newton steps and final fit are f64; the rss floors are
// the context's (Floors<float>: 128 eps(f32) q for REML, tiny(f32) for ML)
// and keep a NaN, and ML takes no ld_xx.
// ---------------------------------------------------------------------------
constexpr int CONV_WARPS = 4;      // problems a converge block holds
constexpr int LIST_THREADS = 128;  // threads of a lists block
constexpr int LIST_ITEMS = 8;      // problems a lists thread takes a chunk
#ifndef CRM_CONV_LIST_CHUNK  // the emulated tests build one with 2, so
#define CRM_CONV_LIST_CHUNK 128  // that their few rho take several chunks
#endif
constexpr int LIST_CHUNK = CRM_CONV_LIST_CHUNK;  // counts a block reads at once
#ifndef CRM_CONV_SMEM_KB  // the emulated tests build some with less, so
#define CRM_CONV_SMEM_KB 110  // that their small R takes the chunks
#endif
// a block's staged rows: two blocks an SM, with their static shared
// memory and the 1 KB the card keeps a block, within its 228 KB
constexpr int CONV_SMEM = CRM_CONV_SMEM_KB * 1024;
constexpr int WBLK = 2;  // 4 x 4 column blocks a wide lane owns (<= 45)
// problems below which a call with no Newton steps still splits each
// problem's rows over two warps (p + 1 <= 2): 4 blocks of 4 an SM hold
// 2112 at one warp each
#ifndef CRM_CONV_SPLIT_BELOW  // the emulated tests build one with 0, so
#define CRM_CONV_SPLIT_BELOW 4096  // that their few problems take one warp
#endif
constexpr int CONV_SPLIT_BELOW = CRM_CONV_SPLIT_BELOW;

// blocks an SM of a converge instantiation (its launch bounds): at
// p + 1 <= 2, where a problem's registers are fewest, two of eight warps
// (WPP = 2: two warps a problem, its rows split between them) or four of
// four (WPP = 1: many problems and no Newton steps, whose one pass gains
// less from the split than the tile's tail loses at the barriers), at
// 128 registers; else one.  On f32 rows (es = 4) the WPP = 1
// instantiation, which serves only those zero-step calls, takes eight
// (64 registers: its unused Newton path spills; K7-MG-f32's fits at the
// grid's ends 0.124 to 0.086 ms on an H100 80GB HBM3, PERF.md §6)
__host__ __device__ constexpr int conv_min_blocks(int P1MAX, int WPP,
                                                  int es) {
  return P1MAX != 2 ? 1 : WPP == 2 ? 2 : es == 4 ? 8 : 4;
}

// list[k, 0 .. n_k): the problems i = g nS + s whose best rho is k
// (k_best null: every problem at rho 0), ascending; count[k] = n_k.  A
// block a rho; each thread takes LIST_ITEMS consecutive problems of a
// chunk, and a prefix over the threads' counts (a shuffle scan a warp,
// then the warps' totals) places them.
__global__ void __launch_bounds__(LIST_THREADS)
conv_lists_kernel(const int64_t* __restrict__ k_best, int* __restrict__ list,
                  int* __restrict__ count, int P) {
  __shared__ int wtotal[LIST_THREADS / 32];
  const int k = blockIdx.x, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  int* lk = list + (int64_t)k * P;
  int base = 0;
  for (int i0 = 0; i0 < P; i0 += LIST_THREADS * LIST_ITEMS) {
    const int first = i0 + tid * LIST_ITEMS;
    unsigned on = 0;  // bit j: problem first + j is at rho k
    for (int j = 0; j < LIST_ITEMS; ++j) {
      const int i = first + j;
      if (i < P && (k_best ? (int)k_best[i] : 0) == k) on |= 1u << j;
    }
    int incl = __popc(on);  // the warp's inclusive scan of the counts
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(FULL, incl, d);
      if (lane >= d) incl += v;
    }
    if (lane == 31) wtotal[warp] = incl;
    __syncthreads();
    int at = base + incl - __popc(on), total = 0;
    for (int w = 0; w < LIST_THREADS / 32; ++w) {
      at += w < warp ? wtotal[w] : 0;
      total += wtotal[w];
    }
    for (int j = 0; j < LIST_ITEMS; ++j)
      if (on >> j & 1u) lk[at++] = first + j;
    base += total;
    __syncthreads();  // wtotal is rewritten by the next chunk
  }
  if (tid == 0) count[k] = base;
}

// the staged rows, in units of rch values of the operand type: [S | W (p)
// | g (a problem each) | y (at each gene's first problem of the tile)]
__host__ __device__ inline int conv_width(int p) {
  return 1 + p + 2 * CONV_WARPS;
}

// one buffer (every row) or two (chunks)
template <class T>
struct ConvStage {
  T* sm;
  int rch, chunks, w;
  __device__ T* buf(int c) const { return sm + (c & 1) * w * rch; }
};


// cp.async of rows [r0, r0 + rows) of rho k (S and W at Sk and Wk) into
// buf, for the tile's nv problems prob[]
template <class T>
__device__ void conv_fetch(T* buf, int rch, const T* __restrict__ Sk,
                           const T* __restrict__ Wk,
                           const T* __restrict__ yt, const int* prob,
                           int nv, int k, int r0, int rows, int R, int p,
                           int nS, int nrho) {
  const int nt = blockDim.x, tid = threadIdx.x;
  const int64_t ps = p + nS;
  for (int e = tid; e < rows * (1 + p); e += nt) {
    const int rr = e / (1 + p), c = e - rr * (1 + p);
    const int64_t r = r0 + rr;
    cp_async_val(buf + c * rch + rr, c == 0 ? Sk + r : Wk + r * ps + (c - 1));
  }
  // the problems' genotype, a row's nv values along the variants
  for (int e = tid; e < rows * nv; e += nt) {
    const int rr = e / nv, v = e - rr * nv;
    cp_async_val(buf + (1 + p + v) * rch + rr,
                 Wk + (r0 + rr) * ps + p + prob[v] % nS);
  }
  // each gene's phenotype, at its first problem of the tile
  for (int e = tid; e < rows * nv; e += nt) {
    const int v = e / rows, rr = e - v * rows;
    const int g = prob[v] / nS;
    if (v > 0 && prob[v - 1] / nS == g) continue;
    cp_async_val(buf + (1 + p + CONV_WARPS + v) * rch + rr,
                 yt + ((int64_t)g * nrho + k) * R + r0 + rr);
  }
}

// One pass of the block over the rows: use(buf, rows) on each staged
// chunk.  Resident (one chunk): staged at the first pass, then read in
// place.  Chunked: the next chunk is fetched while the current one is
// used.
template <class T, class Fetch, class Use>
__device__ void conv_pass(const ConvStage<T>& st, int R, bool& staged,
                          Fetch fetch, Use use) {
  if (st.chunks == 1) {
    if (!staged) {
      fetch(st.buf(0), 0, R);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      staged = true;
    }
    use(st.buf(0), R);
    return;
  }
  __syncthreads();  // every warp is done with the last pass's chunks
  fetch(st.buf(0), 0, min(st.rch, R));
  cp_async_commit();
  for (int c = 0; c < st.chunks; ++c) {
    const int r0 = c * st.rch;
    cp_async_wait<0>();
    __syncthreads();  // chunk c landed; every warp is done with c - 1
    if (c + 1 < st.chunks)
      fetch(st.buf(c + 1), r0 + st.rch, min(st.rch, R - r0 - st.rch));
    cp_async_commit();
    use(st.buf(c), min(st.rch, R - r0));
  }
}

// One problem's rows, where they lie: row r's eigenvalue at S[r], W's
// column j at W[j wc + r wr], the genotype at g[r gs], the phenotype at
// y[r]: the staged rows (columns of rch values) or the tensors.
template <class T>
struct ConvRows {
  const T *S, *W, *g, *y;
  int64_t wc, wr, gs;
};

// the lane's rows first, first + step, ... < rows into the NF families'
// sums of its problem: the products of the localize's per-problem loop,
// unrounded.  On f32 rows (the float32 context) the products, e = 1 - S
// and e^2 are the f32 values the reference forms on its f32 tensors
// (engine.py:672-734, :991-1062), widened; the weights and the sums f64.
template <int P1MAX, int NF, class T>
__device__ void conv_rows(const ConvRows<T>& x, int rows, int first,
                          int step, int p, double delta,
                          double (&acc)[NF][Cfg<P1MAX>::NE], double& ex1,
                          double& ex2) {
  constexpr int NE = Cfg<P1MAX>::NE, TRI = Cfg<P1MAX>::TRI;
  const int p1 = p + 1;
  double dprod = 1.0;  // NF == 1: sum log d a log of LOG_GROUP rows
  int nprod = 0;
  for (int rr = first; rr < rows; rr += step) {
    const T Sr = x.S[rr];
    const double d = (1.0 - delta) * Sr + delta;
    const double w1 = 1.0 / d;
    double wf[NF];
    wf[0] = w1;
    if constexpr (NF == 3) {
      const T er = T(1) - Sr;
      const double e = er;
      const double e2 = (T)(er * er);
      wf[1] = e * w1 * w1;
      wf[2] = e2 * w1 * w1 * w1;
      ex1 += w1 * e;
      ex2 += w1 * w1 * e2;
    } else {
      dprod *= d;
      if (++nprod == LOG_GROUP) {
        ex1 += log(dprod);
        dprod = 1.0;
        nprod = 0;
      }
    }
    const T g = x.g[rr * x.gs], yv = x.y[rr];
    const T* W = x.W + rr * x.wr;
    SMALL_FOR(i, 0, p1) {
      const T xi = i < p ? W[i * x.wc] : g;
      SMALL_FOR(j, 0, i + 1) {
        const double v = (T)(xi * (j < p ? W[j * x.wc] : g));
        for (int f = 0; f < NF; ++f) acc[f][tri(i, j)] += wf[f] * v;
      }
      const double v = (T)(xi * yv);
      for (int f = 0; f < NF; ++f) acc[f][TRI + i] += wf[f] * v;
    }
    const double v = (T)(yv * yv);
    for (int f = 0; f < NF; ++f) acc[f][NE - 1] += wf[f] * v;
  }
  if (NF == 1) ex1 += log(dprod);
}

// the warps of a problem (two at p + 1 <= 2, its rows split between them)
// add up their sums, each warp over its lanes and then the two warps' in
// one order, so that both hold the same sums and take the same steps;
// red: [2][CONV_WARPS][NF NE + 2] doubles
template <int P1MAX, int NF>
__device__ void conv_reduce(double* red, int v, int half, bool active,
                            double (&acc)[NF][Cfg<P1MAX>::NE], double& ex1,
                            double& ex2) {
  constexpr int NE = Cfg<P1MAX>::NE, W = NF * NE + 2;
  for (int f = 0; f < NF; ++f)
    for (int e = 0; e < NE; ++e) acc[f][e] = warp_sum(acc[f][e]);
  ex1 = warp_sum(ex1);
  ex2 = warp_sum(ex2);
  double* mine = red + (half * CONV_WARPS + v) * W;
  if (active && threadIdx.x % 32 == 0) {
    for (int f = 0; f < NF; ++f)
      for (int e = 0; e < NE; ++e) mine[f * NE + e] = acc[f][e];
    mine[NF * NE] = ex1;
    mine[NF * NE + 1] = ex2;
  }
  __syncthreads();
  const double* r0 = red + v * W;
  const double* r1 = red + (CONV_WARPS + v) * W;
  for (int f = 0; f < NF; ++f)
    for (int e = 0; e < NE; ++e) acc[f][e] = r0[f * NE + e] + r1[f * NE + e];
  ex1 = r0[NF * NE] + r1[NF * NE];
  ex2 = r0[NF * NE + 1] + r1[NF * NE + 1];
  __syncthreads();  // both warps have read before the next pass's sums
}

// a wide lane's blocks (rows 4 bi .. 4 bi + 3, columns 4 bj .. 4 bj + 3)
// of the column pairs of [W, g, y] (ncol = p + 2), bi >= bj; bi = -1
// where the lane has none
__device__ void wide_blocks(int ncol, int (&bi)[WBLK], int (&bj)[WBLK]) {
  const int lane = threadIdx.x % 32;
  const int nbk = (ncol + 3) / 4, nbl = nbk * (nbk + 1) / 2;
  for (int t = 0; t < WBLK; ++t) {
    const int e = lane + 32 * t;
    int a = -1, b = 0;
    if (e < nbl) {
      a = 0;
      while ((a + 1) * (a + 2) / 2 <= e) ++a;
      b = e - a * (a + 1) / 2;
    }
    bi[t] = a;
    bj[t] = b;
  }
}

// a wide lane's staged rows [0, rows) into its blocks' NF families' sums
// (oa, ob: the blocks' columns in the staged rows); ws.wf holds the
// weights of WRC rows at a time, a lane a row
template <int NF>
__device__ void wide_rows(const WideWs<>& ws, const double* buf, int rows,
                          const int (&bi)[WBLK], const int (&oa)[WBLK][4],
                          const int (&ob)[WBLK][4], double delta,
                          double (&acc)[NF][WBLK][16], double& ex1,
                          double& ex2) {
  const int lane = threadIdx.x % 32;
  double dprod = 1.0;  // NF == 1: sum log d a log of LOG_GROUP rows
  int nprod = 0;
  for (int rb = 0; rb < rows; rb += WRC) {
    const int nr = min(WRC, rows - rb);
    if (lane < nr) {
      const double Sr = buf[rb + lane];
      const double d = (1.0 - delta) * Sr + delta;
      const double w1 = 1.0 / d;
      double* wf = ws.wf + lane * 3;
      wf[0] = w1;
      if constexpr (NF == 3) {
        const double e = 1.0 - Sr;
        const double e2 = (1.0 - Sr) * (1.0 - Sr);
        wf[1] = e * w1 * w1;
        wf[2] = e2 * w1 * w1 * w1;
        ex1 += w1 * e;
        ex2 += w1 * w1 * e2;
      } else {
        dprod *= d;
        if (++nprod == LOG_GROUP) {
          ex1 += log(dprod);
          dprod = 1.0;
          nprod = 0;
        }
      }
    }
    __syncwarp();
    for (int rr = 0; rr < nr; ++rr) {
      const int r = rb + rr;
      double w[NF];
#pragma unroll
      for (int f = 0; f < NF; ++f) w[f] = ws.wf[rr * 3 + f];
#pragma unroll
      for (int t = 0; t < WBLK; ++t) {
        if (bi[t] < 0) continue;
        double xa[4], xb[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          xa[u] = buf[oa[t][u] + r];
          xb[u] = buf[ob[t][u] + r];
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            const double pr = xa[u] * xb[v];
#pragma unroll
            for (int f = 0; f < NF; ++f) acc[f][t][4 * u + v] += w[f] * pr;
          }
      }
    }
    __syncwarp();
  }
  if (NF == 1) ex1 += log(dprod);
}

// the wide sums into ws.acc ([A lower | b | q] over [W, g], y), the
// complements added with weight 1/delta^(f+1); ex1, ex2 summed over the
// warp
template <int NF>
__device__ void wide_finish(const Problem& pb, const WideWs<>& ws,
                            double delta, const int (&bi)[WBLK],
                            const int (&bj)[WBLK],
                            const double (&acc)[NF][WBLK][16], double& ex1,
                            double& ex2) {
  const int p = pb.p, p1 = p + 1, ntri = p1 * (p1 + 1) / 2;
  ex1 = warp_sum(ex1);
  ex2 = warp_sum(ex2);
  const double i1 = 1.0 / delta;
#pragma unroll
  for (int t = 0; t < WBLK; ++t) {
    if (bi[t] < 0) continue;
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int a = 4 * bi[t] + u, b = 4 * bj[t] + v;
        if (a > p1 || b > a) continue;
        int e;
        double c;
        if (a < p1) {  // A: x_a x_b
          e = tri(a, b);
          c = a < p ? pb.CWW[a * p + b]
                    : (b < p ? pb.CWg[(int64_t)b * pb.nS + pb.s] : pb.cgg);
        } else if (b < p1) {  // b: x_b y
          e = ntri + b;
          c = b < p ? pb.CWy[b] : pb.cgy;
        } else {  // q: y y
          e = ws.ne - 1;
          c = pb.cyy;
        }
        double ic = i1;
#pragma unroll
        for (int f = 0; f < NF; ++f) {
          ws.acc[f * ws.ne + e] = acc[f][t][4 * u + v] + c * ic;
          ic *= i1;
        }
      }
  }
  __syncwarp();
}

// the doubles of a wide converge warp's workspace: its rows' weights,
// then the algebra's
__host__ __device__ inline int conv_ws_words(int p1) {
  return 3 * WRC + epi_words(p1);
}

template <class T, int P1MAX, bool REML, int WPP>
__global__ void __launch_bounds__(32 * CONV_WARPS * WPP,
                                  conv_min_blocks(P1MAX, WPP, sizeof(T)))
converge_kernel(const T* __restrict__ Sv, const T* __restrict__ WGt,
                const T* __restrict__ yt, const T* __restrict__ CWW,
                const T* __restrict__ CWy, const T* __restrict__ Cyy,
                const T* __restrict__ CWg, const T* __restrict__ Cgy,
                const T* __restrict__ Cgg, const T* __restrict__ ld_xx,
                const double* __restrict__ x0,
                const double* __restrict__ br_lo,
                const double* __restrict__ br_hi,
                const int* __restrict__ list, const int* __restrict__ count,
                double* __restrict__ delta_out, double* __restrict__ lml_out,
                double* __restrict__ scale_out, double* __restrict__ beta_out,
                int n, int nrho, int R, int p, int nS, int genes, int steps,
                int rch) {
  extern __shared__ __align__(16) unsigned char conv_dyn[];
  __shared__ int prob[CONV_WARPS];
  // the two warps' sums of each problem (WPP == 2)
  __shared__ double red[WPP == 2 ? 2 * CONV_WARPS * (3 * Cfg<P1MAX>::NE + 2)
                                 : 1];
  // the block's tile: problems t0 .. t0 + nv of rho k's list, found in
  // the counts, read LIST_CHUNK rho at a time by as many threads (not
  // one after another: each read is a round trip to L2)
  __shared__ int cnt[LIST_CHUNK];
  __shared__ int tile[3];  // k (-1: none yet), t0, nv
  if (threadIdx.x == 0) tile[0] = -1;
  for (int k0 = 0, start = 0; k0 < nrho; k0 += LIST_CHUNK) {
    if (threadIdx.x < LIST_CHUNK)
      cnt[threadIdx.x] = k0 + (int)threadIdx.x < nrho
                             ? count[k0 + threadIdx.x] : 0;
    __syncthreads();
    if (threadIdx.x == 0)
      for (int j = 0; j < LIST_CHUNK && k0 + j < nrho; ++j) {
        const int tiles = (cnt[j] + CONV_WARPS - 1) / CONV_WARPS;
        if ((int)blockIdx.x < start + tiles) {
          tile[0] = k0 + j;
          tile[1] = ((int)blockIdx.x - start) * CONV_WARPS;
          tile[2] = min(CONV_WARPS, cnt[j] - tile[1]);
          break;
        }
        start += tiles;
      }
    __syncthreads();
    if (tile[0] >= 0) break;
  }
  const int k = tile[0], t0 = tile[1], nv = tile[2];
  if (k < 0) return;  // past the last tile: the whole block exits
  const int P = genes * nS;
  if ((int)threadIdx.x < nv)
    prob[threadIdx.x] = list[(int64_t)k * P + t0 + threadIdx.x];
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int half = warp / CONV_WARPS;  // the warp's share of the rows
  const bool active = warp % CONV_WARPS < nv;  // the others only stage
  const int v = min(warp % CONV_WARPS, nv - 1);
  const int i = prob[v], gi = i / nS, s = i - gi * nS;
  int head = v;  // the gene's first problem of the tile holds its y
  while (head > 0 && prob[head - 1] / nS == gi) --head;
  const int p1 = p + 1, w = conv_width(p);
  const int chunks = (R + rch - 1) / rch;
  const ConvStage<T> st{reinterpret_cast<T*>(conv_dyn), rch, chunks, w};
  const int gcol = 1 + p + v, ycol = 1 + p + CONV_WARPS + head;
  const T* Sk = Sv + (int64_t)k * R;
  const T* Wk = WGt + (int64_t)k * R * (p + nS);
  auto fetch = [&](T* buf, int r0, int rows) {
    conv_fetch(buf, rch, Sk, Wk, yt, prob, nv, k, r0, rows, R, p, nS, nrho);
  };
  using FL = Floors<T>;
  const ProblemT<T> pb =
      make_problem(CWW, CWy + (int64_t)gi * p, Cyy + gi, CWg,
                   Cgy + (int64_t)gi * nS, Cgg, s, R, p, nS, false);
  const int64_t so = (int64_t)i * nrho + k;
  double lo = br_lo[so], hi = br_hi[so];
  double x = x0 ? x0[so] : 0.5 * (lo + hi);
  const double ldx = REML ? ld_xx[s] : 0.0;
  bool staged = false;
  double delta, lml, rss;
  bool bad;
  if constexpr (P1MAX == 0) {  // the wide instantiation: f64 only
    double* base = st.sm + (chunks == 1 ? 1 : 2) * w * rch +
                   (int64_t)warp * conv_ws_words(p1);
    WideWs<> ws = wide_ws(base + 3 * WRC, p1);
    ws.wf = base;
    int bi[WBLK], bj[WBLK], oa[WBLK][4], ob[WBLK][4];
    wide_blocks(p1 + 1, bi, bj);
    // column c of [W, g, y] in the staged rows (padding: any column)
    auto col = [&](int c) {
      return (c < p ? 1 + c : c == p ? gcol : c == p1 ? ycol : 0) * rch;
    };
    for (int t = 0; t < WBLK; ++t)
      for (int u = 0; u < 4; ++u) {
        oa[t][u] = col(4 * max(bi[t], 0) + u);
        ob[t][u] = col(4 * bj[t] + u);
      }
    for (int it = 0; it < steps; ++it) {
      delta = sigmoid(x);
      double acc[3][WBLK][16] = {}, ex1 = 0.0, ex2 = 0.0;
      conv_pass(st, R, staged, fetch, [&](const double* buf, int rows) {
        if (active)
          wide_rows<3>(ws, buf, rows, bi, oa, ob, delta, acc, ex1, ex2);
      });
      if (active) {
        wide_finish<3>(pb, ws, delta, bi, bj, acc, ex1, ex2);
        double Lp, Lpp;
        derivs_tail_wide<REML>(ws, R, n, delta, ex1, ex2, Lp, Lpp);
        newton_update(delta, Lp, Lpp, x, lo, hi);
      }
    }
    delta = sigmoid(x);
    double acc[1][WBLK][16] = {}, logd = 0.0, unused = 0.0;
    conv_pass(st, R, staged, fetch, [&](const double* buf, int rows) {
      if (active)
        wide_rows<1>(ws, buf, rows, bi, oa, ob, delta, acc, logd, unused);
    });
    if (!active) return;
    wide_finish<1>(pb, ws, delta, bi, bj, acc, logd, unused);
    lml = fit_tail_wide<REML, REML>(ws, R, delta, n, ldx, logd, rss, bad);
    if (lane == 0)
      for (int j = 0; j < p1; ++j) beta_out[(int64_t)i * p1 + j] = ws.vec[j];
  } else {
    constexpr int NE = Cfg<P1MAX>::NE;
    const int first = half * 32 + lane, step = 32 * WPP;
    auto staged_rows = [&](const T* buf) {
      return ConvRows<T>{buf, buf + rch, buf + gcol * rch, buf + ycol * rch,
                         rch, 1, 1};
    };
    for (int it = 0; it < steps; ++it) {
      delta = sigmoid(x);
      double acc[3][NE] = {}, ex1 = 0.0, ex2 = 0.0;
      conv_pass(st, R, staged, fetch, [&](const T* buf, int rows) {
        if (active)
          conv_rows<P1MAX, 3>(staged_rows(buf), rows, first, step, p, delta,
                              acc, ex1, ex2);
      });
      if constexpr (WPP == 2) {
        conv_reduce<P1MAX, 3>(red, v, half, active, acc, ex1, ex2);
        if (active) ne_complements<P1MAX, 3>(pb, delta, acc);
      } else if (active) {
        ne_finish<P1MAX, 3>(pb, delta, acc, ex1, ex2);
      }
      if (active) {
        double Lp, Lpp;
        derivs_sums<P1MAX, REML, FL>(pb, delta, n, acc, ex1, ex2, Lp, Lpp);
        newton_update(delta, Lp, Lpp, x, lo, hi);
      }
    }
    delta = sigmoid(x);
    double acc[1][NE] = {}, logd = 0.0, unused = 0.0;
    if (steps == 0) {  // one pass: the rows read where they lie
      const int64_t ps = p + nS;
      if (active)
        conv_rows<P1MAX, 1>(ConvRows<T>{Sk, Wk, Wk + p + s,
                                        yt + ((int64_t)gi * nrho + k) * R, 1,
                                        ps, ps},
                            R, first, step, p, delta, acc, logd, unused);
    } else {
      conv_pass(st, R, staged, fetch, [&](const T* buf, int rows) {
        if (active)
          conv_rows<P1MAX, 1>(staged_rows(buf), rows, first, step, p, delta,
                              acc, logd, unused);
      });
    }
    if constexpr (WPP == 2)
      conv_reduce<P1MAX, 1>(red, v, half, active, acc, logd, unused);
    if (!active || half > 0) return;  // the first warp of a problem writes
    if constexpr (WPP == 2)
      ne_complements<P1MAX, 1>(pb, delta, acc);
    else
      ne_finish<P1MAX, 1>(pb, delta, acc, logd, unused);
    double beta[P1MAX];
    lml = fit_sums<P1MAX, REML, REML, FL>(pb, delta, n, ldx, acc, logd, beta,
                                          rss, bad);
    if (lane == 0)
      SMALL_FOR(j, 0, p1) beta_out[(int64_t)i * p1 + j] = beta[j];
  }
  if (lane == 0) {
    delta_out[i] = delta;
    lml_out[i] = lml;
    scale_out[i] = rss / (REML ? (double)(n - p - 1) : (double)n);
  }
}

// the converge's rows a chunk (every row, rounded to 32, where they fit),
// and the bytes of dynamic shared memory of a block (none for a narrow
// call with no Newton steps: its one pass reads the tensors); es the
// bytes of an operand (4 on the float32 context: twice the rows fit)
inline int conv_rows_per_chunk(int R, int p, int steps, int es, int* smem) {
  const bool wide = p + 1 > 16;
  if (!wide && steps == 0) {  // one pass reads its rows where they lie
    *smem = 0;
    return R;
  }
  const int w = conv_width(p);
  const int ws = wide ? (int)sizeof(double) * CONV_WARPS *
                            conv_ws_words(p + 1)
                      : 0;
  const int budget = wide ? min(CONV_SMEM, SMEM_BLOCK - ws) : CONV_SMEM;
  const int all = (R + 31) / 32 * 32;
  int rch = all;
  if (es * w * all > budget)
    rch = max(32, budget / (es * 2 * w) / 32 * 32);
  const int nbuf = (R + rch - 1) / rch == 1 ? 1 : 2;
  *smem = es * nbuf * w * rch + ws;
  return rch;
}
// ---------------------------------------------------------------------------
// The float32 context (the screen's: engine.py:538-734 on an f32 context)
// ---------------------------------------------------------------------------
// Every tensor is f32: the eigenvalues, the rotated [W | G] and y, and the
// complements; the rotated products (W_i W_j, g W_j, g^2, W_j y, g y, y^2)
// and e = 1 - S, e2 = e^2 are the f32 products the reference forms.  The
// arithmetic follows the reference's type promotion:
// * stage 1b (the localize's steps: localize_kernel<float> up to p + 1 =
//   4, localize_wide_kernel from 5): f32 arithmetic with f32 state (x, lo,
//   hi), from the bracket midpoint in f32;
// * stage 2 (the same kernels' evaluation): one f64 lml at the localized
//   optimum, the f32 values widened as they are loaded; an rss at or below
//   128 eps(f32) q is cancellation noise of the f32 tensors and cannot win
//   the argmax (:655);
// * stage 3 (the converge's f32 instantiations, converge_kernel<float>):
//   f64 steps and the final fit at each variant's best rho on the widened
//   f32 tensors, the rss floored at 128 eps(f32) q (:724).
// The floors take the context's eps (Floors<float>): once the operands are
// widened, f64's eps would let spurious maxima through (the note at
// engine.py:357-366).
//
// The localize from p + 1 = 5 (localize_wide_kernel, up to p + 1 = 16): a
// problem's 3 (p + 2)(p + 3) / 2 sums a step (459 at p + 1 = 16) do not
// fit a lane's registers, so they are split over G warps.  A block per
// (rho, tile of LW_WARPS / G problems) stages the rows its problems share
// as the converge does (conv_fetch: the rho's S and W, each problem's
// genotype column, each gene's phenotype; resident, else in chunks
// through two cp.async buffers); warp j of a problem sums the j-th of G
// compile-time ranges of the packed lower triangle of [W, g, y] over the
// staged rows (the lanes over the rows, the sums in registers, the
// products f32), an xor-shuffle tree puts them in the problem's
// shared-memory workspace, and the problem's first warp adds the
// complements and runs the algebra there (derivs_tail_wide in f32, the
// lanes over rows, columns or entries; at the end fit_tail_wide in f64)
// and publishes the new iterate: two block barriers a step.  What bounds
// it: that algebra, a chain of short dependent steps on one warp a
// problem (37% of the warps' time at p = 7, 1024 variants, 11 rho;
// scripts/profile_localize.py --f32, H100 80GB HBM3, 700 W); two blocks
// an SM (2.65 against 4.3 device ms at one) hide part of it.
constexpr int LW_WARPS = 8;  // warps of a wide f32 localize block

// the packed triangle's entries of [W, g, y] at P1MAX + 1 columns, each of
// G warps' share of them, and the problems of a block
template <int P1MAX, int G>
struct LwCfg {
  static constexpr int NT = (P1MAX + 1) * (P1MAX + 2) / 2;
  static constexpr int CNT = (NT + G - 1) / G;
  static constexpr int NPB = LW_WARPS / G;
};

// warp J's share of a problem's sums over rows [0, rows) of a staged
// chunk (S at buf, W's column c at buf + (1 + c) rch, the genotype and
// the phenotype at columns gcol and ycol): entries [J CNT, (J + 1) CNT) of
// the packed triangle (A, then b, then q), NF families in the arithmetic
// type A on the f32 products; warp 0 also takes sum e w1 and sum e2 w1^2
// (NF == 3), or sum log d (NF == 1, a log a LOG_GROUP rows)
template <int P1MAX, int G, int J, int NF, class A>
__device__ void lw_rows(const float* buf, int rch, int rows, int p,
                        int gcol, int ycol, A delta,
                        A (&acc)[NF][LwCfg<P1MAX, G>::CNT], A& ex1, A& ex2) {
  constexpr int CNT = LwCfg<P1MAX, G>::CNT, E0 = J * CNT;
  const int p1 = p + 1;
  A dprod = A(1);
  int nprod = 0;
  for (int rr = threadIdx.x % 32; rr < rows; rr += 32) {
    const float Sr = buf[rr];
    const A d = (A(1) - delta) * A(Sr) + delta;
    const A w1 = weight<A, float>(d);
    A wf[NF];
    wf[0] = w1;
    if constexpr (NF == 3) {
      const float er = 1.0f - Sr;
      const A e = er, e2 = er * er;
      wf[1] = e * w1 * w1;
      wf[2] = e2 * w1 * w1 * w1;
      if (J == 0) {
        ex1 += w1 * e;
        ex2 += w1 * w1 * e2;
      }
    } else if (J == 0) {
      dprod *= d;
      if (++nprod == LOG_GROUP) {
        ex1 += log(dprod);
        dprod = A(1);
        nprod = 0;
      }
    }
    float x[P1MAX + 1];
#pragma unroll
    for (int c = 0; c <= P1MAX; ++c)
      x[c] = c < p    ? buf[(1 + c) * rch + rr]
             : c == p  ? buf[gcol * rch + rr]
             : c == p1 ? buf[ycol * rch + rr]
                       : 0.0f;
#pragma unroll
    for (int a = 0; a <= P1MAX; ++a) {
      if (a > p1) continue;
#pragma unroll
      for (int b = 0; b <= a; ++b) {
        const int e = tri(a, b) - E0;
        if (e < 0 || e >= CNT) continue;
        const A v = x[a] * x[b];
        for (int f = 0; f < NF; ++f) acc[f][e] += wf[f] * v;
      }
    }
  }
  if constexpr (NF == 1)
    if (J == 0) ex1 += log(dprod);
}

// lw_rows of warp j (runtime) of its problem
template <int P1MAX, int G, int NF, class A>
__device__ void lw_rows_of(int j, const float* buf, int rch, int rows, int p,
                           int gcol, int ycol, A delta,
                           A (&acc)[NF][LwCfg<P1MAX, G>::CNT], A& ex1,
                           A& ex2) {
  if (j == 0)
    lw_rows<P1MAX, G, 0, NF>(buf, rch, rows, p, gcol, ycol, delta, acc, ex1,
                             ex2);
  if constexpr (G > 1)
    if (j == 1)
      lw_rows<P1MAX, G, 1, NF>(buf, rch, rows, p, gcol, ycol, delta, acc,
                               ex1, ex2);
  if constexpr (G > 2)
    if (j == 2)
      lw_rows<P1MAX, G, 2, NF>(buf, rch, rows, p, gcol, ycol, delta, acc,
                               ex1, ex2);
  if constexpr (G > 3)
    if (j == 3)
      lw_rows<P1MAX, G, 3, NF>(buf, rch, rows, p, gcol, ycol, delta, acc,
                               ex1, ex2);
}

// warp j's sums, added over its lanes (every level of the xor tree for
// every sum, then lane 0's stores), into the problem's ws.acc
template <int P1MAX, int G, int NF, class A>
__device__ void lw_publish(int j, const WideWs<A>& ws,
                           A (&acc)[NF][LwCfg<P1MAX, G>::CNT]) {
  constexpr int CNT = LwCfg<P1MAX, G>::CNT;
  for (int off = 16; off > 0; off >>= 1)
#pragma unroll
    for (int k = 0; k < CNT; ++k)
#pragma unroll
      for (int f = 0; f < NF; ++f)
        acc[f][k] += __shfl_xor_sync(FULL, acc[f][k], off);
  if (threadIdx.x % 32 != 0) return;
#pragma unroll
  for (int k = 0; k < CNT; ++k) {
    const int e = j * CNT + k;
    if (e < ws.ne)
#pragma unroll
      for (int f = 0; f < NF; ++f) ws.acc[f * ws.ne + e] = acc[f][k];
  }
}

// the problem's complements at entries lane, lane + 32, ... of the packed
// triangle of [W, g, y] (entry (a, b)), read once
template <int K>
__device__ void lw_complement_values(const ProblemT<float>& pb, int ne,
                                     float (&cv)[K]) {
  const int p = pb.p, p1 = p + 1;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int e = threadIdx.x % 32 + 32 * k;
    int a = 0;
    while ((a + 1) * (a + 2) / 2 <= e) ++a;
    const int b = e - a * (a + 1) / 2;
    cv[k] = e >= ne  ? 0.0f
            : a < p1 ? (a < p ? pb.CWW[a * p + b]
                        : b < p ? pb.CWg[(int64_t)b * pb.nS + pb.s]
                                : (float)pb.cgg)
            : b < p  ? pb.CWy[b]
            : b == p ? (float)pb.cgy
                     : (float)pb.cyy;
  }
}

// the complements into the problem's ws.acc, family f with weight
// 1 / delta^(f + 1)
template <int NF, int K, class A>
__device__ void lw_complements(const float (&cv)[K], const WideWs<A>& ws,
                               A delta) {
  const A i1 = A(1) / delta;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int e = threadIdx.x % 32 + 32 * k;
    if (e >= ws.ne) continue;
    A ic = i1;
    for (int f = 0; f < NF; ++f) {
      ws.acc[f * ws.ne + e] += A(cv[k]) * ic;
      ic *= i1;
    }
  }
  __syncwarp();
}

// bytes of a wide f32 localize block's staged rows (16-byte aligned; its
// problems' workspaces follow)
__host__ __device__ inline int lw_rows_bytes(int p, int R, int rch) {
  const int nbuf = (R + rch - 1) / rch == 1 ? 1 : 2;
  return ((int)sizeof(float) * nbuf * conv_width(p) * rch + 15) / 16 * 16;
}

// two blocks an SM up to p + 1 = 8 (128 registers, none spilled); one at
// 16, whose sums need more
template <int P1MAX, int G>
__global__ void __launch_bounds__(32 * LW_WARPS, P1MAX <= 8 ? 2 : 1)
localize_wide_kernel(const float* __restrict__ Sv,
                     const float* __restrict__ WGt,
                     const float* __restrict__ yt,
                     const float* __restrict__ CWW,
                     const float* __restrict__ CWy,
                     const float* __restrict__ Cyy,
                     const float* __restrict__ CWg,
                     const float* __restrict__ Cgy,
                     const float* __restrict__ Cgg,
                     const float* __restrict__ ld_xx,
                     const double* __restrict__ br_lo,
                     const double* __restrict__ br_hi,
                     double* __restrict__ x_out, double* __restrict__ lml_out,
                     int n, int nrho, int R, int p, int nS, int genes,
                     int steps, int rch) {
  using C = LwCfg<P1MAX, G>;
  static_assert(C::NPB <= CONV_WARPS, "a tile's problems: conv_fetch's");
  extern __shared__ __align__(16) unsigned char lw_dyn[];
  __shared__ int prob[C::NPB];
  __shared__ float xs[C::NPB];
  const int P = genes * nS, k = blockIdx.y, t0 = blockIdx.x * C::NPB;
  const int nv = min(C::NPB, P - t0);
  if ((int)threadIdx.x < nv) prob[threadIdx.x] = t0 + threadIdx.x;
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int v = warp % C::NPB, j = warp / C::NPB;
  const bool active = v < nv;  // the others only stage
  const int i = t0 + min(v, nv - 1), gi = i / nS, s = i - gi * nS;
  int head = min(v, nv - 1);  // the gene's first problem of the tile
  while (head > 0 && prob[head - 1] / nS == gi) --head;
  const int p1 = p + 1, chunks = (R + rch - 1) / rch;
  const ConvStage<float> st{reinterpret_cast<float*>(lw_dyn), rch, chunks,
                            conv_width(p)};
  const int gcol = 1 + p + v, ycol = 1 + p + CONV_WARPS + head;
  const float* Sk = Sv + (int64_t)k * R;
  const float* Wk = WGt + (int64_t)k * R * (p + nS);
  auto fetch = [&](float* buf, int r0, int rows) {
    conv_fetch(buf, rch, Sk, Wk, yt, prob, nv, k, r0, rows, R, p, nS, nrho);
  };
  // the problem's workspace: f32 for the steps, f64 for the evaluation,
  // in the same place
  double* base = reinterpret_cast<double*>(lw_dyn + lw_rows_bytes(p, R, rch)) +
                 (int64_t)v * epi_words(p1);
  const WideWs<float> wsf = wide_ws(reinterpret_cast<float*>(base), p1);
  const WideWs<double> wsd = wide_ws(base, p1);
  const ProblemT<float> pb =
      make_problem(CWW, CWy + (int64_t)gi * p, Cyy + gi, CWg,
                   Cgy + (int64_t)gi * nS, Cgg, s, R, p, nS, false);
  float cv[(C::NT + 31) / 32];
  lw_complement_values(pb, wsf.ne, cv);
  const int64_t so = (int64_t)i * nrho + k;
  float lo = (float)br_lo[so], hi = (float)br_hi[so];
  float x = 0.5f * (lo + hi);
  bool staged = false;
  // stage 1b: f32 steps
  for (int it = 0; it < steps; ++it) {
    const float delta = sigmoid(x);
    float acc[3][C::CNT] = {}, ex1 = 0.0f, ex2 = 0.0f;
    conv_pass(st, R, staged, fetch, [&](const float* buf, int rows) {
      if (active)
        lw_rows_of<P1MAX, G, 3>(j, buf, rch, rows, p, gcol, ycol, delta, acc,
                                ex1, ex2);
    });
    if (active) lw_publish<P1MAX, G, 3>(j, wsf, acc);
    __syncthreads();
    if (active && j == 0) {
      ex1 = warp_sum(ex1);
      ex2 = warp_sum(ex2);
      lw_complements<3>(cv, wsf, delta);
      float Lp, Lpp;
      derivs_tail_wide<true, Floors<float>>(wsf, R, n, delta, ex1, ex2, Lp,
                                            Lpp);
      newton_update(delta, Lp, Lpp, x, lo, hi);
      if (lane == 0) xs[v] = x;
    }
    __syncthreads();
    if (active) x = xs[v];  // the problem's other warps take its iterate
  }
  // stage 2: one f64 evaluation on the same rows, widened
  const double delta = sigmoid((double)x);
  double acc[1][C::CNT] = {}, logd = 0.0, unused = 0.0;
  conv_pass(st, R, staged, fetch, [&](const float* buf, int rows) {
    if (active)
      lw_rows_of<P1MAX, G, 1>(j, buf, rch, rows, p, gcol, ycol, delta, acc,
                              logd, unused);
  });
  if (active) lw_publish<P1MAX, G, 1>(j, wsd, acc);
  __syncthreads();
  if (!active || j != 0) return;
  logd = warp_sum(logd);
  lw_complements<1>(cv, wsd, delta);
  double rss;
  bool bad;
  double lml = fit_tail_wide<true, false, Floors<float>>(
      wsd, R, delta, n, (double)ld_xx[s], logd, rss, bad);
  // noise-floor or NaN evaluations must not win the rho argmax (:664-666)
  if (bad || !isfinite(lml)) lml = -INFINITY;
  if (lane == 0) {
    x_out[so] = x;
    lml_out[so] = lml;
  }
}

// The register localize's launch (p + 1 <= 4) on operands of type T: a
// tile of gc genes and vt variants a block, its rows resident when every
// row fits (with the variants' products if they do), else in chunks
// through two raw buffers; then the argmax over rho
template <class T>
int launch_localize_register(const T* Sv, const T* WGt, const T* yt,
                             const T* CWW, const T* CWy, const T* Cyy,
                             const T* CWg, const T* Cgy, const T* Cgg,
                             const T* ld_xx, const double* br_lo,
                             const double* br_hi, double* x, double* lml_all,
                             int n, int nrho, int R, int p, int nS,
                             int genes, int steps, int round32,
                             cudaStream_t stream) {
  auto kernel = p + 1 <= 2 ? localize_kernel<T, 2> : localize_kernel<T, 4>;
  const int mw = p + 1 <= 2 ? loc_warps<T, 2>() : loc_warps<T, 4>();
  const int gc = min(genes, 4), vt = mw / gc;
  // f32 rows: LOC_G staged by cp.async (loc_stage_g32; forming g W and
  // g g in the sums costs less than staging them), resident rows an odd
  // number of values apart, so that a row's values fall in distinct banks
  constexpr bool F32 = std::is_same<T, float>::value;
  const int es = (int)sizeof(T);
  const int all = (R + 31) / 32 * 32 + (F32 ? 1 : 0);
  const int fields = loc_fields(p, gc);
  auto fits = [&](int layout) {
    return (int64_t)es * (fields + loc_resident(p, vt, layout)) * all <=
           LOC_SMEM;
  };
  int layout = !F32 && fits(LOC_PRODUCTS) ? LOC_PRODUCTS
               : fits(LOC_G)              ? LOC_G
                                          : LOC_CHUNKED;
#ifdef CRM_LOC_CHUNKED  // the emulated tests build the chunked path apart
  layout = LOC_CHUNKED;
#endif
  const bool chunked = layout == LOC_CHUNKED;
  const int per_row = fields + (chunked ? 2 * loc_raw(p, vt, gc)
                                        : loc_resident(p, vt, layout));
  const int rch =
      chunked ? max(32, LOC_SMEM / (es * per_row) / 32 * 32) : all;
  const int smem = es * per_row * rch;
  static const int set = [] {
    const int e = (int)cudaFuncSetAttribute(
        localize_kernel<T, 2>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        LOC_SMEM);
    return e ? e
             : (int)cudaFuncSetAttribute(
                   localize_kernel<T, 4>,
                   cudaFuncAttributeMaxDynamicSharedMemorySize, LOC_SMEM);
  }();
  if (set) return set;
  const dim3 grid((unsigned)((nS + vt - 1) / vt), (unsigned)nrho,
                  (unsigned)((genes + gc - 1) / gc));
  const int threads = 32 * vt * gc;
  kernel<<<grid, threads, smem, stream>>>(Sv, WGt, yt, CWW, CWy, Cyy, CWg,
                                          Cgy, Cgg, ld_xx, br_lo, br_hi, x,
                                          lml_all, n, nrho, R, p, nS, genes,
                                          steps, round32, vt, gc, rch,
                                          layout);
  return (int)cudaGetLastError();
}

// The wide f32 localize's launch (5 <= p + 1 <= P1MAX): a block per (tile
// of LW_WARPS / G problems, rho), its rows resident where they fit beside
// the problems' workspaces, else in chunks
template <int P1MAX, int G>
int launch_localize_wide(const float* Sv, const float* WGt, const float* yt,
                         const float* CWW, const float* CWy, const float* Cyy,
                         const float* CWg, const float* Cgy, const float* Cgg,
                         const float* ld_xx, const double* br_lo,
                         const double* br_hi, double* x, double* lml_all,
                         int n, int nrho, int R, int p, int nS, int genes,
                         int steps, cudaStream_t stream) {
  using C = LwCfg<P1MAX, G>;
  auto kernel = localize_wide_kernel<P1MAX, G>;
  const int w = conv_width(p);
  const int ws = (int)sizeof(double) * C::NPB * epi_words(p + 1);
  const int budget = min(LOC_SMEM, SMEM_BLOCK) - ws;
  // resident rows an odd number of values apart (distinct banks for the
  // copies of a row's values)
  const int all = (R + 31) / 32 * 32 + 1;
  int rch = all;
  if ((int)sizeof(float) * w * all > budget)
    rch = max(32, budget / ((int)sizeof(float) * 2 * w) / 32 * 32);
  const int smem = lw_rows_bytes(p, R, rch) + ws;
  int err = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err) return err;
  const int64_t P = (int64_t)genes * nS;
  const dim3 grid((unsigned)((P + C::NPB - 1) / C::NPB), (unsigned)nrho);
  kernel<<<grid, 32 * LW_WARPS, smem, stream>>>(
      Sv, WGt, yt, CWW, CWy, Cyy, CWg, Cgy, Cgg, ld_xx, br_lo, br_hi, x,
      lml_all, n, nrho, R, p, nS, genes, steps, rch);
  return (int)cudaGetLastError();
}

// k_best (rows,) int64: the first maximum of each row's lml over rho
int launch_argmax(const double* lml_all, int64_t* k_best, int nrho,
                  int64_t rows, cudaStream_t stream) {
  auto argmax = loc_argmax_kernel;
  argmax<<<(unsigned)((rows + 127) / 128), 128, 0, stream>>>(
      lml_all, k_best, nrho, (int)rows);
  return (int)cudaGetLastError();
}

}  // namespace

// Operands: Sv (nrho, R), WGt (nrho, R, p + nS), CWW (p, p), CWg (p, nS),
// Cgg (nS,), ld_xx (nS,) (REML), shared by the genes; yt (genes, nrho, R),
// CWy (genes, p), Cyy (genes,), Cgy (genes, nS), br_lo/br_hi (genes, nS,
// nrho) per gene: row-major f64 on the card, 1 <= p + 1 <= 33, genes <=
// 65535 (a single phenotype is genes = 1).  Launch on `stream`; return
// the launch's CUDA error, 0 if none.

// Bytes of scratch a crm_reml_localize call with these sizes needs (0 for
// the register instantiations, p + 1 < LOC_GEMM_MIN_P1).
extern "C" int64_t crm_reml_localize_workspace(int nrho, int R, int p, int nS,
                                               int round32) {
  if (p + 1 < LOC_GEMM_MIN_P1) return 0;
  return (int64_t)sizeof(double) *
         loc_layout(nrho, R, p, nS, round32 != 0).total;
}

// -> x, lml_all (genes, nS, nrho), k_best (genes, nS) int64.
// work: crm_reml_localize_workspace bytes on the card, 16-byte aligned
// (null when that is 0).
extern "C" int crm_reml_localize(const double* Sv, const double* WGt,
                                 const double* yt, const double* CWW,
                                 const double* CWy, const double* Cyy,
                                 const double* CWg, const double* Cgy,
                                 const double* Cgg, const double* ld_xx,
                                 const double* br_lo, const double* br_hi,
                                 double* x, double* lml_all, int64_t* k_best,
                                 void* work, int n, int nrho, int R, int p,
                                 int nS, int genes, int steps, int round32,
                                 cudaStream_t stream) {
  if (p + 1 >= LOC_GEMM_MIN_P1) {
    for (int gi = 0; gi < genes; ++gi) {  // a gene at a time, one scratch
      const int64_t gp = (int64_t)gi * nS * nrho;
      const LocArgs a{Sv,
                      WGt,
                      yt + (int64_t)gi * nrho * R,
                      CWW,
                      CWy + (int64_t)gi * p,
                      Cyy + gi,
                      CWg,
                      Cgy + (int64_t)gi * nS,
                      Cgg,
                      ld_xx,
                      br_lo + gp,
                      br_hi + gp,
                      x + gp,
                      lml_all + gp,
                      k_best + (int64_t)gi * nS,
                      n,
                      nrho,
                      R,
                      p,
                      nS,
                      steps,
                      round32};
      const int err =
          localize_products(a, static_cast<double*>(work), stream);
      if (err) return err;
    }
    return 0;
  }
  const int err = launch_localize_register(
      Sv, WGt, yt, CWW, CWy, Cyy, CWg, Cgy, Cgg, ld_xx, br_lo, br_hi, x,
      lml_all, n, nrho, R, p, nS, genes, steps, round32, stream);
  if (err) return err;
  return launch_argmax(lml_all, k_best, nrho, (int64_t)genes * nS, stream);
}

// Bytes of scratch a crm_reml_converge call with these sizes needs (the
// per-rho problem lists and their counts).
extern "C" int64_t crm_reml_converge_workspace(int nrho, int nS, int genes) {
  return (int64_t)sizeof(int) * nrho * ((int64_t)genes * nS + 1);
}

// k_best (genes, nS) int64 or null (rho 0), x0 (genes, nS, nrho) or null
// (bracket midpoint) -> delta, lml, scale (genes, nS), beta (genes, nS,
// p + 1); ld_xx may be null when reml == 0.  work:
// crm_reml_converge_workspace bytes on the card, 4-byte aligned;
// genes nS < 2^31.
namespace {

// The converge's two launches (the per-rho lists, then the blocks) on
// operands of type T (float: the float32 context, p + 1 <= 16)
template <class T>
int launch_converge(const T* Sv, const T* WGt, const T* yt, const T* CWW,
                    const T* CWy, const T* Cyy, const T* CWg, const T* Cgy,
                    const T* Cgg, const T* ld_xx, const int64_t* k_best,
                    const double* x0, const double* br_lo,
                    const double* br_hi, double* delta, double* lml,
                    double* scale, double* beta, void* work, int n, int nrho,
                    int R, int p, int nS, int genes, int steps, int reml,
                    cudaStream_t stream) {
  const int P = genes * nS;
  int* list = static_cast<int*>(work);
  int* count = list + (int64_t)nrho * P;
  auto lists = conv_lists_kernel;
  lists<<<nrho, LIST_THREADS, 0, stream>>>(k_best, list, count, P);
  int err = (int)cudaGetLastError();
  if (err) return err;
  const bool wide = p + 1 > 16;
  // two warps a problem at p + 1 <= 2 where Newton steps run or where the
  // problems are too few to fill the card at one warp each (K7's fits at
  // the grid's ends on an H100 80GB HBM3: 0.018 against 0.028 ms at 512
  // problems; 0.141 against 0.119 at 16 x 512, PERF.md)
  const int wpp =
      !wide && p + 1 <= 2 && (steps > 0 || P < CONV_SPLIT_BELOW) ? 2 : 1;
  // the wide instantiation (P1MAX 0) is f64's alone
  constexpr int WIDE = std::is_same<T, double>::value ? 0 : 16;
  auto kernel = reml ? (wide         ? converge_kernel<T, WIDE, true, 1>
                        : wpp == 2   ? converge_kernel<T, 2, true, 2>
                        : p + 1 <= 2 ? converge_kernel<T, 2, true, 1>
                        : p + 1 <= 4 ? converge_kernel<T, 4, true, 1>
                                     : converge_kernel<T, 16, true, 1>)
                     : (wide         ? converge_kernel<T, WIDE, false, 1>
                        : wpp == 2   ? converge_kernel<T, 2, false, 2>
                        : p + 1 <= 2 ? converge_kernel<T, 2, false, 1>
                        : p + 1 <= 4 ? converge_kernel<T, 4, false, 1>
                                     : converge_kernel<T, 16, false, 1>);
  int smem;
  const int rch = conv_rows_per_chunk(R, p, steps, (int)sizeof(T), &smem);
  err = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err) return err;
  // the most tiles the problems could need: one partial tile a rho
  const unsigned blocks = (unsigned)((P + CONV_WARPS - 1) / CONV_WARPS + nrho);
  const int threads = 32 * CONV_WARPS * wpp;
  kernel<<<blocks, threads, smem, stream>>>(
      Sv, WGt, yt, CWW, CWy, Cyy, CWg, Cgy, Cgg, ld_xx, x0, br_lo, br_hi, list,
      count, delta, lml, scale, beta, n, nrho, R, p, nS, genes, steps, rch);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int crm_reml_converge(const double* Sv, const double* WGt,
                                 const double* yt, const double* CWW,
                                 const double* CWy, const double* Cyy,
                                 const double* CWg, const double* Cgy,
                                 const double* Cgg, const double* ld_xx,
                                 const int64_t* k_best, const double* x0,
                                 const double* br_lo, const double* br_hi,
                                 double* delta, double* lml, double* scale,
                                 double* beta, void* work, int n, int nrho,
                                 int R, int p, int nS, int genes, int steps,
                                 int reml, cudaStream_t stream) {
  return launch_converge(Sv, WGt, yt, CWW, CWy, Cyy, CWg, Cgy, Cgg, ld_xx,
                         k_best, x0, br_lo, br_hi, delta, lml, scale, beta,
                         work, n, nrho, R, p, nS, genes, steps, reml, stream);
}

// The float32 context: the operands of crm_reml_localize in f32 (REML),
// p + 1 <= 16, the stage-2 noise floor at 128 eps(f32) q (Floors<float>).  The register route (localize_kernel<float>) up
// to p + 1 = 4, the wide f32 localize (localize_wide_kernel) from 5; then
// the argmax.  -> x (the f32 state, widened), lml_all (genes, nS, nrho),
// k_best (genes, nS) int64.  No scratch.
extern "C" int crm_reml_localize_f32(const float* Sv, const float* WGt,
                                     const float* yt, const float* CWW,
                                     const float* CWy, const float* Cyy,
                                     const float* CWg, const float* Cgy,
                                     const float* Cgg, const float* ld_xx,
                                     const double* br_lo, const double* br_hi,
                                     double* x, double* lml_all,
                                     int64_t* k_best, int n, int nrho, int R,
                                     int p, int nS, int genes, int steps,
                                     cudaStream_t stream) {
  if (p < 0 || p + 1 > 16) return (int)cudaErrorInvalidValue;
  auto launch = p + 1 <= 8 ? launch_localize_wide<8, 2>
                           : launch_localize_wide<16, 4>;
  const int err =
      p + 1 <= 4
          ? launch_localize_register(Sv, WGt, yt, CWW, CWy, Cyy, CWg, Cgy,
                                     Cgg, ld_xx, br_lo, br_hi, x, lml_all, n,
                                     nrho, R, p, nS, genes, steps, 0, stream)
          : launch(Sv, WGt, yt, CWW, CWy, Cyy, CWg, Cgy, Cgg, ld_xx, br_lo,
                   br_hi, x, lml_all, n, nrho, R, p, nS, genes, steps,
                   stream);
  if (err) return err;
  return launch_argmax(lml_all, k_best, nrho, (int64_t)genes * nS, stream);
}

// The float32 context: the operands of crm_reml_converge in f32 (k_best,
// x0, the brackets, the outputs and the scratch as there), p + 1 <= 16;
// the same kernels on f32 rows (see converge_kernel: f32 products, f64
// weights, sums, steps and final fit), REML's rss floored at 128
// eps(f32) q, ML's at tiny(f32), a NaN kept.
extern "C" int crm_reml_converge_f32(const float* Sv, const float* WGt,
                                     const float* yt, const float* CWW,
                                     const float* CWy, const float* Cyy,
                                     const float* CWg, const float* Cgy,
                                     const float* Cgg, const float* ld_xx,
                                     const int64_t* k_best, const double* x0,
                                     const double* br_lo,
                                     const double* br_hi, double* delta,
                                     double* lml, double* scale, double* beta,
                                     void* work, int n, int nrho, int R,
                                     int p, int nS, int genes, int steps,
                                     int reml, cudaStream_t stream) {
  if (p + 1 > 16) return (int)cudaErrorInvalidValue;
  return launch_converge(Sv, WGt, yt, CWW, CWy, Cyy, CWg, Cgy, Cgg, ld_xx,
                         k_best, x0, br_lo, br_hi, delta, lml, scale, beta,
                         work, n, nrho, R, p, nS, genes, steps, reml, stream);
}
