// K6b: the device tails of the score statistic, f64, for sm_90a.
//
// Per pair (Q, lambda_1..lambda_C) (Q ~ sum_i lambda_i chi2_1 under the
// null; zero weights are inert), in one fused pass:
//
//   pv_liu: modified Liu (Liu-Tang-Zhang with the Lee/Wu/Lin kurtosis
//     match): the four cumulant sums c1..c4, s1 = c3 / c2^1.5, s2 = c4 /
//     c2^2, the noncentral branch where s1^2 > s2 and the central one
//     otherwise, then the noncentral chi2 tail as a 64-term Poisson series
//     of central tails gammaincc((dof + 2k) / 2, x / 2);
//   pv_sp: the Kuonen saddlepoint: n_iters + 60 bisection steps on
//     K'(t) = sum lambda / (1 - 2 t lambda) = Q over
//     (lo, (1 - 1e-12) / (2 lambda_max)), then Lugannani-Rice 1 - ndtr(z),
//     z = w + log(v / w) / w; the Liu value where |v| < 1e-8 (the mean) or
//     lambda_max <= 0.
//
// Both as the JAX package writes them, op for op (cellregmap_tpu/models/
// pvalues.py `liu_sf` :31-69, `_chi2_sf`/`_ncx2_sf` :72-91,
// `saddlepoint_sf` :97-145; ndtr as jax.scipy's `_ndtr`: 1 + erf inside
// |x| < 1, else from erfc), so that the two packages round alike.
//
// gammaincc is the regularized upper incomplete gamma Q(a, x): the series
// of P(a, x) for x < a + 1 (Q = 1 - P is not small there), Lentz's
// continued fraction otherwise, each scaled by exp(-x + a log x -
// lgamma(a)); both keep relative accuracy in the deep tail (p-values to
// ~1e-300).
//
// Replaces: the device tails of `interaction_batch` (engine.py:794-801).
//
// What bounds it on the H100: operations, and those on the FP64 pipes'
// division and transcendental throughput: per pair ~100 bisection steps of
// C divisions and 64 series terms (each a gammaincc of tens of
// iterations), ~3e4 flop at C = 10.  Design: one thread per pair, blocks
// of 128; the weights are read from global memory (L1-cached) at each
// pass over them.  Nothing but the two p-values is written.
#include <cuda_runtime.h>
#include <cfloat>
#include <cmath>
#include <cstdint>

namespace {

constexpr int NT = 128;
constexpr int MAX_IT = 2000;

__device__ double gammaincc_d(double a, double x) {
  if (isnan(a) || isnan(x) || a < 0.0 || x < 0.0) return nan("");
  if (a == 0.0) return x > 0.0 ? 0.0 : nan("");
  if (x == 0.0) return 1.0;
  if (isinf(x)) return 0.0;
  const double lpre = -x + a * log(x) - lgamma(a);
  if (x < a + 1.0) {  // 1 - P(a, x), P by its series
    double ap = a, term = 1.0 / a, sum = term;
    for (int i = 0; i < MAX_IT; ++i) {
      ap += 1.0;
      term *= x / ap;
      sum += term;
      if (fabs(term) < fabs(sum) * DBL_EPSILON) break;
    }
    return 1.0 - sum * exp(lpre);
  }
  // Q(a, x) by Lentz's continued fraction
  const double tiny = 1e-300;
  double b = x + 1.0 - a, c = 1.0 / tiny, d = 1.0 / b, h = d;
  for (int i = 1; i <= MAX_IT; ++i) {
    const double an = -i * (i - a);
    b += 2.0;
    d = an * d + b;
    if (fabs(d) < tiny) d = tiny;
    c = b + an / c;
    if (fabs(c) < tiny) c = tiny;
    d = 1.0 / d;
    const double del = d * c;
    h *= del;
    if (fabs(del - 1.0) < DBL_EPSILON) break;
  }
  return exp(lpre) * h;
}

// the noncentral chi2 tail by the Poisson series (ncp = 0: central)
__device__ double ncx2_sf(double x, double df, double ncp) {
  const double xh = fmax(x, 0.0) / 2.0;
  if (!(ncp > 0.0)) return gammaincc_d(df / 2.0, xh);
  const double halfn = ncp / 2.0;
  const double lh = log(fmax(halfn, DBL_MIN));
  double series = 0.0;
  for (int k = 0; k < 64; ++k) {
    const double w = exp(-halfn + k * lh - lgamma(k + 1.0));
    series += w * gammaincc_d((df + 2.0 * k) / 2.0, xh);
  }
  return series;
}

__device__ double liu_sf(double q, const double* lam, int C) {
  double c1 = 0.0, c2 = 0.0, c3 = 0.0, c4 = 0.0;
  for (int i = 0; i < C; ++i) {
    const double l = lam[i], l2 = l * l;
    c1 += l;
    c2 += l2;
    c3 += l2 * l;
    c4 += l2 * l2;
  }
  const double r2 = sqrt(c2);
  const double s1 = c3 / (r2 * r2 * r2);
  const double s2 = c4 / (c2 * c2);
  const bool has_ncp = s1 * s1 > s2;
  const double a = 1.0 / (s1 - sqrt(fmax(s1 * s1 - s2, 0.0)));
  const double ncp_1 = s1 * (a * a * a) - a * a;
  const double ncp = has_ncp ? ncp_1 : 0.0;
  const double dof = has_ncp ? a * a - 2.0 * ncp_1 : 1.0 / s2;
  const double sigma_x = sqrt(2.0 * (dof + 2.0 * ncp));
  const double t = (q - c1) / sqrt(2.0 * c2);
  return ncx2_sf(t * sigma_x + dof + ncp, dof, ncp);
}

// jax.scipy.special's ndtr
__device__ double ndtr(double x) {
  const double half_sqrt_2 = 0.5 * 1.4142135623730951;
  const double w = x * half_sqrt_2, z = fabs(w);
  const double y = z < half_sqrt_2 ? 1.0 + erf(w)
                                   : (w > 0.0 ? 2.0 - erfc(z) : erfc(z));
  return 0.5 * y;
}

__device__ double kprime(double t, const double* lam, int C) {
  double v = 0.0;
  for (int i = 0; i < C; ++i) v += lam[i] / (1.0 - 2.0 * t * lam[i]);
  return v;
}

__global__ void __launch_bounds__(NT)
mixture_tails_kernel(const double* __restrict__ Q,
                     const double* __restrict__ lam_all,
                     double* __restrict__ pv_liu, double* __restrict__ pv_sp,
                     int64_t P, int C, int n_bisect) {
  const int64_t i = (int64_t)blockIdx.x * NT + threadIdx.x;
  if (i >= P) return;
  const double q = Q[i];
  const double* lam = lam_all + i * C;
  const double liu = liu_sf(q, lam, C);
  pv_liu[i] = liu;

  double lmax = -INFINITY, mean = 0.0;
  for (int k = 0; k < C; ++k) {
    lmax = fmax(lmax, lam[k]);
    mean += lam[k];
  }
  const double hi = 1.0 / (2.0 * lmax);
  const double span = fmax(mean, 1.0) / fmax(q, DBL_MIN);
  double a = -fabs(hi) * 1e3 - span * 1e3 - 1e3;
  double b = hi * (1.0 - 1e-12);
  for (int it = 0; it < n_bisect; ++it) {
    const double mid = 0.5 * (a + b);
    if (kprime(mid, lam, C) < q) a = mid;
    else b = mid;
  }
  const double t = 0.5 * (a + b);
  double K = 0.0, kpp = 0.0;
  for (int k = 0; k < C; ++k) {
    const double l = lam[k];
    K += log1p(-2.0 * t * l);
    const double d = 1.0 - 2.0 * t * l;
    kpp += 2.0 * (l * l) / (d * d);
  }
  K *= -0.5;
  const double sgn = t > 0.0 ? 1.0 : (t < 0.0 ? -1.0 : 0.0);
  const double w = sgn * sqrt(fmax(2.0 * (t * q - K), 0.0));
  const double v = t * sqrt(kpp);
  const bool near_mean = fabs(v) < 1e-8;
  const double ws = near_mean ? 1.0 : w, vs = near_mean ? 1.0 : v;
  const double sp = 1.0 - ndtr(ws + log(vs / ws) / ws);
  pv_sp[i] = (near_mean || lmax <= 0.0) ? liu : sp;
}

}  // namespace

// Q (P,), lam (P, C) row-major f64 on the card -> pv_liu, pv_sp (P,);
// n_bisect bisection steps of the saddlepoint (the JAX package's
// n_iters + 60).  Launches on `stream`; returns cudaGetLastError().
extern "C" int crm_mixture_tails(const double* Q, const double* lam,
                                 double* pv_liu, double* pv_sp, int64_t P,
                                 int C, int n_bisect, cudaStream_t stream) {
  const int64_t blocks = (P + NT - 1) / NT;
  mixture_tails_kernel<<<(unsigned)blocks, NT, 0, stream>>>(
      Q, lam, pv_liu, pv_sp, P, C, n_bisect);
  return (int)cudaGetLastError();
}
