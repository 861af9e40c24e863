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
// What bounds it on the H100: operations on the FP64 CUDA cores (34
// TFLOP/s; the tensor cores take no part): per pair n_iters + 60
// bisection steps of C divisions, a gammaincc of tens of dependent
// iterations (a division each, two on the continued fraction) for the
// central tail, or 64 of them where the Liu match is noncentral (for real
// weights s1^2 <= s2 by Cauchy-Schwarz, so only where rounding tips the
// equality).  Each pair is a chain of dependent steps, so at a few
// hundred pairs the latency of one chain is the time.
//
// Design: pairs over lane groups of L lanes, L = the power of two >= C /
// 2 (1 to 32; C <= 64, the wrapper refuses more), four warps a block; a
// block past P works on the last pair and stores nothing.  Each lane
// holds two of its pair's weights in registers (lane l of the group
// weights l and l + L), so every sum over the weights (the moments, K'(t)
// at each bisection step, K and K'' at the saddlepoint) is a lane's two
// terms, then a butterfly of log2 L xor shuffles: every lane of the group
// ends with the same bits and takes the same branch.
// * Up to CRM_MT_SPEC_MAX_PAIRS pairs (2048: a batch that fills a few
//   warps a scheduler) and C <= 16, a warp a pair, every group holding
//   its weights, and the bisection speculated: a round evaluates K' at
//   the 2^D - 1 midpoints that the next D steps could take (D = 2 at C
//   9-16, 3 up to C = 8), a group a midpoint, gathers them by shuffles
//   and takes D steps.  Its midpoints are the sequential bisection's (the
//   same bracket, the same n_iters + 60 halvings), in half or a third of
//   the dependent rounds: at a few hundred pairs a pair's chain of steps
//   is the time.
// * Else 32 / L pairs a warp, one step a round (the FP64 pipes' issue
//   rate is the time).
// K'(t)'s terms take 1 / (1 - 2 t lambda) as the hardware's estimate and
// two Newton steps (async_copy.cuh's rcp_nr, ~1 ulp), half the dependent
// steps of a division, as does the series of P(a, x) (its divisors are
// >= 1); the continued fraction and the tail keep IEEE divisions.  The
// noncentral series goes to the whole warp: for each pair of the warp
// that needs it (a ballot), every lane takes two of its 64 terms (k =
// lane, lane + 32, lgamma(k + 1) from a table), and a 32-lane butterfly
// adds them in one fixed order.  Nothing but the two p-values is
// written.
#include <cuda_runtime.h>
#include <cfloat>
#include <cmath>
#include <cstdint>

#include "async_copy.cuh"

namespace {

constexpr int NT = 128;  // threads a block: four warps
constexpr int MAX_IT = 2000;
constexpr unsigned FULL = 0xffffffffu;
// up to this many pairs (and C <= 16), a warp a pair, its bisection
// speculated over the warp's groups
#ifndef CRM_MT_SPEC_MAX_PAIRS
#define CRM_MT_SPEC_MAX_PAIRS 2048
#endif

// lgamma(k + 1) = log(k!), k = 0 .. 63 (correctly rounded)
__device__ const double LGAMMA_K1[64] = {
    0.0, 0.0, 0.693147180559945, 1.7917594692280554, 3.178053830347945,
    4.787491742782047, 6.579251212010102, 8.525161361065415,
    10.604602902745249, 12.801827480081467, 15.104412573075514,
    17.502307845873887, 19.987214495661885, 22.55216385312342,
    25.191221182738683, 27.89927138384089, 30.671860106080672,
    33.50507345013689, 36.39544520803305, 39.339884187199495,
    42.335616460753485, 45.38013889847691, 48.47118135183522,
    51.60667556776438, 54.78472939811232, 58.00360522298052,
    61.26170176100201, 64.55753862700634, 67.88974313718153,
    71.257038967168, 74.65823634883017, 78.0922235533153, 81.55795945611503,
    85.05446701758152, 88.58082754219768, 92.1361756036871, 95.7196945421432,
    99.33061245478743, 102.96819861451381, 106.63176026064346,
    110.32063971475738, 114.03421178146169, 117.77188139974507,
    121.53308151543864, 125.3172711493569, 129.12393363912722,
    132.95257503561632, 136.80272263732635, 140.67392364823425,
    144.5657439463449, 148.47776695177305, 152.40959258449732,
    156.3608363030788, 160.3311282166309, 164.32011226319514,
    168.32744544842765, 172.35279713916282, 176.39584840699737,
    180.45629141754375, 184.53382886144948, 188.62817342367163,
    192.7390472878449, 196.86618167288998, 201.00931639928152};

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
      term *= x * rcp_nr(ap);  // ap >= 1
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

// jax.scipy.special's ndtr
__device__ double ndtr(double x) {
  const double half_sqrt_2 = 0.5 * 1.4142135623730951;
  const double w = x * half_sqrt_2, z = fabs(w);
  const double y = z < half_sqrt_2 ? 1.0 + erf(w)
                                   : (w > 0.0 ? 2.0 - erfc(z) : erfc(z));
  return 0.5 * y;
}

// the sum of v over the aligned group of L lanes (a power of two): a
// butterfly, so that every lane of the group holds the same bits
__device__ __forceinline__ double group_sum(double v, int L) {
  for (int o = L >> 1; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// D = 0: a group of L lanes a pair, 32 / L pairs a warp.  D = 2 or 3 (L
// <= 8): a warp a pair, every group holding its weights; each round of
// the bisection evaluates K' at the 2^D - 1 midpoints the next D steps
// could take (group g at node g of that tree, in heap order), gathers
// them, then takes D steps, so that the midpoints are the sequential
// bisection's.
template <int D>
__global__ void __launch_bounds__(NT)
mixture_tails_kernel(const double* __restrict__ Q,
                     const double* __restrict__ lam_all,
                     double* __restrict__ pv_liu, double* __restrict__ pv_sp,
                     int64_t P, int C, int L, int n_bisect) {
  const int lane = threadIdx.x % 32;
  const int gl = lane % L;                 // the lane in its group
  const int lead = lane - gl;              // the group's first lane
  const int plead = D ? 0 : lead;          // the pair's first lane
  const int64_t pair =
      ((int64_t)blockIdx.x * NT + threadIdx.x) / (D ? 32 : L);
  const bool valid = pair < P;
  const int64_t i = valid ? pair : P - 1;  // past P: the last pair, unstored
  const double q = Q[i];
  const double* lam = lam_all + i * C;
  // the lane's weights, gl and gl + L (C <= 2L), in registers
  const bool has0 = gl < C, has1 = gl + L < C;
  const double l0 = has0 ? lam[gl] : 0.0, l1 = has1 ? lam[gl + L] : 0.0;
  auto lane_sum = [&](auto f) {
    return (has0 ? f(l0) : 0.0) + (has1 ? f(l1) : 0.0);
  };

  // the moments: c1 (the mean), c2, c3, c4 and lambda_max (NaN if a
  // weight is NaN, as the reference's max)
  double c1 = 0.0, c2 = 0.0, c3 = 0.0, c4 = 0.0, lmax = -INFINITY;
  auto moments = [&](double l) {
    const double l2 = l * l;
    c1 += l;
    c2 += l2;
    c3 += l2 * l;
    c4 += l2 * l2;
    lmax = (l > lmax || l != l) ? l : lmax;
  };
  if (has0) moments(l0);
  if (has1) moments(l1);
  c1 = group_sum(c1, L);
  c2 = group_sum(c2, L);
  c3 = group_sum(c3, L);
  c4 = group_sum(c4, L);
  for (int o = L >> 1; o > 0; o >>= 1) {
    const double m = __shfl_xor_sync(FULL, lmax, o);
    lmax = (m > lmax || m != m) ? m : lmax;
  }
  lmax = __shfl_sync(FULL, lmax, lead);  // one value for the whole group

  // Liu: the chi2 match, then its tail
  const double r2 = sqrt(c2);
  const double s1 = c3 / (r2 * r2 * r2);
  const double s2 = c4 / (c2 * c2);
  const bool has_ncp = s1 * s1 > s2;
  const double a_ = 1.0 / (s1 - sqrt(fmax(s1 * s1 - s2, 0.0)));
  const double ncp_1 = s1 * (a_ * a_ * a_) - a_ * a_;
  const double ncp = has_ncp ? ncp_1 : 0.0;
  const double dof = has_ncp ? a_ * a_ - 2.0 * ncp_1 : 1.0 / s2;
  const double sigma_x = sqrt(2.0 * (dof + 2.0 * ncp));
  const double tq = (q - c1) / sqrt(2.0 * c2);
  const double xh = fmax(tq * sigma_x + dof + ncp, 0.0) / 2.0;
  const bool series = ncp > 0.0;
  double liu = series ? 0.0 : gammaincc_d(dof / 2.0, xh);
  // the noncentral series, a pair of the warp at a time over all 32 lanes
  unsigned need = __ballot_sync(FULL, series && lane == plead);
  while (need) {
    const int src = __popc((need & (0u - need)) - 1u);  // its lowest lane
    need &= need - 1u;
    const double df_j = __shfl_sync(FULL, dof, src);
    const double xh_j = __shfl_sync(FULL, xh, src);
    const double halfn = __shfl_sync(FULL, ncp, src) / 2.0;
    const double lh = log(fmax(halfn, DBL_MIN));
    double part = 0.0;
    for (int k = lane; k < 64; k += 32) {
      const double w = exp(-halfn + k * lh - LGAMMA_K1[k]);
      part += w * gammaincc_d((df_j + 2.0 * k) / 2.0, xh_j);
    }
    part = group_sum(part, 32);
    if (plead == src) liu = part;
  }

  // the saddlepoint: the reference's bisection on K'(t) = q
  const double hi = 1.0 / (2.0 * lmax);
  const double span = fmax(c1, 1.0) / fmax(q, DBL_MIN);
  double a = -fabs(hi) * 1e3 - span * 1e3 - 1e3;
  double b = hi * (1.0 - 1e-12);
  auto kprime = [&](double mid) {
    return group_sum(lane_sum([mid](double l) {
      return l * rcp_nr(1.0 - 2.0 * mid * l);
    }), L);
  };
  int steps = n_bisect;
  if constexpr (D > 0) {
    constexpr int NODES = (1 << D) - 1;
    // this group's node (the groups past the tree repeat the last one)
    // and its path from the root, a bit a level (1: the right half)
    const int node = lane / L < NODES ? lane / L : NODES - 1;
    int level = 0;
    while ((2 << level) <= node + 1) ++level;
    for (; steps >= D; steps -= D) {
      double lo = a, up = b;
#pragma unroll
      for (int k = 0; k < D - 1; ++k) {
        if (k < level) {
          const double mid = 0.5 * (lo + up);
          if (((node + 1) >> (level - 1 - k)) & 1) lo = mid;
          else up = mid;
        }
      }
      const double kp_mine = kprime(0.5 * (lo + up));
      double kp[NODES];
#pragma unroll
      for (int j = 0; j < NODES; ++j)
        kp[j] = __shfl_sync(FULL, kp_mine, j * L);
      int at = 0;
#pragma unroll
      for (int k = 0; k < D; ++k) {
        double kk = kp[(1 << k) - 1];
#pragma unroll
        for (int j = (1 << k); j < (2 << k) - 1; ++j)
          kk = at == j ? kp[j] : kk;
        const double mid = 0.5 * (a + b);
        if (kk < q) {
          a = mid;
          at = 2 * at + 2;
        } else {
          b = mid;
          at = 2 * at + 1;
        }
      }
    }
  }
  for (; steps > 0; --steps) {
    const double mid = 0.5 * (a + b);
    if (kprime(mid) < q) a = mid;
    else b = mid;
  }
  const double t = 0.5 * (a + b);
  const double K = -0.5 * group_sum(
      lane_sum([t](double l) { return log1p(-2.0 * t * l); }), L);
  const double kpp = group_sum(lane_sum([t](double l) {
    const double d = 1.0 - 2.0 * t * l;
    return 2.0 * (l * l) / (d * d);
  }), L);
  const double sgn = t > 0.0 ? 1.0 : (t < 0.0 ? -1.0 : 0.0);
  const double w = sgn * sqrt(fmax(2.0 * (t * q - K), 0.0));
  const double v = t * sqrt(kpp);
  const bool near_mean = fabs(v) < 1e-8;
  const double ws = near_mean ? 1.0 : w, vs = near_mean ? 1.0 : v;
  const double sp = 1.0 - ndtr(ws + log(vs / ws) / ws);
  if (valid && lane == plead) {
    pv_liu[i] = liu;
    pv_sp[i] = (near_mean || lmax <= 0.0) ? liu : sp;
  }
}

}  // namespace

// Q (P,), lam (P, C <= 64) row-major f64 on the card -> pv_liu, pv_sp (P,);
// n_bisect bisection steps of the saddlepoint (the JAX package's
// n_iters + 60).  Launches on `stream`; returns cudaGetLastError().
extern "C" int crm_mixture_tails(const double* Q, const double* lam,
                                 double* pv_liu, double* pv_sp, int64_t P,
                                 int C, int n_bisect, cudaStream_t stream) {
  int L = 1;  // lanes a group: two weights a lane, a warp from C = 33
  while (L < 32 && 2 * L < C) L *= 2;
  // a few pairs: a warp a pair, the bisection speculated D steps a round
  // over 2^D - 1 groups (latency); else 32 / L pairs a warp (throughput)
  const int D = (P > CRM_MT_SPEC_MAX_PAIRS || L > 8) ? 0 : L == 8 ? 2 : 3;
  const int64_t per_block = D ? NT / 32 : NT / L;
  const unsigned blocks = (unsigned)((P + per_block - 1) / per_block);
  auto k0 = mixture_tails_kernel<0>;
  auto k2 = mixture_tails_kernel<2>;
  auto k3 = mixture_tails_kernel<3>;
  if (D == 0)
    k0<<<blocks, NT, 0, stream>>>(Q, lam, pv_liu, pv_sp, P, C, L, n_bisect);
  else if (D == 2)
    k2<<<blocks, NT, 0, stream>>>(Q, lam, pv_liu, pv_sp, P, C, L, n_bisect);
  else
    k3<<<blocks, NT, 0, stream>>>(Q, lam, pv_liu, pv_sp, P, C, L, n_bisect);
  return (int)cudaGetLastError();
}
