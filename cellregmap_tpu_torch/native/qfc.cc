// Exact tail probabilities for quadratic forms in normal variables.
//
// P(Q > q) for Q = sum_j lambda_j chi2(n_j, delta_j^2) + sigma N(0,1),
// by numerical inversion of the characteristic function following Davies'
// method (Davies 1980, "The distribution of a linear combination of chi^2
// random variables", Algorithm AS 155):
//
//   * Chernoff-bound cutoffs pick a sampling interval whose aliasing error
//     is below the accuracy target;
//   * a truncation bound picks the upper integration limit;
//   * when the |phi(u)| decay is too slow for a direct midpoint series
//     (few degrees of freedom), an auxiliary Gaussian convolution factor
//     exp(-tau^2 u^2 / 2) splits the integral into a coarsely-sampled
//     correction term (aliasing bounded through the cfe density bound) and
//     a rapidly-decaying main term;
//   * the inversion integral is evaluated as midpoint series.
//
// This replaces the reference stack's only native dependency (the C `qfc`
// routine inside `chiscore`, consumed by CellRegMap's
// cellregmap/_cellregmap.py:333,435).  Implemented from the published
// algorithm; validated against an independent SciPy Imhof quadrature oracle
// and exactly-reducible chi-square mixtures in tests/test_pvalues.py and
// tests/test_torch_pvalues.py.  This is the PyTorch port's own copy of
// cellregmap_tpu/native/qfc.cc, so the port builds without the JAX package.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC -o libqfc.so qfc.cc -lpthread
//
// ifault: 0 ok; 1 accuracy not achievable with `lim` terms; 2 round-off
//         significant; 5 invalid input.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <thread>
#include <vector>

namespace {

constexpr double kPi = 3.14159265358979323846;
constexpr double kLn2Over8 = 0.0866433975699931636772;  // ln(2)/8

inline double exp1(double x) { return x < -700.0 ? 0.0 : std::exp(x); }

// Regularized upper incomplete gamma Q(a, x) = Gamma(a,x)/Gamma(a).
// Series for x < a+1, Lentz continued fraction otherwise (standard
// numerics; absolute accuracy ~1e-14).
double igamc(double a, double x) {
  if (x <= 0.0) return 1.0;
  if (a <= 0.0) return 0.0;
  if (x < a + 1.0) {
    // P(a,x) by series, return 1 - P
    double ap = a, sum = 1.0 / a, del = sum;
    for (int i = 0; i < 500; ++i) {
      ap += 1.0;
      del *= x / ap;
      sum += del;
      if (std::fabs(del) < std::fabs(sum) * 1e-16) break;
    }
    double lg = std::lgamma(a);
    double p = sum * exp1(-x + a * std::log(x) - lg);
    double q = 1.0 - p;
    return q < 0.0 ? 0.0 : q;
  }
  // continued fraction for Q(a,x)
  double b = x + 1.0 - a, cc = 1e300, d = 1.0 / b, h = d;
  for (int i = 1; i <= 500; ++i) {
    double an = -i * (i - a);
    b += 2.0;
    d = an * d + b;
    if (std::fabs(d) < 1e-300) d = 1e-300;
    cc = b + an / cc;
    if (std::fabs(cc) < 1e-300) cc = 1e-300;
    d = 1.0 / d;
    double del = d * cc;
    h *= del;
    if (std::fabs(del - 1.0) < 1e-16) break;
  }
  double lg = std::lgamma(a);
  double q = exp1(-x + a * std::log(x) - lg) * h;
  return q > 1.0 ? 1.0 : (q < 0.0 ? 0.0 : q);
}

// chi2 survival with k degrees of freedom.
inline double chi2_sf(double x, double k) { return igamc(0.5 * k, 0.5 * x); }

// log(1+x) (first=true) or log(1+x)-x (first=false), accurately.
inline double log1(double x, bool first) {
  if (first) return std::log1p(x);
  if (std::fabs(x) < 1e-4)
    return x * x * (-0.5 + x * (1.0 / 3.0 + x * (-0.25 + 0.2 * x)));
  return std::log1p(x) - x;
}

class QfSolver {
 public:
  QfSolver(const double* lb, const double* nc, const int* df, int r,
           double sigma, double q, double lim, double acc)
      : lb_(lb), nc_(nc), df_(df), r_(r), sigsq_(sigma * sigma), c_(q),
        lim_(lim), acc_(acc) {}

  double survival(int* ifault);

 private:
  const double* lb_;
  const double* nc_;
  const int* df_;
  int r_;
  double sigsq_;
  double c_;
  double lim_;
  double acc_;

  double intl_ = 0.0;
  double ersm_ = 0.0;
  bool fail_ = false;
  long count_ = 0;
  long count_lim_ = 0;
  bool over_ = false;
  std::vector<int> th_;
  bool sorted_ = false;

  double ncj(int j) const { return nc_ ? nc_[j] : 0.0; }
  int dfj(int j) const { return df_ ? df_[j] : 1; }

  void tick() {
    if (++count_ > count_lim_) over_ = true;
  }

  void order() {
    th_.resize(r_);
    for (int j = 0; j < r_; ++j) th_[j] = j;
    std::sort(th_.begin(), th_.end(), [&](int a, int b) {
      return std::fabs(lb_[a]) < std::fabs(lb_[b]);
    });
    sorted_ = true;
  }

  // Chernoff bound on the tail beyond the tilted mean *cx at tilt u.
  double errbd(double u, double* cx) {
    tick();
    double xconst = u * sigsq_;
    double sum1 = u * xconst;
    double two_u = 2.0 * u;
    for (int j = r_ - 1; j >= 0; --j) {
      double lj = lb_[j];
      double d2 = ncj(j);
      int nj = dfj(j);
      double x = two_u * lj;
      double y = 1.0 - x;
      xconst += lj * (d2 / y + nj) / y;
      sum1 += d2 * (x / y) * (x / y)
              + nj * (x * x / y + 2.0 * log1(-x, false));
    }
    *cx = xconst;
    return exp1(-0.5 * sum1);
  }

  // Cutoff c_u with tail probability < accx (upper if *upn > 0).
  double ctff(double accx, double* upn, double mean, double lmin,
              double lmax) {
    double u2 = *upn, u1 = 0.0, c1 = mean, c2;
    double rb = 2.0 * ((u2 > 0.0) ? lmax : lmin);
    double u = u2 / (1.0 + u2 * rb);
    while (errbd(u, &c2) > accx) {
      u1 = u2;
      c1 = c2;
      u2 *= 2.0;
      u = u2 / (1.0 + u2 * rb);
      if (over_) return c2;
    }
    for (u = (c1 - mean) / (c2 - mean); u < 0.9;
         u = (c1 - mean) / (c2 - mean)) {
      u = (u1 + u2) / 2.0;
      double xconst;
      if (errbd(u / (1.0 + u * rb), &xconst) > accx) {
        u1 = u;
        c1 = xconst;
      } else {
        u2 = u;
        c2 = xconst;
      }
      if (over_) break;
    }
    *upn = u2;
    return c2;
  }

  // Bound on the integration error from truncating at u (with additional
  // Gaussian convolution variance tausq).
  double truncation(double u, double tausq) {
    tick();
    double sum1 = 0.0, prod2 = 0.0, prod3 = 0.0;
    int s = 0;
    double sigsq = sigsq_ + tausq;
    double sum2 = sigsq * u * u;
    double prod1 = 2.0 * sum2;
    double two_u = 2.0 * u;
    for (int j = 0; j < r_; ++j) {
      double lj = lb_[j];
      double x = two_u * lj;
      double y = x * x;
      sum1 += ncj(j) * y / (1.0 + y);
      if (y > 1.0) {
        prod2 += dfj(j) * std::log(y);
        prod3 += dfj(j) * log1(y, true);
        s += dfj(j);
      } else {
        prod1 += dfj(j) * log1(y, true);
      }
    }
    sum1 *= 0.5;
    prod2 += prod1;
    prod3 += prod1;
    double x = exp1(-sum1 - 0.25 * prod2) / kPi;
    double y = exp1(-sum1 - 0.25 * prod3) / kPi;
    double err1 = (s == 0) ? 1.0 : x * 2.0 / s;
    double err2 = (prod3 > 1.0) ? 2.5 * y : 1.0;
    if (err2 < err1) err1 = err2;
    x = 0.5 * sum2;
    err2 = (x <= y) ? 1.0 : y / x;
    return (err1 < err2) ? err1 : err2;
  }

  // Find u such that truncation(u, 0) <= accx; start search at *utx.
  void findu(double* utx, double accx) {
    static const double divis[] = {2.0, 1.4, 1.2, 1.1};
    double ut = *utx;
    double u = ut / 4.0;
    if (truncation(u, 0.0) > accx) {
      for (u = ut; truncation(u, 0.0) > accx; u = ut) {
        ut *= 4.0;
        if (over_) break;
      }
    } else {
      ut = u;
      for (u /= 4.0; truncation(u, 0.0) <= accx; u /= 4.0) {
        ut = u;
        if (over_) break;
      }
    }
    for (int i = 0; i < 4; ++i) {
      u = ut / divis[i];
      if (truncation(u, 0.0) <= accx) ut = u;
      if (over_) break;
    }
    *utx = ut;
  }

  // Midpoint series over the inversion integrand.  With mainx=false the
  // integrand is multiplied by (1 - exp(-tau^2 u^2 / 2)) — the part of the
  // original integral that the Gaussian convolution removes.
  void integrate(long nterm, double interv, double tausq, bool mainx) {
    double inpi = interv / kPi;
    for (long k = nterm; k >= 0; --k) {
      double u = (k + 0.5) * interv;
      double sum1 = -2.0 * u * c_;
      double sum2 = std::fabs(sum1);
      double sum3 = -0.5 * sigsq_ * u * u;
      for (int j = r_ - 1; j >= 0; --j) {
        int nj = dfj(j);
        double x = 2.0 * lb_[j] * u;
        double y = x * x;
        sum3 -= 0.25 * nj * log1(y, true);
        double yn = ncj(j) * x / (1.0 + y);
        double z = nj * std::atan(x) + yn;
        sum1 += z;
        sum2 += std::fabs(z);
        sum3 -= 0.5 * x * yn;
      }
      double x = inpi * exp1(sum3) / u;
      if (!mainx) x *= (1.0 - exp1(-0.5 * tausq * u * u));
      sum1 = std::sin(0.5 * sum1) * x;
      sum2 *= 0.5 * x;
      intl_ += sum1;
      ersm_ += sum2;
    }
  }

  // Bound on the aliasing error coefficient of tau^2 when the convolution
  // factor is used and the cdf is evaluated at x (Davies' cfe function).
  double cfe(double x) {
    tick();
    if (!sorted_) order();
    double axl = std::fabs(x);
    double sxl = (x > 0.0) ? 1.0 : -1.0;
    double sum1 = 0.0;
    for (int j = r_ - 1; j >= 0; --j) {
      int t = th_[j];
      if (lb_[t] * sxl > 0.0) {
        double lj = std::fabs(lb_[t]);
        double axl1 = axl - lj * (dfj(t) + ncj(t));
        double axl2 = lj / kLn2Over8;
        if (axl1 > axl2) {
          axl = axl1;
        } else {
          if (axl > axl2) axl = axl2;
          sum1 = (axl - axl1) / lj;
          for (int k = j - 1; k >= 0; --k)
            sum1 += dfj(th_[k]) + ncj(th_[k]);
          break;
        }
      }
    }
    if (sum1 > 100.0) {
      fail_ = true;
      return 1.0;
    }
    return std::pow(2.0, sum1 / 4.0) / (kPi * axl * axl);
  }
};

double QfSolver::survival(int* ifault) {
  *ifault = 0;
  count_lim_ = std::max(4000L, 10L * (long)lim_);

  double sd2 = sigsq_;
  double mean = 0.0, lmax = 0.0, lmin = 0.0;
  for (int j = 0; j < r_; ++j) {
    double lj = lb_[j];
    int nj = dfj(j);
    double d2 = ncj(j);
    if (nj < 0 || d2 < 0.0) {
      *ifault = 5;
      return -1.0;
    }
    sd2 += lj * lj * (2 * nj + 4 * d2);
    mean += lj * (nj + d2);
    lmax = std::max(lmax, lj);
    lmin = std::min(lmin, lj);
  }
  if (sd2 == 0.0) return c_ <= 0.0 ? 1.0 : 0.0;
  if (lmin == 0.0 && lmax == 0.0 && sigsq_ == 0.0) {
    *ifault = 5;
    return -1.0;
  }
  double sd = std::sqrt(sd2);
  double almx = std::max(lmax, -lmin);

  double xlim = lim_;
  double acc1 = acc_;
  double utx = 16.0 / sd;
  double up = 4.5 / sd, un = -up;
  findu(&utx, 0.5 * acc1);

  // Does an initial convergence factor help?
  if (c_ != 0.0 && almx > 0.07 * sd) {
    double tausq = 0.25 * acc1 / cfe(c_);
    if (fail_) {
      fail_ = false;
    } else if (truncation(utx, tausq) < 0.2 * acc1) {
      sigsq_ += tausq;
      findu(&utx, 0.25 * acc1);
    }
  }
  acc1 *= 0.5;

  double qfval = -1.0;
  long nt_total = 0;
  for (;;) {
    // Range of the distribution: if q is outside, the answer is immediate.
    double d1 = ctff(acc1, &up, mean, lmin, lmax) - c_;
    if (d1 < 0.0) {
      qfval = 1.0;  // cdf ~ 1
      break;
    }
    double d2v = c_ - ctff(acc1, &un, mean, lmin, lmax);
    if (d2v < 0.0) {
      qfval = 0.0;
      break;
    }
    if (over_) {
      *ifault = 1;
      return -1.0;
    }
    double intv = 2.0 * kPi / std::max(d1, d2v);
    double xnt = utx / intv;
    double xntm = 3.0 / std::sqrt(acc1);
    if (xnt > xntm * 1.5) {
      // Auxiliary integration: coarse series on the convolution-removed
      // part, then continue with the damped integrand.
      if (xntm > xlim) {
        *ifault = 1;
        return -1.0;
      }
      long ntm = (long)std::floor(xntm + 0.5);
      double intv1 = utx / ntm;
      double x = 2.0 * kPi / intv1;
      if (x <= std::fabs(c_)) {
        // fall through to main integration
      } else {
        double tausq = 0.33 * acc1 / (1.1 * (cfe(c_ - x) + cfe(c_ + x)));
        if (fail_) {
          fail_ = false;
          // cannot bound the aliasing: fall through to main integration
        } else {
          acc1 *= 0.67;
          integrate(ntm, intv1, tausq, false);
          xlim -= xntm;
          nt_total += ntm + 1;
          sigsq_ += tausq;
          findu(&utx, 0.25 * acc1);
          acc1 *= 0.75;
          continue;
        }
      }
    }
    // Main integration.
    if (xnt > xlim) {
      *ifault = 1;
      return -1.0;
    }
    long nt = (long)std::floor(xnt + 0.5);
    integrate(nt, intv, 0.0, true);
    nt_total += nt + 1;
    qfval = 0.5 - intl_;
    break;
  }

  // Round-off significance check.
  double upv = ersm_;
  double x = upv + acc_ / 10.0;
  static const double rats[] = {1.0, 2.0, 4.0, 8.0};
  for (int j = 0; j < 4; ++j)
    if (rats[j] * x == rats[j] * upv) *ifault = 2;

  double sf = 1.0 - qfval;
  if (sf < 0.0) sf = 0.0;
  if (sf > 1.0) sf = 1.0;
  return sf;
}

}  // namespace

extern "C" {

// Merge exactly-equal eigenvalues into df counts (exact reduction), then
// solve; central single-eigenvalue mixtures have a closed form.
double qfc_survival_merged(const double* lb, const double* nc, const int* df,
                           int r, double sigma, double q, int lim, double acc,
                           int* ifault) {
  std::vector<double> mlb, mnc;
  std::vector<int> mdf;
  for (int j = 0; j < r; ++j) {
    double lj = lb[j];
    double d2 = nc ? nc[j] : 0.0;
    int nj = df ? df[j] : 1;
    bool merged = false;
    for (size_t k = 0; k < mlb.size(); ++k) {
      if (mlb[k] == lj) {
        mdf[k] += nj;
        mnc[k] += d2;
        merged = true;
        break;
      }
    }
    if (!merged) {
      mlb.push_back(lj);
      mnc.push_back(d2);
      mdf.push_back(nj);
    }
  }
  int mr = (int)mlb.size();
  bool central = true;
  for (double d2 : mnc)
    if (d2 != 0.0) central = false;
  if (mr == 1 && central && sigma == 0.0 && mlb[0] > 0.0) {
    *ifault = 0;
    return chi2_sf(q / mlb[0], (double)mdf[0]);
  }
  QfSolver s(mlb.data(), central ? nullptr : mnc.data(), mdf.data(), mr,
             sigma, q, (double)lim, acc);
  return s.survival(ifault);
}

// Single problem.  lb: lambdas (r).  nc: noncentralities or NULL.
// df: degrees of freedom or NULL (-> all 1).  Returns P(Q > q).
double qfc_survival(const double* lb, const double* nc, const int* df, int r,
                    double sigma, double q, int lim, double acc,
                    int* ifault) {
  return qfc_survival_merged(lb, nc, df, r, sigma, q, lim, acc, ifault);
}

// Batched central chi2(1) mixtures (the CellRegMap score-test case), with
// SKAT-style eigenvalue filtering (keep lambda > mean(positive)/ratio),
// threaded across problems.  lambdas: (n_problems x c) row-major, zero
// padding allowed.  out_pv: survival per problem; out_fault: ifault codes.
void qfc_survival_batch(const double* lambdas, const double* qs,
                        int n_problems, int c, int lim, double acc,
                        double filter_ratio, int n_threads, double* out_pv,
                        int* out_fault) {
  if (n_threads <= 0) {
    n_threads = (int)std::thread::hardware_concurrency();
    if (n_threads <= 0) n_threads = 1;
  }
  n_threads = std::min(n_threads, std::max(1, n_problems));
  std::atomic<int> next(0);

  auto worker = [&]() {
    std::vector<double> lam;
    lam.reserve(c);
    while (true) {
      int i = next.fetch_add(1);
      if (i >= n_problems) break;
      const double* row = lambdas + (int64_t)i * c;
      double pos_sum = 0.0;
      int pos_n = 0;
      for (int j = 0; j < c; ++j)
        if (row[j] >= 0.0) {
          pos_sum += row[j];
          ++pos_n;
        }
      double thr = pos_n ? (pos_sum / pos_n) / filter_ratio : 0.0;
      lam.clear();
      for (int j = 0; j < c; ++j)
        if (row[j] > thr) lam.push_back(row[j]);
      if (lam.empty()) {
        out_pv[i] = 1.0;
        out_fault[i] = 0;
        continue;
      }
      std::sort(lam.begin(), lam.end(), std::greater<double>());
      int ifault = 0;
      out_pv[i] = qfc_survival_merged(lam.data(), nullptr, nullptr,
                                      (int)lam.size(), 0.0, qs[i], lim, acc,
                                      &ifault);
      out_fault[i] = ifault;
    }
  };

  std::vector<std::thread> threads;
  for (int t = 0; t < n_threads; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
}

}  // extern "C"
