"""Mixture-of-chi-squared tail probabilities: the host p-value ladder.

The score statistic's null law is Q ~ sum_i lambda_i chi2_1.  The exact
path (the reference's ``chiscore.davies_pvalue``) runs on the host:

1. Davies' algorithm (native/qfc.cc via ctypes, threaded over a batch),
   with a descending-accuracy ladder for deep-tail results;
2. an Imhof quadrature when Davies fails;
3. modified Liu (4-moment chi-squared match) as the last rung.

A NumPy/SciPy port of ``cellregmap_tpu.models.pvalues`` plus the port's
own copy of ``oracle.imhof_sf``, with two deep-tail repairs of the
reference's ladder: a Davies refinement flagged ifault 2 (round-off) is
accepted only inside a relative band of an independent inversion of the
tail (:func:`imhof_sf`, which the port extends past Imhof's cancellation
limit), and a batch result below zero goes through the ladder.  The
device tails of the Liu, saddlepoint and auto methods (mod-Liu and the
Kuonen saddlepoint, batched over pairs) are :func:`liu_sf_torch` and
:func:`saddlepoint_sf_torch` here, in torch: the plain versions of the
card's kernel (``kernels.mixture_tails``).
"""
from __future__ import annotations

import logging
import math
import warnings

import numpy as np
import torch
from scipy.integrate import IntegrationWarning, quad
from scipy.optimize import brentq
from scipy.special import gammaincc, gammaln
from scipy.stats import chi2

from ..utils.native import get_qfc

logger = logging.getLogger("cellregmap_tpu_torch")


def liu_sf(q, lambdas, modified: bool = True):
    """Pr(Q > q), Q = sum_i lambda_i chi2_1, by Liu moment matching.

    Batched over leading axes: q (...,), lambdas (..., C); zero lambdas are
    inert.  Returns (pv, dof_x, ncp_x, mu_q, sigma_q).
    """
    lam = np.asarray(lambdas, float)
    q = np.asarray(q, float)
    c1 = np.sum(lam, axis=-1)
    c2 = np.sum(lam**2, axis=-1)
    c3 = np.sum(lam**3, axis=-1)
    c4 = np.sum(lam**4, axis=-1)

    with np.errstate(divide="ignore", invalid="ignore"):
        s1 = c3 / np.sqrt(c2) ** 3
        s2 = c4 / c2**2
        has_ncp = s1**2 > s2
        # branch 1: noncentral match
        a = 1.0 / (s1 - np.sqrt(np.maximum(s1**2 - s2, 0.0)))
        ncp_1 = s1 * a**3 - a**2
        dof_1 = a**2 - 2 * ncp_1
        # branch 2: central, kurtosis-matched (modified) or skewness
        dof_2 = 1.0 / s2 if modified else 1.0 / s1**2

        ncp_x = np.where(has_ncp, ncp_1, 0.0)
        dof_x = np.where(has_ncp, dof_1, dof_2)

        mu_q = c1
        sigma_q = np.sqrt(2 * c2)
        mu_x = dof_x + ncp_x
        sigma_x = np.sqrt(2 * (dof_x + 2 * ncp_x))

        t = (q - mu_q) / sigma_q
        q_x = t * sigma_x + mu_x
        pv = _ncx2_sf(q_x, dof_x, ncp_x)
    return pv, dof_x, ncp_x, mu_q, sigma_q


def _chi2_sf(x, df):
    return gammaincc(df / 2.0, np.maximum(x, 0.0) / 2.0)


def _ncx2_sf(x, df, ncp, n_terms: int = 64):
    """Noncentral chi2 survival via the Poisson-weighted central series;
    ncp = 0 reduces exactly to the central case."""
    x = np.asarray(x, float)
    df = np.asarray(df, float)
    ncp = np.asarray(ncp, float)
    central = _chi2_sf(x, df)
    k = np.arange(n_terms, dtype=float)
    halfn = ncp[..., None] / 2.0
    tiny = np.finfo(float).tiny
    logw = -halfn + k * np.log(np.maximum(halfn, tiny)) - gammaln(k + 1)
    w = np.exp(logw)
    w = np.where((halfn == 0) & (k == 0), 1.0, np.where(halfn == 0, 0.0, w))
    terms = _chi2_sf(x[..., None], df[..., None] + 2 * k)
    series = np.sum(w * terms, axis=-1)
    return np.where(ncp > 0, series, central)


def liu_sf_torch(q, lam):
    """mod-Liu Pr(Q > q) in torch, batched: q (...,), lam (..., C); the JAX
    package's ``liu_sf`` (cellregmap_tpu/models/pvalues.py:31-69) op for
    op: the powers as products, as its ``integer_pow`` takes them (torch's
    ``lam ** 4`` is ``pow``, an ulp off (lam^2)^2, which can tip the
    branch below where s1^2 and s2 tie).  Returns the p-values (...,)."""
    l2 = lam * lam
    c1 = lam.sum(dim=-1)
    c2 = l2.sum(dim=-1)
    c3 = (l2 * lam).sum(dim=-1)
    c4 = (l2 * l2).sum(dim=-1)
    s1 = c3 / torch.sqrt(c2) ** 3
    s2 = c4 / c2 ** 2
    has_ncp = s1 ** 2 > s2
    a = 1.0 / (s1 - torch.sqrt(torch.clamp(s1 ** 2 - s2, min=0.0)))
    ncp_1 = s1 * a ** 3 - a ** 2
    dof_1 = a ** 2 - 2 * ncp_1
    dof_2 = 1.0 / s2
    ncp_x = torch.where(has_ncp, ncp_1, torch.zeros_like(ncp_1))
    dof_x = torch.where(has_ncp, dof_1, dof_2)
    sigma_x = torch.sqrt(2 * (dof_x + 2 * ncp_x))
    t = (q - c1) / torch.sqrt(2 * c2)
    return _ncx2_sf_torch(t * sigma_x + dof_x + ncp_x, dof_x, ncp_x)


def _ncx2_sf_torch(x, df, ncp, n_terms: int = 64):
    """The 64-term Poisson series of central chi2 tails (the JAX
    package's ``_ncx2_sf``, pvalues.py:76-91)."""
    gcc = torch.special.gammaincc
    xh = torch.clamp(x, min=0.0) / 2.0
    central = gcc(df / 2.0, xh)
    k = torch.arange(n_terms, dtype=x.dtype, device=x.device)
    halfn = ncp[..., None] / 2.0
    tiny = torch.finfo(x.dtype).tiny
    w = torch.exp(-halfn + k * torch.log(torch.clamp(halfn, min=tiny))
                  - torch.lgamma(k + 1))
    w = torch.where((halfn == 0) & (k == 0), torch.ones_like(w),
                    torch.where(halfn == 0, torch.zeros_like(w), w))
    series = (w * gcc((df[..., None] + 2 * k) / 2.0, xh[..., None])).sum(-1)
    return torch.where(ncp > 0, series, central)


def _ndtr_torch(x):
    """The standard normal CDF in the JAX package's form (its ``_ndtr``:
    1 + erf inside |x| < 1, else from erfc), so that 1 - ndtr rounds as
    there."""
    half_sqrt_2 = 0.5 * math.sqrt(2.0)
    w = x * half_sqrt_2
    z = w.abs()
    y = torch.where(z < half_sqrt_2, 1.0 + torch.erf(w),
                    torch.where(w > 0, 2.0 - torch.erfc(z), torch.erfc(z)))
    return 0.5 * y


def saddlepoint_sf_torch(q, lam, n_iters: int = 40):
    """Kuonen saddlepoint Pr(Q > q) in torch, batched: q (...,), lam (...,
    C); the JAX package's ``saddlepoint_sf`` (pvalues.py:97-145) op for op:
    ``n_iters + 60`` bisection steps on K'(t) = q over (lo, 1 / (2 lmax)),
    Lugannani-Rice with 1 - ndtr(z), and the Liu value near the mean (|v| <
    1e-8) or where lmax <= 0."""
    lmax = lam.amax(dim=-1)
    mean = lam.sum(dim=-1)
    hi = 1.0 / (2.0 * lmax)
    tiny = torch.finfo(q.dtype).tiny

    def kp(t):
        return (lam / (1.0 - 2.0 * t[..., None] * lam)).sum(dim=-1)

    span = torch.clamp(mean, min=1.0) / torch.clamp(q, min=tiny)
    a = -hi.abs() * 1e3 - span * 1e3 - 1e3
    b = hi * (1.0 - 1e-12)
    for _ in range(n_iters + 60):
        mid = 0.5 * (a + b)
        below = kp(mid) < q
        a, b = torch.where(below, mid, a), torch.where(below, b, mid)
    t = 0.5 * (a + b)
    K = -0.5 * torch.log1p(-2.0 * t[..., None] * lam).sum(dim=-1)
    w = torch.sign(t) * torch.sqrt(torch.clamp(2.0 * (t * q - K), min=0.0))
    kpp = (2.0 * lam ** 2 / (1.0 - 2.0 * t[..., None] * lam) ** 2).sum(-1)
    v = t * torch.sqrt(kpp)
    near_mean = v.abs() < 1e-8
    one = torch.ones_like(w)
    w_safe = torch.where(near_mean, one, w)
    v_safe = torch.where(near_mean, one, v)
    sp = 1.0 - _ndtr_torch(w_safe + torch.log(v_safe / w_safe) / w_safe)
    return torch.where(near_mean | (lmax <= 0), liu_sf_torch(q, lam), sp)


def imhof_sf(q, lambdas, epsabs=1e-13, epsrel=1e-11):
    """Pr(Q > q) for Q = sum_i lambda_i chi2_1 by Imhof (1961) inversion.

    Independent of Davies' algorithm.  Imhof's form adds the integral to
    1/2, so it loses absolute accuracy in the far tail (pv < ~1e-7); there
    (q above twice the mean, a tail below 1e-6) the same inversion runs
    along a contour shifted to the saddlepoint (:func:`_tail_inversion`),
    whose integrand is of the tail's own size.  All-equal spectra (a
    scaled chi2) use the closed form.
    """
    lambdas = np.asarray(lambdas, float)
    lambdas = lambdas[lambdas != 0.0]
    if lambdas.size == 0:
        return 1.0 if q <= 0 else 0.0
    if np.all(lambdas == lambdas[0]) and lambdas[0] > 0:
        return float(chi2.sf(q / lambdas[0], lambdas.size))

    if q > 2.0 * lambdas.sum() and lambdas.max() > 0:
        tail = _tail_inversion(float(q), lambdas)
        if np.isfinite(tail) and 0.0 <= tail < 1e-6:
            return tail

    def theta(u):
        return 0.5 * np.sum(np.arctan(lambdas * u)) - 0.5 * q * u

    def rho(u):
        return np.prod((1.0 + (lambdas * u) ** 2) ** 0.25)

    def integrand(u):
        if u == 0.0:
            return 0.5 * (np.sum(lambdas) - q)
        return np.sin(theta(u)) / (u * rho(u))

    # few DISTINCT eigenvalues make the integrand decay slowly, so quad may
    # reach its subdivision limit; the value is still well inside the
    # tolerances this rung is used at
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", IntegrationWarning)
        val, _ = quad(integrand, 0.0, np.inf, epsabs=epsabs, epsrel=epsrel,
                      limit=2000)
    return float(np.clip(0.5 + val / np.pi, 0.0, 1.0))


def _tail_inversion(q, lambdas):
    """Pr(Q > q), q above the mean, by the inversion integral
    (1 / pi) int_0^inf Re[exp(K(c + iy) - (c + iy) q) / (c + iy)] dy of
    the cumulant generating function K(s) = -1/2 sum log(1 - 2 lambda s),
    on the line Re s = c through the saddlepoint K'(c) = q: there the
    integrand is of the size of the tail itself, so no 1/2 cancels.  The
    integrand is h(y) exp(-i y q) with h smooth: the saddle's neighbourhood
    (100 times the narrowest scale (1 - 2 lambda c) / (2 lambda)) by
    adaptive quadrature, the rest by QUADPACK's Fourier-integral rule."""
    lam = lambdas[lambdas > 0]
    hi = 0.5 / lam.max()
    kp = lambda t: np.sum(lam / (1.0 - 2.0 * lam * t)) - q  # noqa: E731
    c = brentq(kp, 0.0, hi * (1.0 - 1e-15), xtol=1e-300, rtol=1e-15,
               maxiter=500)
    rest = lambdas[lambdas < 0]
    K = lambda s: -0.5 * (np.sum(np.log(1.0 - 2.0 * lam * s))  # noqa: E731
                          + np.sum(np.log(1.0 - 2.0 * rest * s)))
    Kc = float(np.real(K(c)))
    h = lambda y: np.exp(K(c + 1j * y) - Kc) / (c + 1j * y)  # noqa: E731
    y0 = 100.0 * float(np.min((1.0 - 2.0 * lam * c) / (2.0 * lam)))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", IntegrationWarning)
        near, _ = quad(lambda y: float(np.real(h(y) * np.exp(-1j * y * q))),
                       0.0, y0, epsabs=0.0, epsrel=1e-9, limit=1000)
        fc, _ = quad(lambda y: float(np.real(h(y))), y0, np.inf,
                     weight="cos", wvar=q, limlst=200)
        fs, _ = quad(lambda y: float(np.imag(h(y))), y0, np.inf,
                     weight="sin", wvar=q, limlst=200)
    return math.exp(Kc - c * q) * (near + fc + fs) / math.pi


def _flagged_refinement_ok(q, lam, pv_r, pv, acc_ref, cur_acc):
    """Whether a Davies refinement flagged ifault 2 (round-off possibly
    significant), requested at ``acc_ref`` (a fraction of the current
    estimate ``pv``), is kept: only inside a band relative to the current
    estimate's scale, 2 max(acc_ref, 1e-2 ref), around an independent
    inversion of the tail, ``ref`` = :func:`imhof_sf`.  (The reference
    keeps any flagged value within 2 cur_acc of ``pv``: at pv ~ 1e-13 and
    cur_acc = 1e-8 that band is 1e5 times the estimate.)  ``cur_acc`` is
    the accuracy the current estimate was computed at."""
    ref = imhof_sf(float(q), lam)
    return ref > 0.0 and abs(pv_r - ref) <= 2.0 * max(acc_ref, 1e-2 * ref)


def _davies_native(q, lambdas, lim, acc):
    """One native Davies call; (pv, ifault), or None without the library."""
    lib = get_qfc()
    if lib is None:
        return None
    return lib.davies(np.asarray(lambdas, float), float(q), int(lim),
                      float(acc))


def davies_pvalue(q, weight_matrix=None, lambdas=None, lim=20_000_000,
                  acc=1e-8, lambda_filter_ratio=1e5, return_info=False):
    """Pr(Q > q) with the chiscore/SKAT pipeline (host, exact).

    Symmetrize the weight matrix, eigendecompose, keep eigenvalues above
    mean(positive)/ratio, run Davies with an accuracy ladder, fall back to
    Imhof and then modified Liu.
    """
    if lambdas is None:
        w = np.asarray(weight_matrix, float)
        w = (w + w.T) / 2
        lam = np.linalg.eigvalsh(w)
    else:
        lam = np.asarray(lambdas, float)
    lam_pos = lam[lam >= 0]
    thr = lam_pos.mean() / lambda_filter_ratio if lam_pos.size else 0.0
    lam = np.sort(lam[lam > thr])[::-1]

    info = {"is_converged": True, "method": "davies", "lambdas": lam}
    if lam.size == 0:
        info["method"] = "degenerate"
        return (1.0, info) if return_info else 1.0

    # requested acc first; slow-decaying few-weight spectra (ifault 4)
    # retry at chiscore's own 1e-6, then fall through to Imhof
    pv = None
    zero_result = False
    for acc_try in ([acc] if acc >= 1e-6 else [acc, 1e-6]):
        res = _davies_native(q, lam, lim, acc_try)
        if res is None:
            break
        pv_d, ifault = res
        if ifault == 0 and 0.0 < pv_d <= 1.0:
            pv = pv_d
            break
        zero_result = zero_result or (ifault == 0 and pv_d <= 0.0)
    # Davies' acc is ABSOLUTE: a pass that cancelled to 0 is re-run at
    # finer accuracies toward the f64 floor
    if pv is None and zero_result:
        for acc_try in (1e-12, 1e-14, 1e-16):
            if acc_try >= acc:
                continue
            res = _davies_native(q, lam, lim, acc_try)
            if res is not None and res[1] == 0 and 0.0 < res[0] <= 1.0:
                pv = res[0]
                break
    # tail results are refined at an accuracy proportional to the result;
    # a round-off-flagged (ifault 2) refinement is kept only inside a
    # relative band of an independent inversion, else the next finer
    # accuracy is tried
    if pv is not None and pv < acc * 1e4:
        cur_acc = acc
        for acc_ref in (max(pv * 1e-1, 1e-15), max(pv * 1e-3, 1e-16)):
            if acc_ref >= cur_acc:
                continue
            res = _davies_native(q, lam, lim, acc_ref)
            if res is None:
                break
            pv_r, if_r = res
            if not (0.0 < pv_r <= 1.0):
                break
            if if_r == 0 or (if_r == 2 and _flagged_refinement_ok(
                    q, lam, pv_r, pv, acc_ref, cur_acc)):
                pv = pv_r
                cur_acc = acc_ref
            elif if_r != 2:
                break
    if pv is None:
        try:
            pv = imhof_sf(float(q), lam)
            info["method"] = "imhof"
            if pv < 1e-12:
                # below the quadrature's own absolute floor: prefer mod-Liu
                pv = None
        except (ValueError, ArithmeticError) as e:
            logger.warning("Imhof fallback failed for q=%g (%s: %s); "
                           "using mod-Liu", q, type(e).__name__, e)
            pv = None
    if pv is None or not (0.0 <= pv <= 1.0):
        pv = float(liu_sf(q, lam)[0])
        info["method"] = "liu"
        info["is_converged"] = False
    if pv <= 0.0:
        pv = float(liu_sf(q, lam)[0])
        info["method"] = "liu"
    return (float(pv), info) if return_info else float(pv)


def davies_pvalue_batch(qs, lambda_rows, lim=20_000_000, acc=1e-8,
                        lambda_filter_ratio=1e5, n_threads=0):
    """Davies over many (q, (S, C) zero-padded spectrum) problems.

    The native threaded batch first; problems it faults on, and deep-tail
    results below ~1e4 * acc (large RELATIVE error at an absolute acc,
    negative ones included), go through the scalar ladder.  Without the
    library: a Python loop.
    """
    qs = np.asarray(qs, float)
    lam = np.asarray(lambda_rows, float)
    ladder = lambda i: davies_pvalue(  # noqa: E731
        qs[i], lambdas=lam[i], lim=lim, acc=acc,
        lambda_filter_ratio=lambda_filter_ratio)
    lib = get_qfc()
    if lib is None:
        return np.array([ladder(i) for i in range(qs.shape[0])], float)
    pv, fault = lib.davies_batch_raw(lam, qs, lim, acc, lambda_filter_ratio,
                                     n_threads)
    for i in np.nonzero(fault != 0)[0]:
        pv[i] = ladder(i)
    # deep-tail results, a result cancelled below zero included, go through
    # the ladder (the reference's mask, pv >= 0, returned those as they are)
    for i in np.nonzero(pv < acc * 1e4)[0]:
        pv[i] = ladder(i)
    return pv


def saddlepoint_sf(q, lambdas, n_iters: int = 40):
    """Kuonen saddlepoint Pr(Q > q), NumPy in and out: q (...,), lambdas
    (..., C) (the JAX package's ``saddlepoint_sf``, through
    :func:`saddlepoint_sf_torch` in f64 on the CPU)."""
    q_t = torch.as_tensor(np.asarray(q, float))
    lam_t = torch.as_tensor(np.asarray(lambdas, float))
    return saddlepoint_sf_torch(q_t, lam_t, n_iters).numpy()


def score_statistic_liu_params(q, weights):
    """Modified-Liu parameters and p-value of one statistic (reference
    _math.py:163-180)."""
    pv, dof_x, _, mu_q, sigma_q = liu_sf(q, weights)
    return {"pv": float(pv), "mu_q": float(mu_q), "sigma_q": float(sigma_q),
            "dof_x": float(dof_x)}


def qmin(liu_params):
    """SKAT-O style per-rho quantile combination (reference _math.py:
    183-201)."""
    T = min(p["pv"] for p in liu_params)
    out = np.zeros(len(liu_params))
    for i, lp in enumerate(liu_params):
        qv = chi2.ppf(1 - T, lp["dof_x"])
        dof = lp["dof_x"]
        out[i] = (qv - dof) / (2 * dof) ** 0.5 * lp["sigma_q"] + lp["mu_q"]
    return out


def lrt_pvalues(null_lml, alt_lmls, dof=1, clip_lo=1e-300,
                clip_hi=1.0 - 1.1e-16):
    """Likelihood-ratio-test p-values: chi2(dof).sf(2 (alt - null)), clipped
    (reference _cellregmap.py:443-469)."""
    lrs = np.clip(
        -2 * np.asarray(null_lml, float) + 2 * np.asarray(alt_lmls, float),
        1e-300, np.inf)
    pv = chi2(df=dof).sf(lrs)
    return np.clip(pv, clip_lo, clip_hi)
