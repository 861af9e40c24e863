"""Mixture-of-chi-squared tail probabilities: the host p-value ladder.

The score statistic's null law is Q ~ sum_i lambda_i chi2_1.  The exact
path (the reference's ``chiscore.davies_pvalue``) runs on the host:

1. Davies' algorithm (native/qfc.cc via ctypes, threaded over a batch),
   with a descending-accuracy ladder for deep-tail results;
2. an Imhof quadrature when Davies fails;
3. modified Liu (4-moment chi-squared match) as the last rung.

A NumPy/SciPy port of ``cellregmap_tpu.models.pvalues`` (the ladder as it
is) plus the port's own copy of ``oracle.imhof_sf``.  The device tails
(batched Liu / saddlepoint on the card) come with a later slice.
"""
from __future__ import annotations

import logging
import warnings

import numpy as np
from scipy.integrate import IntegrationWarning, quad
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


def imhof_sf(q, lambdas, epsabs=1e-13, epsrel=1e-11):
    """Pr(Q > q) for Q = sum_i lambda_i chi2_1 by Imhof (1961) inversion.

    Independent of Davies' algorithm.  The quadrature loses absolute
    accuracy in the far tail (pv < ~1e-7) and for very few distinct
    eigenvalues; all-equal spectra (a scaled chi2) use the closed form.
    """
    lambdas = np.asarray(lambdas, float)
    lambdas = lambdas[lambdas != 0.0]
    if lambdas.size == 0:
        return 1.0 if q <= 0 else 0.0
    if np.all(lambdas == lambdas[0]) and lambdas[0] > 0:
        return float(chi2.sf(q / lambdas[0], lambdas.size))

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
    # a round-off-flagged (ifault 2) refinement is accepted only inside the
    # current estimate's own error band
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
            if if_r == 0 or (if_r == 2 and abs(pv_r - pv) <= 2 * cur_acc):
                pv = pv_r
                cur_acc = acc_ref
            else:
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
    results below ~1e4 * acc (large RELATIVE error at an absolute acc), go
    through the scalar ladder.  Without the library: a Python loop.
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
    for i in np.nonzero((pv >= 0.0) & (pv < acc * 1e4))[0]:
        pv[i] = ladder(i)
    return pv


def lrt_pvalues(null_lml, alt_lmls, dof=1, clip_lo=1e-300,
                clip_hi=1.0 - 1.1e-16):
    """Likelihood-ratio-test p-values: chi2(dof).sf(2 (alt - null)), clipped
    (reference _cellregmap.py:443-469)."""
    lrs = np.clip(
        -2 * np.asarray(null_lml, float) + 2 * np.asarray(alt_lmls, float),
        1e-300, np.inf)
    pv = chi2(df=dof).sf(lrs)
    return np.clip(pv, clip_lo, clip_hi)
