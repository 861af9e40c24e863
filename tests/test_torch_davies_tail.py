"""The deep tail of the port's host Davies ladder (``models/pvalues.py``).

Two repairs of the reference's ladder, held to an independent inversion of
the tail, ``imhof_sf``, whose deep-tail branch (the inversion integral on
a contour through the saddlepoint) is itself held here to Imhof's integral
in 40-digit arithmetic (mpmath):

1. a Davies refinement flagged ifault 2 (round-off) is kept only inside a
   relative band of ``imhof_sf`` (``_flagged_refinement_ok``); the
   reference kept any flagged value within 2 cur_acc of the estimate,
   which at pv ~ 1e-12 and cur_acc = 1e-8 is a band a thousand times the
   estimate.  A seeded search finds real spectra whose refinement is
   flagged: on them the ladder agrees with ``imhof_sf`` within 2e-2
   relative, as it does for spectra tuned to pv = 1e-10 .. 1e-14.  (On
   the spectra the search finds, the flagged values were right: no case
   was found where the reference's rule admits a wrong value, so that
   fault is shown by a refinement made wrong on purpose.)
2. a native batch result below zero with ifault 0 goes through the ladder
   (the reference's mask, pv >= 0, returned it as it was).  The port's
   ``qfc.cc`` clamps its results at 0, so the negative result is put in
   the batch's output on purpose.
"""
import mpmath
import numpy as np
import pytest
from numpy.testing import assert_allclose
from scipy.optimize import brentq

from cellregmap_tpu_torch.models import pvalues as pvm
from cellregmap_tpu_torch.utils.native import get_qfc


def _imhof_mp(q, lam):
    """Imhof's integral with 40 significant digits (mpmath)."""
    mpmath.mp.dps = 40
    lam = [mpmath.mpf(float(x)) for x in lam]
    q = mpmath.mpf(float(q))

    def f(u):
        if u == 0:
            return (sum(lam) - q) / 2
        th = sum(mpmath.atan(x * u) for x in lam) / 2 - q * u / 2
        rho = mpmath.fprod((1 + (x * u) ** 2) ** mpmath.mpf(0.25)
                           for x in lam)
        return mpmath.sin(th) / (u * rho)

    return float(mpmath.mpf(0.5)
                 + mpmath.quadosc(f, [0, mpmath.inf], omega=q / 2)
                 / mpmath.pi)


@pytest.fixture(scope="module")
def flagged():
    """(spectrum, q) pairs whose first refinement Davies flags ifault 2: a
    seeded search over spectra with one dominant weight, in the batch's
    deep tail (pv < 1e-9 at acc 1e-8)."""
    lib = get_qfc()
    assert lib is not None, "native/qfc.cc did not build"
    rng = np.random.default_rng(11)
    n = 4000
    lam = np.abs(rng.normal(size=(n, 4))) * 10.0 ** rng.uniform(-3, 3,
                                                                  (n, 4))
    lam[:, 1:] *= 1e-3
    q = lam.max(1) * 10.0 ** rng.uniform(1.2, 1.8, size=n)
    pv, fault = lib.davies_batch_raw(lam, q, 20_000_000, 1e-8, 1e5, 0)
    out = []
    for i in np.nonzero((fault == 0) & (pv > 0) & (pv < 1e-9))[0]:
        l = np.sort(lam[i])[::-1]
        l = l[l > l.mean() / 1e5]
        if lib.davies(l, q[i], 20_000_000, max(pv[i] * 0.1, 1e-15))[1] == 2:
            out.append((l, float(q[i])))
        if len(out) == 3:
            break
    assert len(out) == 3
    return out


def test_imhof_tail_matches_high_precision(flagged):
    for lam, q in flagged[:2]:
        got = pvm.imhof_sf(q, lam)
        assert 1e-14 < got < 1e-10
        assert_allclose(got, _imhof_mp(q, lam), rtol=1e-3)


def test_flagged_refinements_held_to_imhof(flagged):
    for lam, q in flagged:
        assert_allclose(pvm.davies_pvalue(q, lambdas=lam),
                        pvm.imhof_sf(q, lam), rtol=2e-2)


@pytest.mark.parametrize("target", [1e-10, 1e-12, 1e-14])
def test_ladder_deep_tail_held_to_imhof(flagged, target):
    """Each spectrum at q where ``imhof_sf`` gives ``target``."""
    for lam, _ in flagged:
        q = brentq(lambda x: np.log(pvm.imhof_sf(x, lam) / target),
                   2.5 * lam.sum(), 400.0 * lam.max(), xtol=1e-12)
        ref = pvm.imhof_sf(q, lam)
        assert_allclose(ref, target, rtol=1e-6)
        # the ladder's own accuracy: its finest refinements ask for 1e-3 of
        # the estimate, floored at 1e-16 (1e-15 for the coarser one)
        assert_allclose(pvm.davies_pvalue(q, lambdas=lam), ref, rtol=2e-2,
                        atol=2e-15)


def test_wrong_flagged_refinement_rejected(flagged, monkeypatch):
    """Both refinements flagged ifault 2, the first a thousand times the
    tail, the second on it: the reference's rule (within 2 cur_acc of the
    estimate, 2e-8 at the first step) keeps the wrong value and then
    refuses the right one; the port's rejects the wrong value and keeps
    the right one."""
    lam, q = flagged[0]
    truth = pvm.imhof_sf(q, lam)
    real = pvm._davies_native
    refinements = []

    def davies(q_, lam_, lim, acc):
        if acc >= 1e-8:
            return real(q_, lam_, lim, acc)
        refinements.append(acc)
        return (1e3 if len(refinements) == 1 else 1.0 + 1e-6) * truth, 2

    monkeypatch.setattr(pvm, "_davies_native", davies)
    assert_allclose(pvm.davies_pvalue(q, lambdas=lam), truth, rtol=2e-2)
    assert len(refinements) == 2
    refinements.clear()
    monkeypatch.setattr(pvm, "_flagged_refinement_ok",
                        lambda q_, lam_, pv_r, pv, acc_ref, cur_acc:
                        abs(pv_r - pv) <= 2 * cur_acc)
    assert pvm.davies_pvalue(q, lambdas=lam) > 100 * truth


def test_batch_refines_negative_results(flagged, monkeypatch):
    """A batch result below zero with ifault 0 is refined by the ladder."""
    lib = get_qfc()
    lam = np.zeros((3, 4))
    qs = np.zeros(3)
    for i, (l, q) in enumerate(flagged):
        lam[i, :l.size] = l
        qs[i] = q

    class Negative:
        def davies(self, *a):
            return lib.davies(*a)

        def davies_batch_raw(self, *a):
            pv, fault = lib.davies_batch_raw(*a)
            pv[1] = -3e-10
            fault[1] = 0
            return pv, fault

    monkeypatch.setattr(pvm, "get_qfc", lambda: Negative())
    got = pvm.davies_pvalue_batch(qs, lam)
    assert got[1] > 0.0
    assert got[1] == pvm.davies_pvalue(qs[1], lambdas=lam[1])
    assert_allclose(got[1], pvm.imhof_sf(qs[1], lam[1]), rtol=2e-2)
