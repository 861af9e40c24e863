"""The port's host p-value ladder against the JAX package's, on the same
battery as tests/test_pvalues.py.

Both ladders call the same Davies algorithm (each package builds its own
copy of qfc.cc), so Davies results agree exactly; mod-Liu is NumPy/SciPy
in the port and jnp in the JAX package, so it agrees to the special
functions' last digits (rtol 1e-10).
"""
import numpy as np
import jax.numpy as jnp
import pytest
from numpy.testing import assert_allclose
from scipy.stats import chi2

from cellregmap_tpu import oracle
from cellregmap_tpu.models import pvalues as jpv
from cellregmap_tpu_torch.models import pvalues as tpv
from cellregmap_tpu_torch.utils.native import get_qfc
from _torch_inputs import jax_davies_library  # noqa: F401


def _random_spectra(rng, n_cases, max_c=6):
    cases = []
    for _ in range(n_cases):
        c = rng.integers(1, max_c + 1)
        lam = np.abs(rng.normal(size=c)) * 10.0 ** rng.integers(-3, 2)
        q = lam.sum() * 10.0 ** rng.uniform(-1.0, 1.2)
        cases.append((q, np.sort(lam)[::-1]))
    return cases


@pytest.fixture(scope="module")
def qfc():
    lib = get_qfc()
    assert lib is not None, "the port's qfc.cc did not build (g++ needed)"
    return lib


def test_liu_matches_jax_and_oracle():
    rng = np.random.default_rng(0)
    for q, lam in _random_spectra(rng, 50):
        got = tpv.liu_sf(q, lam)
        want = jpv.liu_sf(jnp.asarray(q), jnp.asarray(lam))
        # pv, mu_q, sigma_q (dof/ncp may take the other branch of the
        # s1^2 > s2 test at a one-weight tie, with the same pv)
        for i in (0, 3, 4):
            assert_allclose(float(got[i]), float(want[i]), rtol=1e-10,
                            atol=1e-300)
        assert_allclose(float(got[0]), oracle.liu_sf(q, lam)[0], rtol=1e-10,
                        atol=1e-300)


def test_liu_batched_matches_rows():
    rng = np.random.default_rng(1)
    cases = _random_spectra(rng, 12, max_c=4)
    lam = np.zeros((len(cases), 4))
    for i, (_, l) in enumerate(cases):
        lam[i, : len(l)] = l
    q = np.array([c[0] for c in cases])
    got = tpv.liu_sf(q, lam)[0]
    want = np.asarray(jpv.liu_sf(jnp.asarray(q), jnp.asarray(lam))[0])
    assert_allclose(got, want, rtol=1e-10, atol=1e-300)


def test_liu_golden_moments():
    """The golden constants of tests/test_pvalues.py:62-70 (reference
    test_math.py:76-83)."""
    lam = np.array([4.55266277e-09, 3.46249449e-01])
    pv, dof_x, ncp_x, mu_q, sigma_q = tpv.liu_sf(0.4996101707, lam)
    assert_allclose(float(mu_q), 0.34624945394475326, rtol=1e-8)
    assert_allclose(float(sigma_q), 0.48967066729451103, rtol=1e-8)
    assert_allclose(float(dof_x), 1.0, rtol=1e-6)
    assert_allclose(float(pv), 0.22966744652848403, rtol=1e-6)


def test_davies_reducible_exact(qfc):
    worst = 0.0
    for C in [1, 2, 3, 6]:
        for a in [0.001, 0.35, 7.0]:
            for fq in [0.05, 0.5, 1.0, 3.0, 8.0, 20.0, 40.0]:
                q = a * C * fq
                pv, ifault = qfc.davies(np.full(C, a), q, 20_000_000, 1e-10)
                assert ifault == 0
                worst = max(worst, abs(pv - chi2.sf(q / a, C)))
    assert worst < 1e-9, worst


def test_davies_extreme_tail_matches_jax(qfc):
    """The genome-wide battery of tests/test_pvalues.py:105-194: the
    production ladder on random spectra with p in [1e-14, 1e-10], where
    the deep-tail refinement matters; the port's ladder must return the
    JAX ladder's values, single and batched (the JAX battery checks those
    values against raw acc=1e-13 runs)."""
    rng = np.random.default_rng(17)
    qs, lams = [], []
    for _ in range(12):
        c = int(rng.integers(2, 7))
        lam = np.sort(np.abs(rng.normal(size=c)))[::-1] + 0.01
        q = lam.sum() * 5.0
        for _step in range(200):
            pv8, if8 = qfc.davies(lam, q, 20_000_000, 1e-8)
            if if8 != 0 or pv8 < 1e-10:
                break
            q *= 1.15
        if if8 != 0 or not 0.0 <= pv8 < 1e-10:
            continue
        qs.append(q)
        lams.append(lam)
    assert len(qs) >= 6
    for q, lam in zip(qs, lams):
        got = tpv.davies_pvalue(q, lambdas=lam, acc=1e-8)
        want = jpv.davies_pvalue(q, lambdas=lam, acc=1e-8)
        assert got == want, (q, lam, got, want)
    C = max(len(l) for l in lams)
    rows = np.zeros((len(qs), C))
    for i, l in enumerate(lams):
        rows[i, : len(l)] = l
    got_b = tpv.davies_pvalue_batch(np.asarray(qs), rows, acc=1e-8)
    want_b = jpv.davies_pvalue_batch(np.asarray(qs), rows, acc=1e-8)
    assert_allclose(got_b, want_b, rtol=1e-12, atol=0)


@pytest.mark.parametrize("seed", [2, 3])
def test_davies_batch_matches_jax(qfc, seed):
    rng = np.random.default_rng(seed)
    cases = _random_spectra(rng, 48, max_c=4)
    lam = np.zeros((len(cases), 4))
    q = np.zeros(len(cases))
    for i, (qi, l) in enumerate(cases):
        lam[i, : len(l)] = l
        q[i] = qi
    got = tpv.davies_pvalue_batch(q, lam, acc=1e-8)
    want = jpv.davies_pvalue_batch(q, lam, acc=1e-8)
    assert_allclose(got, want, rtol=1e-12, atol=1e-15)
    for i, (qi, l) in enumerate(cases):
        assert_allclose(got[i], tpv.davies_pvalue(qi, lambdas=l, acc=1e-8),
                        atol=1e-8)


def test_davies_weight_matrix_and_degenerate():
    rng = np.random.default_rng(4)
    A = rng.normal(size=(5, 5))
    Wmat = A @ A.T / 10
    q = np.linalg.eigvalsh(Wmat).sum() * 0.8
    assert tpv.davies_pvalue(q, weight_matrix=Wmat) == \
        jpv.davies_pvalue(q, weight_matrix=Wmat)
    pv, info = tpv.davies_pvalue(1.0, lambdas=np.zeros(3), return_info=True)
    assert pv == 1.0 and info["method"] == "degenerate"


def test_imhof_matches_jax_oracle():
    rng = np.random.default_rng(5)
    for q, lam in _random_spectra(rng, 6):
        assert_allclose(tpv.imhof_sf(q, lam), oracle.imhof_sf(q, lam),
                        rtol=1e-12, atol=1e-15)


def test_lrt_pvalues_matches_jax():
    null, alt = -10.0, np.array([-9.0, -10.0, -5.0, 1000.0])
    assert_allclose(tpv.lrt_pvalues(null, alt), jpv.lrt_pvalues(null, alt),
                    rtol=1e-14)
    pv = tpv.lrt_pvalues(0.0, np.array([1000.0]))
    assert pv[0] >= 1e-300
    assert_allclose(tpv.lrt_pvalues(-10.0, np.array([-9.0]))[0],
                    chi2.sf(2.0, 1), rtol=1e-12)
