"""The port's low-rank covariance shims (``cellregmap_tpu_torch.ops
.lowrank``) against the JAX package's, on the CPU.

The inputs are those of tests/test_ops.py and tests/test_lmm.py (seeded
numpy, float64).  Budget 1e-10, on what the factorizations determine:
reconstructions, products, solves, log-determinants, statistics and
weights, and the spans (projectors) of bases, never ``Q0``'s columns
themselves, whose signs and order among equal eigenvalues are free.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from cellregmap_tpu.ops import lowrank as jlr
from cellregmap_tpu_torch.ops import lowrank as tlr

TOL = 1e-10


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _recon(Q0, S0):
    Q0, S0 = _np(Q0), _np(S0)
    return Q0 @ np.diag(S0) @ Q0.T


def _factors(seed, n, m):
    return np.random.default_rng(seed).normal(size=(n, m))


# (n, m): tests/test_ops.py's three shapes, tests/test_lmm.py's factors
# (n = 40, m = 5 at seeds 0-2; 30 x 4; 45 x 6), a rank-deficient one
QS_CASES = [(0, 20, 5), (0, 5, 20), (0, 16, 16), (0, 40, 5), (1, 40, 5),
            (2, 40, 5), (3, 30, 4), (9, 45, 6)]


@pytest.mark.parametrize("seed,n,m", QS_CASES)
def test_economic_qs_linear_matches_jax(seed, n, m):
    F = _factors(seed, n, m)
    Q0, S0 = tlr.economic_qs_linear(F, device="cpu")
    jQ0, jS0 = jlr.economic_qs_linear(jnp.asarray(F))
    assert Q0.dtype == torch.float64 and Q0.shape == jQ0.shape
    assert_allclose(_recon(Q0, S0), _recon(jQ0, jS0), atol=TOL)
    assert_allclose(_recon(Q0, S0), F @ F.T, atol=TOL)
    assert_allclose(np.sort(_np(S0)), np.sort(_np(jS0)),
                    atol=TOL * max(1.0, float(np.max(_np(jS0)))))


def test_economic_qs_linear_rank_deficient_columns_inert():
    F = _factors(5, 24, 6)
    F[:, 5] = F[:, 0] - F[:, 1]              # rank 5
    Q0, S0 = tlr.economic_qs_linear(F, device="cpu")
    jQ0, jS0 = jlr.economic_qs_linear(jnp.asarray(F))
    assert int((_np(S0) == 0).sum()) == int((_np(jS0) == 0).sum()) == 1
    assert np.all(_np(Q0)[:, _np(S0) == 0] == 0)
    assert_allclose(_recon(Q0, S0), _recon(jQ0, jS0), atol=TOL)


@pytest.mark.parametrize("seed,n,m", [(0, 40, 5), (3, 30, 4), (9, 45, 6)])
def test_orthonormal_basis_and_gram_eigh_match_jax(seed, n, m):
    F = _factors(seed, n, m)
    Z = _np(tlr.orthonormal_basis(F, device="cpu"))
    jZ = _np(jlr.orthonormal_basis(jnp.asarray(F)))
    assert_allclose(Z.T @ Z, np.eye(m), atol=TOL)
    assert_allclose(Z @ Z.T, jZ @ jZ.T, atol=TOL)
    G = F.T @ F
    S, V = tlr.gram_eigh(G, device="cpu")
    jS, jV = jlr.gram_eigh(jnp.asarray(G))
    assert_allclose(_recon(V, S), _recon(jV, jS), atol=TOL * np.abs(G).max())
    assert_allclose(_np(S), _np(jS), atol=TOL * np.abs(G).max())


@pytest.mark.parametrize("n,m", [(20, 5), (12, 12)])
def test_economic_qs_matches_jax(n, m):
    rng = np.random.default_rng(n)
    F = rng.normal(size=(n, m - 2))            # rank m - 2 < n
    K = F @ F.T
    (Q0, Q1), S0 = tlr.economic_qs(K, device="cpu")
    (jQ0, jQ1), jS0 = jlr.economic_qs(jnp.asarray(K))
    assert Q0.shape == jQ0.shape and Q1.shape == jQ1.shape
    assert_allclose(_np(S0), jS0, atol=TOL * np.abs(K).max())
    assert_allclose(_recon(Q0, S0), _recon(jQ0, jS0), atol=TOL)
    assert_allclose(_np(Q1) @ _np(Q1).T, jQ1 @ jQ1.T, atol=TOL)


def test_qscov_dot_solve_logdet_match_jax():
    rng = np.random.default_rng(0)
    n, m = 15, 4
    F = rng.normal(size=(n, m))
    a, b = 0.2, 0.3
    cov = tlr.QSCov(*tlr.economic_qs_linear(F, device="cpu"), a, b)
    jcov = jlr.QSCov(*jlr.economic_qs_linear(jnp.asarray(F)), a, b)
    v = rng.normal(size=n)
    V = rng.normal(size=(n, 3))
    for rhs in (v, V):
        assert_allclose(_np(cov.dot(rhs)), _np(jcov.dot(jnp.asarray(rhs))),
                        atol=TOL)
        assert_allclose(_np(cov.solve(rhs)),
                        _np(jcov.solve(jnp.asarray(rhs))), atol=TOL)
    assert_allclose(_np(cov.solve(V)),
                    np.linalg.solve(a * F @ F.T + b * np.eye(n), V),
                    atol=TOL)
    assert_allclose(float(cov.logdet()), float(jcov.logdet()), atol=TOL)


def _score_inputs(rng, n=15, m=4, p=2, C=3):
    F = rng.normal(size=(n, m))
    W = rng.normal(size=(n, p))
    y = rng.normal(size=n)
    sq = rng.normal(size=(n, C))
    return F, W, y, sq


def test_pmat_matches_jax():
    rng = np.random.default_rng(0)
    F, W, _, _ = _score_inputs(rng)
    v = rng.normal(size=F.shape[0])
    P = tlr.PMat(tlr.QSCov(*tlr.economic_qs_linear(F, device="cpu"), 0.5,
                           0.7), W)
    jP = jlr.PMat(jlr.QSCov(*jlr.economic_qs_linear(jnp.asarray(F)), 0.5,
                            0.7), jnp.asarray(W))
    assert_allclose(_np(P.dot(v)), _np(jP.dot(jnp.asarray(v))), atol=TOL)


@pytest.mark.parametrize("seed", [0, 1])
def test_score_statistic_matches_jax(seed):
    rng = np.random.default_rng(seed)
    F, W, y, sq = _score_inputs(rng)
    cov = tlr.QSCov(*tlr.economic_qs_linear(F, device="cpu"), 0.5, 0.7)
    ss = tlr.ScoreStatistic(tlr.PMat(cov, W), cov, sq)
    jcov = jlr.QSCov(*jlr.economic_qs_linear(jnp.asarray(F)), 0.5, 0.7)
    jss = jlr.ScoreStatistic(jlr.PMat(jcov, jnp.asarray(W)), jcov,
                             jnp.asarray(sq))
    assert_allclose(float(ss.statistic(y)),
                    float(jss.statistic(jnp.asarray(y))), rtol=TOL)
    assert_allclose(_np(ss.matrix_for_dist_weights()),
                    _np(jss.matrix_for_dist_weights()), atol=TOL)
    w, jw = np.sort(_np(ss.distr_weights())), np.sort(jss.distr_weights())
    assert w.shape == jw.shape
    assert_allclose(w, jw, atol=TOL * jw.max())


def test_kinv_quad_matches_jax():
    rng = np.random.default_rng(4)
    n, r = 30, 6
    Q, _ = np.linalg.qr(rng.normal(size=(n, r)))
    S = np.abs(rng.normal(size=r))
    S[-1] = 0.0
    U, Vv = rng.normal(size=(n, 3)), rng.normal(size=(n, 3))
    got = tlr.kinv_quad(torch.as_tensor(Q.T @ U), torch.as_tensor(Q.T @ Vv),
                        torch.as_tensor((U * Vv).sum(0)), 0.4, 0.9,
                        torch.as_tensor(S))
    want = jlr.kinv_quad(jnp.asarray(Q.T @ U), jnp.asarray(Q.T @ Vv),
                         jnp.asarray((U * Vv).sum(0)), 0.4, 0.9,
                         jnp.asarray(S))
    assert_allclose(_np(got), _np(want), atol=TOL)
    K = 0.4 * Q @ np.diag(S) @ Q.T + 0.9 * np.eye(n)
    assert_allclose(_np(got), (U * np.linalg.solve(K, Vv)).sum(0), atol=TOL)


def _first(out):
    """The first tensor a shim returns (a QSCov's half-factor)."""
    while isinstance(out, tuple):
        out = out[0]
    return getattr(out, "_Q0", out)


SHIMS = [lambda F, **k: tlr.economic_qs_linear(F, **k),
         lambda F, **k: tlr.orthonormal_basis(F, **k),
         lambda F, **k: tlr.gram_eigh(F.T @ F, **k),
         lambda F, **k: tlr.economic_qs(F @ F.T, **k),
         lambda F, **k: tlr.QSCov(F, np.ones(F.shape[1]), **k)]


@pytest.mark.parametrize("shim", range(len(SHIMS)))
def test_host_arrays_go_to_the_card_unless_asked(shim):
    """Host arrays resolve their device as every entry point of the port:
    the card by default (raising, and naming ``device='cpu'``, where there
    is none), the CPU when asked; a tensor keeps its own device."""
    F = _factors(7, 12, 4)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            SHIMS[shim](F)
    t = _first(SHIMS[shim](F, device="cpu"))
    assert t.device.type == "cpu" and t.dtype == torch.float64
    assert _first(SHIMS[shim](torch.as_tensor(F))).device.type == "cpu"
