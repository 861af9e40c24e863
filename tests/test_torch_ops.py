"""The PyTorch port's small linear algebra and host setup against the JAX
package, on the CPU.

Same inputs (made with numpy from a seed) go through both; tolerances:

* rtol 1e-13 for the small Cholesky routines: both run the same f64
  arithmetic in the same order up to the BLAS/LAPACK kernel's summation
  order, so they differ at a few ulp of the O(1) entries;
* 1e-12 for the host setup: the same NumPy/LAPACK code runs on both sides
  (the JAX engine uploads it, the port too), so only the upload differs.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch
from numpy.testing import assert_allclose

from cellregmap_tpu import engine as jengine
from cellregmap_tpu.ops import hadamard as jhadamard
from cellregmap_tpu.ops import linalg as jlinalg
from cellregmap_tpu_torch import engine as tengine
from cellregmap_tpu_torch.ops import hadamard as thadamard
from cellregmap_tpu_torch.ops import linalg as tlinalg


def _spd_batch(rng, batch, m, collinear=False):
    X = rng.normal(size=(batch, m + 3, m))
    if collinear:
        X[..., -1] = X[..., 0]
    return np.einsum("bki,bkj->bij", X, X)


def _components(A):
    m = A.shape[-1]
    return [[A[..., i, j] for j in range(i + 1)] for i in range(m)]


@pytest.mark.parametrize("m,collinear", [(1, False), (2, False), (3, False),
                                         (5, False), (2, True), (3, True),
                                         (5, True)])
def test_unrolled_chol_matches_jax(m, collinear):
    rng = np.random.default_rng(10 * m + collinear)
    A = _spd_batch(rng, 7, m, collinear)
    b = rng.normal(size=(7, m))
    Lj = jlinalg.unrolled_chol_factor(_components(jnp.asarray(A)))
    Lt = tlinalg.unrolled_chol_factor(_components(torch.as_tensor(A)))
    for i in range(m):
        for j in range(i + 1):
            assert_allclose(Lt[i][j].numpy(), np.asarray(Lj[i][j]),
                            rtol=1e-13, atol=1e-13)
    bj = [jnp.asarray(b[:, i]) for i in range(m)]
    bt = [torch.as_tensor(b[:, i]) for i in range(m)]
    xj, ldj = jlinalg.unrolled_chol_solve_logdet(_components(jnp.asarray(A)),
                                                 bj)
    xt, ldt = tlinalg.unrolled_chol_solve_logdet(
        _components(torch.as_tensor(A)), bt)
    # collinear systems are solved through the 1e-12 ridge: the solution
    # has ~1e12 amplification, so it is compared relative to its own size
    scale = max(float(np.max(np.abs(np.asarray(x)))) for x in xj)
    for i in range(m):
        assert_allclose(xt[i].numpy(), np.asarray(xj[i]), rtol=1e-13 if not
                        collinear else 1e-6, atol=1e-13 * scale)
    assert_allclose(ldt.numpy(), np.asarray(ldj), rtol=1e-13)
    y = tlinalg.sym_components_matvec(_components(torch.as_tensor(A)), bt)
    assert_allclose(np.stack([v.numpy() for v in y], -1),
                    np.einsum("bij,bj->bi", A, b), rtol=1e-13)


@pytest.mark.parametrize("collinear", [False, True])
def test_sym_pseudo_matches_jax(collinear):
    rng = np.random.default_rng(3)
    A = _spd_batch(rng, 5, 4, collinear)
    b = rng.normal(size=(5, 4, 3))
    ldj = np.asarray(jlinalg.sym_pseudo_logdet(jnp.asarray(A)))
    ldt = tlinalg.sym_pseudo_logdet(torch.as_tensor(A)).numpy()
    assert_allclose(ldt, ldj, rtol=1e-13)
    xj = np.asarray(jlinalg.sym_pseudo_solve(jnp.asarray(A), jnp.asarray(b)))
    xt = tlinalg.sym_pseudo_solve(torch.as_tensor(A),
                                  torch.as_tensor(b)).numpy()
    if collinear:  # ridge-amplified: compare relative to the solution
        assert_allclose(xt, xj, rtol=0, atol=1e-6 * np.abs(xj).max())
    else:
        assert_allclose(xt, xj, rtol=1e-13, atol=1e-13)


def test_get_L_values_matches_jax():
    rng = np.random.default_rng(4)
    hK = rng.normal(size=(30, 5))
    E = rng.normal(size=(30, 4))
    E[:, 3] = E[:, 0]                   # rank-deficient: one factor dropped
    Lj = [np.asarray(L) for L in jhadamard.get_L_values(hK, E)]
    Lt = thadamard.get_L_values(hK, E)
    assert len(Lt) == len(Lj) == 3
    for a, b in zip(Lt, Lj):
        assert_allclose(a, b, rtol=1e-12, atol=1e-12)


def test_gram_basis_matches_jax():
    rng = np.random.default_rng(5)
    F = rng.normal(size=(40, 12))
    F[:, 11] = F[:, 0] + F[:, 1]        # exactly rank-deficient stack
    Zj, Tj = jengine._gram_basis(F)
    Zt, Tt = tengine._gram_basis(F)
    assert Zt.shape == Zj.shape == (40, 11)
    assert_allclose(Zt @ Zt.T, Zj @ Zj.T, atol=1e-12)
    assert_allclose(Zt @ Tt, F, atol=1e-12)


@pytest.mark.parametrize("mode", ["Ls", "hK", "E-only"])
def test_build_null_context_matches_jax(mode):
    rng = np.random.default_rng(6)
    n, C = 50, 3
    E = rng.normal(size=(n, C))
    W = np.concatenate([np.ones((n, 1)), rng.normal(size=(n, 1))], axis=1)
    hK = rng.normal(size=(n, 6)) / np.sqrt(6)
    y = rng.normal(size=n)
    kw = {"Ls": thadamard.get_L_values(hK, E)} if mode == "Ls" else (
        {"hK": hK} if mode == "hK" else {})
    cj = jengine.build_null_context(y, W, E, **kw)
    ct = tengine.build_null_context(y, W, E, **kw, device="cpu")
    Zj, Zt = np.asarray(cj.Z), ct.Z.numpy()
    assert Zt.shape == Zj.shape
    # the basis is unique up to rotation: compare the spans
    assert_allclose(Zt @ Zt.T, Zj @ Zj.T, atol=1e-12)
    for f in ("S", "rho", "WW", "Wy", "yy", "y", "W", "E0"):
        assert_allclose(getattr(ct, f).numpy(), np.asarray(getattr(cj, f)),
                        rtol=1e-12, atol=1e-12)
    # Z-rotations through the spans: Z Zy and Z ZW are basis-invariant
    assert_allclose(Zt @ ct.Zy.numpy(), Zj @ np.asarray(cj.Zy), atol=1e-12)
    assert_allclose(Zt @ ct.ZW.numpy(), Zj @ np.asarray(cj.ZW), atol=1e-12)
    assert ct.V.dtype == torch.float64 and ct.V.device.type == "cpu"


def test_null_context_from_numpy_roundtrip():
    rng = np.random.default_rng(7)
    n, C = 30, 2
    E = rng.normal(size=(n, C))
    cj = jengine.build_null_context(rng.normal(size=n), None, E,
                                    hK=rng.normal(size=(n, 4)))
    ct = tengine.null_context_from_numpy(
        {k: np.asarray(v) for k, v in cj._asdict().items()}, "cpu")
    for f in tengine.NullContext._fields:
        assert np.array_equal(getattr(ct, f).numpy(),
                              np.asarray(getattr(cj, f)))
