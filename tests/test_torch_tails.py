"""The port's device tails (K6) and the p-value methods, on the CPU, against
the JAX package.

1. The plain versions that the card's kernels are held to: the mixture
   weights (``sym_eigvalsh_plain`` against the JAX package's ``safe_eigh``
   clamped at 0, as ``per_snp`` does) within 1e-12 of each row's largest
   |lambda|; the Liu and saddlepoint tails (``liu_sf_torch``,
   ``saddlepoint_sf_torch``) against ``liu_sf`` and ``saddlepoint_sf`` at
   1e-9 relative with an absolute floor of 1e-300, on seeded spectra that
   reach the near-mean and lambda_max <= 0 fallbacks, rank-1 spectra and
   the deep tail (p < 1e-20).  Both sides evaluate the same formulas in
   f64; 1e-9 covers the two libraries' gammaincc, lgamma and erfc, which
   differ by a few ulps, amplified by the series and the bisection's end
   point.
2. ``engine.interaction_batch`` with ``device_pvalues`` against the JAX
   kernel's: lambdas at 1e-12 of the row's max, the tails as in 1.
3. ``scan_interaction`` under "liu", "saddlepoint" and "auto": identical
   rho1 and p-values within 1e-8 of the JAX package's (its end-to-end
   budget), and the port's versions of the JAX suite's info-contract and
   auto-refinement tests (tests/test_api.py:308-337).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import cellregmap_tpu as crt
import cellregmap_tpu_torch as crp
from cellregmap_tpu import engine as jengine
from cellregmap_tpu.models import pvalues as jpv
from cellregmap_tpu.ops.linalg import safe_eigh
from cellregmap_tpu_torch import engine as tengine
from cellregmap_tpu_torch.kernels import mixture_tails as k6b
from cellregmap_tpu_torch.kernels import sym_eigvalsh as k6a
from cellregmap_tpu_torch.models import pvalues as tpv
from _torch_inputs import (assert_tails_close,  # noqa: F401
                           jax_davies_library, tail_battery)
from test_api import _dataset

DELTA_CFG = (-18.0, 18.0, 64, 60)


@pytest.mark.parametrize("C", [3, 10, 50])
def test_sym_eigvalsh_plain_matches_safe_eigh(C):
    rng = np.random.default_rng(C)
    B = rng.normal(size=(6, C, C))
    A = np.concatenate([B @ np.swapaxes(B, 1, 2),           # PSD
                        rng.normal(size=(2, C, C)),          # not symmetric
                        (B[:1, :, : C // 2 + 1]
                         @ np.swapaxes(B[:1, :, : C // 2 + 1], 1, 2))])
    want = np.maximum(np.asarray(safe_eigh(jnp.asarray(A))[0]), 0.0)
    got = k6a.sym_eigvalsh(torch.as_tensor(A)).numpy()
    scale = np.maximum(np.abs(want).max(axis=1, keepdims=True), 1e-300)
    assert (np.abs(got - want) / scale).max() <= 1e-12
    assert np.all(np.diff(got, axis=1) >= 0) and np.all(got >= 0)


@pytest.mark.parametrize("C", [3, 10, 50])
def test_tails_plain_match_jax(C):
    q, lam = tail_battery(100 + C, C=C)
    liu = tpv.liu_sf_torch(torch.as_tensor(q), torch.as_tensor(lam))
    sp = tpv.saddlepoint_sf_torch(torch.as_tensor(q), torch.as_tensor(lam))
    liu_j = np.asarray(jpv.liu_sf(jnp.asarray(q), jnp.asarray(lam))[0])
    sp_j = np.asarray(jpv.saddlepoint_sf(jnp.asarray(q), jnp.asarray(lam)))
    assert_tails_close(liu.numpy(), liu_j)
    assert_tails_close(sp.numpy(), sp_j)
    # the battery reaches the deep tail
    assert np.nanmin(liu_j) < 1e-20


def test_mixture_tails_wrapper_on_cpu_is_plain():
    q, lam = tail_battery(7)
    q, lam = torch.as_tensor(q), torch.as_tensor(lam)
    before = k6b.launches
    got = k6b.mixture_tails(q, lam)
    assert k6b.launches == before
    want = k6b.mixture_tails_plain(q, lam)
    for g, w in zip(got, want):
        assert torch.equal(torch.isnan(g), torch.isnan(w))
        assert torch.equal(g[~torch.isnan(w)], w[~torch.isnan(w)])


@pytest.mark.parametrize("case", ["kinship", "pW2"])
def test_interaction_batch_device_pvalues_match_jax(case):
    d = _dataset(seed=11 if case == "pW2" else 7,
                 pW=2 if case == "pW2" else 1, S=9)
    d["y"] = d["y"] + 1.2 * d["G"][:, 1] * d["E"][:, 0]
    ctx_j = jengine.build_null_context(d["y"], d["W"], d["E"], Ls=d["Ls"])
    out_j = jengine.interaction_kernel(
        ctx_j, jnp.asarray(d["G"]), jnp.asarray(d["G"]), d["n"],
        delta_cfg=DELTA_CFG, device_pvalues=True)
    ctx_t = tengine.null_context_from_numpy(
        {k: np.asarray(v) for k, v in ctx_j._asdict().items()}, "cpu")
    out_t = tengine.interaction_batch(
        ctx_t, torch.as_tensor(d["G"]), torch.as_tensor(d["G"]), d["n"],
        delta_cfg=DELTA_CFG, device_pvalues=True)
    assert np.array_equal(out_t["rho1"].numpy(), np.asarray(out_j["rho1"]))
    lam_j = np.asarray(out_j["lambdas"])
    scale = np.abs(lam_j).max(axis=1, keepdims=True)
    assert (np.abs(out_t["lambdas"].numpy() - lam_j) / scale).max() <= 1e-12
    # the tails at the batch test's 1e-9 relative, as Q
    for k in ("pv_liu", "pv_saddlepoint"):
        assert_tails_close(out_t[k].numpy(), np.asarray(out_j[k]))
    assert float(out_t["pv_saddlepoint"].min()) < 1e-3


def _scan_pair(d, method, **kw):
    cfg_j = crt.ScanConfig(pvalue_method=method, **kw)
    cfg_t = crp.ScanConfig(pvalue_method=method, **kw)
    out_j = crt.CellRegMap(y=d["y"], E=d["E"], W=d["W"], Ls=d["Ls"],
                           config=cfg_j).scan_interaction(d["G"])
    out_t = crp.CellRegMap(y=d["y"], E=d["E"], W=d["W"], Ls=d["Ls"],
                           config=cfg_t, device="cpu"
                           ).scan_interaction(d["G"])
    return out_j, out_t


@pytest.mark.parametrize("method", ["liu", "saddlepoint", "auto"])
def test_scan_interaction_methods_match_jax(method):
    d = _dataset(seed=53, S=8)
    d["y"] = d["y"] + 1.5 * d["G"][:, 1] * d["E"][:, 0]
    (pv_j, info_j), (pv_t, info_t) = _scan_pair(
        d, method, davies_threshold=0.5)
    assert np.array_equal(info_t["rho1"], info_j["rho1"])
    assert_allclose(pv_t, pv_j, rtol=0, atol=1e-8)
    assert np.all((pv_t > 0) & (pv_t <= 1))
    assert set(info_t) == set(info_j)
    for k in ("pv_liu", "pv_saddlepoint"):
        assert_allclose(info_t[k], info_j[k], rtol=0, atol=1e-8, err_msg=k)


def test_davies_info_has_no_placeholder_pvalues():
    d = _dataset(seed=47, S=3)
    crm = crp.CellRegMap(y=d["y"], E=d["E"], W=d["W"], Ls=d["Ls"],
                         device="cpu")
    _, info = crm.scan_interaction(d["G"])  # default method is davies
    assert "pv_liu" not in info
    assert "pv_saddlepoint" not in info
    cfg = crp.ScanConfig(pvalue_method="liu")
    crm2 = crp.CellRegMap(y=d["y"], E=d["E"], W=d["W"], Ls=d["Ls"],
                          config=cfg, device="cpu")
    _, info2 = crm2.scan_interaction(d["G"])
    assert "pv_liu" in info2 and "pv_saddlepoint" in info2
    assert np.all((info2["pv_liu"] > 0) & (info2["pv_liu"] <= 1.0))


def test_auto_mode_refined_matches_davies_1e8():
    """auto's Davies refinement agrees with the davies method to 1e-8: the
    refined pairs' mixture weights are host eigenvalues of their weight
    matrices, as in davies."""
    d = _dataset(seed=53, S=8)
    d["y"] = d["y"] + 1.5 * d["G"][:, 1] * d["E"][:, 0]
    cfg_auto = crp.ScanConfig(pvalue_method="auto", davies_threshold=0.5)
    pv_auto, info = crp.CellRegMap(y=d["y"], E=d["E"], W=d["W"], Ls=d["Ls"],
                                   config=cfg_auto, device="cpu"
                                   ).scan_interaction(d["G"])
    pv_dav, _ = crp.CellRegMap(y=d["y"], E=d["E"], W=d["W"], Ls=d["Ls"],
                               device="cpu").scan_interaction(d["G"])
    refined = pv_auto < 0.5
    assert refined.any() and not refined.all()
    assert_allclose(pv_auto[refined], pv_dav[refined], atol=1e-8)
    assert np.array_equal(pv_auto[~refined], info["pv_saddlepoint"][~refined])


def test_unknown_pvalue_method_raises():
    d = _dataset(seed=47, S=3)
    cfg = dataclasses.replace(crp.DEFAULT_CONFIG, pvalue_method="imhof")
    crm = crp.CellRegMap(y=d["y"], E=d["E"], W=d["W"], Ls=d["Ls"],
                         config=cfg, device="cpu")
    with pytest.raises(ValueError, match="pvalue_method"):
        crm.scan_interaction(d["G"])
