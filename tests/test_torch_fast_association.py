"""The port's fast association scan against the JAX package, on the CPU.

On the tests/test_api.py datasets (one and two covariates, hK mode and Ls
mode), with the JAX engine's null context carried across
(``null_context_from_numpy``):

1. K8's plain version, ``models.lmm.fast_scan``, against the JAX package's
   on the same rotated inputs: every output at rtol 1e-10 (the same
   algebra, summed in another order);
2. ``engine.fast_scan_batch`` against ``engine.fast_scan_kernel`` called at
   the port's own null delta and best rho (the port's golden-section delta
   agrees with the JAX package's only to ~1e-8 relative, and the alternative
   lml at a fixed delta moves with it to first order): rtol 1e-10;
3. end to end, ``scan_association_fast`` / ``run_association_fast``
   p-values against the JAX package's within the JAX suite's fast-scan
   oracle budget (tests/test_api.py:123: rtol 1e-5, atol 1e-12), with the
   same null rho, also in ragged batches.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import cellregmap_tpu as crt
import cellregmap_tpu_torch as crp
from cellregmap_tpu import engine as jengine
from cellregmap_tpu.models import lmm as jlmm
from cellregmap_tpu_torch import engine as tengine
from cellregmap_tpu_torch.models import lmm as tlmm
from test_api import _dataset
from test_torch_association import CASES, DELTA_CFG, _bg, _contexts


def _rotated(ctx, G, k):
    """fast_scan's operands at rho index k, as the JAX kernel forms them
    (NumPy)."""
    V, S = np.asarray(ctx.V[k]), np.asarray(ctx.S[k])
    ZW, Zy, Z = (np.asarray(a) for a in (ctx.ZW, ctx.Zy, ctx.Z))
    W, y = np.asarray(ctx.W), np.asarray(ctx.y)
    Wt, yt = V.T @ ZW, V.T @ Zy
    Gt = V.T @ (Z.T @ G)
    return (S, Wt, yt, np.asarray(ctx.WW) - Wt.T @ Wt,
            np.asarray(ctx.Wy) - Wt.T @ yt, float(ctx.yy) - yt @ yt, Gt,
            W.T @ G - Wt.T @ Gt, G.T @ y - Gt.T @ yt,
            (G * G).sum(0) - (Gt * Gt).sum(0))


@pytest.mark.parametrize("mode,seed,pW", CASES)
def test_fast_scan_plain_matches_jax(mode, seed, pW):
    d = _dataset(seed=seed, pW=pW)
    ctx_j, _ = _contexts(d, mode)
    args = _rotated(ctx_j, d["G"], k=3)
    want = jlmm.fast_scan(0.37, *(jnp.asarray(a) for a in args), d["n"])
    got = tlmm.fast_scan(0.37, *(torch.tensor(a) for a in args), d["n"])
    for g, w, name in zip(got, want, want._fields):
        assert_allclose(g.numpy(), np.asarray(w), rtol=1e-10, err_msg=name)


@pytest.mark.parametrize("mode,seed,pW", CASES)
def test_fast_scan_batch_matches_jax_at_the_ports_delta(mode, seed, pW):
    d = _dataset(seed=seed, pW=pW, S=9)
    ctx_j, ctx_t = _contexts(d, mode)
    fits, k = tengine.null_association_fit(ctx_t, d["n"], restricted=False,
                                           delta_cfg=DELTA_CFG)
    k = int(k)
    delta = float(fits.delta[k])
    got = tengine.fast_scan_batch(ctx_t, torch.as_tensor(d["G"]), k, delta,
                                  d["n"])
    want = jengine.fast_scan_kernel(ctx_j, jnp.asarray(d["G"]), k, delta,
                                    d["n"])
    for g, w, name in zip(got, want, want._fields):
        assert_allclose(g.numpy(), np.asarray(w), rtol=1e-10, err_msg=name)


@pytest.mark.parametrize("mode,seed,pW", CASES)
def test_scan_association_fast_matches_jax(mode, seed, pW, tmp_path):
    d = _dataset(seed=seed, pW=pW)
    pv_j, info_j = crt.CellRegMap(
        y=d["y"], E=d["E"], W=d["W"], **_bg(d, mode)).scan_association_fast(
            d["G"])
    crm = crp.CellRegMap(y=d["y"], E=d["E"], W=d["W"], **_bg(d, mode),
                         device="cpu")
    pv_t, info_t = crm.scan_association_fast(d["G"])
    assert np.array_equal(info_t["rho1"], info_j["rho1"])
    assert_allclose(pv_t, pv_j, rtol=1e-5, atol=1e-12)
    assert np.all((pv_t > 0) & (pv_t <= 1))
    # a checkpointed scan gives the same p-values
    pv_ck, _ = crm.scan_association_fast(d["G"],
                                         checkpoint=str(tmp_path / "ck"))
    assert np.array_equal(pv_ck, pv_t)


def test_run_association_fast_matches_jax_in_ragged_batches():
    """7 variants in batches of 3: the padded last batch is cut away."""
    d = _dataset(seed=29, S=7)
    pv_j, _ = crt.run_association_fast(d["y"], d["W"], d["E"], d["G"],
                                       hK=d["hK"])
    pv_t, info = crp.run_association_fast(
        d["y"], d["W"], d["E"], d["G"], hK=d["hK"], device="cpu",
        config=crp.ScanConfig(snp_batch=3))
    assert pv_t.shape == (7,)
    assert_allclose(pv_t, pv_j, rtol=1e-5, atol=1e-12)
    assert set(info) == {"rho1", "e2", "g2", "eps2"}
    traced = crp.CellRegMap(y=d["y"], E=d["E"], W=d["W"], hK=d["hK"],
                            device="cpu", config=crp.ScanConfig(trace=True))
    pv_tr, info_tr = traced.scan_association_fast(d["G"])
    assert set(info_tr["timers"]) == {"association_fast/setup",
                                      "association_fast/device",
                                      "association_fast/device_get"}
    assert_allclose(pv_tr, pv_t, rtol=0, atol=1e-15)
