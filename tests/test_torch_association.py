"""The port's association test against the JAX package, on the CPU.

On the tests/test_api.py datasets (one and two covariates, hK mode and Ls
mode), with the null context built by the JAX engine and carried across
(``null_context_from_numpy``):

1. K10, the null fits over the rho grid (``null_association_fit`` vs
   ``null_association_kernel``; ``_fit_over_rho`` vs ``mean_fit_kernel``
   for the REML objective): per-rho lml at rtol 1e-10 and the same best
   rho.  Both run the same 256-point grid and 60 golden-section steps in
   f64, but delta is not compared with delta: within ~sqrt(eps) of the
   optimum the lml is flat to eps * |lml|, so two correct searches that
   sum in different orders stop ~1e-8 apart (measured: 1e-8 to 7e-8
   relative), and where the profile is flat (the REML fit at rho = 1,
   where E E^T lies in the span of M = [W, g, E]) anywhere in the flat
   range (9e-5).  Instead the reference's objective is evaluated at the
   port's delta: it must equal the reference's maximum at rtol 1e-10 (the
   port's delta is an optimum of the same objective), and the port's beta
   and scale must equal the reference's at that delta at rtol 1e-10;
2. K7, the per-variant ML refit (``association_refit_batch`` vs
   ``association_refit_kernel``): alt lmls within 1e-8 absolute and betas
   at rtol 1e-6, the JAX package's own Newton-vs-golden budgets
   (tests/test_api.py:214-217);
3. end to end, ``scan_association`` / ``run_association``: p-values within
   1e-9 absolute (tests/test_api.py:221) with identical rho1; the null's
   variance components (functions of its golden-section delta, see 1) at
   rtol 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from numpy.testing import assert_allclose

import cellregmap_tpu as crt
import cellregmap_tpu_torch as crp
import torch
from cellregmap_tpu import engine as jengine
from cellregmap_tpu.models import lmm as jlmm
from cellregmap_tpu_torch import engine as tengine
from cellregmap_tpu_torch.parallel.checkpoint import ScanCheckpoint
from test_api import _dataset

DELTA_CFG = (-18.0, 18.0, 256, 60)
CASES = [("hK", 11, 2), ("hK", 23, 1), ("Ls", 7, 1), ("Ls", 31, 2)]


def _bg(d, mode):
    return {"Ls": d["Ls"]} if mode == "Ls" else {"hK": d["hK"]}


def _contexts(d, mode):
    ctx_j = jengine.build_null_context(d["y"], d["W"], d["E"], **_bg(d, mode))
    ctx_t = tengine.null_context_from_numpy(
        {k: np.asarray(v) for k, v in ctx_j._asdict().items()}, "cpu")
    return ctx_j, ctx_t


def _assert_fits(fits_t, fits_j, ctx_j, Xz, X_gram, X_y, n, restricted):
    """The port's per-rho fits against the reference's (module doc, 1)."""
    assert_allclose(fits_t.lml.numpy(), np.asarray(fits_j.lml), rtol=1e-10)

    def at_port_delta(V, S, delta):
        Xt, yt = V.T @ Xz, V.T @ ctx_j.Zy
        data = jlmm.EigData(S=S, Xt=Xt, yt=yt, Cxx=X_gram - Xt.T @ Xt,
                            cxy=X_y - Xt.T @ yt, cyy=ctx_j.yy - yt @ yt)
        return jlmm.lml_at_delta_eig(delta, data, n, restricted)

    lml, beta, scale, _ = jax.vmap(at_port_delta)(
        ctx_j.V, ctx_j.S, jnp.asarray(fits_t.delta.numpy()))
    assert_allclose(np.asarray(lml), np.asarray(fits_j.lml), rtol=1e-10)
    assert_allclose(fits_t.beta.numpy(), np.asarray(beta), rtol=1e-10)
    assert_allclose(fits_t.scale.numpy(), np.asarray(scale), rtol=1e-10)


@pytest.mark.parametrize("mode,seed,pW", CASES)
def test_null_fit_matches_jax(mode, seed, pW):
    d = _dataset(seed=seed, pW=pW)
    ctx_j, ctx_t = _contexts(d, mode)
    fits_j, k_j = jengine.null_association_kernel(
        ctx_j, d["n"], restricted=False, delta_cfg=DELTA_CFG)
    fits_t, k_t = tengine.null_association_fit(
        ctx_t, d["n"], restricted=False, delta_cfg=DELTA_CFG)
    assert int(k_t) == int(k_j)
    _assert_fits(fits_t, fits_j, ctx_j, ctx_j.ZW, ctx_j.WW, ctx_j.Wy,
                 d["n"], False)


@pytest.mark.parametrize("mode,seed,pW", CASES[:2])
def test_reml_fit_over_rho_matches_jax(mode, seed, pW):
    """The REML instantiation, on the mean matrix M = [W, g, E] of
    ``mean_fit_kernel`` (reference :207-230)."""
    d = _dataset(seed=seed, pW=pW)
    ctx_j, ctx_t = _contexts(d, mode)
    M = np.concatenate([d["W"], d["G"][:, :1], d["E"]], axis=1)
    cfg = (-18.0, 18.0, 64, 60)
    fits_j = jengine.mean_fit_kernel(ctx_j, jnp.asarray(M), d["n"], True, cfg)
    Mt = torch.as_tensor(M)
    fits_t = tengine._fit_over_rho(ctx_t, ctx_t.Z.T @ Mt, Mt.T @ Mt,
                                   Mt.T @ ctx_t.y, d["n"], True, cfg)
    assert int(fits_t.lml.argmax()) == int(np.argmax(fits_j.lml))
    Mj = jnp.asarray(M)
    _assert_fits(fits_t, fits_j, ctx_j, ctx_j.Z.T @ Mj, Mj.T @ Mj,
                 Mj.T @ ctx_j.y, d["n"], True)


@pytest.mark.parametrize("mode,seed,pW", CASES)
@pytest.mark.parametrize("localize_f32", [True, False])
def test_refit_matches_jax(mode, seed, pW, localize_f32):
    d = _dataset(seed=seed, pW=pW, S=8)
    ctx_j, ctx_t = _contexts(d, mode)
    _, k = jengine.null_association_kernel(ctx_j, d["n"], restricted=False,
                                           delta_cfg=DELTA_CFG)
    k = int(k)
    lml_j, beta_j = jengine.association_refit_kernel(
        ctx_j, jnp.asarray(d["G"]), k, d["n"], delta_cfg=DELTA_CFG,
        localize_f32=localize_f32)
    lml_t, beta_t = tengine.association_refit_batch(
        ctx_t, torch.as_tensor(d["G"]), k, d["n"], delta_cfg=DELTA_CFG,
        localize_f32=localize_f32)
    assert_allclose(lml_t.numpy(), np.asarray(lml_j), rtol=0, atol=1e-8)
    assert_allclose(beta_t.numpy(), np.asarray(beta_j), rtol=1e-6,
                    atol=1e-9)


@pytest.mark.parametrize("mode,seed,pW", CASES)
def test_scan_association_matches_jax(mode, seed, pW):
    d = _dataset(seed=seed, pW=pW)
    pv_j, info_j = crt.CellRegMap(y=d["y"], E=d["E"], W=d["W"],
                                  **_bg(d, mode)).scan_association(d["G"])
    crm = crp.CellRegMap(y=d["y"], E=d["E"], W=d["W"], **_bg(d, mode),
                         device="cpu")
    pv_t, info_t = crm.scan_association(d["G"])
    assert np.array_equal(info_t["rho1"], info_j["rho1"])
    assert_allclose(pv_t, pv_j, rtol=0, atol=1e-9)
    assert np.all((pv_t > 0) & (pv_t <= 1))
    for k in ("e2", "g2", "eps2"):
        assert_allclose(info_t[k], info_j[k], rtol=1e-6, err_msg=k)


def test_run_association_matches_jax_in_ragged_batches():
    """7 variants in batches of 3: the padded last batch is cut away."""
    d = _dataset(seed=29, S=7)
    pv_j, _ = crt.run_association(d["y"], d["W"], d["E"], d["G"],
                                  hK=d["hK"])
    pv_t, info = crp.run_association(d["y"], d["W"], d["E"], d["G"],
                                     hK=d["hK"], device="cpu",
                                     config=crp.ScanConfig(snp_batch=3))
    assert pv_t.shape == (7,)
    assert_allclose(pv_t, pv_j, rtol=0, atol=1e-9)
    assert set(info) == {"rho1", "e2", "g2", "eps2"}


def test_association_scanner_state(tmp_path):
    d = _dataset(seed=37, S=4)
    crm = crp.CellRegMap(y=d["y"], E=d["E"], W=d["W"], hK=d["hK"],
                         device="cpu")
    pv0, _ = crm.scan_association(d["G"])
    # a checkpointed scan gives the same p-values and clears its checkpoint
    pv_ck, _ = crm.scan_association(d["G"], checkpoint=str(tmp_path / "ck"))
    assert np.array_equal(pv_ck, pv0)
    assert ScanCheckpoint(tmp_path / "ck").load() is None
    # another phenotype refits the null; the base scanner keeps its own
    y2 = d["y"] + np.random.default_rng(3).normal(size=d["n"])
    pv2, _ = crm.with_phenotype(y2).scan_association(d["G"])
    pv_f, _ = crp.CellRegMap(y=y2, E=d["E"], W=d["W"], hK=d["hK"],
                             device="cpu").scan_association(d["G"])
    assert_allclose(pv2, pv_f, rtol=0, atol=1e-12)
    assert np.max(np.abs(pv2 - pv0)) > 1e-6
    assert np.array_equal(crm.scan_association(d["G"])[0], pv0)
    traced = crp.CellRegMap(y=d["y"], E=d["E"], W=d["W"], hK=d["hK"],
                            device="cpu", config=crp.ScanConfig(trace=True))
    pv_t, info = traced.scan_association(d["G"])
    assert set(info["timers"]) == {"association/setup", "association/device",
                                   "association/device_get"}
    assert np.array_equal(pv_t, pv0)
