"""The port's interaction scan against the JAX package, on the CPU.

Three parts:

1. the batch program alone: one null context, built by the JAX engine and
   carried across (``null_context_from_numpy``), through
   ``engine.interaction_batch`` of both packages.  Q, Wmat, delta and lml
   agree at rtol 1e-9 and rho1 exactly: both run the same f64 Newton tail
   from the same f32-localized bracket, so they differ by the f64 Newton
   convergence and summation order only (the JAX engine's hybrid-vs-f64
   budget is the same 1e-9, tests/test_hybrid.py);
2. end to end (``run_interaction`` / ``CellRegMap.scan_interaction``) on
   the tests/test_api.py datasets: p-values within 1e-8 absolute with
   identical rho1 (the JAX engine's own budget against the dense oracle);
3. C = 50 (the tests/test_many_contexts.py dataset): within 1e-8 of the
   JAX engine, which feeds Davies the same inputs, and within 2e-8 of the
   dense oracle.  Davies' ``acc`` is an ABSOLUTE accuracy (1e-8 by
   default) and the oracle runs its own Davies pass, so each side of that
   comparison carries up to davies_acc of error: 2 * davies_acc is the
   resolution of the method, not slack in the port.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import cellregmap_tpu as crt
import cellregmap_tpu_torch as crp
from cellregmap_tpu import engine as jengine
from cellregmap_tpu import oracle
from cellregmap_tpu_torch import engine as tengine
from test_api import _dataset
from test_many_contexts import _dataset as _c50_dataset
from _torch_inputs import jax_davies_library  # noqa: F401

DELTA_CFG = (-18.0, 18.0, 64, 60)


def _assert_scan_equal(pv, info, pv_ref, info_ref, atol=1e-8):
    assert np.array_equal(info["rho1"], info_ref["rho1"])
    assert_allclose(pv, pv_ref, rtol=0, atol=atol)
    assert np.all((pv > 0) & (pv <= 1))


# --------------------------------------------------------------------------
# 1. the batch program from one carried-across context
# --------------------------------------------------------------------------
@pytest.mark.parametrize("case", ["kinship", "pW2", "permuted", "full_f64",
                                  "c50"])
def test_interaction_batch_matches_jax(case):
    if case == "c50":
        y, W, E, G, Ls = _c50_dataset()
        d = dict(y=y, W=W, E=E, G=G, Ls=Ls, n=len(y))
    else:
        d = _dataset(seed=11 if case == "pW2" else 7,
                     pW=2 if case == "pW2" else 1, S=9)
    G = d["G"]
    Gs = G[np.random.default_rng(1).permutation(d["n"])] \
        if case == "permuted" else G
    localize = case != "full_f64"
    ctx_j = jengine.build_null_context(d["y"], d["W"], d["E"], Ls=d["Ls"])
    out_j = jengine.interaction_kernel(
        ctx_j, jnp.asarray(G), jnp.asarray(Gs), d["n"], delta_cfg=DELTA_CFG,
        device_pvalues=False, localize_f32=localize)
    ctx_t = tengine.null_context_from_numpy(
        {k: np.asarray(v) for k, v in ctx_j._asdict().items()}, "cpu")
    out_t = tengine.interaction_batch(
        ctx_t, torch.as_tensor(G), torch.as_tensor(np.ascontiguousarray(Gs)),
        d["n"], delta_cfg=DELTA_CFG, localize_f32=localize)
    assert np.array_equal(out_t["rho1"].numpy(), np.asarray(out_j["rho1"]))
    for k in ("Q", "Wmat", "delta", "lml", "v0", "v1", "e2", "g2", "eps2"):
        assert_allclose(out_t[k].numpy(), np.asarray(out_j[k]), rtol=1e-9,
                        atol=1e-12, err_msg=k)


# --------------------------------------------------------------------------
# 2. end to end on the tests/test_api.py datasets
# --------------------------------------------------------------------------
@pytest.mark.parametrize("mode,seed,pW", [("Ls", 7, 1), ("E-only", 9, 1),
                                          ("hK", 13, 1), ("Ls", 11, 2)])
def test_scan_interaction_matches_jax(mode, seed, pW):
    d = _dataset(seed=seed, kinship=(mode == "Ls"), pW=pW)
    kw = {"Ls": d["Ls"]} if mode == "Ls" else (
        {"hK": d["hK"]} if mode == "hK" else {})
    pv_j, info_j = crt.CellRegMap(y=d["y"], E=d["E"], W=d["W"],
                                  **kw).scan_interaction(d["G"])
    pv_t, info_t = crp.CellRegMap(y=d["y"], E=d["E"], W=d["W"], **kw,
                                  device="cpu").scan_interaction(d["G"])
    _assert_scan_equal(pv_t, info_t, pv_j, info_j)
    for k in ("Q", "e2", "g2", "eps2"):
        assert_allclose(info_t[k], info_j[k], rtol=1e-9, atol=1e-12)
    assert_allclose(info_t["lambdas"], np.asarray(info_j["lambdas"]),
                    rtol=1e-9, atol=1e-12)


def test_scan_interaction_permutations_match_jax():
    d = _dataset(seed=21, S=4)
    idx = np.random.default_rng(1).permutation(d["n"])
    crm_j = crt.CellRegMap(y=d["y"], E=d["E"], W=d["W"], Ls=d["Ls"])
    crm_t = crp.CellRegMap(y=d["y"], E=d["E"], W=d["W"], Ls=d["Ls"],
                           device="cpu")
    for kw in ({"idx_E": idx}, {"idx_G": idx}):
        pv_j, info_j = crm_j.scan_interaction(d["G"], **kw)
        pv_t, info_t = crm_t.scan_interaction(d["G"], **kw)
        _assert_scan_equal(pv_t, info_t, pv_j, info_j)
    # a permutation moves the statistics: not the unpermuted scan
    pv0, _ = crm_t.scan_interaction(d["G"])
    assert np.max(np.abs(pv0 - pv_t)) > 1e-6


def test_ragged_batches_match_jax():
    """7 variants in batches of 3: the padded last batch is cut away."""
    d = _dataset(seed=33, S=7)
    cfg_j = crt.ScanConfig(snp_batch=3)
    cfg_t = crp.ScanConfig(snp_batch=3)
    pv_j, info_j = crt.CellRegMap(y=d["y"], E=d["E"], W=d["W"], Ls=d["Ls"],
                                  config=cfg_j).scan_interaction(d["G"])
    crm = crp.CellRegMap(y=d["y"], E=d["E"], W=d["W"], Ls=d["Ls"],
                         config=cfg_t, device="cpu")
    pv_t, info_t = crm.scan_interaction(d["G"])
    assert pv_t.shape == (7,) and info_t["Q"].shape == (7,)
    _assert_scan_equal(pv_t, info_t, pv_j, info_j)
    # one batch of all 7 gives the same answers
    pv_1, _ = crp.CellRegMap(y=d["y"], E=d["E"], W=d["W"], Ls=d["Ls"],
                             device="cpu").scan_interaction(d["G"])
    assert_allclose(pv_t, pv_1, rtol=0, atol=1e-12)


def test_run_interaction_matches_jax():
    d = _dataset(seed=29, S=5)
    pv_j, info_j = crt.run_interaction(y=d["y"], E=d["E"], G=d["G"],
                                       W=d["W"], hK=d["hK"])
    pv_t, info_t = crp.run_interaction(y=d["y"], E=d["E"], G=d["G"],
                                       W=d["W"], hK=d["hK"], device="cpu")
    _assert_scan_equal(pv_t, info_t, pv_j, info_j)
    idx = np.random.default_rng(3).permutation(d["n"])
    pv_j, info_j = crt.run_interaction(y=d["y"], E=d["E"], G=d["G"],
                                       W=d["W"], hK=d["hK"], idx_G=idx)
    pv_t, info_t = crp.run_interaction(y=d["y"], E=d["E"], G=d["G"],
                                       W=d["W"], hK=d["hK"], idx_G=idx,
                                       device="cpu")
    _assert_scan_equal(pv_t, info_t, pv_j, info_j)


def test_with_phenotype_equals_fresh_build():
    d = _dataset(seed=41, S=4)
    y2 = d["y"] + np.random.default_rng(5).normal(size=d["n"])
    base = crp.CellRegMap(y=d["y"], E=d["E"], W=d["W"], Ls=d["Ls"],
                          device="cpu")
    pv_w, info_w = base.with_phenotype(y2).scan_interaction(d["G"])
    pv_f, info_f = crp.CellRegMap(y=y2, E=d["E"], W=d["W"], Ls=d["Ls"],
                                  device="cpu").scan_interaction(d["G"])
    _assert_scan_equal(pv_w, info_w, pv_f, info_f, atol=1e-12)
    # the base scanner is untouched
    pv_b, _ = base.scan_interaction(d["G"])
    pv_j, _ = crt.CellRegMap(y=d["y"], E=d["E"], W=d["W"],
                             Ls=d["Ls"]).scan_interaction(d["G"])
    assert_allclose(pv_b, pv_j, rtol=0, atol=1e-8)


def test_hybrid_matches_full_f64():
    """The tests/test_hybrid.py dataset and budget, on the port."""
    rng = np.random.default_rng(11)
    n, C, donors, S = 200, 4, 20, 24
    E = rng.normal(size=(n, C)) / np.sqrt(C)
    W = np.concatenate([np.ones((n, 1)), rng.normal(size=(n, 1))], axis=1)
    hK = np.zeros((n, donors))
    hK[np.arange(n), np.repeat(np.arange(donors), n // donors)] = 1.0
    Ls = crp.get_L_values(hK, E)
    G = rng.binomial(2, 0.3, size=(n, S)).astype(float)
    y = (rng.normal(size=n) + 0.6 * E @ rng.normal(size=C)
         + 0.5 * hK @ rng.normal(size=donors) + 0.4 * G[:, 3] * E[:, 1])
    run = lambda hybrid: crp.CellRegMap(  # noqa: E731
        y=y, E=E, W=W, Ls=Ls, device="cpu",
        config=crp.ScanConfig(hybrid_localization=hybrid),
    ).scan_interaction(G)
    pv_h, info_h = run(True)
    pv_f, info_f = run(False)
    np.testing.assert_array_equal(info_h["rho1"], info_f["rho1"])
    assert_allclose(info_h["Q"], info_f["Q"], rtol=1e-9)
    assert_allclose(pv_h, pv_f, atol=1e-9)
    assert np.max(np.abs(info_h["eps2"] - info_f["eps2"])) < 1e-8


def test_traced_scan_reports_phases():
    d = _dataset(seed=47, S=3)
    cfg = crp.ScanConfig(trace=True)
    pv, info = crp.CellRegMap(y=d["y"], E=d["E"], W=d["W"], Ls=d["Ls"],
                              config=cfg, device="cpu").scan_interaction(
                                  d["G"])
    assert set(info["timers"]) == {"interaction/setup", "interaction/device",
                                   "interaction/device_get",
                                   "interaction/pvalue_ladder"}
    assert all(v >= 0 for v in info["timers"].values())
    pv_u, _ = crp.CellRegMap(y=d["y"], E=d["E"], W=d["W"], Ls=d["Ls"],
                             device="cpu").scan_interaction(d["G"])
    assert np.array_equal(pv, pv_u)


def test_unported_options_raise():
    """The float32 context runs every scan but the aggregate environment,
    which refuses it, naming its path; invalid phenotypes raise
    ValueError."""
    d = _dataset(seed=49, S=3)
    crm32 = crp.CellRegMap(y=d["y"], E=d["E"], device="cpu",
                           config=crp.ScanConfig(dtype="float32"))
    with pytest.raises(NotImplementedError,
                       match="estimate_aggregate_environment"):
        crm32.estimate_aggregate_environment(d["G"][:, 0])
    with pytest.raises(ValueError):
        crp.CellRegMap(y=np.full(d["n"], np.nan), E=d["E"], device="cpu")


# --------------------------------------------------------------------------
# 3. C = 50 contexts
# --------------------------------------------------------------------------
def test_c50_matches_jax_engine_and_dense_oracle():
    y, W, E, G, Ls = _c50_dataset()
    pv_t, info_t = crp.CellRegMap(y=y, E=E, W=W, Ls=Ls,
                                  device="cpu").scan_interaction(G)
    pv_j, info_j = crt.CellRegMap(y=y, E=E, W=W,
                                  Ls=Ls).scan_interaction(G)
    # same Davies inputs on both sides: the engines' own agreement
    _assert_scan_equal(pv_t, info_t, pv_j, info_j, atol=1e-8)
    pv_d, info_d = oracle.scan_interaction_dense(y, W, E, Ls=Ls, G=G)
    # each side carries Davies' absolute acc (1e-8): 2 * davies_acc
    assert np.array_equal(info_t["rho1"], info_d["rho1"])
    assert np.max(np.abs(pv_t - pv_d)) < 2 * crp.DEFAULT_CONFIG.davies_acc
    assert pv_t.shape == (6,) and np.all((pv_t > 0) & (pv_t <= 1))
