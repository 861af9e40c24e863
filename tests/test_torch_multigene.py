"""The port's gene-batched interaction scan against the JAX package and
against its own per-gene loop, on the CPU.

1. ``engine.interaction_multigene_batch`` against the JAX engine's
   ``interaction_multigene_kernel`` from one carried-across context with a
   gene axis: rho1 identical, Q, Wmat, delta and lml at rtol 1e-9 (the
   single-gene batch test's budget, tests/test_torch_interaction.py), the
   device tails at 1e-9 relative (floor 1e-300).
2. ``run_interaction_multigene`` end to end: p-values within 1e-8 of the
   JAX package's (its end-to-end budget) with identical rho1, and within
   1e-12 of the port's own per-gene loop (``with_phenotype(...)
   .scan_interaction``): the gene axis runs the same kernels' plain
   versions one gene at a time, so only the batched phenotype terms round
   differently.  Tiles of 2 over 5 genes leave a ragged last tile.
3. A one-gene call equals the single-gene path, and the "auto" method's
   gene-batched scan matches the JAX package's.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import cellregmap_tpu as crt
import cellregmap_tpu_torch as crp
from cellregmap_tpu import engine as jengine
from cellregmap_tpu_torch import engine as tengine
from _torch_inputs import (assert_tails_close, captured,  # noqa: F401
                           jax_davies_library)
from test_api import _dataset

DELTA_CFG = (-18.0, 18.0, 64, 60)


def _genes(d, k, seed, scale=0.3):
    rng = np.random.default_rng(seed)
    return d["y"][:, None] + scale * rng.normal(size=(d["n"], k))


@pytest.mark.parametrize("device_pvalues", [False, True])
def test_interaction_multigene_batch_matches_jax(device_pvalues):
    d = _dataset(seed=41, S=7)
    Y = _genes(d, 3, 5)
    Y[:, 1] += 1.2 * d["G"][:, 2] * d["E"][:, 0]
    ctx_j = jengine.build_null_context(d["y"], d["W"], d["E"], Ls=d["Ls"])
    Yj = jnp.asarray(Y)
    ctx_jg = ctx_j._replace(y=Yj.T, Zy=(ctx_j.Z.T @ Yj).T,
                            Wy=(ctx_j.W.T @ Yj).T, yy=jnp.sum(Yj * Yj, 0))
    out_j = jengine.interaction_multigene_kernel(
        ctx_jg, jnp.asarray(d["G"]), jnp.asarray(d["G"]), d["n"],
        delta_cfg=DELTA_CFG, device_pvalues=device_pvalues)
    ctx_t = tengine.null_context_from_numpy(
        {k: np.asarray(v) for k, v in ctx_jg._asdict().items()}, "cpu")
    assert ctx_t.y.shape == (3, d["n"])
    G = torch.as_tensor(d["G"])
    out_t = tengine.interaction_multigene_batch(
        ctx_t, G, G, d["n"], delta_cfg=DELTA_CFG,
        device_pvalues=device_pvalues)
    assert out_t["Q"].shape == (3, 7) and out_t["Wmat"].shape == (3, 7, 3, 3)
    assert np.array_equal(out_t["rho1"].numpy(), np.asarray(out_j["rho1"]))
    for k in ("Q", "Wmat", "delta", "lml", "v0", "v1", "e2", "g2", "eps2"):
        assert_allclose(out_t[k].numpy(), np.asarray(out_j[k]), rtol=1e-9,
                        atol=1e-12, err_msg=k)
    if device_pvalues:
        lam_j = np.asarray(out_j["lambdas"])
        scale = np.abs(lam_j).max(axis=-1, keepdims=True)
        assert (np.abs(out_t["lambdas"].numpy() - lam_j)
                / scale).max() <= 1e-12
        for k in ("pv_liu", "pv_saddlepoint"):
            assert_tails_close(out_t[k].numpy(), np.asarray(out_j[k]))
    else:
        assert "pv_liu" not in out_t


@pytest.mark.parametrize("method", ["davies", "auto"])
def test_multigene_hands_kernels_contiguous_operands(method):
    """The card's kernels take contiguous operands only (the wrappers
    raise otherwise): every tensor that ``scan_interaction_multigene``
    hands a kernel wrapper is contiguous (the phenotype terms come out of
    vmap, the tile's phenotypes out of a transpose), here with two
    covariates."""
    d = _dataset(seed=11, pW=2, S=6)
    names = ["kr_contract", "delta_grid", "reml_localize", "reml_converge",
             "best_rho_rotate", "score_core", "sym_eigvalsh",
             "mixture_tails"]
    cfg = crp.ScanConfig(pvalue_method=method)
    calls = captured(lambda: crp.CellRegMap(
        y=d["y"], E=d["E"], W=d["W"], Ls=d["Ls"], config=cfg, device="cpu"
    ).scan_interaction_multigene(_genes(d, 3, 2), d["G"]), names)
    if method == "davies":
        names = names[:-2]
    for name in names:
        (args, _), *_ = calls[name]
        flat = [t for a in args
                for t in (a if isinstance(a, tuple) else (a,))]
        for i, t in enumerate(flat):
            if isinstance(t, torch.Tensor):
                assert t.is_contiguous(), f"{name}: operand {i}"


def _per_gene_loop(Y, d, cfg):
    crm = crp.CellRegMap(y=Y[:, 0], E=d["E"], W=d["W"],
                         Ls=crp.get_L_values(d["hK"], d["E"]), config=cfg,
                         device="cpu")
    return [(crm if j == 0 else crm.with_phenotype(Y[:, j]))
            .scan_interaction(d["G"]) for j in range(Y.shape[1])]


@pytest.mark.parametrize("n_genes,gene_batch,seed",
                         [(5, 2, 43), (2, 16, 41)])
def test_run_interaction_multigene_matches_jax_and_loop(n_genes, gene_batch,
                                                        seed):
    d = _dataset(seed=seed, S=5)
    Y = _genes(d, n_genes, seed + 1)
    pv_j, info_j = crt.run_interaction_multigene(
        Y, d["E"], d["G"], W=d["W"], hK=d["hK"], gene_batch=gene_batch)
    cfg = crp.ScanConfig(snp_batch=4)   # two variant batches a tile
    pv, info = crp.run_interaction_multigene(
        Y, d["E"], d["G"], W=d["W"], hK=d["hK"], gene_batch=gene_batch,
        config=cfg, device="cpu")
    assert pv.shape == (n_genes, 5)
    assert set(info) == set(info_j) and info["lambdas"].shape == (n_genes, 5,
                                                                  3)
    assert np.array_equal(info["rho1"], info_j["rho1"])
    assert_allclose(pv, pv_j, rtol=0, atol=1e-8)
    for j, (pv_l, info_l) in enumerate(_per_gene_loop(Y, d, cfg)):
        assert np.array_equal(info["rho1"][j], info_l["rho1"])
        assert_allclose(pv[j], pv_l, rtol=0, atol=1e-12)
        for k in ("Q", "e2", "g2", "eps2"):
            assert_allclose(info[k][j], info_l[k], rtol=1e-12, atol=0,
                            err_msg=k)


def test_multigene_one_gene_equals_single_gene_path():
    d = _dataset(seed=47, S=6)
    pv, info = crp.run_interaction_multigene(
        d["y"], d["E"], d["G"], W=d["W"], hK=d["hK"], device="cpu")
    pv1, info1 = crp.run_interaction(y=d["y"], E=d["E"], G=d["G"], W=d["W"],
                                     hK=d["hK"], device="cpu")
    assert pv.shape == (1, 6)
    assert np.array_equal(info["rho1"][0], info1["rho1"])
    assert_allclose(pv[0], pv1, rtol=0, atol=1e-12)
    assert_allclose(info["Q"][0], info1["Q"], rtol=1e-12, atol=0)


def test_multigene_auto_matches_jax():
    d = _dataset(seed=53, S=6)
    Y = _genes(d, 3, 9)
    Y[:, 0] += 1.5 * d["G"][:, 1] * d["E"][:, 0]
    kw = dict(pvalue_method="auto", davies_threshold=0.5)
    pv_j, info_j = crt.run_interaction_multigene(
        Y, d["E"], d["G"], W=d["W"], hK=d["hK"], gene_batch=2,
        config=crt.ScanConfig(**kw))
    pv, info = crp.run_interaction_multigene(
        Y, d["E"], d["G"], W=d["W"], hK=d["hK"], gene_batch=2,
        config=crp.ScanConfig(**kw), device="cpu")
    assert set(info) == set(info_j)
    assert np.array_equal(info["rho1"], info_j["rho1"])
    refined = pv < 0.5
    assert refined.any() and not refined.all()
    assert_allclose(pv, pv_j, rtol=0, atol=1e-8)
    for k in ("pv_liu", "pv_saddlepoint"):
        assert_allclose(info[k], info_j[k], rtol=0, atol=1e-8, err_msg=k)


def test_multigene_rejects_bad_shapes():
    d = _dataset(seed=47, S=3)
    crm = crp.CellRegMap(y=d["y"], E=d["E"], W=d["W"], Ls=d["Ls"],
                         device="cpu")
    with pytest.raises(ValueError):
        crm.scan_interaction_multigene(_genes(d, 2, 1)[:-1], d["G"])
    with pytest.raises(ValueError):
        crm.scan_interaction_multigene(_genes(d, 2, 1),
                                       np.zeros((d["n"], 0)))
