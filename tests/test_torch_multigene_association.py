"""The port's gene-batched association scans against the JAX package, on the
CPU.

Each gene of a tile is fitted at its own null's best rho; the tiles here
hold genes that pick different best rho (the tests assert it), so that
the per-gene rho index is exercised.  The null context is built by the JAX
engine and carried across (``null_context_from_numpy``), so that both
packages start from the same factorization.  Budgets, as in
tests/test_torch_association.py and tests/test_torch_fast_association.py:

1. K10 with the gene axis (``null_association_multigene_fit`` vs
   ``null_association_multigene_kernel``): per-rho lml at rtol 1e-10 and
   the same best rho per gene;
2. K8 with the gene axis (``fast_scan_multigene_batch`` vs
   ``fast_scan_multigene_kernel``, at the reference's k and delta): lml at
   rtol 1e-10;
3. K7 at a per-gene rho (``association_refit_multigene_batch`` vs
   ``association_refit_multigene_kernel``): lml within 1e-8 absolute, beta
   at rtol 1e-6 / atol 1e-9.  Under hybrid localization one dataset's
   phenotype has a variant whose ML profile is flat up to the grid's upper
   end: there the float32 grid's argmax sits at float32 noise, the two
   packages start their Newton steps from different brackets and stop at
   their edges, short of the float64 optimum.  The port then checks the
   grid's ends and reaches the optimum; the reference keeps the shortfall,
   so that dataset is held to the reference in float64 and, under float32,
   to the float64 optimum and the dense oracle on its own;
4. end to end, ``run_association_multigene`` / ``run_association_fast_
   multigene`` in ragged gene tiles: p-values within 1e-9 absolute
   (refit) or rtol 1e-5 / atol 1e-12 (fast), info at rtol 1e-6, rho1
   identical; the same against the port's own per-gene loop.
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

DELTA_CFG = (-18.0, 18.0, 256, 60)
CASES = [("hK", 11, 2), ("hK", 23, 1), ("Ls", 7, 1), ("Ls", 31, 2)]
FLAT = ("hK", 23, 1)        # a flat ML profile under float32 (module doc)


def _genes(d, seed, mode):
    """Four phenotypes on the dataset's cells: its own, a noisy copy, one
    driven by the contexts and one by the background of ``mode`` (these
    pick different best rho)."""
    rng = np.random.default_rng(seed)
    n, C = d["n"], d["E"].shape[1]
    B = (d["hK"] if mode == "hK"
         else np.linalg.cholesky(d["KE"] + 1e-8 * np.eye(n)))
    return np.stack([d["y"], d["y"] + 0.1 * rng.normal(size=n),
                     0.3 * rng.normal(size=n) + d["E"] @ rng.normal(size=C),
                     0.3 * rng.normal(size=n)
                     + B @ rng.normal(size=B.shape[1])], axis=1)


def _bg(d, mode):
    return {"Ls": d["Ls"]} if mode == "Ls" else {"hK": d["hK"]}


def _gene_contexts(mode, seed, pW, S=8):
    """(JAX and port gene-batched contexts, the reference's null fits and
    best rho per gene, the dataset)."""
    d = _dataset(seed=seed, pW=pW, S=S)
    ctx_j = jengine.build_null_context(d["y"], d["W"], d["E"], **_bg(d, mode))
    Yt = jnp.asarray(_genes(d, seed, mode).T)
    ctx_j = ctx_j._replace(y=Yt, Zy=Yt @ ctx_j.Z, Wy=Yt @ ctx_j.W,
                           yy=jnp.sum(Yt * Yt, axis=1))
    ctx_t = tengine.null_context_from_numpy(
        {k: np.asarray(v) for k, v in ctx_j._asdict().items()}, "cpu")
    fits_j, k_j = jengine.null_association_multigene_kernel(
        ctx_j, d["n"], restricted=False, delta_cfg=DELTA_CFG)
    return ctx_j, ctx_t, fits_j, np.asarray(k_j), d


@pytest.mark.parametrize("mode,seed,pW", CASES)
def test_null_fit_multigene_matches_jax(mode, seed, pW):
    _, ctx_t, fits_j, k_j, d = _gene_contexts(mode, seed, pW)
    fits_t, k_t = tengine.null_association_multigene_fit(
        ctx_t, d["n"], restricted=False, delta_cfg=DELTA_CFG)
    assert len(set(k_j.tolist())) > 1, "the genes share one best rho"
    assert np.array_equal(k_t.numpy(), k_j)
    assert fits_t.lml.shape == (4, 11) and fits_t.beta.shape == (4, 11, pW)
    assert_allclose(fits_t.lml.numpy(), np.asarray(fits_j.lml), rtol=1e-10)


@pytest.mark.parametrize("mode,seed,pW", CASES)
def test_fast_scan_multigene_matches_jax(mode, seed, pW):
    ctx_j, ctx_t, fits_j, k, d = _gene_contexts(mode, seed, pW)
    assert len(set(k.tolist())) > 1
    delta = np.asarray(fits_j.delta)[np.arange(4), k]
    want = jengine.fast_scan_multigene_kernel(
        ctx_j, jnp.asarray(d["G"]), jnp.asarray(k), jnp.asarray(delta),
        d["n"])
    got = tengine.fast_scan_multigene_batch(
        ctx_t, torch.as_tensor(d["G"]), k, torch.as_tensor(delta), d["n"])
    for g, w, name in zip(got, want, want._fields):
        assert g.shape[:2] == (4, 8)
        assert_allclose(g.numpy(), np.asarray(w), rtol=1e-10, err_msg=name)


REFIT_CASES = [(c, f32) for c in CASES for f32 in (True, False)
               if not (c == FLAT and f32)]


@pytest.mark.parametrize("case,localize_f32", REFIT_CASES)
def test_refit_multigene_matches_jax(case, localize_f32):
    ctx_j, ctx_t, _, k, d = _gene_contexts(*case)
    assert len(set(k.tolist())) > 1
    lml_j, beta_j = jengine.association_refit_multigene_kernel(
        ctx_j, jnp.asarray(d["G"]), jnp.asarray(k), d["n"],
        delta_cfg=DELTA_CFG, localize_f32=localize_f32)
    lml_t, beta_t = tengine.association_refit_multigene_batch(
        ctx_t, torch.as_tensor(d["G"]), k, d["n"], delta_cfg=DELTA_CFG,
        localize_f32=localize_f32)
    assert lml_t.shape == (4, 8) and beta_t.shape == (4, 8, case[2] + 1)
    assert_allclose(lml_t.numpy(), np.asarray(lml_j), rtol=0, atol=1e-8)
    assert_allclose(beta_t.numpy(), np.asarray(beta_j), rtol=1e-6,
                    atol=1e-9)


def test_refit_flat_profile_under_float32():
    """The flat profile of the FLAT dataset (module doc).  The port checks
    the f64 fit at the grid's ends after its Newton steps
    (``engine._best_of_grid_ends``), so under float32 localization it
    reaches the float64 optimum within 1e-8 and agrees with the dense
    oracle (``cellregmap_tpu.oracle.fit_lmm_dense``, ML at each gene's best
    rho) within 1e-8 on every pair; the JAX package keeps the fault: its
    float32 refit stops within the float32 resolution of the lml (|lml| ~
    80, eps32 ~ 6e-8: 1e-5) short of the optimum, never above it.  In
    float64 the two packages agree at 1e-8."""
    ctx_j, ctx_t, _, k, d = _gene_contexts(*FLAT)
    G = d["G"]
    ref64 = tengine.association_refit_multigene_batch(
        ctx_t, torch.as_tensor(G), k, d["n"], delta_cfg=DELTA_CFG,
        localize_f32=False)[0].numpy()
    for f32 in (True, False):
        lml_j = np.asarray(jengine.association_refit_multigene_kernel(
            ctx_j, jnp.asarray(G), jnp.asarray(k), d["n"],
            delta_cfg=DELTA_CFG, localize_f32=f32)[0])
        lml_t = tengine.association_refit_multigene_batch(
            ctx_t, torch.as_tensor(G), k, d["n"], delta_cfg=DELTA_CFG,
            localize_f32=f32)[0].numpy()
        if not f32:
            assert_allclose(lml_t, lml_j, rtol=0, atol=1e-8)
            continue
        assert_allclose(lml_t, ref64, rtol=0, atol=1e-8)
        assert np.all(lml_j <= ref64 + 1e-9)
        assert np.all(lml_j >= ref64 - 1e-5)
        # the reference's fault is real: a pair stops measurably short
        assert np.max(ref64 - lml_j) > 1e-8
    # the port against the dense oracle (the same ML objective at each
    # gene's best rho of the hK background: rho E E^T + (1 - rho) hK hK^T)
    Y = _genes(d, FLAT[1], FLAT[0])
    rho = np.linspace(0.0, 1.0, 11)[k]
    want = np.array([[oracle.fit_lmm_dense(
        Y[:, g], np.concatenate([d["W"], G[:, s:s + 1]], axis=1),
        rho[g] * d["E"] @ d["E"].T + (1 - rho[g]) * d["hK"] @ d["hK"].T,
        False)["lml"] for s in range(G.shape[1])] for g in range(4)])
    assert_allclose(lml_t, want, rtol=0, atol=1e-8)


def _ragged_genes(d, seed=1):
    rng = np.random.default_rng(seed)
    n = d["n"]
    return np.stack([d["y"], d["y"] + 0.1 * rng.normal(size=n),
                     0.3 * rng.normal(size=n) + d["E"] @ rng.normal(size=3)],
                    axis=1)


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("mode", ["hK", "Ls"])
def test_run_multigene_association_matches_jax(fast, mode):
    """3 genes in tiles of 2 (the padded last tile is cut away)."""
    d = _dataset(seed=7, S=6)
    Y = _ragged_genes(d)
    name = ("run_association_fast_multigene" if fast
            else "run_association_multigene")
    pv_j, info_j = getattr(crt, name)(Y, d["E"], d["G"], W=d["W"],
                                      gene_batch=2, **_bg(d, mode))
    pv_t, info_t = getattr(crp, name)(Y, d["E"], d["G"], W=d["W"],
                                      gene_batch=2, device="cpu",
                                      **_bg(d, mode))
    assert pv_t.shape == (3, 6) and np.all((pv_t > 0) & (pv_t <= 1))
    assert set(info_t) == {"rho1", "e2", "g2", "eps2"}
    assert len(set(info_t["rho1"].tolist())) > 1
    assert np.array_equal(info_t["rho1"], info_j["rho1"])
    if fast:
        assert_allclose(pv_t, pv_j, rtol=1e-5, atol=1e-12)
    else:
        assert_allclose(pv_t, pv_j, rtol=0, atol=1e-9)
    for k in ("e2", "g2", "eps2"):
        assert info_t[k].shape == (3,)
        assert_allclose(info_t[k], info_j[k], rtol=1e-6, err_msg=k)


@pytest.mark.parametrize("gene_batch", [1, 3])
@pytest.mark.parametrize("fast", [False, True])
def test_multigene_association_matches_per_gene_loop(fast, gene_batch):
    """Every gene as the single-gene scan of its own scanner gives it
    (``with_phenotype``), in tiles of one gene and of the whole set."""
    d = _dataset(seed=13, S=5)
    Y = _ragged_genes(d, seed=2)
    cfg = crp.ScanConfig(snp_batch=3)
    crm = crp.CellRegMap(y=Y[:, 0], E=d["E"], W=d["W"], Ls=d["Ls"],
                         config=cfg, device="cpu")
    scan = (crm.scan_association_fast_multigene if fast
            else crm.scan_association_multigene)
    pv, info = scan(Y, d["G"], gene_batch=gene_batch)
    for j in range(3):
        one = crm.with_phenotype(Y[:, j])
        pv_j, info_j = (one.scan_association_fast(d["G"]) if fast
                        else one.scan_association(d["G"]))
        assert info["rho1"][j] == info_j["rho1"][0]
        for k in ("e2", "g2", "eps2"):
            assert_allclose(info[k][j], info_j[k][0], rtol=1e-6)
        if fast:
            assert_allclose(pv[j], pv_j, rtol=1e-5, atol=1e-12)
        else:
            assert_allclose(pv[j], pv_j, rtol=0, atol=1e-9)


def test_multigene_association_bad_shapes_raise():
    d = _dataset(seed=17, S=3)
    crm = crp.CellRegMap(y=d["y"], E=d["E"], W=d["W"], hK=d["hK"],
                         device="cpu")
    Y = np.stack([d["y"], d["y"]], axis=1)
    bad = [(Y[:-1], d["G"]), (Y, d["G"][:-1]), (Y[:, :0], d["G"]),
           (Y, d["G"][:, :0]), (np.where(Y > 0, np.nan, Y), d["G"]),
           (Y[:, :, None], d["G"])]
    for scan in (crm.scan_association_multigene,
                 crm.scan_association_fast_multigene):
        for Yb, Gb in bad:
            with pytest.raises(ValueError):
                scan(Yb, Gb)


def test_multigene_association_traced():
    """With ``config.trace`` both scans report their phase timers (the
    factorization, the tile's null fits, the variant batches on the device
    and back, the host LRT) and the untraced scans' p-values."""
    d = _dataset(seed=19, S=4)
    Y = _ragged_genes(d, seed=3)
    scanners = [crp.CellRegMap(y=Y[:, 0], E=d["E"], W=d["W"], hK=d["hK"],
                               config=crp.ScanConfig(trace=trace),
                               device="cpu") for trace in (True, False)]
    for kind in ("association_multigene", "association_fast_multigene"):
        (pv, info), (pv_u, _) = (getattr(c, f"scan_{kind}")(
            Y, d["G"], gene_batch=2) for c in scanners)
        assert set(info["timers"]) == {f"{kind}/{phase}" for phase in (
            "setup", "null_fit", "device", "device_get", "lrt")}
        assert all(v >= 0 for v in info["timers"].values())
        assert np.array_equal(pv, pv_u)
