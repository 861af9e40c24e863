"""The port's effect sizes and aggregate environment against the JAX
package, on the CPU.

1. ``build_betas_context`` against the JAX package's (both NumPy setups of
   the same algebra) at 1e-12, and carried across field by field by
   ``betas_context_from_numpy``;
2. K9's plain version, ``models.lmm._family_eval_batch`` (the lml-only
   bordered-Gram path and, with ``want_beta``, ``_family_blocks_matrix``),
   against the JAX package's at fixed points: f64 lml and beta at rtol
   1e-10, f32 lml at 1e-4 of max(|lml|, 1) (f32 Grams summed in another
   order; the bordered Cholesky's last pivot amplifies their rounding) with
   the same -inf mask;
3. ``predict_interaction_batch`` full f64 against
   ``predict_interaction_kernel`` on the carried context: identical rho1,
   beta_G and alpha within 1e-7 (the budget of tests/test_api.py:151-152);
4. the same under hybrid localization, held by the JAX suite's own rule
   (tests/test_hybrid.py:62-79): a rho flip only where the lml gap is below
   1e-4, beta_G within 1e-7 where rho agrees;
5. ``estimate_betas`` end to end against the JAX package's in ragged
   batches (1e-7), and a C = 50 case against the dense oracle within 1e-6
   (tests/test_many_contexts.py:40-72);
6. ``mean_fit`` (K10, REML, M = [B, g]) against ``mean_fit_kernel``, held
   as the association's fits are (tests/test_torch_association.py), and
   ``estimate_aggregate_environment`` within 1e-5 of the JAX package's
   (tests/test_api.py:180).
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
from cellregmap_tpu.models import lmm as jlmm
from cellregmap_tpu_torch import engine as tengine
from cellregmap_tpu_torch.models import lmm as tlmm
from _torch_inputs import captured
from test_api import _dataset
from test_many_contexts import _dataset as _c50_dataset
from test_torch_association import _assert_fits, _contexts

CFG = (-18.0, 18.0, 16, 60)


@pytest.fixture(scope="module")
def gxe():
    """The tests/test_hybrid.py dataset, cut to 8 variants: a planted GxC
    variant and a block background, so that rho1 > 0 for some variants."""
    rng = np.random.default_rng(11)
    n, C, donors, S = 200, 4, 20, 8
    E = rng.normal(size=(n, C)) / np.sqrt(C)
    W = np.concatenate([np.ones((n, 1)), rng.normal(size=(n, 1))], axis=1)
    hK = np.zeros((n, donors))
    hK[np.arange(n), np.repeat(np.arange(donors), n // donors)] = 1.0
    Ls = [np.asarray(L) for L in crt.get_L_values(hK, E)]
    G = rng.binomial(2, 0.3, size=(n, S)).astype(float)
    y = (rng.normal(size=n) + 0.6 * E @ rng.normal(size=C)
         + 0.5 * hK @ rng.normal(size=donors) + 0.4 * G[:, 3] * E[:, 1])
    bj = jengine.build_betas_context(y, W, E, Ls)
    bt = tengine.betas_context_from_numpy(
        {k: np.asarray(v) for k, v in bj._asdict().items()}, "cpu")
    return dict(y=y, W=W, E=E, hK=hK, Ls=Ls, G=G, n=n, bj=bj, bt=bt,
                norm=np.linspace(1.1, 1.9, S))


def _predict(d, localize_f32):
    want = jengine.predict_interaction_kernel(
        d["bj"], jnp.asarray(d["G"]), jnp.asarray(d["norm"]), d["n"],
        delta_cfg=CFG, localize_f32=localize_f32)
    got = tengine.predict_interaction_batch(
        d["bt"], torch.as_tensor(d["G"]), torch.as_tensor(d["norm"]), d["n"],
        delta_cfg=CFG, localize_f32=localize_f32)
    return got, want


@pytest.mark.parametrize("background", ["Ls", "none"])
def test_build_betas_context_matches_jax(background):
    d = _dataset(seed=17)
    Ls = d["Ls"] if background == "Ls" else None
    bj = jengine.build_betas_context(d["y"], d["W"], d["E"], Ls)
    bt = tengine.build_betas_context(d["y"], d["W"], d["E"], Ls,
                                     device="cpu")
    carried = tengine.betas_context_from_numpy(
        {k: np.asarray(v) for k, v in bj._asdict().items()}, "cpu")
    for f in tengine.BetasContext._fields:
        want = np.asarray(getattr(bj, f))
        scale = max(float(np.abs(want).max()), 1.0)
        assert_allclose(getattr(bt, f).numpy(), want, rtol=0,
                        atol=1e-12 * scale, err_msg=f)
        assert np.array_equal(getattr(carried, f).numpy(), want), f


def _family_inputs(d, L=12, seed=0):
    """A betas batch's columns, complement Grams and logdet(X^T X), as the
    engine hands them to K9 on the CPU, and L random (logit, rho) points
    per variant."""
    calls = captured(lambda: tengine.predict_interaction_batch(
        d["bt"], torch.as_tensor(d["G"]), torch.as_tensor(d["norm"]),
        d["n"], delta_cfg=CFG), ["family_eval"])
    (args, _) = calls["family_eval"][0]
    cols, compS, ld_xx = args[2], args[3], args[8]
    rng = np.random.default_rng(seed)
    S = d["G"].shape[1]
    logits = torch.as_tensor(rng.uniform(-8, 8, size=(S, L)))
    rho = torch.as_tensor(rng.uniform(0, 1, size=(S, L)))
    return cols, compS, ld_xx, logits, rho


@pytest.mark.parametrize("dtype,want_beta", [(torch.float64, False),
                                             (torch.float64, True),
                                             (torch.float32, False)])
def test_family_eval_matches_jax(gxe, dtype, want_beta):
    cols, compS, ld_xx, logits, rho = _family_inputs(gxe)
    C = gxe["E"].shape[1]
    colsS = tlmm.stack_cols(cols).to(dtype)
    args = [logits.to(dtype), rho.to(dtype), colsS, compS.to(dtype),
            gxe["bt"].Lam.to(dtype)]
    rcond = 1e-12 if dtype == torch.float64 else 1e-6
    got = tlmm._family_eval_batch(*args, C, gxe["n"], True, ld_xx.to(dtype),
                                  rcond, want_beta=want_beta)
    want = jlmm._family_eval_batch(*(jnp.asarray(a.numpy()) for a in args),
                                   C, gxe["n"], True,
                                   jnp.asarray(ld_xx.to(dtype).numpy()),
                                   rcond, want_beta=want_beta)
    if not want_beta:
        got, want = (got,), (want,)
    for g, w in zip(got, want):
        g, w = g.numpy(), np.asarray(w)
        assert np.array_equal(np.isfinite(g), np.isfinite(w))
        fin = np.isfinite(w)
        tol = 1e-10 if dtype == torch.float64 else 1e-4
        assert_allclose(g[fin], w[fin], rtol=tol,
                        atol=tol * max(1.0, float(np.abs(w[fin]).max())))


def test_predict_interaction_matches_jax_full_f64(gxe):
    (bg_t, al_t, info_t), (bg_j, al_j, info_j) = _predict(gxe, False)
    assert np.array_equal(info_t["rho1"].numpy(), np.asarray(info_j["rho1"]))
    assert np.any(info_t["rho1"].numpy() > 0)
    assert_allclose(bg_t.numpy(), np.asarray(bg_j), rtol=0, atol=1e-7)
    assert_allclose(al_t.numpy(), np.asarray(al_j), rtol=0, atol=1e-7)


def test_predict_interaction_hybrid_matches_jax(gxe):
    (bg_t, al_t, info_t), (bg_j, al_j, info_j) = _predict(gxe, True)
    flipped = info_t["rho1"].numpy() != np.asarray(info_j["rho1"])
    gap = np.abs(info_t["lml"].numpy() - np.asarray(info_j["lml"]))
    assert np.all(gap[flipped] < 1e-4), gap[flipped]
    same = ~flipped
    assert_allclose(bg_t.numpy()[same], np.asarray(bg_j)[same], rtol=0,
                    atol=1e-7)


def test_estimate_betas_matches_jax_in_ragged_batches(tmp_path):
    """7 variants in batches of 3, full f64 on both sides."""
    d = _dataset(seed=23, S=7)
    maf = np.linspace(0.1, 0.4, 7)
    cfg_j = crt.ScanConfig(hybrid_localization=False)
    cfg_t = crp.ScanConfig(hybrid_localization=False, snp_batch=3)
    bg_j, bgxe_j = crt.estimate_betas(d["y"], d["W"], d["E"], d["G"],
                                      maf=maf, hK=d["hK"], config=cfg_j)
    bg_t, bgxe_t = crp.estimate_betas(d["y"], d["W"], d["E"], d["G"],
                                      maf=maf, hK=d["hK"], config=cfg_t,
                                      device="cpu")
    assert bg_t.shape == (7,) and bgxe_t.shape == (d["n"], 7)
    assert_allclose(bg_t, bg_j, rtol=0, atol=1e-7)
    assert_allclose(bgxe_t, bgxe_j, rtol=0, atol=1e-7)
    assert_allclose(crp.compute_maf(d["G"] + 1.0),
                    np.minimum((d["G"] + 1).mean(0) / 2,
                               1 - (d["G"] + 1).mean(0) / 2), rtol=1e-15)
    crm = crp.CellRegMap(y=d["y"], E=d["E"], W=d["W"],
                         Ls=crt.get_L_values(d["hK"], d["E"]), device="cpu")
    # checkpointed, in ragged batches of 3: the same effect sizes
    crm_b = crp.CellRegMap(y=d["y"], E=d["E"], W=d["W"],
                           Ls=crt.get_L_values(d["hK"], d["E"]),
                           config=crp.ScanConfig(snp_batch=3), device="cpu")
    bg_ck, bgxe_ck = crm_b.predict_interaction(
        d["G"][:, :4], maf[:4], checkpoint=str(tmp_path / "ck"))
    bg_u, bgxe_u = crm_b.predict_interaction(d["G"][:, :4], maf[:4])
    assert np.array_equal(bg_ck, bg_u) and np.array_equal(bgxe_ck, bgxe_u)
    crm.predict_interaction(d["G"][:, :2], maf[:2])
    assert crm._ctx_cache is None     # the effect sizes never build it


def test_betas_c50_matches_oracle():
    """C = 50 (q = 103 columns), the port's default (hybrid) config against
    the dense oracle, as tests/test_many_contexts.py:40-72 holds the JAX
    package."""
    y, W, E, G, Ls = _c50_dataset(S=3)
    maf = np.full(3, 0.3)
    bg, bgxe = crp.CellRegMap(y=y, E=E, W=W, Ls=Ls,
                              device="cpu").predict_interaction(G, maf)
    assert np.isfinite(bg).all() and np.isfinite(bgxe).all()
    bgm = sum(L @ L.T for L in Ls)
    norm = 1.0 / np.sqrt(2 * 0.3 * 0.7)
    n = len(y)
    for i in range(3):
        g = G[:, [i]]
        M = np.concatenate((W, g, E), axis=1)
        gE = g * E
        best = None
        for rho1 in np.linspace(0, 1, 11):
            Sigma = rho1 * (gE @ gE.T) + (1 - rho1) * bgm
            fit = oracle.fit_lmm_dense(y, M, Sigma, restricted=True)
            if best is None or fit["lml"] > best["lml"]:
                best = dict(fit, rho1=rho1, Sigma=Sigma)
        assert_allclose(bg[i], best["beta"][W.shape[1]], rtol=0, atol=1e-6)
        vv = np.linalg.solve(best["v0"] * best["Sigma"]
                             + best["v1"] * np.eye(n), y - M @ best["beta"])
        bgxe_d = best["v0"] * best["rho1"] * (E @ (gE.T @ vv)).ravel() * norm
        assert_allclose(bgxe[:, i], bgxe_d, rtol=0, atol=1e-6)


@pytest.mark.parametrize("mode,seed,pW", [("Ls", 23, 1), ("hK", 11, 2)])
def test_mean_fit_matches_jax(mode, seed, pW):
    d = _dataset(seed=seed, pW=pW)
    ctx_j, ctx_t = _contexts(d, mode)
    B = tengine.reduced_design_basis(d["W"], d["E"])
    M = np.concatenate([B, d["G"][:, :1]], axis=1)
    cfg = (-18.0, 18.0, 64, 60)
    fits_j = jengine.mean_fit_kernel(ctx_j, jnp.asarray(M), d["n"], True, cfg)
    fits_t = tengine.mean_fit(ctx_t, torch.as_tensor(M), d["n"], True, cfg)
    assert int(fits_t.lml.argmax()) == int(np.argmax(fits_j.lml))
    Mj = jnp.asarray(M)
    _assert_fits(fits_t, fits_j, ctx_j, ctx_j.Z.T @ Mj, Mj.T @ Mj,
                 Mj.T @ ctx_j.y, d["n"], True)


@pytest.mark.parametrize("seed", [23, 5])
def test_estimate_aggregate_environment_matches_jax(seed):
    """With E1 = E the null family's E E^T part lies in the span of the
    reduced design [B, g], the REML best rho is 0 and the aggregate is
    exactly 0; an E1 background outside that span gives a non-zero one."""
    d = _dataset(seed=seed, S=3)
    rng = np.random.default_rng(seed + 100)
    E1 = rng.normal(size=(d["n"], 4))
    y = d["y"] + E1 @ rng.normal(size=4)
    want = crt.CellRegMap(y=y, E=d["E"], E1=E1, W=d["W"], Ls=d["Ls"]) \
        .estimate_aggregate_environment(d["G"][:, 0])
    got = crp.CellRegMap(y=y, E=d["E"], E1=E1, W=d["W"], Ls=d["Ls"],
                         device="cpu").estimate_aggregate_environment(
                             d["G"][:, 0])
    assert got.shape == np.shape(want)
    assert np.abs(got).max() > 0.1
    assert_allclose(np.ravel(got), np.ravel(want), rtol=0, atol=1e-5)
