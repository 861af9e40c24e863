"""The float32 context and the screen -> confirm scans of the port, on the
CPU, held against the JAX package.

* The float32 interaction scan on tests/test_dtype.py's case: within rtol
  1e-3 and atol 1e-6 of the port's own float64 scan and of the JAX
  package's float32 scan, rho1 the JAX float32 scan's on at least 95% of
  the variants; the gene-batched float32 scan gene for gene as the
  single-gene one.
* The four screen tests of tests/test_screen.py on the port: confirmed
  p-values exactly the float64 Davies ones, the float32 accuracy bound
  (0.5 decades), the gene-batched screen against the single-gene one
  (rtol 0.05, the JAX suite's tolerance across two f32 programs) and the
  full-rank background.
* The port's screen against the JAX screen on tests/test_screen.py's
  ``_dataset()`` (built once for the module): the same discovery sets,
  confirmed p-values equal to the port's own f64 Davies scan (rtol
  1e-12) and within 1e-8 of the JAX package's (Davies' absolute
  accuracy), the other pairs carrying their screen p-value, and
  screen_pv within rtol 0.05 of the JAX screen's where rho1 agrees.
* The float64-base ValueError; the aggregate environment's float32
  NotImplementedError, naming the path and the reference's NaN; the
  association scans and the effect sizes in float32 against the JAX
  package's float32 results.
* A checkpointed screen stopped in the screen pass and again in the
  confirm pass, each resumed equal at rtol 1e-12; the second resume does
  not run the screen again.
* Each kernel module's plain float32 version against the JAX float32
  computation it stands for (K1 ``_kr_contract``, K2 the grid stage, K3
  the localize's stages 1b and 2, K4 the best-rho rotation, K5
  ``score_test_core`` on f32 tensors with f64 v0 and v1, K6a
  ``safe_eigh`` in f32), and the whole float32 interaction batch against
  the JAX kernel's.
"""
import dataclasses
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import cellregmap_tpu as crt
import cellregmap_tpu_torch as crp
from _torch_inputs import captured, jax_davies_library  # noqa: F401
from cellregmap_tpu import engine as jengine
from cellregmap_tpu.ops.linalg import safe_eigh
from cellregmap_tpu_torch import engine
from cellregmap_tpu_torch.kernels import best_rho_rotate as k4
from cellregmap_tpu_torch.kernels import delta_grid as k2
from cellregmap_tpu_torch.kernels import kr_contract as k1
from cellregmap_tpu_torch.kernels import reml_newton as k3
from cellregmap_tpu_torch.kernels import score_core as k5
from cellregmap_tpu_torch.kernels import sym_eigvalsh as k6a
from test_screen import _dataset

f32 = torch.float32
EPS32 = float(np.finfo(np.float32).eps)
SIG = 1e-3


@pytest.fixture(scope="module")
def data():
    return _dataset()


@pytest.fixture(scope="module")
def jax_runs(data):
    """The JAX package's f64 Davies scan and screen on ``_dataset()``."""
    y, W, E, Ls, G = data
    crm = crt.CellRegMap(y=y, E=E, W=W, Ls=Ls,
                         config=crt.ScanConfig(snp_batch=32))
    pv64, info64 = crm.scan_interaction(G)
    return pv64, info64, crm.scan_interaction_screen(G, significance=SIG)


@pytest.fixture(scope="module")
def crm(data):
    y, W, E, Ls, G = data
    return crp.CellRegMap(y=y, E=E, W=W, Ls=Ls,
                          config=crp.ScanConfig(snp_batch=32), device="cpu")


@pytest.fixture(scope="module")
def port_runs(data, crm):
    G = data[4]
    pv64, info64 = crm.scan_interaction(G)
    return pv64, info64, crm.scan_interaction_screen(G, significance=SIG)


# --------------------------------------------------------------------------
# the float32 scan
# --------------------------------------------------------------------------
def _dtype_case():
    """tests/test_dtype.py's data."""
    rng = np.random.default_rng(7)
    n, C, S = 120, 4, 8
    E = rng.normal(size=(n, C))
    W = np.ones((n, 1))
    hK = rng.normal(size=(n, 8)) / np.sqrt(8)
    Ls = [np.asarray(L) for L in crt.get_L_values(hK, E)]
    G = rng.choice([0.0, 1.0, 2.0], size=(n, S), p=[0.49, 0.42, 0.09])
    G = (G - G.mean(0)) / G.std(0)
    KE = sum(L @ L.T for L in Ls)
    y = (0.6 * rng.normal(size=n)
         + np.linalg.cholesky(KE + 1e-8 * np.eye(n)) @ rng.normal(size=n))
    return y, W, E, Ls, G


def test_float32_scan_matches_float64_and_jax():
    y, W, E, Ls, G = _dtype_case()
    pv64, _ = crp.CellRegMap(y=y, E=E, W=W, Ls=Ls,
                             device="cpu").scan_interaction(G)
    crm32 = crp.CellRegMap(y=y, E=E, W=W, Ls=Ls, device="cpu",
                           config=crp.ScanConfig(dtype="float32"))
    pv32, info32 = crm32.scan_interaction(G)
    assert crm32._ctx.Z.dtype == f32
    assert_allclose(pv32, pv64, rtol=1e-3, atol=1e-6)
    pvj, infoj = crt.CellRegMap(
        y=y, E=E, W=W, Ls=Ls,
        config=crt.ScanConfig(dtype="float32")).scan_interaction(G)
    assert_allclose(pv32, pvj, rtol=1e-3, atol=1e-6)
    assert np.mean(info32["rho1"] == infoj["rho1"]) >= 0.95
    # the gene-batched float32 scan: each gene as its own single-gene scan,
    # to f32 noise (the phenotype's rotations are summed in another order
    # in f32, which the fits carry to ~1e-5 of a p-value)
    rng = np.random.default_rng(3)
    Y = np.stack([y, y + 0.3 * rng.normal(size=y.shape[0])], axis=1)
    pv_mg, _ = crm32.scan_interaction_multigene(Y, G, gene_batch=2)
    for g in range(2):
        pv_g, _ = crm32.with_phenotype(Y[:, g]).scan_interaction(G)
        assert_allclose(pv_mg[g], pv_g, rtol=1e-4, atol=1e-9)


# --------------------------------------------------------------------------
# tests/test_screen.py on the port
# --------------------------------------------------------------------------
def test_screen_confirms_exact_f64_pvalues(port_runs):
    pv64, _, (pv_sc, info) = port_runs
    below = pv64 < SIG
    assert below.any(), "simulation produced no hits; test is vacuous"
    assert np.all(info["confirmed"][below])
    assert_allclose(pv_sc[below], pv64[below], rtol=1e-12, atol=0.0)
    far = ~info["confirmed"]
    assert np.all(pv_sc[far] == info["screen_pv"][far])


def test_screen_f32_accuracy_bound(data, crm):
    y, W, E, Ls, G = data
    _, info = crm.scan_interaction_screen(G, significance=1e-300)
    pv32 = info["screen_pv"]
    crm_sp = crm._with_config(dataclasses.replace(
        crm._cfg, pvalue_method="saddlepoint"))
    pv64_sp, _ = crm_sp.scan_interaction(G)
    ok = (np.isfinite(pv32) & (pv32 > 0) & np.isfinite(pv64_sp)
          & (pv64_sp > 1e-30))
    assert ok.sum() >= G.shape[1] * 0.9
    dlog = np.abs(np.log10(pv32[ok]) - np.log10(pv64_sp[ok]))
    assert dlog.max() < 0.5, dlog.max()


def test_screen_multigene_matches_single_gene(data, crm):
    y, W, E, Ls, G = data
    rng = np.random.default_rng(7)
    Y = y[:, None] + 0.3 * rng.normal(size=(y.shape[0], 3))
    Y[:, 1] = y
    pv_mg, info_mg = crm.scan_interaction_multigene_screen(
        Y, G, gene_batch=2, significance=SIG)
    for g in range(3):
        pv_sg, info_sg = crm.with_phenotype(Y[:, g]).scan_interaction_screen(
            G, significance=SIG)
        assert_allclose(pv_mg[g], pv_sg, rtol=0.05, atol=1e-12)
        both = info_mg["confirmed"][g] & info_sg["confirmed"]
        assert_allclose(pv_mg[g][both], pv_sg[both], rtol=1e-12)


def test_screen_full_rank_background_robust():
    rng = np.random.default_rng(3)
    n, C, n_donors, S = 400, 8, 50, 64
    E = rng.normal(size=(n, C)) / np.sqrt(C)
    W = np.ones((n, 1))
    donor_of = np.repeat(np.arange(n_donors), n // n_donors)[:n]
    hK = np.zeros((n, n_donors))
    hK[np.arange(n), donor_of] = 1.0
    Ls = crp.get_L_values(hK, E)
    maf = rng.uniform(0.2, 0.45, size=S)
    G = rng.binomial(2, maf[None, :].repeat(n_donors, 0))[donor_of, :]
    G = np.asarray(G, float)
    G = (G - G.mean(0)) / np.maximum(G.std(0), 1e-9)
    y = (rng.normal(size=n) + 0.5 * E @ rng.normal(size=C)
         + 0.4 * hK @ rng.normal(size=n_donors))
    crm = crp.CellRegMap(y=y, E=E, W=W, Ls=Ls, device="cpu",
                         config=crp.ScanConfig(snp_batch=64))
    assert int(crm._ctx.S.shape[1]) >= n - C
    _, info = crm.scan_interaction_screen(G, significance=1e-300)
    pv32 = info["screen_pv"]
    assert np.isfinite(pv32).all()
    assert (pv32 > 1e-300).all(), (pv32.min(), (pv32 <= 1e-300).sum())
    pv64, _ = crm.scan_interaction(G)
    ok = pv64 > 1e-30
    dlog = np.abs(np.log10(pv32[ok]) - np.log10(pv64[ok]))
    assert dlog.max() < 1.0, dlog.max()


# --------------------------------------------------------------------------
# the port's screen against the JAX screen
# --------------------------------------------------------------------------
def test_screen_matches_jax_screen(port_runs, jax_runs):
    pv64, _, (pv, info) = port_runs
    _, _, (pvj, infoj) = jax_runs
    assert np.array_equal(pv < SIG, pvj < SIG)
    assert (pv < SIG).any()
    conf = info["confirmed"]
    assert_allclose(pv[conf], pv64[conf], rtol=1e-12, atol=0.0)
    both = conf & infoj["confirmed"]
    assert both.sum() >= 0.9 * conf.sum()
    assert np.abs(pv[both] - pvj[both]).max() <= 1e-8
    assert np.all(pv[~conf] == info["screen_pv"][~conf])
    same = info["rho1"] == infoj["rho1"]
    assert same.mean() >= 0.9
    assert_allclose(info["screen_pv"][same], infoj["screen_pv"][same],
                    rtol=0.05, atol=1e-12)
    assert info["n_confirmed"] == conf.sum()
    assert info["screen_threshold"] == infoj["screen_threshold"]
    assert set(info) == set(infoj)


def test_screen_validates_f32_base_config(data):
    y, W, E, Ls, G = data
    crm32 = crp.CellRegMap(y=y, E=E, W=W, Ls=Ls, device="cpu",
                           config=crp.ScanConfig(dtype="float32"))
    with pytest.raises(ValueError, match="float64"):
        crm32.scan_interaction_screen(G)
    with pytest.raises(ValueError, match="float64"):
        crm32.scan_interaction_multigene_screen(y[:, None], G)


REFUSED = {
    "scan_association": lambda c, y, G: c.scan_association(G),
    "scan_association_fast": lambda c, y, G: c.scan_association_fast(G),
    "scan_association_multigene":
        lambda c, y, G: c.scan_association_multigene(y[:, None], G),
    "scan_association_fast_multigene":
        lambda c, y, G: c.scan_association_fast_multigene(y[:, None], G),
    "predict_interaction":
        lambda c, y, G: c.predict_interaction(G, np.full(G.shape[1], 0.3)),
    "estimate_aggregate_environment":
        lambda c, y, G: c.estimate_aggregate_environment(G[:, 0]),
}


@pytest.mark.parametrize("path", sorted(REFUSED))
def test_float32_refuses_unported_paths(data, path):
    """The aggregate environment refuses the float32 context, naming its
    path and the JAX package's NaN; every other path of ``REFUSED`` now
    runs it and agrees with the JAX package's float32 result on four
    variants: p-values within 5e-3 decades (two f32 programs, as
    tests/test_torch_float32_association.py), effect sizes within 1e-2 of
    the largest |beta|.  Where the JAX float32 null fit takes a NaN rho
    (its p-values NaN: ROADMAP queue 3, "In the reference", item k) the
    port is held to its own float64 result instead."""
    y, W, E, Ls, G = data
    crm32 = crp.CellRegMap(y=y, E=E, W=W, Ls=Ls, device="cpu",
                           config=crp.ScanConfig(dtype="float32"))
    if path == "estimate_aggregate_environment":
        with pytest.raises(NotImplementedError, match=f"{path}.*NaN"):
            REFUSED[path](crm32, y, G[:, :4])
        return
    got = REFUSED[path](crm32, y, G[:, :4])
    ref32 = REFUSED[path](crt.CellRegMap(
        y=y, E=E, W=W, Ls=Ls, config=crt.ScanConfig(dtype="float32")), y,
        G[:, :4])
    ref64 = REFUSED[path](crp.CellRegMap(y=y, E=E, W=W, Ls=Ls,
                                         device="cpu"), y, G[:, :4])
    if path == "predict_interaction":
        for b, b32, b64 in zip(got, ref32, ref64):
            assert np.isfinite(b).all()
            assert np.max(np.abs(b - b32)) <= 1e-2 * np.max(np.abs(b64))
        return
    pv, pv32, pv64 = (np.atleast_2d(r[0]) for r in (got, ref32, ref64))
    assert np.isfinite(pv).all()
    faulty = ~np.isfinite(pv32).all(axis=1)
    ref = np.where(faulty[:, None], pv64, pv32)
    assert np.max(np.abs(np.log10(pv) - np.log10(ref))) <= 5e-3


class Boom(RuntimeError):
    pass


def test_screen_checkpoint_resumes(data, tmp_path, monkeypatch):
    """Every pair a hit (threshold 1): the screen runs 2 batches of 64, the
    confirm 3 of 32.  Stopped after one screen batch, then after one
    confirm batch, each resume equals the clean run; the second resume
    runs no screen batch."""
    y, W, E, Ls, G = data
    crm = crp.CellRegMap(y=y, E=E, W=W, Ls=Ls, device="cpu",
                         config=crp.ScanConfig(snp_batch=32))
    run = lambda ck: crm.scan_interaction_screen(  # noqa: E731
        G, significance=1.0, screen_margin=1.0, checkpoint=ck)
    clean_pv, clean_info = run(None)
    assert clean_info["n_confirmed"] == G.shape[1]
    real = engine.interaction_batch
    calls = {torch.float32: 0, torch.float64: 0}
    stop = {}

    def counted(ctx, *a, **kw):
        dt = ctx.y.dtype
        if calls[dt] == stop.get(dt, -1):
            raise Boom
        calls[dt] += 1
        return real(ctx, *a, **kw)

    monkeypatch.setattr(engine, "interaction_batch", counted)
    ck = tmp_path / "ck"
    for where, resumed in ((torch.float32, {torch.float32: 1,
                                            torch.float64: 3}),
                           (torch.float64, {torch.float32: 0,
                                            torch.float64: 2})):
        calls.update({torch.float32: 0, torch.float64: 0})
        stop.clear()
        stop[where] = 1
        with pytest.raises(Boom):
            run(ck)
        calls.update({torch.float32: 0, torch.float64: 0})
        stop.clear()
        pv, info = run(ck)
        assert calls == resumed, (where, calls)
        assert_allclose(pv, clean_pv, rtol=1e-12, atol=0.0)
        for k in ("rho1", "e2", "g2", "eps2", "Q", "screen_pv"):
            assert_allclose(info[k], clean_info[k], rtol=1e-12, atol=0.0)
        assert not list(ck.rglob("cursor.json"))
    shutil.rmtree(ck)


# --------------------------------------------------------------------------
# each kernel module's plain float32 version against the JAX computation
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def small():
    """A small dataset's JAX float32 context and the port's (from it,
    field by field), and its genotypes in f32."""
    y, W, E, Ls, G = _dataset(n=120, C=4, n_donors=12, S=16, seed=5)
    jctx = crt.CellRegMap(y=y, E=E, W=W, Ls=Ls,
                          config=crt.ScanConfig(dtype="float32"))._ctx
    ctx = engine.null_context_from_numpy(
        {f: np.asarray(getattr(jctx, f)) for f in jctx._fields}, "cpu", f32)
    G32 = np.asarray(G, np.float32)
    return jctx, ctx, G32, len(y)


def test_kr_contract_plain_f32_matches_jax(small):
    jctx, ctx, G32, n = small
    U, V = np.asarray(jctx.Z), np.asarray(jctx.E0)
    want = np.asarray(jengine._kr_contract(jnp.asarray(U), jnp.asarray(V),
                                           jnp.asarray(G32)))
    got = k1.kr_contract_plain(ctx.Z, ctx.E0, torch.as_tensor(G32))
    assert got.dtype == f32 and want.dtype == np.float32
    bound = np.einsum("nk,nj,ns->kjs", np.abs(U).astype(float),
                      np.abs(V).astype(float), np.abs(G32).astype(float))
    assert np.all(np.abs(got.double().numpy() - want) <= 8 * EPS32 * bound)


def test_sym_eigvalsh_plain_f32_matches_jax_safe_eigh():
    rng = np.random.default_rng(2)
    A = np.stack([B @ B.T for B in rng.normal(size=(6, 10, 4))]
                 + [rng.normal(size=(10, 10))]).astype(np.float32)
    A[-1] = A[-1] + A[-1].T
    want = np.maximum(np.asarray(safe_eigh(jnp.asarray(A))[0]), 0.0)
    got = k6a.sym_eigvalsh_plain(torch.as_tensor(A))
    assert got.dtype == f32
    scale = np.abs(want).max(axis=1, keepdims=True)
    assert np.all(np.abs(got.numpy() - want) <= 1e-5 * scale)


def _port_calls(ctx, G32, n, names):
    G = torch.as_tensor(G32)
    return captured(lambda: engine.interaction_batch(
        ctx, G, G, n, device_pvalues=True), names)


def test_delta_grid_and_localize_plain_f32_match_jax(small):
    """K2's brackets (the grid stage) and K3's localize (stages 1b and
    2): the f32 sums of the two frameworks part at f32 rounding, so a
    bracket is the JAX one or a point whose lml ties within 1e-5, and the
    f64 lml at the localized optimum agrees to 1e-6."""
    jctx, ctx, G32, n = small
    G = jnp.asarray(G32)
    grid = jengine.interaction_kernel(jctx, G, G, n, profile_stage="grid")
    st2 = jengine.interaction_kernel(jctx, G, G, n, profile_stage="stage2")
    calls = _port_calls(ctx, G32, n, ["delta_grid", "reml_localize"])
    (args, kw), = calls["delta_grid"]
    br_lo, br_hi, lml = k2.delta_grid_plain(*args, **kw, return_lml=True)
    jlo, jhi = (np.asarray(grid[k], float) for k in ("br_lo", "br_hi"))
    same = (br_lo.numpy() == jlo) & (br_hi.numpy() == jhi)
    assert same.mean() >= 0.9
    assert k2.bracket_shortfall(torch.as_tensor(jlo), torch.as_tensor(jhi),
                                lml, -18.0, 18.0, f32) <= 1e-5
    (args, kw), = calls["reml_localize"]
    x, lml_all, k_best = k3.reml_localize_plain(*args, **kw)
    jl = np.asarray(st2["lml_all"])
    ok = np.isfinite(jl)
    assert np.array_equal(np.isfinite(lml_all.numpy()), ok)
    scale = np.maximum(np.abs(jl[ok]), 1.0)
    assert np.max(np.abs(lml_all.numpy()[ok] - jl[ok]) / scale) <= 1e-6
    assert np.mean(k_best.numpy() == np.asarray(st2["k_best"])) >= 0.9


def test_best_rho_rotate_plain_f32_matches_jax(small):
    jctx, ctx, G32, n = small
    T = jengine._kr_contract(jctx.Z, jctx.E0, jnp.asarray(G32))  # (R, C, S)
    S = G32.shape[1]
    kb = np.arange(S) % int(jctx.S.shape[0])
    want = np.stack([np.asarray(jnp.einsum("rq,rc->qc", jctx.V[kb[s]],
                                           T[:, :, s])) for s in range(S)])
    At, slot = k4.best_rho_rotate_plain(ctx.V, torch.tensor(np.asarray(T)),
                                        torch.as_tensor(kb))
    got = k4.gather(At, slot)
    assert got.dtype == f32
    Va, Ta = np.abs(np.asarray(jctx.V, float)), np.abs(np.asarray(T, float))
    bound = np.stack([Va[kb[s]].T @ Ta[:, :, s] for s in range(S)])
    assert np.all(np.abs(got.double().numpy() - want) <= 8 * EPS32 * bound)


def test_score_core_plain_f32_matches_jax(small):
    """K5 on the f32 operands the engine gives it (f64 v0, v1) against
    ``score_test_core`` on the same values: f64 arithmetic on both sides
    (the reference's promotion), at 1e-9 of each output's largest
    entry."""
    jctx, ctx, G32, n = small
    (args, kw), = _port_calls(ctx, G32, n, ["score_core"])["score_core"]
    (Sv, WGt, yt, At, WW, Wy, Wg, gg, gy, AW, Ag, Ay, AtA, k_best, v0, v1,
     slot) = args
    assert At.dtype == f32 and v0.dtype == torch.float64
    Q, Wmat = k5.score_core_plain(*args)
    p = WW.shape[0]
    Atg = k4.gather(At, slot)
    J = lambda t: jnp.asarray(t.numpy())  # noqa: E731
    core = jax.vmap(jengine.score_test_core)
    ar = np.arange(k_best.shape[0])
    kb = k_best.numpy()
    Xt = np.concatenate([WGt.numpy()[kb, :, :p],
                         WGt.numpy()[kb, :, p + ar][:, :, None]], axis=2)
    XX = np.concatenate([
        np.concatenate([np.broadcast_to(WW.numpy(), (len(ar), p, p)),
                        Wg.numpy().T[:, :, None]], axis=2),
        np.concatenate([Wg.numpy().T[:, None, :],
                        gg.numpy()[:, None, None]], axis=2)], axis=1)
    Xy = np.concatenate([np.broadcast_to(Wy.numpy(), (len(ar), p)),
                         gy.numpy()[:, None]], axis=1)
    AX = np.concatenate([AW.numpy().transpose(2, 0, 1),
                         Ag.numpy().T[:, :, None]], axis=2)
    Qj, Wj = core(jnp.asarray(Sv.numpy()[kb]), jnp.asarray(Xt), J(yt)[kb],
                  J(Atg), jnp.asarray(XX), jnp.asarray(Xy), jnp.asarray(AX),
                  J(Ay).T, J(AtA).transpose(2, 0, 1), J(v0), J(v1))
    for got, want in ((Q, Qj), (Wmat, Wj)):
        want = np.asarray(want)
        assert want.dtype == np.float64
        err = np.abs(got.numpy() - want).max()
        assert err <= 1e-9 * np.abs(want).max(), err


def test_interaction_batch_f32_matches_jax(small):
    """The whole float32 batch (K1-K6b): the converged fits, the score
    statistic and the device tails of the JAX kernel's f32 program.  The
    f32 tensors of the two frameworks (the rotations, complements and
    logdet(X^T X)) part at f32 rounding, which the f64 statistics carry:
    relative to each output's largest entry, 1e-6 for the fits, 1e-5 for
    Q, Wmat and the weights, 1e-4 for the tails."""
    jctx, ctx, G32, n = small
    G = jnp.asarray(G32)
    want = jengine.interaction_kernel(jctx, G, G, n, device_pvalues=True)
    Gt = torch.as_tensor(G32)
    got = engine.interaction_batch(ctx, Gt, Gt, n, device_pvalues=True)
    assert np.array_equal(got["rho1"].numpy(), np.asarray(want["rho1"]))
    for k, rtol in (("delta", 1e-6), ("lml", 1e-6), ("v0", 1e-6),
                    ("v1", 1e-6), ("Q", 1e-5), ("Wmat", 1e-5),
                    ("lambdas", 1e-5), ("pv_saddlepoint", 1e-4),
                    ("pv_liu", 1e-4)):
        g, w = got[k].numpy(), np.asarray(want[k])
        assert g.dtype == np.float64, k
        scale = np.abs(w).max()
        assert np.abs(g - w).max() <= rtol * scale, (k, np.abs(g - w).max()
                                                     / scale)
