"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU: the ``cuda`` fixture skips it, with
its reason, where there is none (as on a CPU-only test machine).  The file
imports neither jax nor the JAX package, so it runs on a machine with the
card and no jax:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerance: the kernels sum in another order than cuBLAS/torch, so the
outputs agree at 1e-12 of their largest entry (1e-10 for K5, whose K0^{-1}
forms subtract nearly equal Grams, and for K8, whose Schur complement
subtracts nearly equal terms).  The fits are held as in
tests/test_torch_cuda_emulated.py: a grid bracket may sit on a near-tie
neighbour of the plain argmax (plain lml within 1e-5 of the maximum in
float32, 1e-12 in float64), the Newton results at rtol 1e-9, the
golden-section fits through ``null_fit.fit_gaps`` at 1e-10, K9 in float64
at 1e-10 of max(|lml|, 1) (beta, rss at 1e-9) and in float32 through
``woodbury_family.f32_gaps``.  K6a's eigenvalues at 1e-12 of each row's
largest, K6b's tails at 1e-9 relative (floor 1e-300).
"""
import numpy as np
import pytest
import torch

from _torch_inputs import (assert_tails_close, betas_dataset, captured,
                           fit_dataset, kr_inputs, rotate_inputs,
                           score_gene_inputs, score_inputs, tail_battery)

CASES = [(C, p) for C in (3, 10, 50) for p in (1, 2)]
FIT_CASES = [(p, nrho, f32) for p in (1, 2) for nrho in (1, 3, 11)
             for f32 in (True, False)] + [(5, 11, True), (5, 3, False)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _close(got, want, rel):
    err = float((got - want).abs().max())
    assert err <= rel * float(want.abs().max()), err


@pytest.mark.cuda
@pytest.mark.parametrize("C,p", CASES)
def test_kr_contract_kernel_matches_plain(cuda, C, p):
    from cellregmap_tpu_torch.kernels import kr_contract as k1

    U, _, G = (torch.as_tensor(a, device=cuda)
               for a in kr_inputs(C + p, n=301, K=71, S=130))
    for width in (C, p):
        V = torch.as_tensor(np.random.default_rng(width).normal(
            size=(U.shape[0], width)), device=cuda)
        before = k1.launches
        got = k1.kr_contract(U, V, G)
        assert k1.launches == before + 1
        _close(got, k1.kr_contract_plain(U, V, G), 1e-12)


@pytest.mark.cuda
@pytest.mark.parametrize("C,p", CASES)
def test_best_rho_rotate_kernel_matches_plain(cuda, C, p):
    from cellregmap_tpu_torch.kernels import best_rho_rotate as k4

    V, T, kb = (torch.as_tensor(a, device=cuda)
                for a in rotate_inputs(C + p, R=201, C=C, S=33 + p))
    before = k4.launches
    _rotate_close(V, T, kb)
    assert k4.launches == before + 1


def _rotate_close(V, T, kb):
    """K4 against its plain version: the slots equal, the factors gathered
    through them within 1e-12 of the largest."""
    from cellregmap_tpu_torch.kernels import best_rho_rotate as k4

    At, slot = k4.best_rho_rotate(V, T, kb)
    At_p, slot_p = k4.best_rho_rotate_plain(V, T, kb)
    assert At.shape == At_p.shape and torch.equal(slot, slot_p)
    _close(k4.gather(At, slot), k4.gather(At_p, slot_p), 1e-12)


@pytest.mark.cuda
@pytest.mark.parametrize("genes,nrho", [(3, 11), (16, 11), (13, 3)])
def test_best_rho_rotate_kernel_gene_axis(cuda, genes, nrho):
    """k_best (genes, S): each distinct (rho, variant) pair once."""
    V, T, _ = (torch.as_tensor(a, device=cuda)
               for a in rotate_inputs(genes, nrho=nrho, R=201, C=10, S=70))
    rng = np.random.default_rng(genes)
    kb = torch.as_tensor(rng.integers(0, nrho, size=(genes, 70)),
                         device=cuda)
    _rotate_close(V, T, kb)


@pytest.mark.cuda
@pytest.mark.parametrize("C,p", CASES)
def test_score_core_kernel_matches_plain(cuda, C, p):
    from cellregmap_tpu_torch.kernels import score_core as k5

    args = [torch.as_tensor(a, device=cuda)
            for a in score_inputs(C + p, C=C, p=p, n=160, R=130, S=21)]
    before = k5.launches
    Q, Wmat = k5.score_core(*args)
    assert k5.launches == before + 1
    Qr, Wr = k5.score_core_plain(*args)
    _close(Q, Qr, 1e-10)
    _close(Wmat, Wr, 1e-10)


@pytest.mark.cuda
def test_interaction_batch_never_syncs(cuda):
    """The batch program enqueues its work without waiting for the card:
    torch's sync debug mode raises on any synchronising call inside it."""
    from cellregmap_tpu_torch import engine

    rng = np.random.default_rng(1)
    n, C, donors, S = 200, 5, 20, 32
    E = rng.normal(size=(n, C)) / np.sqrt(C)
    hK = np.zeros((n, donors))
    hK[np.arange(n), np.arange(n) % donors] = 1.0
    y = rng.normal(size=n)
    ctx = engine.build_null_context(y, None, E, hK=hK, device=cuda)
    G = torch.as_tensor(rng.binomial(2, 0.3, size=(n, S)).astype(float),
                        device=cuda)
    engine.interaction_batch(ctx, G, G, n)      # builds and loads kernels
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = engine.interaction_batch(ctx, G, G, n)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert bool(torch.isfinite(out["Q"]).all())


@pytest.mark.cuda
def test_interaction_multigene_batch_never_syncs(cuda):
    """The gene-batched batch program (K4's slots included) enqueues its
    work without waiting for the card."""
    from cellregmap_tpu_torch import engine

    ctx, G, n = _multigene_ctx(cuda, 5)
    engine.interaction_multigene_batch(ctx, G, G, n)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = engine.interaction_multigene_batch(ctx, G, G, n)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert out["Q"].shape == (5, 70) and bool(torch.isfinite(out["Q"]).all())


@pytest.mark.cuda
@pytest.mark.parametrize("genes", [1, 3])
def test_reml_localize_kernel_past_64_rho(cuda, genes):
    """The register localize at 80 rho points (a block held at most 64
    before): k_best equal, x at 1e-9, lml at 1e-10."""
    from cellregmap_tpu_torch import engine
    from cellregmap_tpu_torch.kernels import reml_newton as k3

    ctx, G, n = fit_dataset(80, p=1, nrho=80, n=300, C=4, donors=30, S=40,
                            device=cuda)
    if genes > 1:
        rng = np.random.default_rng(genes)
        Y = ctx.y[None] + 0.4 * torch.as_tensor(
            rng.normal(size=(genes, n)), device=cuda)
        ctx = ctx._replace(y=Y, Zy=Y @ ctx.Z, Wy=Y @ ctx.W,
                           yy=(Y * Y).sum(dim=1))
    calls = captured(lambda: engine.interaction_batch(ctx, G, G, n),
                     ["reml_localize"])
    (args, kw), = calls["reml_localize"]
    assert args[0].shape[0] == 80
    x, lml_all, kb = k3.reml_localize(*args, **kw)
    xp, lml_p, kb_p = k3.reml_localize_plain(*args, **kw)
    assert torch.equal(kb, kb_p)
    _close(x, xp, 1e-9)
    _close(lml_all, lml_p, 1e-10)


@pytest.mark.cuda
def test_scan_on_card_matches_cpu(cuda):
    """A small scan on the card equals the same scan on the CPU (plain
    versions), and every batch went through the three kernels."""
    import cellregmap_tpu_torch as crp
    from cellregmap_tpu_torch import kernels

    rng = np.random.default_rng(0)
    n, C, donors, S = 300, 4, 30, 50
    E = rng.normal(size=(n, C)) / np.sqrt(C)
    hK = np.zeros((n, donors))
    hK[np.arange(n), np.arange(n) % donors] = 1.0
    G = rng.binomial(2, 0.3, size=(n, S)).astype(float)
    y = rng.normal(size=n) + 0.5 * G[:, 3] * E[:, 0]
    cfg = crp.ScanConfig(snp_batch=16)
    kernels.reset_launches()
    pv_g, info_g = crp.run_interaction(y, E, G, hK=hK, config=cfg,
                                       device=cuda)
    assert kernels.launch_counts() == {"kr_contract": 12, "delta_grid": 4,
                                       "reml_newton": 8,
                                       "best_rho_rotate": 4,
                                       "score_core": 4, "null_fit": 0,
                                       "fast_scan": 0,
                                       "woodbury_family": 0,
                                       "sym_eigvalsh": 0,
                                       "mixture_tails": 0}
    pv_c, info_c = crp.run_interaction(y, E, G, hK=hK, config=cfg,
                                       device="cpu")
    assert np.max(np.abs(pv_g - pv_c)) <= 1e-8
    assert np.array_equal(info_g["rho1"], info_c["rho1"])


@pytest.mark.cuda
def test_plink_interaction_on_card_matches_scan(cuda, tmp_path):
    """The streaming interaction driver on the card, over a small PLINK
    fileset in three blocks: every kept column equals a direct
    ``scan_interaction`` of the same standardized columns (1e-12), the
    first block's head the CPU port's (1e-8, identical rho1), and the
    native decoder is built."""
    import cellregmap_tpu_torch as crp
    from cellregmap_tpu_torch import kernels, plink_scan
    from cellregmap_tpu_torch.utils import plink

    rng = np.random.default_rng(3)
    n_donors, n, C, m = 30, 300, 4, 150
    Gd = rng.binomial(2, rng.uniform(0.05, 0.5, size=m),
                      size=(n_donors, m)).astype(float)
    Gd[0, :5] = np.nan
    Gd[:, 9] = 1.0
    prefix = str(tmp_path / "cohort")
    plink.write_bed(prefix, Gd)
    d2c = np.arange(n) % n_donors
    E = rng.normal(size=(n, C)) / np.sqrt(C)
    hK = np.zeros((n, n_donors))
    hK[np.arange(n), d2c] = 1.0
    y = rng.normal(size=n) + 0.3 * hK @ rng.normal(size=n_donors)
    cfg = crp.ScanConfig(snp_batch=32)
    Ls = crp.get_L_values(hK, E)
    crm = crp.CellRegMap(y=y, E=E, Ls=Ls, config=cfg, device=cuda)
    assert plink._get_bed_lib() is not None
    kernels.reset_launches()
    pv, info, vidx = plink_scan.scan_interaction_plink(
        crm, prefix, donor_to_cell=d2c, block_size=64)
    counts = kernels.launch_counts()
    assert all(counts[k] > 0 for k in ("kr_contract", "delta_grid",
                                       "reml_newton", "best_rho_rotate",
                                       "score_core"))
    assert 9 not in vidx and pv.shape == vidx.shape
    mu = np.nanmean(Gd, axis=0)
    Gc = np.where(np.isnan(Gd), mu, Gd)[d2c][:, vidx]
    Gc = (Gc - Gc.mean(0)) / Gc.std(0)
    pv_d, info_d = crm.scan_interaction(Gc)
    np.testing.assert_allclose(pv, pv_d, rtol=0, atol=1e-12)
    cpu = crp.CellRegMap(y=y, E=E, Ls=Ls, config=cfg, device="cpu")
    pv_c, info_c = cpu.scan_interaction(Gc[:, :32])
    assert np.max(np.abs(pv[:32] - pv_c)) <= 1e-8
    assert np.array_equal(info["rho1"][:32], info_c["rho1"])


def _fit_calls(cuda, p, nrho, f32, S=70):
    """The fit wrappers' arguments on the card: the interaction batch
    (REML) and the association refit (ML)."""
    from cellregmap_tpu_torch import engine

    ctx, G, n = fit_dataset(p + 10 * nrho, p=p, nrho=nrho, n=300, C=4,
                            donors=30, S=S, device=cuda)
    reml = captured(lambda: engine.interaction_batch(ctx, G, G, n,
                                                     localize_f32=f32),
                    ["delta_grid", "reml_localize", "reml_converge"])
    ml = captured(lambda: engine.association_refit_batch(
        ctx, G, nrho // 2, n, delta_cfg=(-18.0, 18.0, 256, 60),
        localize_f32=f32), ["delta_grid", "reml_converge"])
    return reml, ml


@pytest.mark.cuda
@pytest.mark.parametrize("p,nrho,f32", FIT_CASES)
def test_delta_grid_kernel_matches_plain(cuda, p, nrho, f32):
    from cellregmap_tpu_torch.kernels import delta_grid as k2

    for calls in _fit_calls(cuda, p, nrho, f32):
        (args, kw), = calls["delta_grid"]
        before = k2.launches
        br_lo, br_hi = k2.delta_grid(*args, **kw)
        assert k2.launches == before + 1
        _, _, lml = k2.delta_grid_plain(*args, **kw, return_lml=True)
        gap = k2.bracket_shortfall(br_lo, br_hi, lml, args[5], args[6])
        assert gap <= (1e-5 if f32 else 1e-12), gap


@pytest.mark.cuda
@pytest.mark.parametrize("p,nrho,f32", FIT_CASES)
def test_reml_newton_kernel_matches_plain(cuda, p, nrho, f32):
    from cellregmap_tpu_torch.kernels import reml_newton as k3

    reml, ml = _fit_calls(cuda, p, nrho, f32)
    (args, kw), = reml["reml_localize"]
    before = k3.launches
    x, lml_all, kb = k3.reml_localize(*args, **kw)
    assert k3.launches == before + 1
    xp, lml_p, kb_p = k3.reml_localize_plain(*args, **kw)
    assert torch.equal(kb, kb_p)
    _close(x, xp, 1e-9)
    _close(lml_all, lml_p, 1e-10)
    for calls in (reml, ml):
        (args, kw) = calls["reml_converge"][0]
        got = k3.reml_converge(*args, **kw)
        want = k3.reml_converge_plain(*args, **kw)
        for g, w in zip(got, want):
            assert float(((g - w).abs() / w.abs()).max()) <= 1e-9


@pytest.mark.cuda
@pytest.mark.parametrize("p", [1, 2, 5, 12, 16, 20, 52])
@pytest.mark.parametrize("restricted", [False, True])
def test_null_fit_kernel_matches_plain(cuda, p, restricted):
    from cellregmap_tpu_torch import engine
    from cellregmap_tpu_torch.kernels import null_fit as k10

    ctx, G, n = fit_dataset(50 + p, p=p, nrho=11, n=300, C=4, donors=30,
                            device=cuda)
    M = torch.cat([ctx.W, G[:, :1]], dim=1) if restricted else ctx.W
    calls = captured(lambda: engine._fit_over_rho(
        ctx, ctx.Z.T @ M, M.T @ M, M.T @ ctx.y, n, restricted,
        (-18.0, 18.0, 256, 60)), ["null_fit"])
    (args, kw), = calls["null_fit"]
    before = k10.launches
    fits = k10.null_fit(*args, **kw)
    assert k10.launches == before + 1
    gaps = k10.fit_gaps(fits, k10.null_fit_plain(*args, **kw), args[0], n,
                        restricted)
    assert max(gaps.values()) <= 1e-10, gaps


@pytest.mark.cuda
@pytest.mark.parametrize("genes", [3, 17])
@pytest.mark.parametrize("restricted", [False, True])
def test_null_fit_kernel_gene_tiles(cuda, genes, restricted):
    """K10 at p = 1 with a gene axis: the grid a block per tile of up to 16
    genes (17: tiles of 9 and 8), each gene's fits as the plain
    version's."""
    from cellregmap_tpu_torch import engine
    from cellregmap_tpu_torch.kernels import null_fit as k10

    ctx, _, n = fit_dataset(60 + genes, p=1, nrho=11, n=300, C=4, donors=30,
                            device=cuda)
    rng = np.random.default_rng(genes)
    Y = ctx.y[None] + 0.4 * torch.as_tensor(rng.normal(size=(genes, n)),
                                            device=cuda)
    ctx = ctx._replace(y=Y, Zy=Y @ ctx.Z, Wy=Y @ ctx.W, yy=(Y * Y).sum(dim=1))
    (args, kw), = captured(lambda: engine.null_association_multigene_fit(
        ctx, n, delta_cfg=(-18.0, 18.0, 256, 60)), ["null_fit"])["null_fit"]
    data = args[0]
    assert data.yt.shape[:2] == (genes, 11) and data.Xt.shape[2] == 1
    args = (data, n, restricted, *args[3:])
    fits = k10.null_fit(*args, **kw)
    gaps = k10.fit_gaps(fits, k10.null_fit_plain(*args, **kw), data, n,
                        restricted)
    assert max(gaps.values()) <= 1e-10, gaps


@pytest.mark.cuda
@pytest.mark.parametrize("restricted", [False, True])
def test_null_fit_wide_kernel_at_the_envelope(cuda, restricted):
    """K10 at p = 97 mean columns (rank[W, E] + 1 at p = 32, C = 64), 11
    rho points, the interaction's 256-point grid and 60 golden steps."""
    from cellregmap_tpu_torch import engine
    from cellregmap_tpu_torch.kernels import null_fit as k10

    p = 97
    ctx, G, n = fit_dataset(50 + p, p=p - 1 if restricted else p, nrho=11,
                            n=600, C=4, donors=30, device=cuda)
    M = torch.cat([ctx.W, G[:, :1]], dim=1) if restricted else ctx.W
    calls = captured(lambda: engine._fit_over_rho(
        ctx, ctx.Z.T @ M, M.T @ M, M.T @ ctx.y, n, restricted,
        (-18.0, 18.0, 256, 60)), ["null_fit"])
    (args, kw), = calls["null_fit"]
    assert args[0].Xt.shape[2] == p
    before = k10.launches
    fits = k10.null_fit(*args, **kw)
    assert k10.launches == before + 1
    gaps = k10.fit_gaps(fits, k10.null_fit_plain(*args, **kw), args[0], n,
                        restricted)
    assert max(gaps.values()) <= 1e-10, gaps


@pytest.mark.cuda
def test_association_on_card_matches_cpu(cuda):
    """A small association scan on the card equals the same scan on the
    CPU, through the null-fit, grid and Newton kernels."""
    import cellregmap_tpu_torch as crp
    from cellregmap_tpu_torch import kernels

    rng = np.random.default_rng(2)
    n, C, donors, S = 300, 4, 30, 50
    E = rng.normal(size=(n, C)) / np.sqrt(C)
    hK = np.zeros((n, donors))
    hK[np.arange(n), np.arange(n) % donors] = 1.0
    G = rng.binomial(2, 0.3, size=(n, S)).astype(float)
    W = np.concatenate([np.ones((n, 1)), rng.normal(size=(n, 1))], axis=1)
    y = rng.normal(size=n) + 0.5 * hK @ rng.normal(size=donors)
    cfg = crp.ScanConfig(snp_batch=16)
    kernels.reset_launches()
    pv_g, info_g = crp.run_association(y, W, E, G, hK=hK, config=cfg,
                                       device=cuda)
    # K3's converge three times a batch: the Newton steps and the fit at
    # each end of the grid
    assert kernels.launch_counts() == {"kr_contract": 0, "delta_grid": 4,
                                       "reml_newton": 12,
                                       "best_rho_rotate": 0,
                                       "score_core": 0, "null_fit": 1,
                                       "fast_scan": 0,
                                       "woodbury_family": 0,
                                       "sym_eigvalsh": 0,
                                       "mixture_tails": 0}
    pv_c, info_c = crp.run_association(y, W, E, G, hK=hK, config=cfg,
                                       device="cpu")
    assert np.max(np.abs(pv_g - pv_c)) <= 1e-9
    assert np.array_equal(info_g["rho1"], info_c["rho1"])


@pytest.mark.cuda
@pytest.mark.parametrize("p", [1, 2, 5])
def test_fast_scan_kernel_matches_plain(cuda, p):
    from cellregmap_tpu_torch import engine
    from cellregmap_tpu_torch.kernels import fast_scan as k8

    ctx, G, n = fit_dataset(80 + p, p=p, nrho=11, n=600, C=4, donors=60,
                            S=700, device=cuda)
    calls = captured(lambda: engine.fast_scan_batch(ctx, G, 6, 0.37, n),
                     ["fast_scan"])
    (args, kw), = calls["fast_scan"]
    before = k8.launches
    got = k8.fast_scan(*args, **kw)
    assert k8.launches == before + 1
    for g, w in zip(got, k8.fast_scan_plain(*args, **kw)):
        _close(g, w, 1e-10)


@pytest.mark.cuda
@pytest.mark.parametrize("C,p,n,donors,S", [(10, 1, 2000, 100, 64),
                                            (31, 1, 800, 20, 24),
                                            (50, 1, 400, 6, 8),
                                            (64, 32, 800, 8, 8)])
def test_woodbury_family_kernel_matches_plain(cuda, C, p, n, donors, S):
    """The effect sizes' K9 calls at the headline's q = 23 (Rk = 1000),
    q = 65, q = 103 and the envelope's corner q = 64 + 96 + 2 = 162."""
    from cellregmap_tpu_torch import engine
    from cellregmap_tpu_torch.kernels import woodbury_family as k9

    bctx, G, norm, n = betas_dataset(C, p=p, n=n, C=C, donors=donors, S=S,
                                     device=cuda)
    calls = captured(lambda: engine.predict_interaction_batch(
        bctx, G, norm, n, localize_f32=True), ["family_eval"])
    for args, kw in calls["family_eval"]:
        before = k9.launches
        got = k9.family_eval(*args, **kw)
        assert k9.launches == before + 1
        if args[0].dtype == torch.float32:
            gaps = k9.f32_gaps(got, args, kw)
            assert gaps["mask"] == 0 and gaps["excess"] <= 1e-5, gaps
            continue
        want = k9.family_eval_plain(*args, **kw)
        if not kw.get("want_beta"):
            got, want = (got,), (want,)
        gaps = k9.lml_gaps(got[0], want[0])
        assert gaps["mask"] == 0 and gaps["rel"] <= 1e-10, gaps
        for g, w in zip(got[1:], want[1:]):
            _close(g, w, 1e-9)


def _small_gxe(seed):
    rng = np.random.default_rng(seed)
    n, C, donors, S = 300, 4, 30, 50
    E = rng.normal(size=(n, C)) / np.sqrt(C)
    hK = np.zeros((n, donors))
    hK[np.arange(n), np.arange(n) % donors] = 1.0
    G = rng.binomial(2, 0.3, size=(n, S)).astype(float)
    W = np.concatenate([np.ones((n, 1)), rng.normal(size=(n, 1))], axis=1)
    y = (rng.normal(size=n) + 0.5 * hK @ rng.normal(size=donors)
         + 0.5 * G[:, 3] * E[:, 0])
    return y, W, E, hK, G


@pytest.mark.cuda
def test_fast_association_on_card_matches_cpu(cuda):
    """run_association_fast on the card equals the CPU's, through the
    null-fit and fast-scan kernels."""
    import cellregmap_tpu_torch as crp
    from cellregmap_tpu_torch import kernels

    y, W, E, hK, G = _small_gxe(3)
    cfg = crp.ScanConfig(snp_batch=16)
    kernels.reset_launches()
    pv_g, info_g = crp.run_association_fast(y, W, E, G, hK=hK, config=cfg,
                                            device=cuda)
    counts = kernels.launch_counts()
    assert counts["null_fit"] == 1 and counts["fast_scan"] == 4
    assert sum(counts.values()) == 5
    pv_c, info_c = crp.run_association_fast(y, W, E, G, hK=hK, config=cfg,
                                            device="cpu")
    # the JAX suite's fast-scan budget (tests/test_api.py:123): the null's
    # golden-section delta differs in its last ~8 digits between K10 and its
    # plain version, and the alternative lml at a fixed delta moves with it
    np.testing.assert_allclose(pv_g, pv_c, rtol=1e-5, atol=1e-12)
    assert np.array_equal(info_g["rho1"], info_c["rho1"])


@pytest.mark.cuda
def test_betas_on_card_match_cpu(cuda):
    """estimate_betas on the card against the CPU (full f64 and hybrid, the
    hybrid under tests/test_hybrid.py's rule through beta_G), through K1
    and K9; the aggregate environment through K10."""
    import cellregmap_tpu_torch as crp
    from cellregmap_tpu_torch import kernels

    y, W, E, hK, G = _small_gxe(4)
    maf = np.full(G.shape[1], 0.3)
    for hybrid in (False, True):
        cfg = crp.ScanConfig(snp_batch=16, hybrid_localization=hybrid)
        kernels.reset_launches()
        bg_g, bgxe_g = crp.estimate_betas(y, W, E, G, maf=maf, hK=hK,
                                          config=cfg, device=cuda)
        counts = kernels.launch_counts()
        assert counts["kr_contract"] == 12
        assert counts["woodbury_family"] == 4 * (9 if hybrid else 6)
        bg_c, bgxe_c = crp.estimate_betas(y, W, E, G, maf=maf, hK=hK,
                                          config=cfg, device="cpu")
        if not hybrid:
            assert np.max(np.abs(bg_g - bg_c)) <= 1e-7
            assert np.max(np.abs(bgxe_g - bgxe_c)) <= 1e-7
        else:
            assert np.median(np.abs(bg_g - bg_c)) <= 1e-7
    # the aggregate environment within tests/test_api.py:180's 1e-5: its
    # REML delta comes from two golden-section searches (K10 and its plain
    # version), which stop apart where the profile is flat
    Ls = crp.get_L_values(hK, E)
    agg = [crp.CellRegMap(y=y, E=E, W=W, Ls=Ls, device=dev)
           .estimate_aggregate_environment(G[:, 3]) for dev in (cuda, "cpu")]
    assert np.max(np.abs(agg[0] - agg[1])) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("C", [3, 10, 32, 33, 50, 64])
def test_sym_eigvalsh_kernel_matches_plain(cuda, C):
    from cellregmap_tpu_torch.kernels import score_core as k5
    from cellregmap_tpu_torch.kernels import sym_eigvalsh as k6a

    args = [torch.as_tensor(a, device=cuda)
            for a in score_inputs(C, C=C, p=1, n=160, R=130, S=40)]
    _, Wmat = k5.score_core_plain(*args)
    B = torch.as_tensor(np.random.default_rng(C).normal(size=(C, C // 2 + 1)),
                        device=cuda)
    A = torch.cat([Wmat, (B @ B.T)[None]])
    before = k6a.launches
    lam, sweeps = k6a.sym_eigvalsh(A, return_sweeps=True)
    assert k6a.launches == before + 1
    want = k6a.sym_eigvalsh_plain(A)
    scale = want.abs().amax(dim=1, keepdim=True)
    assert float(((lam - want).abs() / scale).max()) <= 1e-12
    # Jacobi sweeps up to 32 contexts, bisection steps above
    cap = k6a.MAX_SWEEPS if C <= k6a.WARP_MAX_C else k6a.MAX_BISECT
    assert 0 < int(sweeps.max()) < cap


@pytest.mark.cuda
def test_kernels_refuse_shapes_past_the_envelope(cuda):
    """The wrappers raise before any launch on a shape their kernels do not
    take: K6a past 64 contexts, K10 past 128 mean columns."""
    from cellregmap_tpu_torch.kernels import null_fit as k10
    from cellregmap_tpu_torch.kernels import sym_eigvalsh as k6a

    before = (k6a.launches, k10.launches)
    with pytest.raises(ValueError, match="64 x 64"):
        k6a.sym_eigvalsh(torch.zeros((2, 65, 65), dtype=torch.float64,
                                     device=cuda))
    z = lambda *shape: torch.zeros(shape, dtype=torch.float64,  # noqa: E731
                                   device=cuda)
    data = k10.EigData(S=z(2, 40), Xt=z(2, 40, 129), yt=z(2, 40),
                       Cxx=z(2, 129, 129), cxy=z(2, 129), cyy=z(2))
    with pytest.raises(ValueError, match="p <= 128"):
        k10.null_fit(data, 500, True, -18.0, 18.0, 64, 60)
    assert (k6a.launches, k10.launches) == before


@pytest.mark.cuda
@pytest.mark.parametrize("C", [3, 10, 50])
def test_mixture_tails_kernel_matches_plain(cuda, C):
    from cellregmap_tpu_torch.kernels import mixture_tails as k6b

    q, lam = (torch.as_tensor(a, device=cuda)
              for a in tail_battery(C, n=300, C=C))
    before = k6b.launches
    got = k6b.mixture_tails(q, lam)
    assert k6b.launches == before + 1
    assert_tails_close(got[0], k6b.mixture_tails_plain(q, lam)[0])
    assert_tails_close(got[1], k6b.mixture_tails_plain(q, lam)[1])


@pytest.mark.cuda
def test_mixture_tails_refuses_past_64_weights(cuda):
    """K6b holds two weights a lane of a warp: the wrapper raises before
    any launch past 64."""
    from cellregmap_tpu_torch.kernels import mixture_tails as k6b

    before = k6b.launches
    with pytest.raises(ValueError, match="at most 64 weights"):
        k6b.mixture_tails(torch.ones(3, dtype=torch.float64, device=cuda),
                          torch.ones((3, 65), dtype=torch.float64,
                                     device=cuda))
    assert k6b.launches == before


def _bits(t):
    """A float64 tensor's bits (NaN compares equal to itself)."""
    return t.contiguous().view(torch.int64)


@pytest.mark.cuda
@pytest.mark.parametrize("P", [512, 1024, 16384])
@pytest.mark.parametrize("C", [10, 50, 64])
def test_mixture_tails_kernel_at_the_paths_batches(cuda, P, C):
    """K6b (a warp a pair with its bisection speculated up to 2048 pairs at
    C <= 16, else a group of lanes a pair; the whole warp on a noncentral
    Liu series) at the headline auto batch's size (512 pairs), a screen
    batch's (1024) and the 16-gene screen's (16 x 1024), C = 10, 50 and
    64, on ``tail_battery``'s pairs, by ``chip_smoke.check_tails``: both
    tails within 1e-9 relative of the plain version, but the saddlepoint
    of the pairs within 1e-3 of their mean (among this many pairs some Q
    lie within 1e-4 of it, where the float64 formula itself is only good
    to ~1e-8), held to its formula in long double; and a second launch
    bit-equal to the first (no atomics, sums in one fixed order)."""
    import chip_smoke
    from cellregmap_tpu_torch.kernels import mixture_tails as k6b

    q, lam = (torch.as_tensor(a, device=cuda)
              for a in tail_battery(P + C, n=P, C=C))
    got = k6b.mixture_tails(q, lam)
    want = k6b.mixture_tails_plain(q, lam)
    chip_smoke.check_tails(got, want, q, lam, f"K6b P = {P}, C = {C}")
    again = k6b.mixture_tails(q, lam)
    assert all(torch.equal(_bits(a), _bits(b)) for a, b in zip(again, got))


@pytest.mark.cuda
@pytest.mark.parametrize("genes,nrho,R,C,S", [
    (1, 11, 1000, 10, 1024),      # a screen batch (screen_2k)
    (16, 11, 1000, 10, 1024),     # screen_multigene_16's batch: m = 11
    (1, 3, 2500, 20, 512),        # cells10k's R and C
    (3, 5, 1001, 12, 300)])       # R % 4 != 0; C % 4 == 0
def test_best_rho_rotate_f32_kernel_at_the_paths_batches(cuda, genes, nrho,
                                                         R, C, S):
    """K4-f32 (128 x 128 tiles of 8 x 8 FP32 sums a thread) at the
    screens' shapes and at R = 2500: the slots equal the plain version's,
    the factors within sqrt(R) eps(f32) of the terms' magnitudes, and a
    second launch bit-equal to the first (each sum over r in order)."""
    from cellregmap_tpu_torch.kernels import best_rho_rotate as k4

    rng = np.random.default_rng(R + genes)
    V = torch.as_tensor(rng.standard_normal((nrho, R, R), dtype=np.float32)
                        / np.float32(np.sqrt(R)), device=cuda)
    T = torch.as_tensor(rng.standard_normal((R, C, S), dtype=np.float32),
                        device=cuda)
    kb = torch.as_tensor(rng.integers(0, nrho, size=(genes, S)),
                         device=cuda)
    if genes == 1:
        kb = kb[0]
    before = k4.launches_f32
    At, slot = k4.best_rho_rotate(V, T, kb)
    assert k4.launches_f32 == before + 1 and At.dtype == torch.float32
    At_p, slot_p = k4.best_rho_rotate_plain(V, T, kb)
    assert At.shape == At_p.shape and torch.equal(slot, slot_p)
    got, want = k4.gather(At, slot), k4.gather(At_p, slot_p)
    del At_p
    mags = k4.gather(k4.best_rho_rotate_plain(V.double().abs(),
                                              T.double().abs(), kb)[0],
                     slot_p)
    err = (got.double() - want.double()).abs()
    assert bool((err <= np.sqrt(R) * EPS32 * mags + 1e-30).all()), \
        float((err / (mags + 1e-30)).max() / EPS32)
    del mags, err, want
    assert torch.equal(k4.gather(*k4.best_rho_rotate(V, T, kb)), got)


def _multigene_ctx(cuda, genes, seed=5):
    """A gene-batched null context on the card: ``genes`` phenotypes
    sharing one factorization, and its genotypes."""
    ctx, G, n = fit_dataset(seed, p=2, nrho=11, n=300, C=4, donors=30, S=70,
                            device=cuda)
    rng = np.random.default_rng(seed)
    Y = ctx.y[None] + 0.4 * torch.as_tensor(rng.normal(size=(genes, n)),
                                            device=cuda)
    return ctx._replace(y=Y, Zy=Y @ ctx.Z, Wy=Y @ ctx.W,
                        yy=(Y * Y).sum(dim=1)), G, n


@pytest.mark.cuda
@pytest.mark.parametrize("genes", [1, 3])
def test_gene_axis_kernels_match_plain(cuda, genes):
    """K2-K5 with a gene axis on a gene-batched batch's own operands."""
    from cellregmap_tpu_torch import engine
    from cellregmap_tpu_torch.kernels import delta_grid as k2
    from cellregmap_tpu_torch.kernels import reml_newton as k3
    from cellregmap_tpu_torch.kernels import score_core as k5

    ctx, G, n = _multigene_ctx(cuda, genes)
    calls = captured(lambda: engine.interaction_multigene_batch(
        ctx, G, G, n, device_pvalues=False),
        ["delta_grid", "reml_localize", "reml_converge", "best_rho_rotate",
         "score_core"])
    (args, kw), = calls["delta_grid"]
    br_lo, br_hi = k2.delta_grid(*args, **kw)
    _, _, lml = k2.delta_grid_plain(*args, **kw, return_lml=True)
    assert br_lo.shape == (genes, 70, 11)
    assert k2.bracket_shortfall(br_lo, br_hi, lml, args[5], args[6]) <= 1e-5
    (args, kw), = calls["reml_localize"]
    x, lml_all, kb = k3.reml_localize(*args, **kw)
    xp, lml_p, kb_p = k3.reml_localize_plain(*args, **kw)
    assert torch.equal(kb, kb_p)
    _close(x, xp, 1e-9)
    _close(lml_all, lml_p, 1e-10)
    (args, kw) = calls["reml_converge"][0]
    for g, w in zip(k3.reml_converge(*args, **kw),
                    k3.reml_converge_plain(*args, **kw)):
        assert float(((g - w).abs() / w.abs()).max()) <= 1e-9
    (args, _), = calls["best_rho_rotate"]
    _rotate_close(*args)
    (args, _), = calls["score_core"]
    for g, w in zip(k5.score_core(*args), k5.score_core_plain(*args)):
        _close(g, w, 1e-10)


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["davies", "liu", "saddlepoint", "auto"])
def test_pvalue_methods_on_card_match_cpu(cuda, method):
    """scan_interaction under each method on the card against the CPU
    (1e-8, rho1 identical); K6a and K6b launch once a batch off davies and
    never under it."""
    import cellregmap_tpu_torch as crp
    from cellregmap_tpu_torch import kernels

    y, W, E, hK, G = _small_gxe(6)
    Ls = crp.get_L_values(hK, E)
    cfg = crp.ScanConfig(snp_batch=16, pvalue_method=method,
                         davies_threshold=0.05)
    kernels.reset_launches()
    pv_g, info_g = crp.CellRegMap(y=y, E=E, W=W, Ls=Ls, config=cfg,
                                  device=cuda).scan_interaction(G)
    counts = kernels.launch_counts()
    tails = 0 if method == "davies" else 4
    assert counts["sym_eigvalsh"] == counts["mixture_tails"] == tails
    pv_c, info_c = crp.CellRegMap(y=y, E=E, W=W, Ls=Ls, config=cfg,
                                  device="cpu").scan_interaction(G)
    assert np.array_equal(info_g["rho1"], info_c["rho1"])
    assert np.max(np.abs(pv_g - pv_c)) <= 1e-8
    assert ("pv_liu" in info_g) == (method != "davies")


@pytest.mark.cuda
def test_multigene_on_card_matches_cpu(cuda):
    """run_interaction_multigene on the card: one launch of each kernel a
    (gene tile, variant batch), K1 three times; within 1e-8 of the CPU with
    identical rho1."""
    import cellregmap_tpu_torch as crp
    from cellregmap_tpu_torch import kernels

    y, W, E, hK, G = _small_gxe(7)
    Y = y[:, None] + 0.3 * np.random.default_rng(7).normal(size=(len(y), 5))
    cfg = crp.ScanConfig(snp_batch=16)
    kernels.reset_launches()
    pv_g, info_g = crp.run_interaction_multigene(
        Y, E, G, W=W, hK=hK, gene_batch=2, config=cfg, device=cuda)
    tiles_batches = 3 * 4
    assert kernels.launch_counts() == dict(
        kr_contract=3 * tiles_batches, delta_grid=tiles_batches,
        reml_newton=2 * tiles_batches, best_rho_rotate=tiles_batches,
        score_core=tiles_batches, null_fit=0, fast_scan=0,
        woodbury_family=0, sym_eigvalsh=0, mixture_tails=0)
    pv_c, info_c = crp.run_interaction_multigene(
        Y, E, G, W=W, hK=hK, gene_batch=2, config=cfg, device="cpu")
    assert pv_g.shape == (5, 50)
    assert np.array_equal(info_g["rho1"], info_c["rho1"])
    assert np.max(np.abs(pv_g - pv_c)) <= 1e-8


@pytest.mark.cuda
def test_aggregate_environment_c50_on_card(cuda):
    """estimate_aggregate_environment at C = 50 (p = rank[W, E] + 1 = 51:
    K10's wide instantiation) on the card against the CPU within 1e-5, with
    an E1 background outside span(E) so that the aggregate is not 0."""
    import cellregmap_tpu_torch as crp
    from cellregmap_tpu_torch.kernels import null_fit as k10

    rng = np.random.default_rng(50)
    n, C, donors = 600, 50, 30
    E = rng.normal(size=(n, C)) / np.sqrt(C)
    E1 = rng.normal(size=(n, 10)) / np.sqrt(10)
    hK = np.zeros((n, donors))
    hK[np.arange(n), np.arange(n) % donors] = 1.0
    g = rng.binomial(2, 0.3, size=n).astype(float)
    y = (rng.normal(size=n) + E1 @ rng.normal(size=10)
         + 0.5 * hK @ rng.normal(size=donors) + 0.4 * g * E[:, 0])
    Ls = crp.get_L_values(hK, E)
    before = k10.launches
    agg = [crp.CellRegMap(y=y, E=E, E1=E1, Ls=Ls, device=dev)
           .estimate_aggregate_environment(g) for dev in (cuda, "cpu")]
    assert k10.launches == before + 1
    assert np.abs(agg[1]).max() > 1e-3
    assert np.max(np.abs(agg[0] - agg[1])) <= 1e-5


# -- the gene-batched association scans: K10, K8 and K7 with a gene axis --
def _assoc_genes(cuda, genes, p, seed=8):
    """A gene-batched null context on the card whose ``genes`` phenotypes
    mix the base phenotype with seeded noise of growing weight, and its
    genotypes."""
    ctx, G, n = fit_dataset(seed, p=p, nrho=11, n=300, C=4, donors=30, S=70,
                            device=cuda)
    rng = np.random.default_rng(seed)
    w = torch.as_tensor(np.linspace(0.1, 2.0, genes)[:, None], device=cuda)
    Y = ctx.y[None] + w * torch.as_tensor(rng.normal(size=(genes, n)),
                                          device=cuda)
    return ctx._replace(y=Y, Zy=Y @ ctx.Z, Wy=Y @ ctx.W,
                        yy=(Y * Y).sum(dim=1)), G, n


@pytest.mark.cuda
@pytest.mark.parametrize("genes,p", [(1, 1), (5, 1), (5, 2), (3, 20)])
def test_null_fit_gene_axis_kernel_matches_plain(cuda, genes, p):
    """K10 with a gene axis (p = 20: the wide instantiation), one launch
    for every gene."""
    from cellregmap_tpu_torch import engine
    from cellregmap_tpu_torch.kernels import null_fit as k10

    ctx, _, n = _assoc_genes(cuda, genes, p)
    calls = captured(lambda: engine.null_association_multigene_fit(
        ctx, n, delta_cfg=(-18.0, 18.0, 256, 60)), ["null_fit"])
    (args, kw), = calls["null_fit"]
    before = k10.launches
    fits = k10.null_fit(*args, **kw)
    assert k10.launches == before + 1 and fits.lml.shape == (genes, 11)
    gaps = k10.fit_gaps(fits, k10.null_fit_plain(*args, **kw), args[0], n,
                        False)
    assert max(gaps.values()) <= 1e-10, gaps


@pytest.mark.cuda
@pytest.mark.parametrize("p,k", [(1, [3, 3, 3, 3, 3, 3, 0, 10]),
                                 (2, [0, 5, 10]), (5, [4, 4, 1])])
def test_fast_scan_gene_axis_kernel_matches_plain(cuda, p, k):
    """K8 with a gene axis: genes sharing a slot and genes on their own."""
    from cellregmap_tpu_torch import engine
    from cellregmap_tpu_torch.kernels import fast_scan as k8

    ctx, G, n = _assoc_genes(cuda, len(k), p)
    delta = torch.linspace(0.1, 0.9, len(k), dtype=torch.float64,
                           device=cuda)
    calls = captured(lambda: engine.fast_scan_multigene_batch(
        ctx, G, np.asarray(k), delta, n), ["fast_scan"])
    (args, kw), = calls["fast_scan"]
    for g, w in zip(k8.fast_scan(*args, **kw),
                    k8.fast_scan_genes_plain(*args, **kw)):
        assert g.shape[0] == len(k)
        _close(g, w, 1e-10)


@pytest.mark.cuda
@pytest.mark.parametrize("f32", [True, False])
def test_refit_per_gene_rho_kernels_match_plain(cuda, f32):
    """K7 with a per-gene rho: the grid at each gene's slot, the converge
    kernel at the same slots."""
    from cellregmap_tpu_torch import engine
    from cellregmap_tpu_torch.kernels import delta_grid as k2
    from cellregmap_tpu_torch.kernels import reml_newton as k3

    k = [7, 0, 7, 10, 0]
    ctx, G, n = _assoc_genes(cuda, len(k), 2)
    calls = captured(lambda: engine.association_refit_multigene_batch(
        ctx, G, np.asarray(k), n, delta_cfg=(-18.0, 18.0, 256, 60),
        localize_f32=f32), ["delta_grid", "reml_converge"])
    (args, kw), = calls["delta_grid"]
    br_lo, br_hi = k2.delta_grid(*args, **kw)
    plo, _, lml = k2.delta_grid_plain(*args, **kw, return_lml=True)
    assert torch.equal(torch.isnan(br_lo), torch.isnan(plo))
    for g, s in enumerate(kw["slot"]):
        gap = k2.bracket_shortfall(br_lo[g, :, s:s + 1],
                                   br_hi[g, :, s:s + 1], lml[g], args[5],
                                   args[6])
        assert gap <= (1e-5 if f32 else 1e-12), gap
    (args, kw) = calls["reml_converge"][0]
    for g, w in zip(k3.reml_converge(*args, **kw),
                    k3.reml_converge_plain(*args, **kw)):
        assert float(((g - w).abs() / w.abs()).max()) <= 1e-9


@pytest.mark.cuda
@pytest.mark.parametrize("fast", [False, True])
def test_association_multigene_on_card_matches_cpu(cuda, fast):
    """run_association[_fast]_multigene on the card: one null-fit launch a
    gene tile and one K7 (grid + converge) or K8 launch a (tile, variant
    batch); against the CPU at the single-gene budgets (refit 1e-9; fast
    rtol 1e-5 / atol 1e-12) with identical rho1."""
    import cellregmap_tpu_torch as crp
    from cellregmap_tpu_torch import kernels

    y, W, E, hK, G = _small_gxe(9)
    rng = np.random.default_rng(9)
    Y = y[:, None] + np.linspace(0.1, 2.0, 5) * rng.normal(size=(len(y), 5))
    cfg = crp.ScanConfig(snp_batch=16)
    run = (crp.run_association_fast_multigene if fast
           else crp.run_association_multigene)
    kernels.reset_launches()
    pv_g, info_g = run(Y, E, G, W=W, hK=hK, gene_batch=2, config=cfg,
                       device=cuda)
    tiles, batches = 3, 4
    want = dict.fromkeys(kernels.MODULES, 0)
    want["null_fit"] = tiles
    if fast:
        want["fast_scan"] = tiles * batches
    else:
        # K3's converge: the Newton steps and the fit at each grid end
        want.update(delta_grid=tiles * batches,
                    reml_newton=3 * tiles * batches)
    assert kernels.launch_counts() == want
    pv_c, info_c = run(Y, E, G, W=W, hK=hK, gene_batch=2, config=cfg,
                       device="cpu")
    assert pv_g.shape == (5, 50)
    assert np.array_equal(info_g["rho1"], info_c["rho1"])
    if fast:
        np.testing.assert_allclose(pv_g, pv_c, rtol=1e-5, atol=1e-12)
    else:
        assert np.max(np.abs(pv_g - pv_c)) <= 1e-9


@pytest.mark.cuda
@pytest.mark.parametrize("n,K,p,S", [(2000, 1010, 10, 512),
                                     (2000, 10, 10, 512), (2000, 10, 1, 512),
                                     (301, 79, 3, 37), (97, 23, 1, 50),
                                     (513, 32, 11, 70), (9, 5, 2, 9)])
def test_kr_contract_tensor_core_tiles_on_card(cuda, n, K, p, S):
    """K1's DMMA kernels at the headline's three calls (T, A^T A, A^T W)
    and at ragged K, p S, n and odd widths (the small-K kernel from K <=
    32), one launch a call, within 1e-12 of the plain version."""
    from cellregmap_tpu_torch.kernels import kr_contract as k1

    rng = np.random.default_rng(n + K + p)
    U, V, G = (torch.as_tensor(rng.normal(size=s), device=cuda)
               for s in ((n, K), (n, p), (n, S)))
    before = k1.launches
    got = k1.kr_contract(U, V, G)
    assert k1.launches == before + 1
    _close(got, k1.kr_contract_plain(U, V, G), 1e-12)


@pytest.mark.cuda
@pytest.mark.parametrize("f32", [True, False])
@pytest.mark.parametrize("p1", [5, 9, 17, 25, 33])
def test_localize_product_route_on_card(cuda, p1, f32):
    """K3's localize from p + 1 = 5 (the pair sums a tensor-core product a
    rho, the genotype's sums, the epilogue) over 21 rho points: one launch
    of the wrapper, k_best equal, x at rtol 1e-9, lml at 1e-10."""
    from cellregmap_tpu_torch.kernels import reml_newton as k3

    reml, _ = _fit_calls(cuda, p1 - 1, 21, f32)
    (args, kw), = reml["reml_localize"]
    before = k3.launches
    x, lml_all, kb = k3.reml_localize(*args, **kw)
    assert k3.launches == before + 1
    xp, lml_p, kb_p = k3.reml_localize_plain(*args, **kw)
    assert torch.equal(kb, kb_p)
    fin = torch.isfinite(lml_p)
    assert torch.equal(fin, torch.isfinite(lml_all))
    assert float(((x - xp).abs() / xp.abs().clamp(min=1e-300)).max()) <= 1e-9
    assert float(((lml_all - lml_p).abs() / lml_p.abs())[fin].max()) <= 1e-10


@pytest.mark.cuda
@pytest.mark.parametrize("pattern,genes,C,p,R", [
    ("one", 16, 10, 1, 1000), ("distinct", 4, 10, 1, 1000),
    ("random", 16, 10, 1, 1000), ("one", 3, 50, 31, 300),
    ("distinct", 3, 50, 31, 300)])
def test_score_core_kernel_genes_on_slots(cuda, pattern, genes, C, p, R):
    """K5 with the gene axis at the headline's widths (C = 10, p = 1, R =
    1000; 64 variants, 4 rho points): 16 genes on one rho, 4 each on its
    own, 16 drawn; and the wide instantiation (m = 83) on 3 genes.  One
    launch of the wrapper, each gene at 1e-10 of its plain version."""
    from cellregmap_tpu_torch.kernels import score_core as k5

    args = score_gene_inputs(genes + C + p, genes, pattern, C=C, p=p,
                             n=R + 100, R=R, S=64 if C == 10 else 16,
                             nrho=4, device=cuda)
    before = k5.launches
    Q, Wmat = k5.score_core(*args)
    assert k5.launches == before + 1
    Qr, Wr = k5.score_core_plain(*args)
    _close(Q, Qr, 1e-10)
    _close(Wmat, Wr, 1e-10)


def _converge_on_card(call):
    """One recorded converge call: the kernel (one launch of the wrapper)
    against its plain version, delta, lml, scale and beta at rel 1e-9."""
    from cellregmap_tpu_torch.kernels import reml_newton as k3

    args, kw = call
    before = k3.launches
    got = k3.reml_converge(*args, **kw)
    assert k3.launches == before + 1
    for g, w in zip(got, k3.reml_converge_plain(*args, **kw)):
        assert g.shape == w.shape
        assert float(((g - w).abs() / w.abs()).max()) <= 1e-9


@pytest.mark.cuda
@pytest.mark.parametrize("p", [1, 3, 6, 17])
def test_converge_kernel_reml_gene_axis(cuda, p):
    """K3's converge (REML) on a gene-batched interaction batch: 4 genes x
    64 variants over 5 rho points, R = 183."""
    from cellregmap_tpu_torch import engine

    ctx, G, n = fit_dataset(400 + p, p=p, nrho=5, n=600, donors=60, S=64,
                            device=cuda)
    rng = np.random.default_rng(p)
    Y = ctx.y[None] + 0.6 * torch.as_tensor(rng.normal(size=(4, n)),
                                            device=cuda)
    ctx = ctx._replace(y=Y, Zy=Y @ ctx.Z, Wy=Y @ ctx.W, yy=(Y * Y).sum(dim=1))
    (call,) = captured(lambda: engine.interaction_batch(
        ctx, G, G, n, delta_cfg=(-18.0, 18.0, 32, 60)),
        ["reml_converge"])["reml_converge"]
    assert call[0][5].shape == (4, 64)
    _converge_on_card(call)


@pytest.mark.cuda
@pytest.mark.parametrize("p", [1, 17])
def test_converge_kernel_ml_refit(cuda, p):
    """K7's converge (ML): the refit's Newton steps and its two zero-step
    fits at the grid's ends, one phenotype at one rho (k_best None), and
    three genes each at its own rho."""
    from cellregmap_tpu_torch import engine

    ctx, G, n = fit_dataset(420 + p, p=p, nrho=3, n=600, donors=60, S=64,
                            device=cuda)
    calls = captured(lambda: engine.association_refit_batch(
        ctx, G, 1, n, delta_cfg=(-18.0, 18.0, 64, 60)),
        ["reml_converge"])["reml_converge"]
    assert [c[0][10] for c in calls] == [10, 0, 0]
    rng = np.random.default_rng(p)
    Y = ctx.y[None] + 0.6 * torch.as_tensor(rng.normal(size=(3, n)),
                                            device=cuda)
    ctx = ctx._replace(y=Y, Zy=Y @ ctx.Z, Wy=Y @ ctx.W, yy=(Y * Y).sum(dim=1))
    calls += captured(lambda: engine.association_refit_multigene_batch(
        ctx, G, np.array([2, 0, 2]), n, delta_cfg=(-18.0, 18.0, 64, 60)),
        ["reml_converge"])["reml_converge"]
    for call in calls:
        _converge_on_card(call)


# --------------------------------------------------------------------------
# the float32 context (the screen's): its instantiations and the screen
# --------------------------------------------------------------------------
EPS32 = float(torch.finfo(torch.float32).eps)
# the float32 context's kernel modules on the interaction path
INTERACTION_F32 = ("kr_contract", "delta_grid", "reml_newton",
                   "best_rho_rotate", "score_core", "sym_eigvalsh")


def _f32_sums_close(got, want, mags, n_terms):
    """f32 sums of n terms: within sqrt(n) eps(f32) of the terms'
    magnitudes (n roundings each side, in other orders)."""
    err = (got.double() - want.double()).abs()
    tol = np.sqrt(n_terms) * EPS32
    assert bool((err <= tol * mags + 1e-30).all()), \
        float((err / (mags + 1e-30)).max()) / EPS32


def _f32_calls(cuda, genes=1, p=1, nrho=11, S=70):
    """Every kernel wrapper's arguments of one float32 interaction batch
    on the card (with the device tails), one phenotype or ``genes``."""
    from cellregmap_tpu_torch import engine

    ctx, G, n = fit_dataset(p + 10 * genes, p=p, nrho=nrho, n=300, C=4,
                            donors=30, S=S, device=cuda)
    if genes > 1:
        rng = np.random.default_rng(genes)
        Y = ctx.y[None] + 0.6 * torch.as_tensor(rng.normal(size=(genes, n)),
                                                device=cuda)
        ctx = ctx._replace(y=Y, Zy=Y @ ctx.Z, Wy=Y @ ctx.W,
                           yy=(Y * Y).sum(dim=1))
    ctx = engine.NullContext(*(t.to(torch.float32) for t in ctx))
    G = G.to(torch.float32)
    return captured(lambda: engine.interaction_batch(
        ctx, G, G, n, device_pvalues=True),
        ["kr_contract", "delta_grid", "reml_localize", "reml_converge",
         "best_rho_rotate", "score_core", "sym_eigvalsh"])


@pytest.mark.cuda
@pytest.mark.parametrize("genes,p", [(1, 1), (3, 1), (1, 5), (2, 12)])
def test_f32_kernels_match_plain(cuda, genes, p):
    """The float32 context's instantiations of K1-K5 and K6a against their
    plain f32 versions (the tolerances of tests/test_torch_emulated_f32.py)
    on one batch, each launch counted as an f32 one."""
    from cellregmap_tpu_torch import kernels
    from cellregmap_tpu_torch.kernels import best_rho_rotate as k4
    from cellregmap_tpu_torch.kernels import delta_grid as k2
    from cellregmap_tpu_torch.kernels import kr_contract as k1
    from cellregmap_tpu_torch.kernels import reml_newton as k3
    from cellregmap_tpu_torch.kernels import score_core as k5
    from cellregmap_tpu_torch.kernels import sym_eigvalsh as k6a

    kernels.reset_launches()
    calls = _f32_calls(cuda, genes, p)
    assert kernels.launch_counts_f32() == dict(
        kr_contract=3, delta_grid=1, reml_newton=2, best_rho_rotate=1,
        score_core=1, sym_eigvalsh=1, null_fit=0, fast_scan=0,
        woodbury_family=0)
    for (U, V, G), _ in calls["kr_contract"]:
        mags = k1.kr_contract_plain(U.double().abs(), V.double().abs(),
                                    G.double().abs())
        _f32_sums_close(k1.kr_contract(U, V, G),
                        k1.kr_contract_plain(U, V, G), mags, U.shape[0])
    (args, kw), = calls["delta_grid"]
    br_lo, br_hi = k2.delta_grid(*args, **kw)
    _, _, lml = k2.delta_grid_plain(*args, **kw, return_lml=True)
    for g in np.ndindex(*br_lo.shape[:-2]):
        assert k2.bracket_shortfall(br_lo[g], br_hi[g], lml[g], args[5],
                                    args[6], torch.float32) <= 1e-5
    (args, kw), = calls["reml_localize"]
    x, lml_all, kb = k3.reml_localize(*args, **kw)
    _, lml_p, _ = k3.reml_localize_plain(*args, **kw)
    fin = torch.isfinite(lml_p)
    assert torch.equal(torch.isfinite(lml_all), fin)
    scale = lml_p.abs().clamp(min=1.0)
    assert float(((lml_all - lml_p).abs() / scale)[fin].max()) <= 1e-6
    best, at_k = lml_p.amax(dim=-1), lml_p.gather(-1, kb[..., None])[..., 0]
    assert float(((best - at_k) / best.abs().clamp(min=1.0)).max()) <= 1e-6
    (args, kw), = calls["reml_converge"]
    for g, w in zip(k3.reml_converge(*args, **kw),
                    k3.reml_converge_plain(*args, **kw)):
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(),
                                   rtol=1e-9, atol=1e-12)
    (V, T, kbest), _ = calls["best_rho_rotate"][0]
    (At, slot), (At_p, slot_p) = (k4.best_rho_rotate(V, T, kbest),
                                  k4.best_rho_rotate_plain(V, T, kbest))
    assert torch.equal(slot, slot_p)
    mags = k4.gather(k4.best_rho_rotate_plain(V.double().abs(),
                                              T.double().abs(), kbest)[0],
                     slot_p)
    _f32_sums_close(k4.gather(At, slot), k4.gather(At_p, slot_p), mags,
                    V.shape[1])
    (args, _), = calls["score_core"]
    assert args[3].dtype == torch.float32
    for got, want in zip(k5.score_core(*args), k5.score_core_plain(*args)):
        _close(got, want, 1e-10)
    (A,), _ = calls["sym_eigvalsh"][0]
    lam, want = k6a.sym_eigvalsh(A), k6a.sym_eigvalsh_plain(A)
    assert lam.dtype == torch.float32
    scale = want.abs().amax(dim=1, keepdim=True).clamp(min=1e-30)
    assert float(((lam - want).abs() / scale).max()) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("C", [3, 10, 32, 33, 50, 64])
def test_sym_eigvalsh_f32_kernel_matches_plain(cuda, C):
    """K6a in f32 on both routes, held to the f64 eigenvalues of its f32
    matrices within 1e-5 of each one's largest |lambda|, and the plain f32
    version alike: on the card the plain version's cuSOLVER f32 eigvalsh
    is itself up to ~1.5e-5 away from them at C = 64, where the two f32
    results part by more than 1e-5."""
    B = np.random.default_rng(C).normal(size=(40, C, C + 3))
    A = torch.as_tensor(B @ np.swapaxes(B, 1, 2) / C, dtype=torch.float32,
                        device=cuda)
    from cellregmap_tpu_torch.kernels import sym_eigvalsh as k6a

    lam, want = k6a.sym_eigvalsh(A), k6a.sym_eigvalsh_plain(A)
    exact = torch.linalg.eigvalsh(A.double()).clamp(min=0.0)
    scale = exact.abs().amax(dim=1, keepdim=True)
    assert float(((lam.double() - exact).abs() / scale).max()) <= 1e-5
    assert float(((want.double() - exact).abs() / scale).max()) <= 2e-5


def _screen_data():
    rng = np.random.default_rng(0)
    n, C, donors, S = 300, 4, 30, 50
    E = rng.normal(size=(n, C)) / np.sqrt(C)
    hK = np.zeros((n, donors))
    hK[np.arange(n), np.arange(n) % donors] = 1.0
    G = rng.binomial(2, 0.3, size=(n, S)).astype(float)
    G = (G - G.mean(0)) / np.maximum(G.std(0), 1e-9)
    y = rng.normal(size=n) + 0.8 * G[:, 3] * E[:, 0]
    return y, E, hK, G


@pytest.mark.cuda
def test_float32_scan_on_card_matches_cpu(cuda):
    """The float32 interaction scan on the card against the CPU's (two f32
    programs: rtol 1e-3 and atol 1e-6, the JAX suite's f32 tolerance)."""
    import cellregmap_tpu_torch as crp

    y, E, hK, G = _screen_data()
    cfg = crp.ScanConfig(snp_batch=16, dtype="float32")
    pv_g, info_g = crp.run_interaction(y, E, G, hK=hK, config=cfg,
                                       device=cuda)
    pv_c, info_c = crp.run_interaction(y, E, G, hK=hK, config=cfg,
                                       device="cpu")
    np.testing.assert_allclose(pv_g, pv_c, rtol=1e-3, atol=1e-6)
    assert np.mean(info_g["rho1"] == info_c["rho1"]) >= 0.95


@pytest.mark.cuda
def test_screen_on_card_matches_cpu(cuda):
    """``run_interaction_screen`` on the card against the CPU: the same
    discovery set and confirmed set, the confirmed p-values within 1e-8
    (the f64 Davies path's card-vs-CPU bound), the screen p-values within
    rtol 0.05 where rho1 agrees (two f32 programs)."""
    import cellregmap_tpu_torch as crp
    from cellregmap_tpu_torch import kernels

    y, E, hK, G = _screen_data()
    cfg = crp.ScanConfig(snp_batch=16)
    kernels.reset_launches()
    pv_g, info_g = crp.run_interaction_screen(y, E, G, hK=hK,
                                              significance=1e-3, config=cfg,
                                              device=cuda)
    counts32 = kernels.launch_counts_f32()
    assert all(counts32[k] > 0 for k in INTERACTION_F32), counts32
    pv_c, info_c = crp.run_interaction_screen(y, E, G, hK=hK,
                                              significance=1e-3, config=cfg,
                                              device="cpu")
    assert info_g["n_confirmed"] > 0
    assert np.array_equal(info_g["confirmed"], info_c["confirmed"])
    assert np.array_equal(pv_g < 1e-3, pv_c < 1e-3)
    conf = info_c["confirmed"]
    assert np.max(np.abs(pv_g[conf] - pv_c[conf])) <= 1e-8
    same = info_g["rho1"] == info_c["rho1"]
    assert same.mean() >= 0.9
    np.testing.assert_allclose(info_g["screen_pv"][same],
                               info_c["screen_pv"][same], rtol=0.05)


# --------------------------------------------------------------------------
# the float32 context on the association scans and the effect sizes
# (the tolerances of tests/test_torch_emulated_f32_association.py)
# --------------------------------------------------------------------------
def _context32(cuda, seed, p, genes=0, nrho=11):
    """A float32 null context on the card (n = 600, R = 183; ``genes``
    phenotypes on a leading axis when genes > 0), its f32 genotypes, n."""
    from cellregmap_tpu_torch import engine

    ctx, G, n = fit_dataset(seed, p=p, nrho=nrho, n=600, donors=60, S=96,
                            device=cuda)
    if genes:
        rng = np.random.default_rng(seed)
        Y = ctx.y[None] + 0.6 * torch.as_tensor(rng.normal(size=(genes, n)),
                                                device=cuda)
        ctx = ctx._replace(y=Y, Zy=Y @ ctx.Z, Wy=Y @ ctx.W,
                           yy=(Y * Y).sum(dim=1))
    return (engine.NullContext(*(t.to(torch.float32) for t in ctx)),
            G.to(torch.float32), n)


def _null_fits_f32_close(fits, plain, data, n):
    """K10-f32 against its plain version: the lml within 1e-5 (relative),
    the f64 objective at the kernel's delta no lower than at the plain
    one's by more than 1e-6 of it, beta and scale within 1e-3 of the f64
    values at the kernel's delta."""
    from cellregmap_tpu_torch.kernels import null_fit as k10
    from cellregmap_tpu_torch.models.lmm import lml_at_delta_eig

    if data.yt.ndim == 3:
        for g in range(data.yt.shape[0]):
            _null_fits_f32_close(type(fits)(*(t[g] for t in fits)),
                                 type(plain)(*(t[g] for t in plain)),
                                 k10.gene_data(data, g), n)
        return
    assert fits.lml.dtype == torch.float32
    assert float(((fits.lml - plain.lml).abs() / plain.lml.abs()).max()) \
        <= 1e-5
    d64 = type(data)(*(t.double() for t in data))
    at_k = lml_at_delta_eig(fits.delta.double()[:, None], d64, n, False)
    at_p = lml_at_delta_eig(plain.delta.double()[:, None], d64, n, False)
    lk, lp = at_k[0][:, 0], at_p[0][:, 0]
    assert bool((lk >= lp - 1e-6 * lp.abs()).all())
    for got, want in ((fits.beta, at_k[1][:, 0]),
                      (fits.scale, at_k[2][:, 0])):
        _close(got.double(), want, 1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("genes,p", [(0, 1), (0, 4), (16, 1), (3, 15)])
def test_f32_null_fit_kernel_matches_plain(cuda, genes, p):
    """K10-f32 (ML, 256 grid points, 60 golden-section steps) on one
    phenotype or a gene axis, one f32 launch a call."""
    from cellregmap_tpu_torch import engine
    from cellregmap_tpu_torch.kernels import null_fit as k10

    ctx, _, n = _context32(cuda, 500 + genes + p, p, genes)
    fit = (engine.null_association_multigene_fit if genes
           else engine.null_association_fit)
    (args, kw), = captured(lambda: fit(
        ctx, n, delta_cfg=(-18.0, 18.0, 256, 60)), ["null_fit"])["null_fit"]
    before = k10.launches_f32
    fits = k10.null_fit(*args, **kw)
    assert k10.launches_f32 == before + 1
    _null_fits_f32_close(fits, k10.null_fit_plain(*args, **kw), args[0], n)


def _fast_f32_close(got, want):
    assert float(((got.lml - want.lml).abs() / want.lml.abs()).max()) <= 1e-6
    for g, w in zip(got[1:], want[1:]):
        assert g.dtype == torch.float32
        _close(g, w, 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("p", [1, 3, 15])
def test_f32_fast_scan_kernels_match_plain(cuda, p):
    """K8-f32, one phenotype (a batch of 96) and 16 genes over 3 slots."""
    from cellregmap_tpu_torch import engine
    from cellregmap_tpu_torch.kernels import fast_scan as k8

    ctx, G, n = _context32(cuda, 520 + p, p)
    (args, kw), = captured(lambda: engine.fast_scan_batch(
        ctx, G, 3, 0.41, n), ["fast_scan"])["fast_scan"]
    before = k8.launches_f32
    _fast_f32_close(k8.fast_scan(*args, **kw), k8.fast_scan_plain(*args,
                                                                   **kw))
    assert k8.launches_f32 == before + 1
    ctx, G, n = _context32(cuda, 530 + p, p, genes=16)
    k = np.arange(16) % 3 * 4
    delta = torch.linspace(0.2, 0.8, 16, dtype=torch.float32, device=cuda)
    (args, kw), = captured(lambda: engine.fast_scan_multigene_batch(
        ctx, G, k, delta, n), ["fast_scan"])["fast_scan"]
    before = k8.launches_f32
    _fast_f32_close(k8.fast_scan(*args, **kw),
                    k8.fast_scan_genes_plain(*args, slot=kw["slot"]))
    assert k8.launches_f32 == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("genes,p", [(0, 1), (0, 6), (4, 1), (3, 15)])
def test_f32_refit_kernels_match_plain(cuda, genes, p):
    """K7-f32: the ML grid (f64-logit brackets) and the ML converge with
    its two zero-step fits, one phenotype at rho 5 or genes at their own
    rho."""
    from cellregmap_tpu_torch import engine
    from cellregmap_tpu_torch.kernels import delta_grid as k2
    from cellregmap_tpu_torch.kernels import reml_newton as k3

    ctx, G, n = _context32(cuda, 540 + genes + p, p, genes)
    cfg = (-18.0, 18.0, 256, 60)
    if genes:
        k = np.arange(genes) % 2 * 7
        run = lambda: engine.association_refit_multigene_batch(  # noqa
            ctx, G, k, n, delta_cfg=cfg)
    else:
        run = lambda: engine.association_refit_batch(  # noqa: E731
            ctx, G, 5, n, delta_cfg=cfg)
    calls = captured(run, ["delta_grid", "reml_converge"])
    (args, kw), = calls["delta_grid"]
    br_lo, br_hi = k2.delta_grid(*args, **kw)
    _, _, lml = k2.delta_grid_plain(*args, **kw, return_lml=True)
    if genes:
        for g, s in enumerate(kw["slot"]):
            assert k2.bracket_shortfall(br_lo[g, :, s:s + 1],
                                        br_hi[g, :, s:s + 1], lml[g],
                                        -18.0, 18.0) <= 1e-5
    else:
        assert k2.bracket_shortfall(br_lo, br_hi, lml, -18.0, 18.0) <= 1e-5
    assert len(calls["reml_converge"]) == 3
    before = k3.launches_f32
    for call in calls["reml_converge"]:
        _converge_on_card(call)
    assert k3.launches_f32 == before + 3


@pytest.mark.cuda
@pytest.mark.parametrize("C,p,donors", [(10, 1, 30), (18, 3, 5)])
def test_f32_family_eval_with_coefficients(cuda, C, p, donors):
    """K9-f32's final fit (lml, beta, rss) against the plain f32 version:
    the lml at most twice the plain version's distance from the f64 value
    plus 1e-5 (of max(|lml|, 1)), the same finite points, beta and rss
    within 1e-3 of the plain ones' largest entry."""
    from cellregmap_tpu_torch import engine
    from cellregmap_tpu_torch.kernels import woodbury_family as k9

    f32 = torch.float32
    bctx, G, norm, n = betas_dataset(550 + C, p=p, n=400, C=C,
                                     donors=donors, S=64, device=cuda)
    bctx = engine.BetasContext(*(t.to(f32) for t in bctx))
    calls = captured(lambda: engine.predict_interaction_batch(
        bctx, G.to(f32), norm.to(f32), n), ["family_eval"])["family_eval"]
    assert [a[0].dtype for a, _ in calls] == [f32] * 6
    args, kw = calls[-1]
    args = tuple(type(a)(*(t.contiguous() for t in a))
                 if isinstance(a, tuple) else
                 a.contiguous() if isinstance(a, torch.Tensor) else a
                 for a in args)
    before = k9.launches_f32
    lml, beta, rss = k9.family_eval(*args, **kw)
    assert k9.launches_f32 == before + 1
    plml, pbeta, prss = k9.family_eval_plain(*args, **kw)
    c = lambda a: a.double() if isinstance(a, torch.Tensor) else a  # noqa
    exact = k9.family_eval_plain(*(type(a)(*map(c, a))
                                   if isinstance(a, tuple) else c(a)
                                   for a in args), **kw)[0]
    ref = exact.abs().clamp(min=1.0)
    fin = torch.isfinite(lml)
    assert torch.equal(fin, torch.isfinite(plml))
    eg, ep = (lml - exact).abs() / ref, (plml - exact).abs() / ref
    assert float((eg - 2 * ep)[fin].max()) <= 1e-5
    for got, want in ((beta, pbeta), (rss, prss)):
        _close(got[fin], want[fin], 1e-3)


@pytest.mark.cuda
def test_float32_association_on_card_matches_cpu(cuda):
    """The float32 association scans (single and gene-batched, refit and
    fast) on the card against the CPU, two f32 programs: the LRT
    statistics within 1e-4 of |null lml| (each f32 lml is good to a few
    1e-6 of its magnitude at the headline; here, 300 cells whose
    intercept lies in the donors' span, the complement Gram's f32
    cancellation amplifies that: 1.6e-5 measured on an H100), the same
    rho1; the effect sizes' fits through
    the engine, a rho flip only where the two lmls lie within 1e-5 of
    |lml|, beta_G within 1e-3 of the largest |beta_G| elsewhere; every
    f32 kernel of the slice launched."""
    from scipy.stats import chi2

    import cellregmap_tpu_torch as crp
    from cellregmap_tpu_torch import engine, kernels

    y, E, hK, G = _screen_data()
    Y = np.stack([y, y + 0.5 * np.random.default_rng(1).normal(
        size=len(y))], axis=1)
    cfg = crp.ScanConfig(dtype="float32", snp_batch=32)
    out = {}
    kernels.reset_launches()
    for dev in (cuda, "cpu"):
        crm = crp.CellRegMap(y=y, E=E, hK=hK, config=cfg, device=dev)
        out[str(dev)] = [crm.scan_association(G), crm.scan_association_fast(G),
                         crm.scan_association_multigene(Y, G),
                         crm.scan_association_fast_multigene(Y, G)]
        if dev == cuda:
            counts32 = kernels.launch_counts_f32()
    assert all(counts32[k] > 0 for k in ("null_fit", "fast_scan",
                                         "delta_grid", "reml_newton"))
    crm = crp.CellRegMap(y=y, E=E, hK=hK, config=cfg, device="cpu")
    null = [abs(float(f.lml[k])) for f, k in (
        crm.with_phenotype(Y[:, j])._fit_null_association()
        for j in range(2))]
    for (pg, ig), (pc, ic) in zip(out[str(cuda)], out["cpu"]):
        assert np.isfinite(pg).all()
        np.testing.assert_allclose(ig["rho1"], ic["rho1"], rtol=1e-6)
        gap = np.abs(chi2.isf(pg, 1) - chi2.isf(pc, 1))
        scale = np.asarray(null[:gap.shape[0]] if gap.ndim == 2
                           else null[:1])
        assert float(np.max(gap / scale.reshape((-1,) + (1,) * (
            gap.ndim - 1)))) <= 1e-4
    from cellregmap_tpu_torch.ops.hadamard import get_L_values

    res = {}
    for dev in (cuda, "cpu"):
        bctx = engine.build_betas_context(y, np.ones((len(y), 1)), E,
                                          get_L_values(hK, E), device=dev,
                                          dtype=torch.float32)
        kernels.reset_launches()
        bg, _, info = engine.predict_interaction_batch(
            bctx, torch.as_tensor(G, device=dev, dtype=torch.float32),
            torch.full((G.shape[1],), 1.5, device=dev,
                       dtype=torch.float32), len(y))
        if dev == cuda:
            assert kernels.launch_counts_f32()["woodbury_family"] == 6
        res[str(dev)] = [t.cpu().double().numpy()
                         for t in (bg, info["rho1"], info["lml"])]
    (bg_g, rho_g, lml_g), (bg_c, rho_c, lml_c) = res[str(cuda)], res["cpu"]
    flipped = np.abs(rho_g - rho_c) > 1e-6
    assert np.all(np.abs(lml_g - lml_c)[flipped]
                  <= 1e-5 * np.abs(lml_c[flipped]))
    assert np.max(np.abs(bg_g - bg_c)[~flipped]) <= \
        1e-3 * np.max(np.abs(bg_c))


# --------------------------------------------------------------------------
# K1-f32 and K2-f32 as redesigned for the tensor cores: K1 at K > 32 and
# K2's sums as split-TF32 products, K1 at K <= 32 split over the cells
# --------------------------------------------------------------------------
# K1-f32's shapes: the screen batch's three (T, A^T A, A^T W: n = 2000,
# R = 1000, C = 10, p = 1, S = 1024), then odd ones on each route
K1_F32_SHAPES = [(2000, 1000, 10, 1024), (2000, 10, 10, 1024),
                 (2000, 10, 1, 1024), (997, 131, 7, 333), (1001, 45, 1, 70),
                 (301, 17, 3, 129), (64, 33, 2, 5)]


@pytest.mark.cuda
@pytest.mark.parametrize("positive", [False, True])
@pytest.mark.parametrize("n,K,p,S", K1_F32_SHAPES)
def test_kr_contract_f32_routes_on_card(cuda, n, K, p, S, positive):
    """Each route against its plain f32 version, and against the f64
    product of the same f32 operands, both within sqrt(n) eps(f32) of the
    terms' magnitudes; ``positive``: every term of one sign (the tensor
    core's own sums, which may round toward zero, would drift there over
    a long chain: the split adds a fresh partial a step)."""
    from cellregmap_tpu_torch.kernels import kr_contract as k1

    rng = np.random.default_rng(n + K + p + S)
    U, V, G = (torch.as_tensor(np.abs(a) if positive else a,
                               dtype=torch.float32, device=cuda)
               for a in (rng.normal(size=(n, K)), rng.normal(size=(n, p)),
                         rng.normal(size=(n, S))))
    before = k1.launches_f32
    got = k1.kr_contract(U, V, G)
    torch.cuda.synchronize()
    assert k1.launches_f32 == before + 1 and got.dtype == torch.float32
    mags = k1.kr_contract_plain(U.double().abs(), V.double().abs(),
                                G.double().abs())
    _f32_sums_close(got, k1.kr_contract_plain(U, V, G), mags, n)
    _f32_sums_close(got, k1.kr_contract_plain(U.double(), V.double(),
                                              G.double()), mags, n)


def _f32_grid_call(cuda, genes, p, ml, n=600, S=1024, donors=60):
    """K2-f32's arguments on a float32 context on the card: the
    interaction's REML grid (11 rho, 64 points) or the association
    refit's ML grid (256 points; genes > 1: each gene at its own rho)."""
    from cellregmap_tpu_torch import engine

    ctx, G, n = fit_dataset(700 + genes + p, p=p, nrho=11, n=n, C=10,
                            donors=donors, S=S, device=cuda)
    if genes > 1:
        rng = np.random.default_rng(genes)
        Y = ctx.y[None] + 0.6 * torch.as_tensor(rng.normal(size=(genes, n)),
                                                device=cuda)
        ctx = ctx._replace(y=Y, Zy=Y @ ctx.Z, Wy=Y @ ctx.W,
                           yy=(Y * Y).sum(dim=1))
    ctx = engine.NullContext(*(t.to(torch.float32) for t in ctx))
    G = G.to(torch.float32)
    if not ml:
        run = lambda: engine.interaction_batch(  # noqa: E731
            ctx, G, G, n, delta_cfg=(-18.0, 18.0, 64, 60))
    elif genes == 1:
        run = lambda: engine.association_refit_batch(  # noqa: E731
            ctx, G, 5, n, delta_cfg=(-18.0, 18.0, 256, 60))
    else:
        run = lambda: engine.association_refit_multigene_batch(  # noqa
            ctx, G, np.arange(genes) % 3 + 4, n,
            delta_cfg=(-18.0, 18.0, 256, 60))
    (args, kw), = captured(run, ["delta_grid"])["delta_grid"]
    return args, kw


@pytest.mark.cuda
@pytest.mark.parametrize("genes,p,ml,S", [
    (1, 1, False, 1024), (16, 1, False, 1024), (1, 1, True, 512),
    (3, 1, True, 512), (1, 4, False, 333), (2, 15, True, 130)])
def test_delta_grid_f32_fused_on_card(cuda, genes, p, ml, S):
    """K2-f32 against its plain version: each bracket on the plain argmax
    or a tie within 1e-5 (the brackets the f32-rounded logits for REML,
    the f64 ones for ML; NaN outside each gene's slot)."""
    from cellregmap_tpu_torch.kernels import delta_grid as k2

    args, kw = _f32_grid_call(cuda, genes, p, ml, S=S)
    before = k2.launches_f32
    br_lo, br_hi = k2.delta_grid(*args, **kw)
    plo, phi, lml = k2.delta_grid_plain(*args, **kw, return_lml=True)
    torch.cuda.synchronize()
    assert k2.launches_f32 == before + 1
    assert torch.equal(torch.isnan(br_lo), torch.isnan(plo))
    ctx_dt = torch.float64 if ml else torch.float32
    lo, hi = args[5], args[6]
    if "slot" in kw:
        gap = max(k2.bracket_shortfall(br_lo[g, :, s:s + 1],
                                       br_hi[g, :, s:s + 1], lml[g], lo, hi,
                                       ctx_dt)
                  for g, s in enumerate(kw["slot"]))
    else:
        gap = max(k2.bracket_shortfall(br_lo[g], br_hi[g], lml[g], lo, hi,
                                       ctx_dt)
                  for g in np.ndindex(*br_lo.shape[:-2]))
    assert gap <= 1e-5, gap


@pytest.mark.cuda
def test_delta_grid_f32_refuses_p16(cuda):
    """p + 1 = 17 in the float32 context: refused before any launch (the
    operands made on the CPU, whose plain grid takes any p)."""
    from cellregmap_tpu_torch.kernels import delta_grid as k2

    args, kw = _f32_grid_call(torch.device("cpu"), 1, 16, False, n=300, S=8,
                              donors=30)
    args = [type(a)(*(t.to(cuda) for t in a)) if isinstance(a, tuple)
            else a.to(cuda) if isinstance(a, torch.Tensor) else a
            for a in args]
    before = k2.launches
    with pytest.raises(ValueError, match="p \\+ 1 <= 16"):
        k2.delta_grid(*args, **kw)
    assert k2.launches == before


# sha256 of the f64 entry points' outputs on ``_f64_k1_k2_outputs``'s
# inputs, recorded on the tree before K1-f32 and K2-f32 were redesigned
# (an NVIDIA H100 80GB HBM3): the f64 kernels are deterministic (no
# atomics, fixed summation orders), so the same sources give the same bits
F64_DIGESTS = {
    "k1 large":
        "16909202f32c7b94c36f03ba7edd2256126a0ce9ecfff9af33d6bf58cab91dfa",
    "k1 small":
        "2a2a103d54821b17dce9ec58d5eb106b50e44283d841133aba3836456dbd9a50",
    "k2 reml":
        "4be0c6bd8a0466274b2442505c8bf189f20de10405de8c38fae46cf0ee34d924",
    "k2 reml fast32":
        "4be0c6bd8a0466274b2442505c8bf189f20de10405de8c38fae46cf0ee34d924",
    "k2 ml":
        "38728dc1aef0735c673407a566df2349cf153da03692fede50dfb6e3add1e127",
}


def _f64_k1_k2_outputs(cuda):
    """K1 (a large-K and a small-K call) and K2 (REML f64, REML under
    hybrid localization, ML) through the f64 entry points on seeded
    inputs: name -> the outputs' bytes."""
    import hashlib

    from cellregmap_tpu_torch import engine
    from cellregmap_tpu_torch.kernels import delta_grid as k2
    from cellregmap_tpu_torch.kernels import kr_contract as k1

    out = {}
    rng = np.random.default_rng(1413)
    for name, (n, K, p, S) in (("k1 large", (503, 70, 3, 45)),
                               ("k1 small", (503, 10, 3, 45))):
        U, V, G = (torch.as_tensor(rng.normal(size=sh), device=cuda)
                   for sh in ((n, K), (n, p), (n, S)))
        out[name] = k1.kr_contract(U, V, G)
    ctx, G, n = fit_dataset(1413, p=2, nrho=11, n=300, C=4, donors=30,
                            S=40, device=cuda)
    for name, run in (
            ("k2 reml", lambda: engine.interaction_batch(
                ctx, G, G, n, localize_f32=False)),
            ("k2 reml fast32", lambda: engine.interaction_batch(
                ctx, G, G, n, localize_f32=True)),
            ("k2 ml", lambda: engine.association_refit_batch(
                ctx, G, 3, n, delta_cfg=(-18.0, 18.0, 256, 60)))):
        (args, kw), = captured(run, ["delta_grid"])["delta_grid"]
        out[name] = torch.stack(k2.delta_grid(*args, **kw))
    torch.cuda.synchronize()
    return {k: hashlib.sha256(v.contiguous().cpu().numpy().tobytes())
            .hexdigest() for k, v in out.items()}


@pytest.mark.cuda
def test_f64_k1_k2_bits_unchanged(cuda):
    """crm_kr_contract and crm_delta_grid (f64, and K2's float working type
    on f64 operands) return, bit for bit, what they returned before the
    float32 context's kernels were redesigned."""
    assert _f64_k1_k2_outputs(cuda) == F64_DIGESTS


# K8's tolerance (chip_smoke.FAST_SCAN_TOLERANCE): f64 every output within
# 1e-10 of its largest plain entry; f32 the lml within 1e-6, the rest 1e-4
FAST_TOL = {torch.float64: dict(lml=1e-10, effsizes_g=1e-10,
                                effsizes_W=1e-10, scale=1e-10),
            torch.float32: dict(lml=1e-6, effsizes_g=1e-4, effsizes_W=1e-4,
                                scale=1e-4)}


def _fast_tol_close(got, want):
    for g, w, name in zip(got, want, want._fields):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        _close(g, w, FAST_TOL[w.dtype][name])


def _fast_scan_call(cuda, dt, p, S, n, C, donors, genes=0):
    """K8's arguments from the engine on a dataset of R = C donors rows:
    one phenotype at rho 6, or ``genes`` genes (Y = y + N(0, 1)
    scaled) at rho 0, 4 and 8 in turn, in dtype ``dt``."""
    from cellregmap_tpu_torch import engine

    ctx, G, n = fit_dataset(1600 + p + S, p=p, nrho=11, n=n, C=C,
                            donors=donors, S=S, device=cuda)
    if genes:
        rng = np.random.default_rng(S)
        Y = ctx.y[None] + 0.3 * torch.as_tensor(
            rng.normal(size=(genes, n)), device=cuda)
        ctx = ctx._replace(y=Y, Zy=Y @ ctx.Z, Wy=Y @ ctx.W,
                           yy=(Y * Y).sum(dim=1))
    ctx = engine.NullContext(*(t.to(dt) for t in ctx))
    G = G.to(dt)
    if genes:
        delta = torch.linspace(0.2, 0.8, genes, dtype=dt, device=cuda)
        run = lambda: engine.fast_scan_multigene_batch(  # noqa: E731
            ctx, G, np.arange(genes) % 3 * 4, delta, n)
    else:
        run = lambda: engine.fast_scan_batch(ctx, G, 6, 0.37, n)  # noqa
    (args, kw), = captured(run, ["fast_scan"])["fast_scan"]
    return args, kw


def _fast_plain(args, kw):
    from cellregmap_tpu_torch.kernels import fast_scan as k8

    if "slot" in kw:
        return k8.fast_scan_genes_plain(*args, slot=kw["slot"])
    return k8.fast_scan_plain(*args, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float64, torch.float32])
@pytest.mark.parametrize("p,S,n,C,donors,genes", [
    (1, 512, 2000, 10, 100, 0), (1, 512, 2000, 10, 100, 16),
    (2, 517, 600, 4, 60, 0), (3, 33, 300, 4, 30, 5), (1, 2, 120, 3, 2, 0),
    (9, 70, 300, 4, 30, 3)])
def test_fast_scan_split_rows_on_card(cuda, dt, p, S, n, C, donors, genes):
    """K8 (rows split over blocks, the splits added in order, each gene's
    terms once) at chip_smoke's shapes (R = 1000, 512 variants, one
    phenotype and 16 genes over three slots) and at odd ones: 517 variants
    (no 16-byte rows), 33 variants of 5 genes, R = 6 rows (fewer than a
    split) and two variants, p = 9 (the 16-wide instantiation); one launch
    a call, and a second launch returns the same bits."""
    from cellregmap_tpu_torch.kernels import fast_scan as k8

    args, kw = _fast_scan_call(cuda, dt, p, S, n, C, donors, genes)
    before = k8.launches
    got = k8.fast_scan(*args, **kw)
    assert k8.launches == before + 1
    _fast_tol_close(got, _fast_plain(args, kw))
    for a, b in zip(got, k8.fast_scan(*args, **kw)):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("p,S,n,C,donors,genes", [
    (24, 512, 2000, 10, 100, 0), (17, 37, 300, 4, 30, 0),
    (32, 64, 300, 4, 30, 3)])
def test_fast_scan_wide_split_rows_on_card(cuda, p, S, n, C, donors, genes):
    """The wide K8 (16 < p <= 32, f64): ``covariates_24``'s width at the
    headline's R, and p = 17 and 32 (3 genes) at odd shapes."""
    from cellregmap_tpu_torch.kernels import fast_scan as k8

    args, kw = _fast_scan_call(cuda, torch.float64, p, S, n, C, donors,
                               genes)
    _fast_tol_close(k8.fast_scan(*args, **kw), _fast_plain(args, kw))


def _f32_converge_calls(cuda, case):
    """The float32 converge's calls of one path (the engine's arguments):
    ``screen`` stage 3 of a 1024-variant batch at the headline's R = 1000,
    ``refit`` K7's three calls on 512 of them, ``refit_genes`` K7 with 16
    genes at their own rho, ``p15`` stage 3 at p + 1 = 16 with 3 genes,
    ``chunked`` stage 3 and K7 at R = 3000 (the f32 rows pass in chunks)."""
    from cellregmap_tpu_torch import engine

    f32 = torch.float32
    shape = dict(screen=(1, 2000, 10, 100, 1024, 1),
                 refit=(1, 2000, 10, 100, 512, 1),
                 refit_genes=(1, 2000, 10, 100, 512, 16),
                 p15=(15, 600, 4, 60, 96, 3),
                 chunked=(1, 3000, 3, 1000, 40, 1))[case]
    p, n, C, donors, S, genes = shape
    ctx, G, n = fit_dataset(1700 + p + S, p=p, nrho=11, n=n, C=C,
                            donors=donors, S=S, device=cuda)
    if genes > 1:
        rng = np.random.default_rng(genes)
        Y = ctx.y[None] + 0.3 * torch.as_tensor(
            rng.normal(size=(genes, n)), device=cuda)
        ctx = ctx._replace(y=Y, Zy=Y @ ctx.Z, Wy=Y @ ctx.W,
                           yy=(Y * Y).sum(dim=1))
    ctx = engine.NullContext(*(t.to(f32) for t in ctx))
    G = G.to(f32)
    cfg = (-18.0, 18.0, 256, 60)
    runs = []
    if case in ("screen", "p15", "chunked"):
        runs.append(lambda: engine.interaction_batch(ctx, G, G, n))
    if case in ("refit", "chunked"):
        runs.append(lambda: engine.association_refit_batch(
            ctx, G, 5, n, delta_cfg=cfg))
    if case == "refit_genes":
        runs.append(lambda: engine.association_refit_multigene_batch(
            ctx, G, np.arange(genes) % 3 * 4, n, delta_cfg=cfg))
    return [c for run in runs
            for c in captured(run, ["reml_converge"])["reml_converge"]]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["screen", "refit", "refit_genes", "p15",
                                  "chunked"])
def test_f32_converge_on_card(cuda, case):
    """The float32 converge (the f64 converge's kernels on f32 rows) against
    the plain version at rtol 1e-9, atol 1e-12, REML and ML, on every call
    of the path."""
    from cellregmap_tpu_torch.kernels import reml_newton as k3

    calls = _f32_converge_calls(cuda, case)
    assert calls and all(a[0].dtype == torch.float32 for a, _ in calls)
    for args, kw in calls:
        before = k3.launches_f32
        got = k3.reml_converge(*args, **kw)
        assert k3.launches_f32 == before + 1
        for g, w, name in zip(got, k3.reml_converge_plain(*args, **kw),
                              ("delta", "lml", "scale", "beta")):
            np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(),
                                       rtol=1e-9, atol=1e-12,
                                       err_msg=f"{case} {name}")



def _f32_localize_call(cuda, case):
    """The float32 localize's arguments at one path's shapes: ``screen`` a
    1024-variant screen batch at the headline's R = 1000 (p = 1, 7 and 15:
    the register localize and the wide f32 one), ``chunked`` 256 variants
    at cells10k's R = 2500 (the register localize's rows in chunks),
    ``genes`` 256 variants with 16 phenotypes (tiles of 4 genes) and
    ``genes_p7`` 3 phenotypes at p = 7."""
    from cellregmap_tpu_torch import engine

    p, n, C, donors, S, genes = dict(
        screen=(1, 2000, 10, 99, 1024, 1),
        screen_p7=(7, 2000, 10, 99, 1024, 1),
        screen_p15=(15, 2000, 10, 99, 1024, 1),
        chunked=(1, 2600, 20, 124, 256, 1), genes=(1, 2000, 10, 99, 256, 16),
        genes_p7=(7, 2000, 10, 99, 256, 3))[case]
    ctx, G, n = fit_dataset(1600 + p + genes, p=p, nrho=11, n=n, C=C,
                            donors=donors, S=S, device=cuda)
    if genes > 1:
        rng = np.random.default_rng(genes)
        Y = ctx.y[None] + 0.3 * torch.as_tensor(
            rng.normal(size=(genes, n)), device=cuda)
        ctx = ctx._replace(y=Y, Zy=Y @ ctx.Z, Wy=Y @ ctx.W,
                           yy=(Y * Y).sum(dim=1))
    ctx = engine.NullContext(*(t.to(torch.float32) for t in ctx))
    G = G.to(torch.float32)
    (args, kw), = captured(lambda: engine.interaction_batch(ctx, G, G, n),
                           ["reml_localize"])["reml_localize"]
    return args, kw


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["screen", "screen_p7", "screen_p15",
                                  "chunked", "genes", "genes_p7"])
def test_f32_localize_on_card(cuda, case):
    """The float32 localize against its plain version: the f64 lml at the
    localized optimum within 1e-6 of max(|lml|, 1), the same -inf entries,
    the argmax a tie within 1e-6, x the f32 state; a second launch returns
    the same bits (no atomics, fixed summation orders)."""
    from cellregmap_tpu_torch.kernels import reml_newton as k3

    args, kw = _f32_localize_call(cuda, case)
    before = k3.launches_f32
    x, lml, kb = got = k3.reml_localize(*args, **kw)
    assert k3.launches_f32 == before + 1
    _, lml_p, _ = k3.reml_localize_plain(*args, **kw)
    assert torch.equal(x.to(torch.float32).double(), x)
    fin = torch.isfinite(lml_p)
    assert torch.equal(torch.isfinite(lml), fin)
    scale = lml_p.abs().clamp(min=1.0)
    assert float(((lml - lml_p).abs() / scale)[fin].max()) <= 1e-6
    best, at_k = lml_p.amax(dim=-1), lml_p.gather(-1, kb[..., None])[..., 0]
    assert float(((best - at_k) / best.abs().clamp(min=1.0)).max()) <= 1e-6
    again = k3.reml_localize(*args, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("genes,p", [(0, 1), (16, 1), (17, 1), (0, 15)])
def test_f32_null_fit_at_scale_on_card(cuda, genes, p):
    """K10-f32 at the Ls scanner's shapes (2000 cells, R = 1000, 11 rho,
    the association's 256-point grid and 60 golden-section steps): one
    phenotype, a tile of 16 genes, 17 genes (tiles of 9 and 8) and p =
    15, against its plain version (``_null_fits_f32_close``); a second
    launch returns the same bits."""
    from cellregmap_tpu_torch import engine
    from cellregmap_tpu_torch.kernels import null_fit as k10

    ctx, _, n = fit_dataset(1650 + genes + p, p=p, nrho=11, n=2000, C=10,
                            donors=99, S=2, device=cuda)
    if genes:
        rng = np.random.default_rng(genes)
        Y = ctx.y[None] + 0.1 * torch.as_tensor(
            rng.normal(size=(genes, n)), device=cuda)
        ctx = ctx._replace(y=Y, Zy=Y @ ctx.Z, Wy=Y @ ctx.W,
                           yy=(Y * Y).sum(dim=1))
    ctx = engine.NullContext(*(t.to(torch.float32) for t in ctx))
    fit = (engine.null_association_multigene_fit if genes
           else engine.null_association_fit)
    (args, kw), = captured(lambda: fit(
        ctx, n, delta_cfg=(-18.0, 18.0, 256, 60)), ["null_fit"])["null_fit"]
    before = k10.launches_f32
    fits = k10.null_fit(*args, **kw)
    assert k10.launches_f32 == before + 1
    _null_fits_f32_close(fits, k10.null_fit_plain(*args, **kw), args[0], n)
    again = k10.null_fit(*args, **kw)
    assert all(torch.equal(a, b) for a, b in zip(fits, again))
    if genes:
        one = k10.null_fit(k10.gene_data(args[0], genes - 1), *args[1:],
                           **kw)
        assert all(torch.equal(a[genes - 1], b) for a, b in zip(fits, one))

# the wrappers whose calls the paths of ``_unmoved_outputs`` record (the
# engine's names): every kernel but K8 and K6b; the float32 context's
# converge, localize and null fit and what reads their results (K4, K5,
# K6a, K6b) are left out of its paths
UNMOVED_F64 = ("kr_contract", "delta_grid", "reml_localize", "reml_converge",
               "best_rho_rotate", "score_core", "sym_eigvalsh", "null_fit",
               "family_eval")
UNMOVED_F32 = ("kr_contract", "delta_grid", "family_eval")


def _digest(out):
    """sha256 of a wrapper's outputs (tensors, in nested tuples)."""
    import hashlib

    h = hashlib.sha256()

    def add(t):
        if isinstance(t, (tuple, list)):
            for u in t:
                add(u)
        elif isinstance(t, torch.Tensor):
            h.update(t.contiguous().cpu().numpy().tobytes())

    add(out)
    return h.hexdigest()


def _unmoved_outputs(cuda):
    """Every kernel but K8, K6b and the float32 converge, localize and
    null fit (and K4 on the float32 localize's k_best), through the engine's
    paths on seeded inputs: interaction batches with the device tails at p
    = 1 (under hybrid localization and without), 3, 8 and 20 (the
    register and product localize, the converge's instantiations); a
    3-gene interaction batch; the association refit (ML: the Newton call
    and the zero-step fits at the grid's ends) and the null fit at p = 1
    and 20; the gene-batched refit over 16 genes x 300 variants (4800
    problems: the zero-step fits one warp a problem); an effect-size
    batch; and in the float32 context an interaction batch at p = 1 and
    4 (K1 and K2), the refit's grid and an effect-size batch.  Each
    recorded wrapper call is made again from its arguments: "path name i"
    -> sha256 of its outputs (K4's gathered per gene and variant)."""
    from cellregmap_tpu_torch import engine
    from cellregmap_tpu_torch.kernels import best_rho_rotate as k4

    f32 = torch.float32
    cfg = (-18.0, 18.0, 256, 60)
    paths = []
    for p in (1, 3, 8, 20):
        ctx, G, n = fit_dataset(1515 + p, p=p, nrho=11, n=300, C=4,
                                donors=30, S=40, device=cuda)
        paths.append((f"interaction p={p}", UNMOVED_F64,
                      lambda c=ctx, G=G, n=n: engine.interaction_batch(
                          c, G, G, n, device_pvalues=True)))
        if p in (1, 20):
            paths += [
                (f"refit p={p}", UNMOVED_F64,
                 lambda c=ctx, G=G, n=n: engine.association_refit_batch(
                     c, G, 3, n, delta_cfg=cfg)),
                (f"null fit p={p}", UNMOVED_F64,
                 lambda c=ctx, n=n: engine.null_association_fit(
                     c, n, delta_cfg=cfg))]
        if p == 1:
            paths.append(("interaction p=1 f64 localize", UNMOVED_F64,
                          lambda c=ctx, G=G, n=n: engine.interaction_batch(
                              c, G, G, n, localize_f32=False)))
    ctx_g, G, n = _multigene_ctx(cuda, 3, seed=1521)
    paths.append(("interaction 3 genes", UNMOVED_F64,
                  lambda: engine.interaction_multigene_batch(ctx_g, G, G,
                                                             n)))
    ctx_a, _, n = _assoc_genes(cuda, 16, 1, seed=1522)
    G300 = torch.as_tensor(np.random.default_rng(1522).normal(
        size=(n, 300)), device=cuda)
    k_a = np.arange(16) % 3
    paths.append(("refit 16 genes", UNMOVED_F64,
                  lambda: engine.association_refit_multigene_batch(
                      ctx_a, G300, k_a, n, delta_cfg=cfg)))
    bctx, Gb, norm, nb = betas_dataset(1523, p=2, n=300, C=4, donors=30,
                                       S=32, device=cuda)
    paths.append(("betas", UNMOVED_F64,
                  lambda: engine.predict_interaction_batch(bctx, Gb, norm,
                                                           nb)))
    for p in (1, 4):
        c32, G32, n32 = _context32(cuda, 1530 + p, p)
        paths.append((f"f32 interaction p={p}", UNMOVED_F32,
                      lambda c=c32, G=G32, n=n32: engine.interaction_batch(
                          c, G, G, n)))
        if p == 1:
            paths.append(
                ("f32 refit p=1", UNMOVED_F32,
                 lambda c=c32, G=G32, n=n32: engine.association_refit_batch(
                     c, G, 3, n, delta_cfg=cfg)))
    b32 = engine.BetasContext(*(t.to(f32) for t in bctx))
    paths.append(("f32 betas", UNMOVED_F32,
                  lambda: engine.predict_interaction_batch(
                      b32, Gb.to(f32), norm.to(f32), nb)))
    out = {}
    for label, names, run in paths:
        for name, calls in captured(run, list(names)).items():
            for i, (args, kw) in enumerate(calls):
                got = getattr(engine, name)(*args, **kw)
                if name == "best_rho_rotate":  # the slots no gene uses
                    got = k4.gather(*got)      # are never written
                out[f"{label} {name} {i}"] = _digest(got)
    torch.cuda.synchronize()
    return out


# sha256 of ``_unmoved_outputs`` recorded on the tree before the float32
# converge and K8 were redesigned (an NVIDIA H100 80GB HBM3), less the
# float32 localize's, K10's and K4's float32 entries since the float32
# localize and K10 were, and K6b's since it was: those kernels are
# deterministic (no atomics, fixed summation orders), so the same sources,
# and the f64 instantiations of the converge's and the localize's shared
# templates, give the same bits
UNMOVED_DIGESTS = {
    "interaction p=1 kr_contract 0":
        "de1e48165c3594d27b21a0933dfec3edd0598b40c5c889c3d08d7f41c31814fc",
    "interaction p=1 kr_contract 1":
        "6f7bafb77370d05d718939d74d89052ed4e8013bd8ce3cb61a9a58c54e94d140",
    "interaction p=1 kr_contract 2":
        "360f1e802814dc57ee637d692fcf5e2fd7b51eeb66a8c593dea2f49cd53c662d",
    "interaction p=1 delta_grid 0":
        "ea8d7f14c018137ec62aa498f6c9b165c878669c63150c7cbf2bf763da0dc536",
    "interaction p=1 reml_localize 0":
        "29a45257de972d0e47ef4f88998bc160bdaecbef9e4dc34d3e3d1d47482b5916",
    "interaction p=1 reml_converge 0":
        "b50d77ae6e3bbea2923c1333dc1cbfe1eabdb627d2b94df58e6acd490fc0a2ca",
    "interaction p=1 best_rho_rotate 0":
        "1d315b6434d0337a31ae336a34029670413223eb1f55b0b6b2244295108fc6d6",
    "interaction p=1 score_core 0":
        "576f622892987304cfa18dfc7ae214f245c7617afd4ba9212366f251bb703533",
    "interaction p=1 sym_eigvalsh 0":
        "3a64d07a071d298cc82865bb7513188f5ab04a84a07dfd2615bd67f7c49c3f63",
    "refit p=1 delta_grid 0":
        "777041b3dcb006cc8ef0c2ee831b562e419615c4087c1f9f029892a7de139ee5",
    "refit p=1 reml_converge 0":
        "73ad6e44b48cc830ab83de106449fe9a017756da73692946761d76204987e0b3",
    "refit p=1 reml_converge 1":
        "d9392a333bc7781807b0644d22705e51212e8b87698227643dc6f092f4a11947",
    "refit p=1 reml_converge 2":
        "eab1b7371fcf12d6931184d96fae75ba13983997b247baf5d2f6ee73dd26ccf2",
    "null fit p=1 null_fit 0":
        "dc4db4a609dcc9fc178dc802f6f1305fb64990bf06faeda689bff5691b914242",
    "interaction p=1 f64 localize kr_contract 0":
        "de1e48165c3594d27b21a0933dfec3edd0598b40c5c889c3d08d7f41c31814fc",
    "interaction p=1 f64 localize kr_contract 1":
        "6f7bafb77370d05d718939d74d89052ed4e8013bd8ce3cb61a9a58c54e94d140",
    "interaction p=1 f64 localize kr_contract 2":
        "360f1e802814dc57ee637d692fcf5e2fd7b51eeb66a8c593dea2f49cd53c662d",
    "interaction p=1 f64 localize delta_grid 0":
        "ea8d7f14c018137ec62aa498f6c9b165c878669c63150c7cbf2bf763da0dc536",
    "interaction p=1 f64 localize reml_localize 0":
        "6a6f2762a14681a81d4a99830ac2b9115fd22b2f463068dbc49e95a693bba8f7",
    "interaction p=1 f64 localize reml_converge 0":
        "4a75ecef138d9eb31b704f5dbd8983d037a3cb6d644fcec31bbe90fe0ea2514c",
    "interaction p=1 f64 localize best_rho_rotate 0":
        "1d315b6434d0337a31ae336a34029670413223eb1f55b0b6b2244295108fc6d6",
    "interaction p=1 f64 localize score_core 0":
        "e035af17d2bf457e1ddc9020fecb0fa30bdefe808e6186fee0408ccd8903b192",
    "interaction p=3 kr_contract 0":
        "74627508e885da440a86f1351456e0f9ab5bcf198c379cf17a82f3a7e970ece0",
    "interaction p=3 kr_contract 1":
        "f0b7b5cef7e01ea088b40a3b9a2312771002c11466e51888b055718ecead74f9",
    "interaction p=3 kr_contract 2":
        "75ede578132e4ee5fa39b1f365148fd90e7bd0594bce4ee1f0f231f971580b7d",
    "interaction p=3 delta_grid 0":
        "9a4fc0d5957f7c0c6cb5d48ebabac2d7bedefee6be9ad311c443f82eb28d695e",
    "interaction p=3 reml_localize 0":
        "588d03a7a270cde6c4d9b3a794cc85d5e1395a452386dad0da8b0e36de195f2c",
    "interaction p=3 reml_converge 0":
        "e6e00868bbb57802150f50f8e707928ad404cc65a34dd037874aff8690a8f591",
    "interaction p=3 best_rho_rotate 0":
        "8e139433756eb630bc089da94164f95d70a91b12d55b681ac6d7817f01633e70",
    "interaction p=3 score_core 0":
        "fd7f88524f03b531d4d111d52850f18227a08b2598dff0172151499cc693bd7a",
    "interaction p=3 sym_eigvalsh 0":
        "64763a7465969c98190adb0eacac2c241c7a0e6670aa9cf2aa7347776100bb6b",
    "interaction p=8 kr_contract 0":
        "e55e3f9ac590aa85c359d89c65303c6a8e2fc5f7a6c3eb6367bec54958154aa6",
    "interaction p=8 kr_contract 1":
        "3c351aced4f384fed33a671f9c2f85eaecf772a37189067612104e0a68b64a87",
    "interaction p=8 kr_contract 2":
        "9547d1a61a3b91117e42ac32b8f5e593b5bc7cc1b2e6f9b2c32dc8e316aa69fd",
    "interaction p=8 delta_grid 0":
        "175fde648a95a1f6cb78c74038c76f3e3aea71086c9ef213591f04971855ff07",
    "interaction p=8 reml_localize 0":
        "8a8fe178d030c4f001869f35b2e9c37540def7e4f0b6679bbff719e03fa7f472",
    "interaction p=8 reml_converge 0":
        "e3aba288c0d064e5704df1bac398cdb5a92387d37929a4d2a8021fc7c6e73246",
    "interaction p=8 best_rho_rotate 0":
        "c7d099bea88b92df5c7e32bbc4348345e31880af45e471ddf2ec66a69ad14191",
    "interaction p=8 score_core 0":
        "25f3a35839cc4198166ef6189cf25b2706e5a13c4b900795233c5f13649f4538",
    "interaction p=8 sym_eigvalsh 0":
        "c0710d8f74acc4c9aaca329342270dca7439d5ce3e0bbc9d1ce730dda7e6dd24",
    "interaction p=20 kr_contract 0":
        "814dcfce362afc4570d44047b2c40567a3503e07d1ff7dd2286739ae6c9f94b5",
    "interaction p=20 kr_contract 1":
        "6bc95fc1a8834c1882cbc89568e871dd520d46e0051c13ecc5796953bc2813ee",
    "interaction p=20 kr_contract 2":
        "e2fdab43ae9739c113a532bce99b56b89caa912e6e7d497cf685cb0fd51ba7a0",
    "interaction p=20 delta_grid 0":
        "9a4fc0d5957f7c0c6cb5d48ebabac2d7bedefee6be9ad311c443f82eb28d695e",
    "interaction p=20 reml_localize 0":
        "f4915d902bd284a3cfe2423b52ea90b1658e17c4f00bfe45e5a0c83f2a7a5066",
    "interaction p=20 reml_converge 0":
        "117499ba55f046689b6d6b263c47d2bd12d233a7b8bbf5c94b2fcdf8ed34ef65",
    "interaction p=20 best_rho_rotate 0":
        "5f47fdcac22dae8bd7450a98d204b74c4b82ce982ea102f31092b070a16fe10b",
    "interaction p=20 score_core 0":
        "82383edbc17cd463c64f77a0196dd8d204de088c36e6e0992fb6a576458708c7",
    "interaction p=20 sym_eigvalsh 0":
        "c11b509070622a36d38b5519bf4a1e31901e598afd77f24513e4bd12950ac32b",
    "refit p=20 delta_grid 0":
        "b019505846c0a976fed28e2a1382e77ae3b1febea9e64f66980192a48f36610b",
    "refit p=20 reml_converge 0":
        "1f93f5bf2e22b5af5d16155ceeeee029fbca69ff04e3fa0c31b45a24d4c235f6",
    "refit p=20 reml_converge 1":
        "49d5f36bb7361fdce96f30887f1231cddb5c2038f1bd21432ec1a11d066c7993",
    "refit p=20 reml_converge 2":
        "9e4e473a0bfce3e9857721cb76638233537452e616eafac9ffb0ca04c1fad8c5",
    "null fit p=20 null_fit 0":
        "1dbd790520b5694a7d601f1dc1b54b5da69a9c45c3f862981ecf00fc1ec3a43a",
    "interaction 3 genes kr_contract 0":
        "a32f679003ea85ff59fc05a32b21cf2bdc38d9e07f3d3f0ea16f667dc029f4b7",
    "interaction 3 genes kr_contract 1":
        "e61d4301a5d083c2e3f6ff728f42d8cd9e56f1e2bdc46f7e144b20b14ea8ab78",
    "interaction 3 genes kr_contract 2":
        "c787f11f9ed4b1590e3b12869ea91b8f1970858d3936857e2db463fd34d8e764",
    "interaction 3 genes delta_grid 0":
        "936dbd03642d867220f8bd2bccb3689e45a0f6787f25e2dc4d18d26a023fd32b",
    "interaction 3 genes reml_localize 0":
        "ef8f6516aa031b89093b59d890af6aa432cb88accea1a54f84535235111e14c0",
    "interaction 3 genes reml_converge 0":
        "303784fa3d82db9e407aa3481b52b225ecfecff88b8bc9de54102d9bb2aca366",
    "interaction 3 genes best_rho_rotate 0":
        "2df06206e51e83bf6cefb935a00ba9243bfbc06c653ca7ba1e0365b274d6341c",
    "interaction 3 genes score_core 0":
        "848b1218616d96fa1e16cc1eafc1b9e5842a3db9b2fa431e8d7f7190d355507e",
    "refit 16 genes delta_grid 0":
        "54f0adbff5a89538241fd12b3167686513d681e250d1e616a7beaa7a0253cff9",
    "refit 16 genes reml_converge 0":
        "26fe161842e6402726fa87edfa3dabd32d07245e86dc20f33aa4c56da2356973",
    "refit 16 genes reml_converge 1":
        "f073f3fb9d1d13012a59b569ca36189e52ea843a461cae1cdfab62e902843329",
    "refit 16 genes reml_converge 2":
        "1162392092cef4aedf6cfe2aca871e80a4ce14589e0eca224c90ab1a8dbf9029",
    "betas kr_contract 0":
        "cbf94dabd1f61711d70c9608507ca8d31a4dcf089959bcd67efeb84471155809",
    "betas kr_contract 1":
        "df3d5002ed766448986ce859414b0084237cc638e3e1d58fcd65dc5202e95ac6",
    "betas kr_contract 2":
        "0489cd13f8da69e3f6033ed5136f6b550c396534da25d77b69c4801132274505",
    "betas family_eval 0":
        "47a10bb82c6401d87fc74f0f5a03760e4ee354c85dad5eb76307f72fdf8f735c",
    "betas family_eval 1":
        "303e209f2920be8cbfaa43ae9da34dba05c0f0c21a290f452fe1ffe2867c7cd2",
    "betas family_eval 2":
        "8683d146503afd624e7fa2eb870358d674c8d16316e09f1d2a0c8690599bdb5a",
    "betas family_eval 3":
        "30b128edcedece495c26b365de88901dfa73ac701e9141004a2c913c77578974",
    "betas family_eval 4":
        "e44407141a6ad222e8cd87d43292f6faddc63d9c310cd96c81442d7478b5f338",
    "betas family_eval 5":
        "64daf11e9903424abb85cba57ab5dff813033c9dea14fd26c5414bcaa14b9630",
    "f32 interaction p=1 kr_contract 0":
        "2346c4a35467c56bf9fe0e335e89f75335e66222832ea9e81604a82117836eb5",
    "f32 interaction p=1 kr_contract 1":
        "75645a6e89ab79a097e876a8990b1d799f8c98af572a942dbbb26f6f037309b6",
    "f32 interaction p=1 kr_contract 2":
        "a80deda7a7c38bb12b02d98795d2c22cbd21514b534a1525a6c0b4be69b9012e",
    "f32 interaction p=1 delta_grid 0":
        "923dbdaba0d631e1d8cd877d598dc86d5f40bceba96bf2a7534571e5730faf77",
    "f32 refit p=1 delta_grid 0":
        "8b111367910db67068220d57544a1a184624aae50e6b6d826cf664029eec97e9",
    "f32 interaction p=4 kr_contract 0":
        "ab517de0c49a6f810d3f4a06c4e29b134810fe05a1b80ca54f1bfbc91479190a",
    "f32 interaction p=4 kr_contract 1":
        "2eb9fe023595ea9b6cc75097fc25f75068bd7ae88dc418d82c2d62bc1714b7ca",
    "f32 interaction p=4 kr_contract 2":
        "f24c368aefab9276b1f361a6933f6604ace384c548784bd38ed45377d07ffb4f",
    "f32 interaction p=4 delta_grid 0":
        "7cd792dd115379418212b0cce3673b6205c683ae60ca79d48e75b14e3a725980",
    "f32 betas kr_contract 0":
        "300c12cf336460f20d0baa66a2fa270e45a3b4cf537b99e1418f15f3aa14d4c1",
    "f32 betas kr_contract 1":
        "d089245622ed42a43e9fa72a91817e11d3e4c2f37713bf1e569acbd100838336",
    "f32 betas kr_contract 2":
        "0098cbb96c4dbbf95a418202988f9f4915d756b8b536f603fc9bbded9f7cf0f5",
    "f32 betas family_eval 0":
        "81314ac3c599fc9b585fe25131045705c00f6f12194a7dd2ee9a3ced79edf8cb",
    "f32 betas family_eval 1":
        "a3cfad91ea7b23508210f217b9f7d6332d3fa7e583d05acadd50a132f6bfea51",
    "f32 betas family_eval 2":
        "803384e4b17759ccc719593b30da3baa8c63a50597bd10874b1a20361f36f8b2",
    "f32 betas family_eval 3":
        "9fc1654463f20502edeff545c1956c27dadd349e146e4ad0357b27c9e4baab24",
    "f32 betas family_eval 4":
        "6de95620f4359f1c0351b0f19bca696c13843615f2eae5eb7b5168b9abede52e",
    "f32 betas family_eval 5":
        "bd526da1c8367aecc9aec0626011058f73c233575463795da5cf163a5800c608",
}


@pytest.mark.cuda
def test_unmoved_kernels_bits_unchanged(cuda):
    """Every entry point but K8's, K6b's and the float32 converge's,
    localize's and null fit's (the f64 converge and localize among them)
    returns, bit for bit, what it returned before those were
    redesigned."""
    got = _unmoved_outputs(cuda)
    assert got.keys() == UNMOVED_DIGESTS.keys()
    assert {k: v for k, v in got.items() if v != UNMOVED_DIGESTS[k]} == {}
