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
``woodbury_family.f32_gaps``.
"""
import numpy as np
import pytest
import torch

from _torch_inputs import (betas_dataset, captured, fit_dataset, kr_inputs,
                           rotate_inputs, score_inputs)

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
    got = k4.best_rho_rotate(V, T, kb)
    assert k4.launches == before + 1
    _close(got, k4.best_rho_rotate_plain(V, T, kb), 1e-12)


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
                                       "woodbury_family": 0}
    pv_c, info_c = crp.run_interaction(y, E, G, hK=hK, config=cfg,
                                       device="cpu")
    assert np.max(np.abs(pv_g - pv_c)) <= 1e-8
    assert np.array_equal(info_g["rho1"], info_c["rho1"])


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
        (args, kw), = calls["reml_converge"]
        got = k3.reml_converge(*args, **kw)
        want = k3.reml_converge_plain(*args, **kw)
        for g, w in zip(got, want):
            assert float(((g - w).abs() / w.abs()).max()) <= 1e-9


@pytest.mark.cuda
@pytest.mark.parametrize("p", [1, 2, 5])
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
    assert kernels.launch_counts() == {"kr_contract": 0, "delta_grid": 4,
                                       "reml_newton": 4,
                                       "best_rho_rotate": 0,
                                       "score_core": 0, "null_fit": 1,
                                       "fast_scan": 0,
                                       "woodbury_family": 0}
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
@pytest.mark.parametrize("C,n,donors,S", [(10, 2000, 100, 64),
                                          (31, 800, 20, 24),
                                          (50, 400, 6, 8)])
def test_woodbury_family_kernel_matches_plain(cuda, C, n, donors, S):
    """The effect sizes' K9 calls at the headline's q = 23 (Rk = 1000),
    q = 65 and q = 103."""
    from cellregmap_tpu_torch import engine
    from cellregmap_tpu_torch.kernels import woodbury_family as k9

    bctx, G, norm, n = betas_dataset(C, n=n, C=C, donors=donors, S=S,
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
