"""The port's CUDA kernel sources, run on the CPU under an emulator, against
their plain torch versions.

The card alone compiles the kernels for real (tests/test_torch_cuda.py and
chip_smoke.py).  Here each ``csrc/*.cu`` is compiled by g++ against a small
header that emulates the CUDA subset the kernels use: a launch runs its
blocks one after another, each block as one std::thread per CUDA thread,
``__shared__`` arrays are block-wide statics, ``__syncthreads`` is a
std::barrier and a warp shuffle is an exchange through one of two
per-warp buffers, alternating, behind one per-warp barrier.  That runs
the kernels' own indexing, tiling, masking and synchronisation at small
shapes, on every test run.

Tolerance: the emulated kernel sums in its own order (FMA on the host), so
it agrees with the plain versions at 1e-12 of the output's largest entry
(1e-10 for K5, whose K0^{-1} forms subtract nearly equal Grams).  The fits
(K2, K3, K7, K10) are held on their own terms: a grid bracket may sit on
a near-tie neighbour of the plain argmax (its plain lml within 1e-5 of the
maximum in float32, 1e-12 in float64); the Newton results at rtol 1e-9 (a
few f64 steps from the same bracket, summed in another order); the
golden-section fits through ``null_fit.fit_gaps`` at 1e-10.  K9 in float64
at 1e-10 of max(|lml|, 1); in float32 the first zoom round spans the whole
delta range, where float32 resolves the lml only to a few percent, so the
kernel is held to the f64 lml at no more than twice the plain float32
version's distance from it (``woodbury_family.f32_gaps``).
"""
import ctypes

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from _cuda_emu import emulated, nan_outputs  # noqa: F401
from _torch_inputs import (assert_tails_close, betas_dataset, captured,
                           fit_dataset, kr_inputs, rotate_inputs,
                           score_inputs, tail_battery)
from cellregmap_tpu_torch import engine
from cellregmap_tpu_torch.kernels import best_rho_rotate as k4
from cellregmap_tpu_torch.kernels import delta_grid as k2
from cellregmap_tpu_torch.kernels import fast_scan as k8
from cellregmap_tpu_torch.kernels import kr_contract as k1
from cellregmap_tpu_torch.kernels import mixture_tails as k6b
from cellregmap_tpu_torch.kernels import null_fit as k10
from cellregmap_tpu_torch.kernels import reml_newton as k3
from cellregmap_tpu_torch.kernels import score_core as k5
from cellregmap_tpu_torch.kernels import sym_eigvalsh as k6a
from cellregmap_tpu_torch.kernels import woodbury_family as k9

CASES = [(C, p) for C in (3, 10, 50) for p in (1, 2)]
# (p, nrho, float32 working type) of the fits; p = 5 takes the kernels'
# 16-wide instantiation
FIT_CASES = [(p, nrho, f32) for p in (1, 2) for nrho in (1, 3)
             for f32 in (True, False)] + [(5, 3, True)]


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("cuda_emu")
    out = {}
    for name, mod in (("kr_contract", k1), ("best_rho_rotate", k4),
                      ("score_core", k5), ("delta_grid", k2),
                      ("reml_newton", k3), ("null_fit", k10),
                      ("fast_scan", k8), ("woodbury_family", k9),
                      ("sym_eigvalsh", k6a), ("mixture_tails", k6b)):
        out[name] = emulated(name, workdir)
        mod._bind(out[name])
    return out


def _p(t):
    return ctypes.c_void_p(t.data_ptr())


def _close(got, want, rel):
    err = float((got - want).abs().max())
    assert err <= rel * float(want.abs().max()), err


@pytest.mark.parametrize("C,p", CASES)
def test_kr_contract_source_matches_plain(libs, C, p):
    U, _, G = (torch.as_tensor(a) for a in kr_inputs(C + p, n=70, K=C + 69,
                                                        S=37))
    for width in (C, p):
        V = torch.as_tensor(np.random.default_rng(width).normal(
            size=(U.shape[0], width)))
        n, K = U.shape
        S = G.shape[1]
        M = torch.full((K, width, S), np.nan, dtype=torch.float64)
        err = libs["kr_contract"].crm_kr_contract(
            _p(U), _p(V), _p(G), _p(M), n, K, width, S, None)
        assert err == 0
        _close(M, k1.kr_contract_plain(U, V, G), 1e-12)


def test_kr_contract_source_at_the_betas_widths(libs):
    """The effect sizes' contractions: U = Zk with K = Rk past two 64-row
    tiles, V = E0 or the reduced design B (11 columns)."""
    bctx, G, _, _ = betas_dataset(3, C=10, donors=15, n=200, S=9)
    calls = captured(lambda: engine.predict_interaction_batch(
        bctx, G, torch.ones(9, dtype=torch.float64), 200), ["kr_contract"])
    assert bctx.Zk.shape[1] > 128 and bctx.B.shape[1] == 11
    for args, _ in _contiguous(calls)["kr_contract"]:
        U, V, Gm = args
        M = torch.full((U.shape[1], V.shape[1], Gm.shape[1]), np.nan,
                       dtype=torch.float64)
        assert libs["kr_contract"].crm_kr_contract(
            _p(U), _p(V), _p(Gm), _p(M), U.shape[0], U.shape[1], V.shape[1],
            Gm.shape[1], None) == 0
        _close(M, k1.kr_contract_plain(U, V, Gm), 1e-12)


def _rotate_close(lib, V, T, kb):
    """K4's source against its plain version: the slots equal, the
    gathered factors within 1e-12 of max|plain|; returns the slots."""
    At, slot = k4.call(lib, V, T, kb)
    At_p, slot_p = k4.best_rho_rotate_plain(V, T, kb)
    assert At.shape == At_p.shape and torch.equal(slot, slot_p)
    _close(k4.gather(At, slot), k4.gather(At_p, slot_p), 1e-12)
    return At, slot


@pytest.mark.parametrize("C,p", CASES)
def test_best_rho_rotate_source_matches_plain(libs, C, p):
    V, T, kb = (torch.as_tensor(a)
                for a in rotate_inputs(C + p, R=130, C=C, S=5 + p))
    At, _ = _rotate_close(libs["best_rho_rotate"], V, T, kb)
    assert At.shape == (1, 5 + p, 130, C)


@pytest.mark.parametrize("genes", [1, 3])
def test_best_rho_rotate_source_gene_axis(libs, genes):
    """k_best (genes, S): every gene's variants rotated from the one T,
    each distinct (rho, variant) pair once."""
    V, T, _ = (torch.as_tensor(a) for a in rotate_inputs(5, R=70, C=4, S=6))
    rng = np.random.default_rng(genes)
    kb = torch.as_tensor(rng.integers(0, V.shape[0], size=(genes, 6)))
    At, _ = _rotate_close(libs["best_rho_rotate"], V, T, kb)
    assert At.shape == (genes, 6, 70, 4)


@pytest.mark.parametrize("C,p", CASES)
def test_score_core_source_matches_plain(libs, C, p):
    args = [torch.as_tensor(a)
            for a in score_inputs(C + p, C=C, p=p, n=80, R=37, S=6)]
    Q, Wmat = k5.call(libs["score_core"], *args)
    Qr, Wr = k5.score_core_plain(*args)
    _close(Q, Qr, 1e-10)
    _close(Wmat, Wr, 1e-10)


# the phenotype's operands of score_core (yt, Wy, gy, Ay, k_best, v0, v1,
# slot), by position, and the slots' (At)
SCORE_GENE_ARGS = (2, 5, 8, 11, 13, 14, 15, 16)
SCORE_AT = 3


@pytest.mark.parametrize("genes", [1, 3])
def test_score_core_source_gene_axis(libs, genes):
    """Per-gene operands stacked on a leading axis (each gene's own seeded
    phenotype), the genotype's shared, each gene's two factor slots
    appended to one At (gene g's slots at 2 g, 2 g + 1): one launch, each
    gene as alone."""
    per = [[torch.as_tensor(a)
            for a in score_inputs(9, C=4, p=2, n=60, R=31, S=5)]]
    for g in range(1, genes):
        other = [torch.as_tensor(a)
                 for a in score_inputs(9 + g, C=4, p=2, n=60, R=31, S=5)]
        per.append([other[i] if i in SCORE_GENE_ARGS + (SCORE_AT,)
                    else per[0][i] for i in range(len(other))])
    args = [torch.stack([a[i] for a in per]) if i in SCORE_GENE_ARGS
            else per[0][i] for i in range(len(per[0]))]
    args[SCORE_AT] = torch.cat([a[SCORE_AT] for a in per])
    args[16] = args[16] + 2 * torch.arange(genes)[:, None]
    Q, Wmat = k5.call(libs["score_core"], *args)
    assert Q.shape == (genes, 5) and Wmat.shape == (genes, 5, 4, 4)
    for g, a in enumerate(per):
        Qr, Wr = k5.score_core_plain(*a)
        _close(Q[g], Qr, 1e-10)
        _close(Wmat[g], Wr, 1e-10)


def _contiguous(calls):
    """The recorded arguments in the contiguous layout the kernels take
    (the plain versions may hand on transposed views)."""
    c = lambda a: a.contiguous() if isinstance(a, torch.Tensor) else a  # noqa
    return {k: [(tuple(type(a)(*map(c, a)) if isinstance(a, tuple) else c(a)
                       for a in args), kw) for args, kw in v]
            for k, v in calls.items()}


def _fit_calls(p, nrho, f32, seed=0):
    """The wrappers' arguments on the interaction path (REML) and on the
    association refit (ML), as the engine gives them on the CPU."""
    ctx, G, n = fit_dataset(seed + 10 * p + nrho, p=p, nrho=nrho)
    reml = captured(lambda: engine.interaction_batch(
        ctx, G, G, n, delta_cfg=(-18.0, 18.0, 20, 60), localize_f32=f32),
        ["delta_grid", "reml_localize", "reml_converge"])
    ml = captured(lambda: engine.association_refit_batch(
        ctx, G, nrho // 2, n, delta_cfg=(-18.0, 18.0, 40, 60),
        localize_f32=f32), ["delta_grid", "reml_converge"])
    return _contiguous(reml), _contiguous(ml)


def _gene_fit_calls(genes, p=2, nrho=3, f32=True, seed=5):
    """The K2/K3 wrappers' arguments of a gene-batched interaction batch:
    ``genes`` phenotypes sharing one null context."""
    ctx, G, n = fit_dataset(seed, p=p, nrho=nrho)
    rng = np.random.default_rng(seed)
    Y = ctx.y[None] + 0.4 * torch.as_tensor(rng.normal(size=(genes, n)))
    ctx_g = ctx._replace(y=Y, Zy=Y @ ctx.Z, Wy=Y @ ctx.W,
                         yy=(Y * Y).sum(dim=1))
    calls = captured(lambda: engine.interaction_multigene_batch(
        ctx_g, G, G, n, delta_cfg=(-18.0, 18.0, 20, 60),
        device_pvalues=False, localize_f32=f32),
        ["delta_grid", "reml_localize", "reml_converge", "best_rho_rotate",
         "score_core"])
    return _contiguous(calls)


@pytest.mark.parametrize("genes", [1, 3])
def test_fit_sources_gene_axis(libs, genes):
    """K2 and K3 on a gene-batched batch: the brackets held as in the
    single-phenotype tests, the Newton results at rtol 1e-9, and each
    gene's slice of a launch equal to that gene's own plain version."""
    calls = _gene_fit_calls(genes)
    (args, kw), = calls["delta_grid"]
    assert args[2].shape[0] == genes
    br_lo, br_hi = k2.call(libs["delta_grid"], *args, **kw)
    _, _, lml = k2.delta_grid_plain(*args, **kw, return_lml=True)
    assert lml.shape[0] == genes
    assert k2.bracket_shortfall(br_lo, br_hi, lml, args[5], args[6]) <= 1e-5
    lib = libs["reml_newton"]
    (args, kw), = calls["reml_localize"]
    x, lml_all, kb = k3.call_localize(lib, *args, **kw)
    xp, lml_p, kb_p = k3.reml_localize_plain(*args, **kw)
    assert kb.shape == (genes, 7) and torch.equal(kb, kb_p)
    assert_allclose(x.numpy(), xp.numpy(), rtol=1e-9, atol=1e-9)
    assert_allclose(lml_all.numpy(), lml_p.numpy(), rtol=1e-10)
    (args, kw) = calls["reml_converge"][0]
    got = k3.call_converge(lib, *args, **kw)
    want = k3.reml_converge_plain(*args, **kw)
    for g, w, name in zip(got, want, ("delta", "lml", "scale", "beta")):
        assert g.shape[0] == genes
        assert_allclose(g.numpy(), w.numpy(), rtol=1e-9, atol=1e-12,
                        err_msg=name)
    (args, _), = calls["best_rho_rotate"]
    _rotate_close(libs["best_rho_rotate"], *args)
    (args, _), = calls["score_core"]
    for got, want in zip(k5.call(libs["score_core"], *args),
                         k5.score_core_plain(*args)):
        _close(got, want, 1e-10)


@pytest.mark.parametrize("p,nrho,f32", FIT_CASES)
def test_delta_grid_source_matches_plain(libs, p, nrho, f32):
    for calls in _fit_calls(p, nrho, f32):
        (args, kw), = calls["delta_grid"]
        br_lo, br_hi = k2.call(libs["delta_grid"], *args, **kw)
        _, _, lml = k2.delta_grid_plain(*args, **kw, return_lml=True)
        lo, hi = args[5], args[6]
        gap = k2.bracket_shortfall(br_lo, br_hi, lml, lo, hi)
        assert gap <= (1e-5 if f32 else 1e-12), gap


@pytest.mark.parametrize("p,nrho,f32", FIT_CASES)
def test_reml_newton_source_matches_plain(libs, p, nrho, f32):
    reml, ml = _fit_calls(p, nrho, f32)
    lib = libs["reml_newton"]
    (args, kw), = reml["reml_localize"]
    x, lml_all, kb = k3.call_localize(lib, *args, **kw)
    xp, lml_p, kb_p = k3.reml_localize_plain(*args, **kw)
    assert torch.equal(kb, kb_p)
    assert_allclose(x.numpy(), xp.numpy(), rtol=1e-9, atol=1e-9)
    assert_allclose(lml_all.numpy(), lml_p.numpy(), rtol=1e-10)
    for calls in (reml, ml):
        (args, kw) = calls["reml_converge"][0]
        got = k3.call_converge(lib, *args, **kw)
        want = k3.reml_converge_plain(*args, **kw)
        for g, w, name in zip(got, want, ("delta", "lml", "scale", "beta")):
            assert_allclose(g.numpy(), w.numpy(), rtol=1e-9, atol=1e-12,
                            err_msg=name)


# p = 20 and 52 take the wide (shared-memory) instantiation
@pytest.mark.parametrize("p", [1, 2, 5, 20, 52])
@pytest.mark.parametrize("restricted", [False, True])
def test_null_fit_source_matches_plain(libs, p, restricted):
    ctx, G, n = fit_dataset(40 + p, p=p, nrho=3)
    M = torch.cat([ctx.W, G[:, :1]], dim=1) if restricted else ctx.W
    calls = captured(lambda: engine._fit_over_rho(
        ctx, ctx.Z.T @ M, M.T @ M, M.T @ ctx.y, n, restricted,
        (-18.0, 18.0, 24, 30)), ["null_fit"])
    (args, kw), = calls["null_fit"]
    fits = k10.call(libs["null_fit"], *args, **kw)
    plain = k10.null_fit_plain(*args, **kw)
    gaps = k10.fit_gaps(fits, plain, args[0], n, restricted)
    assert max(gaps.values()) <= 1e-10, gaps


@pytest.mark.parametrize("p,nrho", [(1, 1), (2, 3), (5, 3)])
def test_fast_scan_source_matches_plain(libs, p, nrho):
    ctx, G, n = fit_dataset(60 + p, p=p, nrho=nrho, S=70)
    calls = captured(lambda: engine.fast_scan_batch(ctx, G, nrho // 2, 0.41,
                                                    n), ["fast_scan"])
    (args, kw), = _contiguous(calls)["fast_scan"]
    got = k8.call(libs["fast_scan"], *args, **kw)
    want = k8.fast_scan_plain(*args, **kw)
    for g, w in zip(got, want):
        _close(g, w, 1e-12)


def _family_calls(seed, C, p=1, donors=8, n=80, S=3, f32=True):
    """K9's arguments on the effect-size path at small shapes: the zoom
    rounds' (float32 with ``f32``) and the final float64 call with the
    coefficients."""
    bctx, G, norm, n = betas_dataset(seed, p=p, n=n, C=C, donors=donors, S=S)
    calls = captured(lambda: engine.predict_interaction_batch(
        bctx, G, norm, n, localize_f32=f32), ["family_eval"])
    return _contiguous(calls)["family_eval"]


def _family_close(lib, args, kw):
    """K9's source against its plain version on one call: float64 lml at
    1e-10 of max(|lml|, 1) with the same non-finite points, beta and rss at
    1e-9 of their largest entry; float32 through ``f32_gaps`` (module
    doc)."""
    got = k9.call(lib, *args, **kw)
    if args[0].dtype == torch.float32:
        gaps = k9.f32_gaps(got, args, kw)
        assert gaps["mask"] == 0 and gaps["excess"] <= 1e-5, gaps
        return got
    want = k9.family_eval_plain(*args, **kw)
    if not kw.get("want_beta"):
        got, want = (got,), (want,)
    gaps = k9.lml_gaps(got[0], want[0])
    assert gaps["mask"] == 0 and gaps["rel"] <= 1e-10, gaps
    for g, w in zip(got[1:], want[1:]):
        _close(g, w, 1e-9)
    return got[0]


# (C, p, donors): q = C + rank[W, E] + 2 is 7 and 10 (4 points a thread
# item), 47 (past the 44-column tile of the 4-point items: one point an
# item); Rk = C donors crosses the 32-row chunk
@pytest.mark.parametrize("C,p,donors", [(3, 1, 11), (4, 2, 9), (22, 1, 3)])
def test_woodbury_family_source_matches_plain(libs, C, p, donors):
    lib = libs["woodbury_family"]
    calls = _family_calls(70 + C, C, p=p, donors=donors)
    assert [a[0].dtype for a, _ in calls] == [torch.float32] * 5 \
        + [torch.float64] * 4
    assert calls[-1][1].get("want_beta")
    # one call of each kind: the first f32 round (the whole delta range),
    # the first f64 round (top-2 rho) and the fit with coefficients
    for args, kw in (calls[0], calls[5], calls[-1]):
        _family_close(lib, args, kw)


def test_woodbury_family_source_masks_collapsed_f32_points(libs):
    """A float32 point whose bordered Gram is not positive definite (here a
    variant whose y complement is made negative) is -inf in both versions;
    the other variants stay finite."""
    args, kw = _family_calls(5, 3)[0]
    assert args[0].dtype == torch.float32
    comp = args[3].clone()
    comp[0, -1, -1] = -1e30
    args = (*args[:3], comp, *args[4:])
    lml = _family_close(libs["woodbury_family"], args, kw)
    assert bool(torch.isneginf(lml[0]).all())
    assert bool(torch.isfinite(lml[1:]).all())


@pytest.mark.parametrize("C", [3, 10, 50])
def test_sym_eigvalsh_source_matches_plain(libs, C):
    """K6a (Jacobi a warp a matrix up to C = 32, Householder and bisection
    above) against the shifted eigvalsh, ascending and clamped, within
    1e-12 of each row's largest |lambda|; the matrices are K5's (through
    ``score_inputs``) plus an exactly rank-deficient one and a
    non-symmetric one."""
    args = [torch.as_tensor(a)
            for a in score_inputs(C + 7, C=C, p=1, n=80, R=37, S=4)]
    _, Wmat = k5.score_core_plain(*args)
    rng = np.random.default_rng(C)
    B = torch.as_tensor(rng.normal(size=(C, max(C // 2, 1))))
    A = torch.cat([Wmat, (B @ B.T)[None],
                   torch.as_tensor(rng.normal(size=(1, C, C)))])
    lam, sweeps = k6a.call(libs["sym_eigvalsh"], A, return_sweeps=True)
    want = k6a.sym_eigvalsh_plain(A)
    scale = want.abs().amax(dim=1, keepdim=True).clamp(min=1e-300)
    assert float(((lam - want).abs() / scale).max()) <= 1e-12
    assert bool((lam[:, 1:] >= lam[:, :-1]).all()) and bool((lam >= 0).all())
    # Jacobi sweeps up to 32 contexts, bisection steps above
    cap = k6a.MAX_SWEEPS if C <= k6a.WARP_MAX_C else k6a.MAX_BISECT
    assert 0 < int(sweeps.max()) < cap


@pytest.mark.parametrize("C", [3, 10, 50])
def test_mixture_tails_source_matches_plain(libs, C):
    """K6b against the torch ports of the JAX package's tails (1e-9
    relative, floor 1e-300; the kernel's gammaincc is its own series and
    continued fraction, torch's is Cephes')."""
    q, lam = (torch.as_tensor(a) for a in tail_battery(C, C=C))
    got = k6b.call(libs["mixture_tails"], q, lam)
    want = k6b.mixture_tails_plain(q, lam)
    assert_tails_close(got, want)
    liu = want[0][~torch.isnan(want[0])]
    assert float(liu.min()) < 1e-20
