"""K4 (``csrc/best_rho_rotate.cu``), K5 reading its factors through K4's
slots (``csrc/score_core.cu``) and K3's register localize
(``csrc/reml_newton.cu``, p + 1 <= 4) under the CPU emulator
(``_cuda_emu.py``), against their plain versions.

K4 stores each distinct (rho, variant) pair's factor once: the slots must
equal the plain version's and the factors gathered through them agree
within 1e-12 of the largest (the same f64 products summed in another
order), for one gene, genes that all pick one rho, genes that all pick
different ones and more genes than rho points.  K5 on K4's emulated
slots at 1e-10 (its K0^{-1} forms subtract nearly equal Grams).  The
localize at p + 1 = 2 and 4, one and three genes, with and without the
f32 rounding of the Newton steps, and 1, 11 and 70 rho points (past the
64 that a block held before): k_best equal, x at rtol 1e-9 and the lml at
1e-10, as ``test_torch_cuda_emulated.py`` holds it.  At 70 points the
grid holds every rho twice, so that each best rho ties with its twin and
the first of the two must win.
"""
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from _cuda_emu import emulated, nan_outputs  # noqa: F401
from _torch_inputs import captured, fit_dataset, rotate_inputs
from cellregmap_tpu_torch import engine
from cellregmap_tpu_torch.kernels import best_rho_rotate as k4
from cellregmap_tpu_torch.kernels import reml_newton as k3
from cellregmap_tpu_torch.kernels import score_core as k5


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    """The emulated libraries; the localize's blocks at 4 warps (a tile of
    4 variants of one gene, or of 1 variant and up to 4 genes), which
    the emulator runs ~4x faster than the card's 16
    (test_torch_cuda_emulated.py runs those), and with 16 KB of shared
    memory, where the test's R = 36 rows stay resident with the
    variants' products, or at p = 3 and one gene (4 variants) with their
    g alone; a second build stages them in chunks through the raw
    buffers, in 10 KB, where every case's chunk is 32 rows, so that each
    pass takes two chunks (the card's 227 KB hold every row of those
    tests)."""
    workdir = tmp_path_factory.mktemp("cuda_emu_k3_k4")
    out = {}
    warps = "CRM_LOC_MAX_WARPS=4"
    for key, name, mod, defines in (
            ("best_rho_rotate", "best_rho_rotate", k4, ()),
            ("score_core", "score_core", k5, ()),
            ("reml_newton", "reml_newton", k3, (warps, "CRM_LOC_SMEM_KB=16")),
            ("chunked", "reml_newton", k3,
             (warps, "CRM_LOC_SMEM_KB=10", "CRM_LOC_CHUNKED"))):
        (workdir / key).mkdir()
        out[key] = emulated(name, workdir / key, defines)
        mod._bind(out[key])
    return out


def _close(got, want, rel):
    err = float((got - want).abs().max())
    assert err <= rel * float(want.abs().max()), err


def _rotate_close(lib, V, T, kb):
    At, slot = k4.call(lib, V, T, kb)
    At_p, slot_p = k4.best_rho_rotate_plain(V, T, kb)
    assert At.shape == At_p.shape and torch.equal(slot, slot_p)
    _close(k4.gather(At, slot), k4.gather(At_p, slot_p), 1e-12)
    return At, slot


def _k_best(pattern, genes, nrho, S, seed):
    rng = np.random.default_rng(seed)
    if pattern == "one":          # every gene on one rho
        kb = np.full((genes, S), nrho // 2)
    elif pattern == "distinct":   # every gene on its own rho
        kb = np.stack([rng.permutation(nrho)[:genes] for _ in range(S)]).T
    else:
        kb = rng.integers(0, nrho, size=(genes, S))
    return torch.as_tensor(np.ascontiguousarray(kb, dtype=np.int64))


# (genes, nrho, pattern)
ROTATE_CASES = [(1, 3, "one"), (1, 11, "random"), (3, 3, "distinct"),
                (3, 11, "one"), (3, 11, "distinct"), (13, 3, "random"),
                (13, 11, "random"), (13, 11, "one")]


@pytest.mark.parametrize("genes,nrho,pattern", ROTATE_CASES)
def test_best_rho_rotate_slots(libs, genes, nrho, pattern):
    V, T, _ = (torch.as_tensor(a)
               for a in rotate_inputs(genes + nrho, nrho=nrho, R=37, C=3,
                                      S=9))
    kb = _k_best(pattern, genes, nrho, 9, genes * nrho)
    if genes == 1:
        kb = kb[0]
    At, slot = _rotate_close(libs["best_rho_rotate"], V, T, kb)
    assert At.shape == (min(genes, nrho), 9, 37, 3)
    distinct = [len(set(kb.reshape(-1, 9)[:, s].tolist())) for s in range(9)]
    assert int(slot.max()) == max(distinct) - 1
    if pattern == "one":
        assert not bool(slot.any())


@pytest.mark.parametrize("genes", [1, 3, 13])
def test_score_core_through_the_slots(libs, genes):
    """K4's emulated slots of a gene-batched interaction batch (11 rho
    points), then K5 on them: one launch, each gene at 1e-10 of its plain
    version."""
    ctx, G, n = fit_dataset(90 + genes, p=2, nrho=11, S=6)
    rng = np.random.default_rng(genes)
    Y = ctx.y[None] + 0.5 * torch.as_tensor(rng.normal(size=(genes, n)))
    ctx_g = ctx._replace(y=Y, Zy=Y @ ctx.Z, Wy=Y @ ctx.W,
                         yy=(Y * Y).sum(dim=1))
    calls = captured(lambda: engine.interaction_multigene_batch(
        ctx_g, G, G, n, delta_cfg=(-18.0, 18.0, 20, 60),
        device_pvalues=False), ["best_rho_rotate", "score_core"])
    (rot, _), = calls["best_rho_rotate"]
    (args, _), = calls["score_core"]
    At, slot = _rotate_close(libs["best_rho_rotate"], *rot)
    args = list(args)
    args[3], args[16] = At, slot
    Q, Wmat = k5.call(libs["score_core"], *args)
    Qr, Wr = k5.score_core_plain(*args)
    assert Q.shape == (genes, 6) and Wmat.shape == (genes, 6, 3, 3)
    _close(Q, Qr, 1e-10)
    _close(Wmat, Wr, 1e-10)


def _localize_call(p, genes, nrho, round32, S):
    """reml_localize's arguments on a (gene-batched) interaction batch of
    S variants, with two Newton steps (the emulator spends ~0.1 ms on a
    warp shuffle, and a step of one problem takes ~500 of them); at 70 rho
    points the grid holds 35 points twice each."""
    grid = (np.repeat(np.linspace(0, 1, nrho // 2), 2) if nrho == 70
            else np.linspace(0, 1, nrho))
    ctx, G, n = fit_dataset(7 * p + nrho, p=p, nrho=nrho, S=S, n=60,
                            donors=12, rho_grid=grid)
    if genes > 1:
        rng = np.random.default_rng(p + genes)
        Y = ctx.y[None] + 0.4 * torch.as_tensor(rng.normal(size=(genes, n)))
        ctx = ctx._replace(y=Y, Zy=Y @ ctx.Z, Wy=Y @ ctx.W,
                           yy=(Y * Y).sum(dim=1))
    calls = captured(lambda: engine.interaction_batch(
        ctx, G, G, n, delta_cfg=(-18.0, 18.0, 12, 60),
        localize_f32=round32), ["reml_localize"])
    (args, kw), = calls["reml_localize"]
    assert args[0].shape == (nrho, 36) and args[3].CWW.shape[0] == p
    return (*args[:8], 2, *args[9:]), kw       # steps


def _localize_close(lib, p, genes, round32, nrho):
    S = 4 if nrho == 1 else 2
    args, kw = _localize_call(p, genes, nrho, round32, S)
    x, lml_all, kb = k3.call_localize(lib, *args, **kw)
    xp, lml_p, kb_p = k3.reml_localize_plain(*args, **kw)
    assert kb.shape == (() if genes == 1 else (genes,)) + (S,)
    assert torch.equal(kb, kb_p)
    assert_allclose(x.numpy(), xp.numpy(), rtol=1e-9, atol=1e-9)
    assert_allclose(lml_all.numpy(), lml_p.numpy(), rtol=1e-10)
    if nrho == 70:
        # each point's twin evaluates to the same lml: the first one wins
        assert torch.equal(lml_all[..., 0::2], lml_all[..., 1::2])
        assert not bool((kb % 2).any())


@pytest.mark.parametrize("nrho", [1, 11, 70])
@pytest.mark.parametrize("round32", [True, False])
@pytest.mark.parametrize("genes", [1, 3])
@pytest.mark.parametrize("p", [1, 3])
def test_register_localize(libs, p, genes, round32, nrho):
    _localize_close(libs["reml_newton"], p, genes, round32, nrho)


@pytest.mark.parametrize("genes", [1, 3])
@pytest.mark.parametrize("p", [1, 3])
def test_register_localize_chunked(libs, p, genes):
    """The rows staged in chunks through the raw buffers."""
    _localize_close(libs["chunked"], p, genes, True, 11)
