"""The card's covariate envelope (p + 1 <= 33, C + p + 2 <= 98, up to 64 rho
points) in the CUDA sources, run on the CPU under the emulator of
``_cuda_emu.py``, against their plain versions.

K2 (the delta grid: its weights, register-tiled product and epilogue
kernels) at p + 1 = 2, 17 and 33 under REML and ML, float32 and float64
working types, with the gene axis and with a per-gene slot; K3's wide
instantiation (each warp's normal equations in shared memory) at
p + 1 = 33 and 21 rho points; K5's wide instantiation (C = 50, p = 24,
and m = C + p + 2 = 98); K8's (p = 24, single phenotype and gene axis).

The operands are the engine's own, recorded on small problems (n = 80 or
fewer cells).  Every output the wrappers allocate starts as NaN
(``nan_outputs``).  Tolerances are those of tests/test_torch_cuda_emulated
.py: a grid bracket on a near-tie neighbour of the plain argmax within
1e-5 (float32) or 1e-12 (float64) of the maximum, the Newton results at
rtol 1e-9 (localize's lml at 1e-10, k_best equal), K5 at 1e-10 and K8 at
1e-12 of each output's largest entry.
"""
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from _cuda_emu import emulated, nan_outputs  # noqa: F401
from _torch_inputs import captured, fit_dataset, score_inputs
from cellregmap_tpu_torch import engine
from cellregmap_tpu_torch.kernels import delta_grid as k2
from cellregmap_tpu_torch.kernels import fast_scan as k8
from cellregmap_tpu_torch.kernels import reml_newton as k3
from cellregmap_tpu_torch.kernels import score_core as k5


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("cuda_emu_wide")
    out = {}
    for name, mod in (("delta_grid", k2), ("reml_newton", k3),
                      ("score_core", k5), ("fast_scan", k8)):
        out[name] = emulated(name, workdir)
        mod._bind(out[name])
    return out


def _recorded(run, names):
    """The wrappers' recorded arguments in the contiguous layout the
    kernels take (the plain versions may hand on transposed views)."""
    c = lambda a: a.contiguous() if isinstance(a, torch.Tensor) else a  # noqa
    return {k: [(tuple(type(a)(*map(c, a)) if isinstance(a, tuple) else c(a)
                       for a in args), kw) for args, kw in v]
            for k, v in captured(run, names).items()}


def _grid_close(lib, call, f32):
    """K2's source against its plain version on one recorded call."""
    args, kw = call
    kw = dict(kw)
    if kw.get("slot") is not None:
        kw["slot"] = torch.as_tensor(kw["slot"])
    br_lo, br_hi = k2.call(lib, *args, **kw)
    kw["slot"] = None if kw.get("slot") is None else call[1]["slot"]
    plo, _, lml = k2.delta_grid_plain(*args, **kw, return_lml=True)
    assert torch.equal(torch.isnan(br_lo), torch.isnan(plo))
    tol = 1e-5 if f32 else 1e-12
    if kw["slot"] is None:
        gap = k2.bracket_shortfall(br_lo, br_hi, lml, args[5], args[6])
        assert gap <= tol, gap
        return
    for g, s in enumerate(kw["slot"]):
        gap = k2.bracket_shortfall(br_lo[g, :, s:s + 1], br_hi[g, :, s:s + 1],
                                   lml[g], args[5], args[6])
        assert gap <= tol, gap


@pytest.mark.parametrize("f32", [True, False])
@pytest.mark.parametrize("restricted", [True, False])
@pytest.mark.parametrize("p1", [2, 17, 33])
def test_delta_grid_source_covariates(libs, p1, restricted, f32):
    """p + 1 = 2 (the register epilogue), 17 and 33 (each lane's system in
    shared memory); at p + 1 = 2, K = 70 crosses a 64-point tile of the
    product."""
    ctx, G, n = fit_dataset(200 + p1, p=p1 - 1, nrho=2, S=5)
    cfg = (-18.0, 18.0, 70 if p1 == 2 else 40, 60)
    if restricted:
        run = lambda: engine.interaction_batch(  # noqa: E731
            ctx, G, G, n, delta_cfg=cfg, localize_f32=f32)
    else:
        run = lambda: engine.association_refit_batch(  # noqa: E731
            ctx, G, 1, n, delta_cfg=cfg, localize_f32=f32)
    (call,) = _recorded(run, ["delta_grid"])["delta_grid"]
    assert call[0][3].CWW.shape[0] + 1 == p1
    _grid_close(libs["delta_grid"], call, f32)


def test_delta_grid_source_wide_gene_axis(libs):
    """Three phenotypes in one launch at p + 1 = 17: the genotype's
    columns once, one g y column per gene."""
    ctx, G, n = fit_dataset(230, p=16, nrho=3, S=6)
    rng = np.random.default_rng(230)
    Y = ctx.y[None] + 0.4 * torch.as_tensor(rng.normal(size=(3, n)))
    ctx_g = ctx._replace(y=Y, Zy=Y @ ctx.Z, Wy=Y @ ctx.W,
                         yy=(Y * Y).sum(dim=1))
    (call,) = _recorded(lambda: engine.interaction_multigene_batch(
        ctx_g, G, G, n, delta_cfg=(-18.0, 18.0, 20, 60)),
        ["delta_grid"])["delta_grid"]
    assert call[0][2].shape[0] == 3
    _grid_close(libs["delta_grid"], call, True)


def test_delta_grid_source_gene_chunks(tmp_path):
    """Five genes through a scratch cap of one gene a chunk (the source
    built with an 8 KB chunk): the weights once, the genotype's columns and
    W W sums in the first chunk, each chunk's g y and W y, y^2 after."""
    lib = emulated("delta_grid", tmp_path,
                   defines=["CRM_GRID_CHUNK_BYTES=8192"])
    k2._bind(lib)
    ctx, G, n = fit_dataset(235, p=3, nrho=2, S=6)
    rng = np.random.default_rng(235)
    Y = ctx.y[None] + 0.4 * torch.as_tensor(rng.normal(size=(5, n)))
    ctx_g = ctx._replace(y=Y, Zy=Y @ ctx.Z, Wy=Y @ ctx.W,
                         yy=(Y * Y).sum(dim=1))
    (call,) = _recorded(lambda: engine.interaction_multigene_batch(
        ctx_g, G, G, n, delta_cfg=(-18.0, 18.0, 20, 60)),
        ["delta_grid"])["delta_grid"]
    args = call[0]
    per_gene = 2 * 64 * (6 + 2 * 4) * 4     # nrho Kp (nS + 2 (p + 1)) f32
    assert 8192 // 2 < per_gene <= 8192      # one gene a chunk
    _grid_close(lib, call, True)


@pytest.mark.parametrize("f32", [True, False])
def test_delta_grid_source_wide_slot(libs, f32):
    """Each gene at its own slot (p + 1 = 25, ML): its shared sums and its
    epilogue at that slot alone."""
    ctx, G, n = fit_dataset(240, p=24, nrho=3, S=6)
    rng = np.random.default_rng(240)
    Y = ctx.y[None] + 0.4 * torch.as_tensor(rng.normal(size=(3, n)))
    ctx_g = ctx._replace(y=Y, Zy=Y @ ctx.Z, Wy=Y @ ctx.W,
                         yy=(Y * Y).sum(dim=1))
    (call,) = _recorded(lambda: engine.association_refit_multigene_batch(
        ctx_g, G, np.array([2, 0, 2]), n, delta_cfg=(-18.0, 18.0, 24, 60),
        localize_f32=f32), ["delta_grid"])["delta_grid"]
    assert list(call[1]["slot"]) == [1, 0, 1]
    _grid_close(libs["delta_grid"], call, f32)


def test_reml_newton_source_wide(libs, f32=True):
    """K3's wide instantiation at p + 1 = 33 over 21 rho points (a
    localize block's warps loop over them): localize (REML, the f32-rounded
    steps) and converge under REML and ML."""
    ctx, G, n = fit_dataset(250, p=32, nrho=21, S=3)
    reml = _recorded(lambda: engine.interaction_batch(
        ctx, G, G, n, delta_cfg=(-18.0, 18.0, 16, 60), newton_f32=2,
        newton_f64=2, localize_f32=f32), ["reml_localize", "reml_converge"])
    ml = _recorded(lambda: engine.association_refit_batch(
        ctx, G, 20, n, delta_cfg=(-18.0, 18.0, 16, 60), localize_f32=f32,
        newton_f64=2), ["reml_converge"])
    lib = libs["reml_newton"]
    (args, kw), = reml["reml_localize"]
    assert args[0].shape[0] == 21 and args[3].CWW.shape[0] == 32
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


@pytest.mark.parametrize("C,p", [(50, 24), (64, 32)])
def test_score_core_source_wide(libs, C, p):
    """K5's wide instantiation: m = C + p + 2 = 76 and 98 columns."""
    args = [torch.as_tensor(a)
            for a in score_inputs(C + p, C=C, p=p, n=60, R=37, S=3)]
    Q, Wmat = k5.call(libs["score_core"], *args)
    Qr, Wr = k5.score_core_plain(*args)
    for got, want in ((Q, Qr), (Wmat, Wr)):
        err = float((got - want).abs().max())
        assert err <= 1e-10 * float(want.abs().max()), err


@pytest.mark.parametrize("genes", [0, 3])
def test_fast_scan_source_wide(libs, genes):
    """K8's wide instantiation at p = 24: one phenotype, and three genes
    on two slots (one gene a block)."""
    ctx, G, n = fit_dataset(260 + genes, p=24, nrho=3, S=37)
    if genes == 0:
        calls = _recorded(lambda: engine.fast_scan_batch(ctx, G, 1, 0.41, n),
                         ["fast_scan"])
        (args, kw), = calls["fast_scan"]
        got = k8.call(libs["fast_scan"], *args, **kw)
        want = k8.fast_scan_plain(*args, **kw)
    else:
        rng = np.random.default_rng(260)
        Y = ctx.y[None] + 0.4 * torch.as_tensor(rng.normal(size=(3, n)))
        ctx_g = ctx._replace(y=Y, Zy=Y @ ctx.Z, Wy=Y @ ctx.W,
                             yy=(Y * Y).sum(dim=1))
        delta = torch.tensor([0.3, 0.5, 0.7], dtype=torch.float64)
        calls = _recorded(lambda: engine.fast_scan_multigene_batch(
            ctx_g, G, np.array([1, 0, 1]), delta, n), ["fast_scan"])
        (args, kw), = calls["fast_scan"]
        slot = kw["slot"]
        index = torch.as_tensor(k8.slot_order(slot, args[1].shape[0]))
        got = k8.call_genes(libs["fast_scan"], *args, slot=slot, index=index)
        want = k8.fast_scan_genes_plain(*args, slot=slot)
    for g, w in zip(got, want):
        assert g.shape[-1 if g.ndim == 1 else 0] > 0
        err = float((g - w).abs().max())
        assert err <= 1e-12 * float(w.abs().max()), err
