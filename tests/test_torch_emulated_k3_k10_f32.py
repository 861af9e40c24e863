"""The float32 context's localize (K3-f32's stages 1b and 2,
``crm_reml_localize_f32``) and null fit (K10-f32, ``crm_null_fit_f32``)
under the CPU emulator (``_cuda_emu.py``), against their plain versions.

The localize up to p + 1 = 4 is the register localize on f32 rows (a block
a rho and a tile of variants and genes, the rows staged as f32, f32 Newton
steps, an f64 evaluation on the same rows); from p + 1 = 5 its sums are
split over warps whose sums meet in shared memory.  K10-f32 is the narrow
design on f32 rows: the grid a launch of its own (a warp a point, at p = 1
a block a tile of genes), then a block a (rho, gene) for the argmax, the
golden section and the final fit.

Tolerances (``chip_smoke.py``'s), and why:

* the localize: the f32 steps part from the plain version's at f32
  rounding, so the f64 lml at the localized optimum agrees within 1e-6 of
  max(|lml|, 1) (the optimum is flat), the same entries are -inf (the
  stage-2 noise floor and failed factorizations), and the kernel's argmax
  is a tie of the plain lmls within 1e-6; x is the f32 state, widened.
* K10-f32 (``chip_smoke.null_fits_agree``'s f32 budget): the lml within
  1e-5 (relative) of the plain one, the f64 objective at the kernel's delta
  no lower than at the plain one's by more than 1e-6 of it, beta and the
  scale within 1e-3 of the f64 values at the kernel's delta (of their
  largest entry).  A gene's slice of a gene-tiled call is its
  single-phenotype call, exactly.
* Either kernel called twice returns the same bits (the emulator runs each
  launch's blocks under other interleavings of their threads).

The builds, compiled side by side: the localize with 4 warps a register
block (``CRM_LOC_MAX_WARPS=4``) and 32 KB of staging (every row resident)
or 3 KB with the chunked layout forced (the rows in chunks of 32); K10 as
on the card and with 1 KB of staging (the rows read where they lie).
"""
import functools
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from _cuda_emu import emulated, nan_outputs  # noqa: F401
from _torch_inputs import captured, fit_dataset
from cellregmap_tpu_torch import engine
from cellregmap_tpu_torch.kernels import null_fit as k10
from cellregmap_tpu_torch.kernels import reml_newton as k3
from cellregmap_tpu_torch.models.lmm import lml_at_delta_eig

f32 = torch.float32
DELTA_CFG = (-18.0, 18.0, 40, 60)
NULL_CFG = (-18.0, 18.0, 16, 12)  # 16 points: two grid blocks a problem


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("cuda_emu_k3_k10_f32")
    warps = "CRM_LOC_MAX_WARPS=4"
    builds = {
        "resident": ("reml_newton", k3, (warps, "CRM_LOC_SMEM_KB=32")),
        "chunked": ("reml_newton", k3, (warps, "CRM_LOC_SMEM_KB=3",
                                        "CRM_LOC_CHUNKED")),
        "k10": ("null_fit", k10, ()),
        "k10_global": ("null_fit", k10, ("CRM_NF_SMEM_KB=1",))}
    for key in builds:
        (workdir / key).mkdir()
    with ThreadPoolExecutor(len(builds)) as pool:
        done = {key: pool.submit(emulated, name, workdir / key, defines)
                for key, (name, _, defines) in builds.items()}
        out = {key: f.result() for key, f in done.items()}
    for key, (_, mod, _) in builds.items():
        mod._bind(out[key])
    return out


class _Recorded(Exception):
    """Raised once the localize's operands are recorded: the rest of the
    batch is not needed."""


@functools.lru_cache(maxsize=None)
def _localize_case(genes, p):
    """The localize's operands of a small f32 interaction batch (R = 63
    rows, 6 variants, 4 at p = 15, 3 rho), one phenotype or ``genes`` on a
    gene axis, and the plain version's outputs on them."""
    seed = 700 + 10 * p + genes
    ctx, G, n = fit_dataset(seed, p=p, nrho=3, n=80, donors=20,
                            S=4 if p > 7 else 6)
    if genes > 1:
        rng = np.random.default_rng(seed)
        Y = ctx.y[None] + 0.6 * torch.as_tensor(rng.normal(size=(genes, n)))
        ctx = ctx._replace(y=Y, Zy=Y @ ctx.Z, Wy=Y @ ctx.W,
                           yy=(Y * Y).sum(dim=1))
    ctx = engine.NullContext(*(t.to(f32) for t in ctx))
    G = G.to(f32)
    calls = []

    def record(*args, **kw):
        calls.append((args, kw))
        raise _Recorded

    saved, engine.reml_localize = engine.reml_localize, record
    try:
        engine.interaction_batch(ctx, G, G, n, delta_cfg=DELTA_CFG)
    except _Recorded:
        pass
    finally:
        engine.reml_localize = saved
    (args, kw), = calls
    return args, kw, k3.reml_localize_plain(*args, **kw)


def _assert_localize(got, want):
    x, lml, kb = got
    x_p, lml_p, _ = want
    assert torch.equal(x.to(f32).double(), x)
    fin = torch.isfinite(lml_p)
    assert torch.equal(torch.isfinite(lml), fin)
    assert torch.equal(lml[~fin], lml_p[~fin])  # -inf where the plain is
    scale = lml_p.abs().clamp(min=1.0)
    assert float(((lml - lml_p).abs() / scale)[fin].max()) <= 1e-6
    best = lml_p.amax(dim=-1)
    at_k = lml_p.gather(-1, kb[..., None])[..., 0]
    gap = (best - at_k) / best.abs().clamp(min=1.0)
    assert bool((gap[torch.isfinite(best)] <= 1e-6).all())


@pytest.mark.parametrize("build", ["resident", "chunked"])
@pytest.mark.parametrize("genes,p", [(1, 1), (3, 1), (1, 3), (3, 3),
                                     (1, 7), (3, 7), (1, 15), (3, 15)])
def test_localize_f32_matches_plain(libs, build, genes, p):
    args, kw, want = _localize_case(genes, p)
    got = k3.call_localize(libs[build], *args, **kw)
    _assert_localize(got, want)
    if p <= 7:
        again = k3.call_localize(libs[build], *args, **kw)
        assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("p", [1, 7])
def test_localize_f32_failed_evaluations_never_win(libs, p):
    """Variant 0's genotype is its phenotype at rho 1 (rotated and in the
    complements): its stage-2 rss there is at the noise floor, so its lml
    is -inf at rho 1; variant 1's complement Gram is so negative that its
    f64 factorization fails (a NaN lml, -inf) wherever its rotated rows do
    not outweigh it.  Neither wins the argmax, and every -inf is the
    plain version's."""
    args, kw, _ = _localize_case(1, p)
    S, WGt, yt = (a.clone() for a in args[:3])
    comp = args[3]
    WGt[1, :, p] = yt[1]
    CWg, Cgy, Cgg = comp.CWg.clone(), comp.Cgy.clone(), comp.Cgg.clone()
    CWg[:, 0] = comp.CWy
    Cgy[0] = comp.Cyy
    Cgg[0] = comp.Cyy
    WGt[2, :, p + 1] *= 1e-3
    Cgg[1] = -2.0 * float((WGt[:, :, p + 1] ** 2).sum(dim=1).min())
    comp = comp._replace(CWg=CWg, Cgy=Cgy, Cgg=Cgg)
    args = (S, WGt, yt, comp) + tuple(args[4:])
    want = k3.reml_localize_plain(*args, **kw)
    assert not bool(torch.isfinite(want[1][0, 1]))
    assert not bool(torch.isfinite(want[1][1]).all())
    assert bool(torch.isfinite(want[1][1]).any())
    got = k3.call_localize(libs["resident"], *args, **kw)
    _assert_localize(got, want)
    assert int(got[2][0]) != 1
    assert bool(torch.isfinite(want[1][1, got[2][1]]))


def _assert_null_fits(fits, plain, data, n):
    """``chip_smoke.null_fits_agree``'s f32 budget, gene by gene."""
    if data.yt.ndim == 3:
        for g in range(data.yt.shape[0]):
            _assert_null_fits(type(fits)(*(t[g] for t in fits)),
                              type(plain)(*(t[g] for t in plain)),
                              k10.gene_data(data, g), n)
        return
    assert fits.lml.dtype == f32
    rel = ((fits.lml - plain.lml).abs() / plain.lml.abs()).max()
    assert float(rel) <= 1e-5, float(rel)
    d64 = type(data)(*(t.double() for t in data))
    at_k = lml_at_delta_eig(fits.delta.double()[:, None], d64, n, False)
    at_p = lml_at_delta_eig(plain.delta.double()[:, None], d64, n, False)
    lk, lp = at_k[0][:, 0], at_p[0][:, 0]
    assert bool((lk >= lp - 1e-6 * lp.abs()).all()), (lk - lp) / lp.abs()
    for got, want in ((fits.beta, at_k[1][:, 0]),
                      (fits.scale, at_k[2][:, 0])):
        err = float((got.double() - want).abs().max())
        assert err <= 1e-3 * float(want.abs().max()), err


def _null_args(seed, genes, p):
    ctx, _, n = fit_dataset(seed, p=p, nrho=3, n=80, donors=20, S=2)
    if genes:
        rng = np.random.default_rng(seed)
        Y = ctx.y[None] + torch.as_tensor(
            rng.uniform(0.2, 1.5, size=(genes, 1))
            * rng.normal(size=(genes, n)))
        ctx = ctx._replace(y=Y, Zy=Y @ ctx.Z, Wy=Y @ ctx.W,
                           yy=(Y * Y).sum(dim=1))
    ctx = engine.NullContext(*(t.to(f32) for t in ctx))
    fit = (engine.null_association_multigene_fit if genes
           else engine.null_association_fit)
    (args, kw), = captured(lambda: fit(ctx, n, delta_cfg=NULL_CFG),
                           ["null_fit"])["null_fit"]
    return args, kw, n


# 16 genes: one tile of 16 at p = 1; 17: two tiles of 9 and 8
@pytest.mark.parametrize("build", ["k10", "k10_global"])
@pytest.mark.parametrize("genes,p", [(16, 1), (17, 1), (0, 1), (0, 4),
                                     (0, 15)])
def test_null_fit_f32_matches_plain(libs, build, genes, p):
    args, kw, n = _null_args(800 + genes + 10 * p, genes, p)
    data = args[0]
    fits = k10.call(libs[build], *args, **kw)
    _assert_null_fits(fits, k10.null_fit_plain(*args, **kw), data, n)
    again = k10.call(libs[build], *args, **kw)
    assert all(torch.equal(a, b) for a, b in zip(fits, again))
    if genes:
        for g in (0, genes - 1):
            one = k10.call(libs[build], k10.gene_data(data, g), *args[1:],
                           **kw)
            for got, alone in zip(fits, one):
                assert torch.equal(got[g], alone)


def test_null_fit_f32_failed_factorizations_never_win(libs):
    """The intercept in the span of a donors' one-hot background: at rho
    = 0 and small delta the f32 normal matrix is indefinite (its
    complement Gram is cancellation noise) and the plain grid's lml is NaN
    there.  Those points never win the kernel's argmax: its fits are
    finite and agree with the plain version's."""
    rng = np.random.default_rng(3)
    n, C, donors = 120, 4, 12
    E = rng.normal(size=(n, C)) / np.sqrt(C)
    hK = np.zeros((n, donors))
    hK[np.arange(n), np.arange(n) % donors] = 1.0
    y = rng.normal(size=n) + 0.7 * hK @ rng.normal(size=donors)
    ctx = engine.build_null_context(y, np.ones((n, 1)), E, hK=hK,
                                    rho_grid=np.linspace(0, 1, 3),
                                    device="cpu", dtype=f32)
    cfg = (-18.0, 18.0, 64, 12)
    (args, kw), = captured(lambda: engine.null_association_fit(
        ctx, n, delta_cfg=cfg), ["null_fit"])["null_fit"]
    data = args[0]
    grid = torch.linspace(-18.0, 18.0, 64, dtype=f32)
    vals = lml_at_delta_eig(torch.sigmoid(grid).expand(3, 64), data, n,
                            False)[0]
    assert bool(torch.isnan(vals).any())
    fits = k10.call(libs["k10"], *args, **kw)
    assert bool(torch.isfinite(fits.lml).all())
    _assert_null_fits(fits, k10.null_fit_plain(*args, **kw), data, n)
