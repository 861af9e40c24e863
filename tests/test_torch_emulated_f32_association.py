"""The float32 context's instantiations on the association scans' and the
effect sizes' paths (K10's null fit, K8's fast scan, K7's grid and ML
converge, each with its gene axis, and K9 with the coefficients), run on
the CPU under the emulator of ``tests/_cuda_emu.py`` against their plain
float32 versions.  The operands are the engine's own, recorded on small
float32 problems; every output the wrappers allocate starts as NaN
(``nan_outputs``).

Tolerances, and why:

* K10-f32 (the grid, 12 golden-section steps and the final fit all in
  f32): the kernel's and the plain version's f32 sums part at f32
  rounding, so their golden sections can stop at different points of an
  lml that is flat there to f32 resolution.  Held: the lml within 1e-5 of
  the plain one (relative), the f64 objective at the kernel's delta no
  lower than at the plain version's by more than 1e-6 of its magnitude
  (the kernel's delta is as good an optimum), and beta and the scale
  within 1e-3 of the f64 values at the kernel's own delta (relative to
  their largest entry; f32 solves of the normal equations).  A gene's
  slice of a gene-axis launch is its single-phenotype launch, exactly.
* K8-f32 (f32 sums over R, an f32 Cholesky, the rank-1 update): lml
  within 1e-6 relative, the effect sizes and scale within 1e-4 of each
  output's largest entry.
* K7-f32: the grid's ML brackets are the f64 logits (the reference's
  `linspace` there is f64), on the plain argmax or a neighbour within 1e-5
  of the maximum; the converge (f64 arithmetic on the same f32 tensors
  from the same start) at rtol 1e-9, as the f64 converge's tests.
* K9-f32 with the coefficients (the final fit of the float32 context):
  the lml held to the plain f32 one through the f64 value at the same
  points (``woodbury_family.f32_gaps``'s rule: at most twice the plain
  version's distance from f64, plus 1e-5), the same masked points, and
  beta and rss within 1e-3 of the plain f32 ones' largest entry; a zoom
  round's lml entry by the same rule.
"""
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from _cuda_emu import emulated, nan_outputs  # noqa: F401
from _torch_inputs import betas_dataset, captured, fit_dataset
from cellregmap_tpu_torch import engine
from cellregmap_tpu_torch.kernels import delta_grid as k2
from cellregmap_tpu_torch.kernels import fast_scan as k8
from cellregmap_tpu_torch.kernels import null_fit as k10
from cellregmap_tpu_torch.kernels import reml_newton as k3
from cellregmap_tpu_torch.kernels import woodbury_family as k9
from cellregmap_tpu_torch.models.lmm import lml_at_delta_eig

f32, f64 = torch.float32, torch.float64


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("cuda_emu_f32_assoc")
    out = {}
    for name, mod in (("null_fit", k10), ("fast_scan", k8),
                      ("delta_grid", k2), ("reml_newton", k3),
                      ("woodbury_family", k9)):
        (workdir / name).mkdir()
        out[name] = emulated(name, workdir / name)
        mod._bind(out[name])
    return out


def _context32(seed, p, nrho=3, genes=0, S=7):
    """A small null context in f32 (with ``genes`` phenotypes on a leading
    axis when genes > 0), its f32 genotypes and n."""
    ctx, G, n = fit_dataset(seed, p=p, nrho=nrho, S=S)
    if genes:
        rng = np.random.default_rng(seed)
        Y = ctx.y[None] + torch.as_tensor(
            rng.uniform(0.2, 1.5, size=(genes, 1))
            * rng.normal(size=(genes, n)))
        ctx = ctx._replace(y=Y, Zy=Y @ ctx.Z, Wy=Y @ ctx.W,
                           yy=(Y * Y).sum(dim=1))
    return engine.NullContext(*(t.to(f32) for t in ctx)), G.to(f32), n


def _widen(data):
    return type(data)(*(t.double() for t in data))


def _assert_null_fits(fits, plain, data, n):
    """The module doc's K10-f32 rule, gene by gene."""
    if data.yt.ndim == 3:
        for g in range(data.yt.shape[0]):
            _assert_null_fits(type(fits)(*(t[g] for t in fits)),
                              type(plain)(*(t[g] for t in plain)),
                              k10.gene_data(data, g), n)
        return
    assert fits.lml.dtype == f32
    rel = ((fits.lml - plain.lml).abs() / plain.lml.abs()).max()
    assert float(rel) <= 1e-5, float(rel)
    d64 = _widen(data)
    at_k = lml_at_delta_eig(fits.delta.double()[:, None], d64, n, False)
    at_p = lml_at_delta_eig(plain.delta.double()[:, None], d64, n, False)
    lk, lp = at_k[0][:, 0], at_p[0][:, 0]
    assert bool((lk >= lp - 1e-6 * lp.abs()).all()), (lk - lp) / lp.abs()
    for got, want in ((fits.beta, at_k[1][:, 0]),
                      (fits.scale, at_k[2][:, 0])):
        err = float((got.double() - want).abs().max())
        assert err <= 1e-3 * float(want.abs().max()), err


@pytest.mark.parametrize("genes,p", [(0, 1), (0, 4), (3, 1), (2, 7),
                                     (2, 15)])
def test_null_fit_f32_matches_plain(libs, genes, p):
    ctx, _, n = _context32(300 + 10 * genes + p, p, genes=genes)
    fit = (engine.null_association_multigene_fit if genes
           else engine.null_association_fit)
    calls = captured(lambda: fit(ctx, n, delta_cfg=(-18.0, 18.0, 16, 12)),
                     ["null_fit"])
    (args, kw), = calls["null_fit"]
    data = args[0]
    assert data.S.dtype == f32 and data.Xt.shape[2] == p
    fits = k10.call(libs["null_fit"], *args, **kw)
    _assert_null_fits(fits, k10.null_fit_plain(*args, **kw), data, n)
    if genes:
        one = k10.call(libs["null_fit"], k10.gene_data(data, genes - 1),
                       *args[1:])
        for got, alone in zip(fits, one):
            assert torch.equal(got[genes - 1], alone)


def _fast_close(got, want):
    rel = float(((got.lml - want.lml).abs() / want.lml.abs()).max())
    assert rel <= 1e-6, rel
    for g, w in zip(got[1:], want[1:]):
        assert g.dtype == f32
        err = float((g - w).abs().max())
        assert err <= 1e-4 * float(w.abs().max()), err


@pytest.mark.parametrize("p", [1, 3, 9])
def test_fast_scan_f32_matches_plain(libs, p):
    ctx, G, n = _context32(330 + p, p, S=37)
    calls = captured(lambda: engine.fast_scan_batch(ctx, G, 1, 0.37, n),
                     ["fast_scan"])
    (args, kw), = calls["fast_scan"]
    assert args[1].dtype == f32
    _fast_close(k8.call(libs["fast_scan"], *args, **kw),
                k8.fast_scan_plain(*args, **kw))


# (p, best rho per gene): genes sharing a slot past the p <= 2 chunk of
# four, distinct slots, and the 16-wide instantiation
@pytest.mark.parametrize("p,k", [(1, [1, 1, 1, 1, 1, 0]), (2, [2, 0, 1]),
                                 (6, [1, 0, 1])])
def test_fast_scan_f32_gene_axis(libs, p, k):
    genes = len(k)
    ctx, G, n = _context32(340 + genes + p, p, genes=genes, S=37)
    delta = torch.linspace(0.2, 0.8, genes, dtype=f32)
    calls = captured(lambda: engine.fast_scan_multigene_batch(
        ctx, G, np.asarray(k), delta, n), ["fast_scan"])
    (args, kw), = calls["fast_scan"]
    slot = kw["slot"]
    index = torch.as_tensor(k8.slot_order(slot, args[1].shape[0]))
    got = k8.call_genes(libs["fast_scan"], *args, slot=slot, index=index)
    want = k8.fast_scan_genes_plain(*args, slot=slot)
    assert got.lml.shape == (genes, G.shape[1])
    _fast_close(got, want)


@pytest.mark.parametrize("genes,p,k", [(0, 1, 1), (0, 5, 2),
                                       (3, 1, [2, 0, 2]), (2, 3, [1, 1])])
def test_refit_f32_grid_and_ml_converge(libs, genes, p, k):
    """K7 on the float32 context: the ML grid in f32 with f64-logit
    brackets, then the ML converge (and its zero-step fits at the grid's
    ends) on the f32 tensors."""
    ctx, G, n = _context32(360 + genes + p, p, genes=genes)
    cfg = (-18.0, 18.0, 24, 60)
    if genes:
        run = lambda: engine.association_refit_multigene_batch(  # noqa
            ctx, G, np.asarray(k), n, delta_cfg=cfg)
    else:
        run = lambda: engine.association_refit_batch(  # noqa: E731
            ctx, G, k, n, delta_cfg=cfg)
    calls = captured(run, ["delta_grid", "reml_converge"])
    (args, kw), = calls["delta_grid"]
    assert args[0].dtype == f32 and args[9] == f32
    dkw = dict(kw, slot=torch.as_tensor(kw["slot"])) if genes else kw
    br_lo, br_hi = k2.call(libs["delta_grid"], *args, **dkw)
    plo, phi, lml = k2.delta_grid_plain(*args, **kw, return_lml=True)
    assert torch.equal(torch.isnan(br_lo), torch.isnan(plo))
    # the f64 logits (within 1e-12 of one, far inside f32's rounding of
    # ~1e-6 there)
    logit = k2.logit_grid(-18.0, 18.0, 24, "cpu")
    for br in (br_lo, br_hi):
        fin = ~torch.isnan(br)
        near = (br[fin][:, None] - logit).abs().amin(dim=1)
        assert float(near.max()) <= 1e-12
    if genes:
        for g, s in enumerate(kw["slot"]):
            gap = k2.bracket_shortfall(br_lo[g, :, s:s + 1],
                                       br_hi[g, :, s:s + 1], lml[g], -18.0,
                                       18.0)
            assert gap <= 1e-5, gap
    else:
        assert k2.bracket_shortfall(br_lo, br_hi, lml, -18.0, 18.0) <= 1e-5
    assert len(calls["reml_converge"]) == 3   # the Newton fit, both ends
    for cargs, ckw in calls["reml_converge"]:
        assert cargs[0].dtype == f32 and not ckw["restricted"]
        got = k3.call_converge(libs["reml_newton"], *cargs, **ckw)
        want = k3.reml_converge_plain(*cargs, **ckw)
        for gv, wv, name in zip(got, want, ("delta", "lml", "scale",
                                            "beta")):
            assert gv.dtype == f64 and gv.shape == wv.shape
            assert_allclose(gv.numpy(), wv.numpy(), rtol=1e-9, atol=1e-12,
                            err_msg=name)


def test_refit_f32_grid_skips_failed_factorizations(libs):
    """The intercept in the span of a donors' one-hot background: at rho =
    0 and small delta the f32 normal matrix is indefinite (its complement
    Gram is cancellation noise), the plain grid's Cholesky is NaN there and
    those points are masked (432 of the 4096 here).  The kernel's brackets
    avoid them as the plain version's do (a NaN residual kept NaN, not
    floored into a huge finite lml), and the converge from them is finite
    for every variant."""
    rng = np.random.default_rng(0)
    n, C, donors, S = 120, 4, 12, 16
    E = rng.normal(size=(n, C)) / np.sqrt(C)
    hK = np.zeros((n, donors))
    hK[np.arange(n), np.arange(n) % donors] = 1.0
    G = rng.binomial(2, 0.3, size=(n, S)).astype(float)
    G = (G - G.mean(0)) / np.maximum(G.std(0), 1e-9)
    y = rng.normal(size=n) + 0.8 * G[:, 3] * E[:, 0]
    y = y + 0.5 * np.random.default_rng(1).normal(size=n)
    ctx = engine.build_null_context(y, np.ones((n, 1)), E, hK=hK,
                                    rho_grid=np.linspace(0, 1, 11),
                                    device="cpu", dtype=f32)
    calls = captured(lambda: engine.association_refit_batch(
        ctx, torch.as_tensor(G, dtype=f32), 0, n,
        delta_cfg=(-18.0, 18.0, 256, 60)), ["delta_grid", "reml_converge"])
    (args, kw), = calls["delta_grid"]
    br_lo, br_hi = k2.call(libs["delta_grid"], *args, **kw)
    _, _, lml = k2.delta_grid_plain(*args, **kw, return_lml=True)
    assert int((~torch.isfinite(lml)).sum()) > 0
    assert k2.bracket_shortfall(br_lo, br_hi, lml, -18.0, 18.0) <= 1e-5
    cargs, ckw = calls["reml_converge"][0]
    got = k3.call_converge(libs["reml_newton"], *cargs[:7], br_lo, br_hi,
                           *cargs[9:], **ckw)
    assert bool(torch.isfinite(got[1]).all())


def _contiguous(args):
    return tuple(type(a)(*(t.contiguous() for t in a))
                 if isinstance(a, tuple)
                 else a.contiguous() if isinstance(a, torch.Tensor) else a
                 for a in args)


# (C, W columns, donors): q = C + rank[W, E] + 2 = 9 (a lane a row of J)
# and 41 (J's packed triangle)
@pytest.mark.parametrize("C,p,donors", [(3, 2, 8), (18, 3, 5)])
def test_woodbury_family_f32_with_coefficients(libs, C, p, donors):
    bctx, G, norm, n = betas_dataset(380 + C, p=p, n=160, C=C, donors=donors,
                                     S=3)
    bctx = engine.BetasContext(*(t.to(f32) for t in bctx))
    calls = captured(lambda: engine.predict_interaction_batch(
        bctx, G.to(f32), norm.to(f32), n), ["family_eval"])
    calls = [(_contiguous(a), kw) for a, kw in calls["family_eval"]]
    # five zoom rounds and the final fit, every call in f32
    assert [a[0].dtype for a, _ in calls] == [f32] * 6
    args, kw = calls[-1]
    assert kw.get("want_beta")
    lml, beta, rss = k9.call(libs["woodbury_family"], *args, **kw)
    plml, pbeta, prss = k9.family_eval_plain(*args, **kw)
    c = lambda a: a.double() if isinstance(a, torch.Tensor) else a  # noqa
    exact = k9.family_eval_plain(*(type(a)(*map(c, a))
                                   if isinstance(a, tuple) else c(a)
                                   for a in args), **kw)[0]
    ref = exact.abs().clamp(min=1.0)
    fin_g, fin_p = torch.isfinite(lml), torch.isfinite(plml)
    assert torch.equal(fin_g, fin_p)
    eg, ep = (lml - exact).abs() / ref, (plml - exact).abs() / ref
    assert float((eg - 2 * ep)[fin_g].max()) <= 1e-5
    for got, want in ((beta, pbeta), (rss, prss)):
        assert got.dtype == f32
        err = float((got - want).abs()[fin_g].max())
        assert err <= 1e-3 * float(want.abs()[fin_g].max()), err
    # a zoom round's lml entry (the second: the first spans the whole
    # delta range, whose ends are ill-conditioned in f32 for both versions,
    # 1e-4 from f64 at logit -15.6), through the same rule
    gaps = k9.f32_gaps(k9.call(libs["woodbury_family"], *calls[1][0],
                               **calls[1][1]), *calls[1])
    assert gaps["mask"] == 0 and gaps["excess"] <= 1e-5, gaps
