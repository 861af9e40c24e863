"""The gene axes of the association kernels' CUDA sources (K10's null fits,
K8's fast scan and K7's grid and converge at a per-gene rho), run on the
CPU under the emulator of ``_cuda_emu.py``, against their plain versions.

The operands are the engine's own, recorded on a small gene-batched
problem (several phenotypes against one null context).  Every output the
wrappers allocate starts as NaN (``nan_outputs``), so that an entry a
kernel never writes fails.  Tolerances are those of the single-phenotype
sources (tests/test_torch_cuda_emulated.py): the golden-section fits
through ``null_fit.fit_gaps`` at 1e-10, the fast scan at 1e-12 of each
output's largest entry, a grid bracket on a near-tie neighbour of the
plain argmax within 1e-5 (float32) or 1e-12 (float64) of the maximum, and
the Newton results at rtol 1e-9.
"""
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from _cuda_emu import emulated, nan_outputs  # noqa: F401
from _torch_inputs import captured, fit_dataset
from cellregmap_tpu_torch import engine
from cellregmap_tpu_torch.kernels import delta_grid as k2
from cellregmap_tpu_torch.kernels import fast_scan as k8
from cellregmap_tpu_torch.kernels import null_fit as k10
from cellregmap_tpu_torch.kernels import reml_newton as k3


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("cuda_emu_mg")
    out = {}
    for name, mod in (("null_fit", k10), ("fast_scan", k8),
                      ("delta_grid", k2), ("reml_newton", k3)):
        out[name] = emulated(name, workdir)
        mod._bind(out[name])
    return out


def _gene_context(genes, p, nrho, seed, S=7):
    """A small null context with ``genes`` seeded phenotypes on a leading
    axis (the gene-batched scans' convention), its genotypes and n."""
    ctx, G, n = fit_dataset(seed, p=p, nrho=nrho, S=S)
    rng = np.random.default_rng(seed)
    Y = ctx.y[None] + torch.as_tensor(
        rng.uniform(0.2, 1.5, size=(genes, 1)) * rng.normal(size=(genes, n)))
    return ctx._replace(y=Y, Zy=Y @ ctx.Z, Wy=Y @ ctx.W,
                        yy=(Y * Y).sum(dim=1)), G, n


# (genes, p); p = 20 takes the wide (shared-memory) instantiation
@pytest.mark.parametrize("genes,p", [(1, 1), (3, 1), (3, 2), (2, 20)])
def test_null_fit_source_gene_axis(libs, genes, p):
    nrho = 2 if p > 16 else 3
    ctx_g, _, n = _gene_context(genes, p, nrho, 80 + genes + p)
    calls = captured(lambda: engine.null_association_multigene_fit(
        ctx_g, n, delta_cfg=(-18.0, 18.0, 8, 12)), ["null_fit"])
    (args, kw), = calls["null_fit"]
    data = args[0]
    assert data.yt.shape == (genes, nrho, data.S.shape[1])
    fits = k10.call(libs["null_fit"], *args, **kw)
    plain = k10.null_fit_plain(*args, **kw)
    assert fits.lml.shape == (genes, nrho)
    assert fits.beta.shape == (genes, nrho, p)
    gaps = k10.fit_gaps(fits, plain, data, n, False)
    assert max(gaps.values()) <= 1e-10, gaps
    if p <= 16:
        # a gene's slice of the launch is its single-phenotype call's
        one = k10.call(libs["null_fit"], k10.gene_data(data, genes - 1),
                       *args[1:])
        for got, alone in zip(fits, one):
            assert torch.equal(got[genes - 1], alone)


def test_null_fit_source_wide_reml_gene_axis(libs):
    """The wide instantiation's REML logdet(X^T X), computed once per rho
    and read by every gene's grid and golden section."""
    ctx_g, G, n = _gene_context(2, 19, 2, 91)
    M = torch.cat([ctx_g.W, G[:, :1]], dim=1)
    Vt = ctx_g.V.transpose(1, 2)
    Xt = Vt @ (ctx_g.Z.T @ M)
    yt = torch.matmul(Vt, ctx_g.Zy.T).permute(2, 0, 1).contiguous()
    XtT = Xt.transpose(1, 2)
    data = k10.EigData(S=ctx_g.S, Xt=Xt, yt=yt, Cxx=M.T @ M - XtT @ Xt,
                       cxy=(ctx_g.y @ M)[:, None, :]
                       - (XtT @ yt[..., None])[..., 0],
                       cyy=ctx_g.yy[:, None] - (yt * yt).sum(dim=-1))
    args = (data, n, True, -18.0, 18.0, 6, 10)
    fits = k10.call(libs["null_fit"], *args)
    gaps = k10.fit_gaps(fits, k10.null_fit_plain(*args), data, n, True)
    assert max(gaps.values()) <= 1e-10, gaps


# (p, best rho per gene): genes sharing a slot (past a chunk of the p <= 2
# instantiation's 4 genes), genes on distinct slots, one gene; p = 5 takes
# the 16-wide instantiation (one gene a chunk)
@pytest.mark.parametrize("p,k", [(1, [1, 1, 1, 1, 1, 0]), (2, [2, 0, 1]),
                                 (1, [2]), (5, [1, 0, 1])])
def test_fast_scan_source_gene_axis(libs, p, k):
    genes = len(k)
    ctx_g, G, n = _gene_context(genes, p, 3, 100 + genes + p, S=37)
    delta = torch.linspace(0.2, 0.8, genes, dtype=torch.float64)
    calls = captured(lambda: engine.fast_scan_multigene_batch(
        ctx_g, G, np.asarray(k), delta, n), ["fast_scan"])
    (args, kw), = calls["fast_scan"]
    slot = kw["slot"]
    m = args[1].shape[0]
    assert m == len(set(k))
    index = torch.as_tensor(k8.slot_order(slot, m))
    got = k8.call_genes(libs["fast_scan"], *args, slot=slot, index=index)
    want = k8.fast_scan_genes_plain(*args, slot=slot)
    for g, w in zip(got, want):
        assert g.shape[0] == genes
        err = float((g - w).abs().max())
        assert err <= 1e-12 * float(w.abs().max()), err


@pytest.mark.parametrize("f32", [True, False])
@pytest.mark.parametrize("p,k", [(1, [2, 0, 2]), (2, [1, 1])])
def test_refit_sources_per_gene_rho(libs, f32, p, k):
    """K7 with a per-gene rho: each gene's grid at its slot alone (NaN
    elsewhere in the brackets, as in the plain version), and the converge
    kernel at the same slots through k_best."""
    genes = len(k)
    ctx_g, G, n = _gene_context(genes, p, 3, 120 + genes + p)
    calls = captured(lambda: engine.association_refit_multigene_batch(
        ctx_g, G, np.asarray(k), n, delta_cfg=(-18.0, 18.0, 24, 60),
        localize_f32=f32), ["delta_grid", "reml_converge"])
    (args, kw), = calls["delta_grid"]
    slot = kw["slot"]
    S = args[0]
    assert S.shape[0] == len(set(k))
    br_lo, br_hi = k2.call(libs["delta_grid"], *args,
                           **dict(kw, slot=torch.as_tensor(slot)))
    plo, phi, lml = k2.delta_grid_plain(*args, **kw, return_lml=True)
    assert torch.equal(torch.isnan(br_lo), torch.isnan(plo))
    for g, s in enumerate(slot):
        assert not bool(torch.isnan(br_lo[g, :, s]).any())
        gap = k2.bracket_shortfall(br_lo[g, :, s:s + 1], br_hi[g, :, s:s + 1],
                                   lml[g], args[5], args[6])
        assert gap <= (1e-5 if f32 else 1e-12), gap
    (args, kw) = calls["reml_converge"][0]
    assert torch.equal(args[5], torch.as_tensor(slot)[:, None].expand(
        genes, G.shape[1]))
    got = k3.call_converge(libs["reml_newton"], *args, **kw)
    want = k3.reml_converge_plain(*args, **kw)
    for gv, wv, name in zip(got, want, ("delta", "lml", "scale", "beta")):
        assert gv.shape[:2] == (genes, G.shape[1])
        assert_allclose(gv.numpy(), wv.numpy(), rtol=1e-9, atol=1e-12,
                        err_msg=name)
