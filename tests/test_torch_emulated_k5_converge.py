"""K5 (``csrc/score_core.cu``: the gathered genotype columns, then a block a
(variant, slot) whose Grams run on the FP64 tensor cores) and K3's
converge (``csrc/reml_newton.cu``: the per-rho problem lists, then a block
a (rho, tile of its problems) staging the rows they share) under the CPU
emulator (``_cuda_emu.py``), against their plain versions.

K5 at 1e-10 of each output's largest entry (its K0^{-1} forms subtract
nearly equal Grams), on a gene axis whose genes share a slot (all at one
rho: one pass of a block serves them), never share one (each at its own
rho) or share some; on more genes at one rho than one pass of a block
holds; and in its wide instantiation (m = C + p + 2 = 83).  The factors
of the slots that no gene uses are NaN, so a kernel that reads one fails.

The converge at rtol 1e-9 (delta, lml, scale, beta: a few f64 Newton
steps from the same bracket, summed in another order), under REML on a
gene-batched interaction batch whose best rho are spread over several
points (p + 1 = 2, 4 and 7 in registers, 18 in the wide instantiation),
and under ML on the association refit (one phenotype at one rho, its
Newton steps and its two zero-step fits at the grid's ends) and on the
gene-batched refit (each gene at its own rho).  Each converge case runs
twice: with every row staged at once, and built with 1 KB of staging so
that the rows pass in two chunks of 32 (R = 36), with the blocks reading
the per-rho counts two at a time (several chunks of rho) and with the
zero-step calls at p + 1 = 2 one warp a problem (as many problems take
them on the card; the first build splits their rows over two warps, as
few do).
"""
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from _cuda_emu import emulated, nan_outputs  # noqa: F401
from _torch_inputs import captured, fit_dataset, score_gene_inputs
from cellregmap_tpu_torch import engine
from cellregmap_tpu_torch.kernels import reml_newton as k3
from cellregmap_tpu_torch.kernels import score_core as k5


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    """The emulated libraries: K5, and the converge twice, its rows staged
    whole and (``chunked``) in 1 KB, with its blocks reading the per-rho
    counts two at a time and its zero-step calls one warp a problem."""
    workdir = tmp_path_factory.mktemp("cuda_emu_k5_converge")
    out = {}
    for key, name, mod, defines in (
            ("score_core", "score_core", k5, ()),
            ("resident", "reml_newton", k3, ()),
            ("chunked", "reml_newton", k3,
             ("CRM_CONV_SMEM_KB=1", "CRM_CONV_LIST_CHUNK=2",
              "CRM_CONV_SPLIT_BELOW=0"))):
        (workdir / key).mkdir()
        out[key] = emulated(name, workdir / key, defines)
        mod._bind(out[key])
    return out


def _close(got, want, rel):
    err = float((got - want).abs().max())
    assert err <= rel * float(want.abs().max()), err


def _score_close(lib, args):
    Q, Wmat = k5.call(lib, *args)
    Qr, Wr = k5.score_core_plain(*args)
    _close(Q, Qr, 1e-10)
    _close(Wmat, Wr, 1e-10)
    return Q


@pytest.mark.parametrize("pattern", ["one", "distinct", "random"])
def test_score_core_genes_on_slots(libs, pattern):
    """Three genes: all at one rho (one block pass of three genes, the
    rows split over two warps a tile), each at its own (a pass a gene,
    the rows over all eight warps), or some together."""
    args = score_gene_inputs(3, 3, pattern)
    assert _score_close(libs["score_core"], args).shape == (3, 5)


def test_score_core_more_genes_than_a_pass(libs):
    """Twenty genes at one rho: a block's passes of 16 and 4 genes."""
    args = score_gene_inputs(20, 20, "one", S=2)
    assert int(args[16].max()) == 0
    _score_close(libs["score_core"], args)


@pytest.mark.parametrize("pattern", ["one", "distinct"])
def test_score_core_wide_gene_axis(libs, pattern):
    """The wide instantiation (m = 83: 41 tiles a gene, eight a warp) on
    two genes that share a slot or do not."""
    args = score_gene_inputs(83, 2, pattern, C=50, p=31, n=90, R=40, S=2,
                              nrho=3)
    _score_close(libs["score_core"], args)


def _converge_close(lib, call):
    args, kw = call
    got = k3.call_converge(lib, *args, **kw)
    want = k3.reml_converge_plain(*args, **kw)
    for g, w, name in zip(got, want, ("delta", "lml", "scale", "beta")):
        assert g.shape == w.shape
        assert_allclose(g.numpy(), w.numpy(), rtol=1e-9, atol=1e-12,
                        err_msg=name)


def _contiguous(call):
    c = lambda a: a.contiguous() if isinstance(a, torch.Tensor) else a  # noqa
    args, kw = call
    return tuple(type(a)(*map(c, a)) if isinstance(a, tuple) else c(a)
                 for a in args), kw


def _dataset(seed, p, genes, nrho):
    """A small dataset (R = 36 rows) with ``genes`` phenotypes (one: no
    gene axis)."""
    ctx, G, n = fit_dataset(seed, p=p, nrho=nrho, n=60, donors=11, S=5)
    if genes > 1:
        rng = np.random.default_rng(seed)
        Y = ctx.y[None] + 0.6 * torch.as_tensor(rng.normal(size=(genes, n)))
        ctx = ctx._replace(y=Y, Zy=Y @ ctx.Z, Wy=Y @ ctx.W,
                           yy=(Y * Y).sum(dim=1))
    return ctx, G, n


@pytest.mark.parametrize("build", ["resident", "chunked"])
@pytest.mark.parametrize("p,seed", [(1, 301), (3, 303), (6, 306), (17, 307)])
def test_converge_reml_gene_axis(libs, p, seed, build):
    """REML (the interaction's stage 3) on three genes whose best rho are
    spread over the grid: a rho's tiles hold problems of more than one
    gene."""
    ctx, G, n = _dataset(seed, p, 3, 5)
    (call,) = captured(lambda: engine.interaction_batch(
        ctx, G, G, n, delta_cfg=(-18.0, 18.0, 12, 60), newton_f32=2,
        newton_f64=2), ["reml_converge"])["reml_converge"]
    call = _contiguous(call)
    kb = call[0][5]
    assert kb.shape == (3, 5) and len(set(kb.flatten().tolist())) >= 2
    _converge_close(libs[build], call)


@pytest.mark.parametrize("build", ["resident", "chunked"])
@pytest.mark.parametrize("p", [1, 17])
def test_converge_ml_refit(libs, p, build):
    """ML (the association refit at one rho, no k_best): the Newton steps,
    then the zero-step fits at either end of the grid."""
    ctx, G, n = _dataset(320 + p, p, 1, 3)
    calls = captured(lambda: engine.association_refit_batch(
        ctx, G, 1, n, delta_cfg=(-18.0, 18.0, 16, 60), newton_f64=3),
        ["reml_converge"])["reml_converge"]
    assert [c[0][10] for c in calls] == [3, 0, 0]
    for call in calls:
        _converge_close(libs[build], _contiguous(call))


@pytest.mark.parametrize("build", ["resident", "chunked"])
def test_converge_ml_per_gene_rho(libs, build):
    """ML on the gene-batched refit: each gene's problems at its own
    rho (two genes on one, a third on another)."""
    ctx, G, n = _dataset(340, 2, 3, 3)
    calls = captured(lambda: engine.association_refit_multigene_batch(
        ctx, G, np.array([2, 0, 2]), n, delta_cfg=(-18.0, 18.0, 16, 60),
        newton_f64=3), ["reml_converge"])["reml_converge"]
    assert [c[0][10] for c in calls] == [3, 0, 0]
    for call in calls[:2]:
        _converge_close(libs[build], _contiguous(call))
