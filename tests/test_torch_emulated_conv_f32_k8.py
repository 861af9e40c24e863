"""The float32 context's converge and K8 under the CPU emulator
(``_cuda_emu.py``), against their plain versions.

The converge (``csrc/reml_newton.cu``, ``crm_reml_converge_f32``) runs the
f64 converge's design on f32 operands: the per-rho problem lists, a block
a (rho, tile of four problems) staging the rows they share as f32, the f32
products widened, the weights, sums, Newton steps and final fit f64.  K8
(``csrc/fast_scan.cu``) splits the rows over blocks, adds the splits in a
fixed order and computes each gene's shared terms (A, b, yy, logdet D, A's
factor) once.

Tolerances, and why:

* the f32 converge: delta, lml, scale and beta at rtol 1e-9, atol 1e-12
  of ``reml_converge_plain`` (the same f32 products, f64 arithmetic from
  the same start, summed in another order), as the f64 converge's tests;
  a failed f32 factorization's NaN is the plain version's NaN (both
  compared with NaN equal to NaN, and the NaN asserted).
* K8 (``chip_smoke.FAST_SCAN_TOLERANCE``): in f64 every output within
  1e-10 of its largest plain entry (the Schur complement subtracts nearly
  equal terms); in f32 the lml within 1e-6 and beta_g, beta_W and the
  scale within 1e-4 (f32 sums over R, an f32 Cholesky and the rank-1
  update).  Two launches of one call, which the emulator runs under
  different interleavings of each block's threads, return the same bits.

The builds: the converge with every row staged at once (and two warps a
problem at p + 1 <= 2) and with 1 KB of staging (the rows in chunks of 32,
the per-rho counts read two at a time, the zero-step calls one warp a
problem: ``CRM_CONV_SPLIT_BELOW=0``); K8 as on the card (a few splits of
the small R) and with splits of at least two rows (``CRM_FS_SPLIT_ROWS=2``,
so that many splits meet in the epilogue).  The four are compiled side by
side.
"""
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from _cuda_emu import emulated, nan_outputs  # noqa: F401
from _torch_inputs import captured, fit_dataset
from cellregmap_tpu_torch import engine
from cellregmap_tpu_torch.kernels import fast_scan as k8
from cellregmap_tpu_torch.kernels import reml_newton as k3

f32, f64 = torch.float32, torch.float64
CFG = (-18.0, 18.0, 16, 60)
FAST_TOL = {f64: dict(lml=1e-10, effsizes_g=1e-10, effsizes_W=1e-10,
                      scale=1e-10),
            f32: dict(lml=1e-6, effsizes_g=1e-4, effsizes_W=1e-4,
                      scale=1e-4)}


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    """The four emulated builds, compiled at once."""
    workdir = tmp_path_factory.mktemp("cuda_emu_conv_f32_k8")
    builds = {
        "resident": ("reml_newton", k3, ()),
        "chunked": ("reml_newton", k3, ("CRM_CONV_SMEM_KB=1",
                                        "CRM_CONV_LIST_CHUNK=2",
                                        "CRM_CONV_SPLIT_BELOW=0")),
        "k8": ("fast_scan", k8, ()),
        "k8_splits": ("fast_scan", k8, ("CRM_FS_SPLIT_ROWS=2",))}
    for key in builds:
        (workdir / key).mkdir()
    with ThreadPoolExecutor(len(builds)) as pool:
        done = {key: pool.submit(emulated, name, workdir / key, defines)
                for key, (name, _, defines) in builds.items()}
        out = {key: f.result() for key, f in done.items()}
    for key, (_, mod, _) in builds.items():
        mod._bind(out[key])
    return out


def _contiguous(call):
    c = lambda a: a.contiguous() if isinstance(a, torch.Tensor) else a  # noqa
    args, kw = call
    return tuple(type(a)(*map(c, a)) if isinstance(a, tuple) else c(a)
                 for a in args), kw


def _context32(seed, p, genes=1, nrho=5, S=6):
    """A small float32 null context (R = 33 rows) with ``genes``
    phenotypes (one: no gene axis), its f32 genotypes and n."""
    ctx, G, n = fit_dataset(seed, p=p, nrho=nrho, n=70, donors=10, S=S)
    if genes > 1:
        rng = np.random.default_rng(seed)
        w = torch.as_tensor(np.linspace(0.2, 1.5, genes)[:, None])
        Y = ctx.y[None] + w * torch.as_tensor(rng.normal(size=(genes, n)))
        ctx = ctx._replace(y=Y, Zy=Y @ ctx.Z, Wy=Y @ ctx.W,
                           yy=(Y * Y).sum(dim=1))
    return engine.NullContext(*(t.to(f32) for t in ctx)), G.to(f32), n


def _converge_close(lib, call):
    args, kw = _contiguous(call)
    assert args[0].dtype == f32
    got = k3.call_converge(lib, *args, **kw)
    want = k3.reml_converge_plain(*args, **kw)
    for g, w, name in zip(got, want, ("delta", "lml", "scale", "beta")):
        assert g.dtype == f64 and g.shape == w.shape
        assert_allclose(g.numpy(), w.numpy(), rtol=1e-9, atol=1e-12,
                        err_msg=name)
    return got


@pytest.mark.parametrize("build", ["resident", "chunked"])
@pytest.mark.parametrize("p", [1, 3, 15])
def test_f32_converge_reml_gene_axis(libs, p, build):
    """REML (the screen's stage 3) on three genes whose best rho are
    spread over the grid, at p + 1 = 2, 4 and 16 (the float32 context's
    widest)."""
    ctx, G, n = _context32(1500 + p, p, genes=3)
    (call,) = captured(lambda: engine.interaction_batch(
        ctx, G, G, n, delta_cfg=CFG, newton_f32=2, newton_f64=2),
        ["reml_converge"])["reml_converge"]
    kb = call[0][5]
    assert kb.shape == (3, G.shape[1]) and len(set(kb.flatten().tolist())) >= 2
    _converge_close(libs[build], call)


@pytest.mark.parametrize("build", ["resident", "chunked"])
@pytest.mark.parametrize("p", [1, 3])
def test_f32_converge_ml_refit(libs, p, build):
    """ML (K7 on the float32 context, one phenotype at one rho, no
    k_best): the Newton call, then the zero-step fits at the grid's
    ends."""
    ctx, G, n = _context32(1520 + p, p, nrho=3)
    calls = captured(lambda: engine.association_refit_batch(
        ctx, G, 1, n, delta_cfg=CFG, newton_f64=3),
        ["reml_converge"])["reml_converge"]
    assert [c[0][10] for c in calls] == [3, 0, 0]
    for call in calls:
        assert not call[1]["restricted"]
        _converge_close(libs[build], call)


@pytest.mark.parametrize("build", ["resident", "chunked"])
def test_f32_converge_ml_per_gene_rho(libs, build):
    """ML on the gene-batched refit: each gene's problems at its own rho
    (two genes on one, a third on another)."""
    ctx, G, n = _context32(1530, 2, genes=3, nrho=3)
    calls = captured(lambda: engine.association_refit_multigene_batch(
        ctx, G, np.array([2, 0, 2]), n, delta_cfg=CFG, newton_f64=3),
        ["reml_converge"])["reml_converge"]
    assert [c[0][10] for c in calls] == [3, 0, 0]
    for call in calls:
        _converge_close(libs[build], call)


@pytest.mark.parametrize("objective", ["reml", "ml"])
def test_f32_converge_keeps_a_failed_factorization(libs, objective):
    """A variant whose f32 normal matrix is indefinite (its genotype's
    complement Gram set to -1e4): the Cholesky's NaN pivot gives a NaN
    residual, which neither REML's floors (128 eps(f32) q, then tiny) nor
    ML's (tiny(f32)) may turn into a finite lml, as in the plain version;
    the other variants are unchanged."""
    ctx, G, n = _context32(1540, 1, nrho=3)
    if objective == "reml":
        run = lambda: engine.interaction_batch(  # noqa: E731
            ctx, G, G, n, delta_cfg=CFG, newton_f32=2, newton_f64=2)
    else:
        run = lambda: engine.association_refit_batch(  # noqa: E731
            ctx, G, 1, n, delta_cfg=CFG, newton_f64=3)
    args, kw = _contiguous(captured(run, ["reml_converge"])
                           ["reml_converge"][0])
    comp = args[3]
    Cgg = comp.Cgg.clone()
    Cgg[1] = -1e4
    args = (*args[:3], comp._replace(Cgg=Cgg), *args[4:])
    delta, lml, scale, beta = _converge_close(libs["resident"], (args, kw))
    assert bool(torch.isnan(lml[1])) and bool(torch.isnan(scale[1]))
    assert bool(torch.isnan(beta[1]).any())
    assert bool(torch.isfinite(lml[torch.arange(len(lml)) != 1]).all())


def _fast_close(got, want):
    tol = FAST_TOL[want.lml.dtype]
    for g, w, name in zip(got, want, want._fields):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        err = float((g - w).abs().max())
        assert err <= tol[name] * float(w.abs().max()), (name, err)


def _fast_call(seed, p, dt, genes=0, k=None, S=37):
    """K8's arguments from the engine: a 37-variant batch (not a multiple
    of 32 or of a lane's variants) of a single phenotype at rho 1, or of
    ``genes`` genes at rho ``k`` (several slots), in ``dt``."""
    ctx, G, n = fit_dataset(seed, p=p, nrho=4, n=70, donors=10, S=S)
    if genes:
        rng = np.random.default_rng(seed)
        Y = ctx.y[None] + torch.as_tensor(
            rng.uniform(0.2, 1.5, size=(genes, 1))
            * rng.normal(size=(genes, n)))
        ctx = ctx._replace(y=Y, Zy=Y @ ctx.Z, Wy=Y @ ctx.W,
                           yy=(Y * Y).sum(dim=1))
    ctx = engine.NullContext(*(t.to(dt) for t in ctx))
    G = G.to(dt)
    if genes:
        delta = torch.linspace(0.2, 0.8, genes, dtype=dt)
        run = lambda: engine.fast_scan_multigene_batch(  # noqa: E731
            ctx, G, np.asarray(k), delta, n)
    else:
        run = lambda: engine.fast_scan_batch(ctx, G, 1, 0.37, n)  # noqa
    (args, kw), = captured(run, ["fast_scan"])["fast_scan"]
    return _contiguous((args, kw))


def _fast_run(lib, call):
    args, kw = call
    if "slot" in kw:
        slot = kw["slot"]
        index = torch.as_tensor(k8.slot_order(slot, args[1].shape[0]))
        return (k8.call_genes(lib, *args, slot=slot, index=index),
                k8.fast_scan_genes_plain(*args, slot=slot))
    return k8.call(lib, *args, **kw), k8.fast_scan_plain(*args, **kw)


@pytest.mark.parametrize("build", ["k8", "k8_splits"])
@pytest.mark.parametrize("p,dt", [(1, f64), (3, f64), (17, f64), (1, f32),
                                  (3, f32)])
def test_fast_scan_matches_plain(libs, p, dt, build):
    """One phenotype, p = 1 and 3 in both dtypes and the wide
    instantiation (p = 17, f64)."""
    got, want = _fast_run(libs[build], _fast_call(1550 + p, p, dt))
    assert got.lml.shape == (37,)
    _fast_close(got, want)


@pytest.mark.parametrize("build", ["k8", "k8_splits"])
@pytest.mark.parametrize("p,dt,k", [(1, f64, [1, 0, 1, 1, 1, 2, 1]),
                                    (2, f32, [3, 0, 3]),
                                    (5, f64, [2, 1, 2]),
                                    (17, f64, [0, 1])])
def test_fast_scan_gene_axis_on_slots(libs, p, dt, k, build):
    """The gene axis over several slots: five genes of one slot past a
    chunk of four (p <= 2), slots of one and two genes, the 16-wide and
    the wide instantiations."""
    call = _fast_call(1560 + p, p, dt, genes=len(k), k=k)
    got, want = _fast_run(libs[build], call)
    assert got.lml.shape == (len(k), 37)
    _fast_close(got, want)


@pytest.mark.parametrize("dt", [f64, f32])
def test_fast_scan_bits_do_not_depend_on_the_schedule(libs, dt):
    """Two launches of one gene-axis call (each block's threads
    interleaved otherwise by the emulator) return the same bits."""
    call = _fast_call(1570, 1, dt, genes=3, k=[1, 2, 1])
    first, _ = _fast_run(libs["k8_splits"], call)
    second, _ = _fast_run(libs["k8_splits"], call)
    for a, b in zip(first, second):
        assert torch.equal(a, b)
