"""The narrow K10 (``csrc/null_fit.cu`` at p <= 16: every evaluation on a
whole block, its rows staged in shared memory) and K6a
(``csrc/sym_eigvalsh.cu``: a warp a matrix up to C = 32, Householder and
bisection a block a matrix above), run on the CPU under the emulator of
``tests/_cuda_emu.py``, against their plain torch versions.

K10 at p in {1, 2, 5, 12, 16} mean columns (2 x 2 register tiles up to p
= 4, 4 x 4 above; p = 1 makes its weights in the row loop), REML and ML,
on one rho point with R = 90 rows, a 12-point grid (two blocks of the
grid kernel, the second ragged) and 12 golden-section steps, through
``null_fit.fit_gaps`` at 1e-10 (two golden-section searches that sum in
different orders stop ~sqrt(eps) apart in delta where the lml is flat:
the plain objective is evaluated at the kernel's delta); with
the gene axis (3 genes); at p = 1 with 5 genes, REML and ML, the grid a
block per tile of genes (one tile of 5, and tiles of 2, 2 and 1 from a
build held to 2 genes a tile), each gene's fit exactly its own call's;
with the rows streamed in 32-row chunks (a build
with a 1 KB staging limit); and with one rho point's phenotype NaN (its
grid values NaN: the argmax takes the first point, as torch's, the fit is
NaN with the plain version's delta, the other rho point's fit as usual).

K6a at C in {3, 10, 31, 32, 33, 50, 64} (both sides of the routes'
boundary and the card's envelope) on K5's weight matrices, a rank-deficient
one, a non-symmetric one, the zero matrix, a diagonal one, one with a
repeated eigenvalue, a hollow one (zero diagonal: no rotation may be
skipped for it), four copies of one whose Householder steps turn from
trivial reflectors to full ones (a tridiagonal block beside a dense one:
consecutive blocks, so each runs under every order of the emulator's
scheduler) and one with a NaN entry: ascending, clamped at 0,
within 1e-12 of each row's largest |lambda| (both sides reach rounding of
the largest eigenvalue), NaN exactly for the NaN matrix; the iteration
counts (Jacobi sweeps, bisection steps) within their caps.
"""
import numpy as np
import pytest
import torch

from _cuda_emu import emulated, nan_outputs  # noqa: F401
from _torch_inputs import captured, fit_dataset, score_inputs
from cellregmap_tpu_torch import engine
from cellregmap_tpu_torch.kernels import null_fit as k10
from cellregmap_tpu_torch.kernels import score_core as k5
from cellregmap_tpu_torch.kernels import sym_eigvalsh as k6a

DELTA_CFG = (-18.0, 18.0, 12, 12)   # two grid tiles, the second ragged


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("cuda_emu_k6a_k10")
    out = {"null_fit": emulated("null_fit", workdir),
           "sym_eigvalsh": emulated("sym_eigvalsh", workdir)}
    chunked = workdir / "chunked"
    chunked.mkdir()
    out["null_fit_chunked"] = emulated(
        "null_fit", chunked, defines=("CRM_NF_SMEM_KB=1", "CRM_NF_CHUNK=32"))
    tiles = workdir / "tiles"
    tiles.mkdir()
    out["null_fit_tiles"] = emulated("null_fit", tiles,
                                     defines=("CRM_NF_GENE_TILE=2",))
    k10._bind(out["null_fit"])
    k10._bind(out["null_fit_chunked"])
    k10._bind(out["null_fit_tiles"])
    k6a._bind(out["sym_eigvalsh"])
    return out


def _fit_call(p, restricted, nrho=1, seed=0):
    """K10's arguments on a mean fit with p mean columns: REML fits [W, g]
    (W of p - 1 columns; W alone at p = 1), ML fits W."""
    with_g = restricted and p > 1
    ctx, G, n = fit_dataset(seed + p, p=p - 1 if with_g else p, nrho=nrho,
                            n=120, donors=30)
    M = torch.cat([ctx.W, G[:, :1]], dim=1) if with_g else ctx.W
    (args, kw), = captured(lambda: engine._fit_over_rho(
        ctx, ctx.Z.T @ M, M.T @ M, M.T @ ctx.y, n, restricted, DELTA_CFG),
        ["null_fit"])["null_fit"]
    assert args[0].Xt.shape == (nrho, 90, p)
    return args, kw


def _fit_close(lib, args, kw):
    fits = k10.call(lib, *args, **kw)
    gaps = k10.fit_gaps(fits, k10.null_fit_plain(*args, **kw), args[0],
                        args[1], args[2])
    assert max(gaps.values()) <= 1e-10, gaps


@pytest.mark.parametrize("p", [1, 2, 5, 12, 16])
@pytest.mark.parametrize("restricted", [False, True])
def test_null_fit_narrow_source_matches_plain(libs, p, restricted):
    args, kw = _fit_call(p, restricted)
    _fit_close(libs["null_fit"], args, kw)


def test_null_fit_narrow_source_gene_axis(libs):
    """Three phenotypes on one covariance family (the gene-batched null
    fit at p = 5, 4 x 4 tiles): S, Xt and Cxx shared, each gene's fits as
    the plain version's, a gene's slice as its own call's."""
    ctx, _, n = fit_dataset(9, p=5, nrho=1, n=120, donors=30)
    rng = np.random.default_rng(9)
    Y = ctx.y[None] + torch.as_tensor(
        rng.uniform(0.2, 1.5, size=(3, 1)) * rng.normal(size=(3, n)))
    ctx = ctx._replace(y=Y, Zy=Y @ ctx.Z, Wy=Y @ ctx.W, yy=(Y * Y).sum(dim=1))
    (args, kw), = captured(lambda: engine.null_association_multigene_fit(
        ctx, n, delta_cfg=DELTA_CFG), ["null_fit"])["null_fit"]
    data = args[0]
    assert data.yt.shape == (3, 1, 90)
    fits = k10.call(libs["null_fit"], *args, **kw)
    gaps = k10.fit_gaps(fits, k10.null_fit_plain(*args, **kw), data, n,
                        False)
    assert max(gaps.values()) <= 1e-10, gaps
    one = k10.call(libs["null_fit"], k10.gene_data(data, 2), *args[1:], **kw)
    for got, alone in zip(fits, one):
        assert torch.equal(got[2], alone)


@pytest.mark.parametrize("build", ["null_fit", "null_fit_tiles"])
@pytest.mark.parametrize("restricted", [False, True])
def test_null_fit_narrow_source_gene_tiles(libs, build, restricted):
    """Five phenotypes at p = 1 on two rho points: the grid a block per
    tile of genes, one pass a point for the whole tile; each gene's fits
    as the plain version's, and the first and last gene's exactly as
    their own calls' (a gene alone takes the grid a gene a block, with the
    same sums in the same order)."""
    ctx, _, n = fit_dataset(4, p=1, nrho=2, n=120, donors=30)
    rng = np.random.default_rng(4)
    Y = ctx.y[None] + torch.as_tensor(
        rng.uniform(0.2, 1.5, size=(5, 1)) * rng.normal(size=(5, n)))
    ctx = ctx._replace(y=Y, Zy=Y @ ctx.Z, Wy=Y @ ctx.W, yy=(Y * Y).sum(dim=1))
    (args, kw), = captured(lambda: engine.null_association_multigene_fit(
        ctx, n, delta_cfg=DELTA_CFG), ["null_fit"])["null_fit"]
    data = args[0]
    assert data.yt.shape == (5, 2, 90) and data.Xt.shape[2] == 1
    args = (data, n, restricted, *args[3:])
    fits = k10.call(libs[build], *args, **kw)
    gaps = k10.fit_gaps(fits, k10.null_fit_plain(*args, **kw), data, n,
                        restricted)
    assert max(gaps.values()) <= 1e-10, gaps
    for g in (0, 4):
        one = k10.call(libs[build], k10.gene_data(data, g), *args[1:], **kw)
        for got, alone in zip(fits, one):
            assert torch.equal(got[g], alone)


@pytest.mark.parametrize("p", [1, 12])
def test_null_fit_narrow_source_in_chunks(libs, p):
    """The rows past the staging limit: every evaluation streams them in
    three 32-row chunks (p = 1 makes its weights in the row loop, p = 12
    in a pass of their own)."""
    args, kw = _fit_call(p, True)
    _fit_close(libs["null_fit_chunked"], args, kw)


def test_null_fit_narrow_source_nan_rho(libs):
    args, kw = _fit_call(1, False, nrho=2)
    data = args[0]
    yt = data.yt.clone()
    yt[1, 5] = float("nan")
    data = data._replace(yt=yt)
    fits = k10.call(libs["null_fit"], data, *args[1:], **kw)
    plain = k10.null_fit_plain(data, *args[1:], **kw)
    assert bool(torch.isnan(plain.lml[1])) and bool(torch.isnan(fits.lml[1]))
    assert float(fits.delta[1]) == pytest.approx(float(plain.delta[1]),
                                                 rel=1e-12)
    first = data._replace(**{f: getattr(data, f)[:1] for f in data._fields})
    gaps = k10.fit_gaps(type(fits)(*(t[:1] for t in fits)),
                        type(plain)(*(t[:1] for t in plain)), first,
                        args[1], args[2])
    assert max(gaps.values()) <= 1e-10, gaps


def _matrices(C):
    """K5's weight matrices at C contexts, then a rank-deficient, a
    non-symmetric, the zero, a diagonal, a repeated-eigenvalue and a
    hollow (zero-diagonal) matrix, four copies of a tridiagonal block
    beside a dense one, then one with a NaN entry."""
    args = [torch.as_tensor(a)
            for a in score_inputs(C + 7, C=C, p=1, n=80, R=37, S=2)]
    _, Wmat = k5.score_core_plain(*args)
    rng = np.random.default_rng(C)
    B = rng.normal(size=(C, max(C // 2, 1)))
    Q = np.linalg.qr(rng.normal(size=(C, C)))[0]
    rep = Q @ np.diag(np.r_[np.full(C // 2, 2.0), np.ones(C - C // 2)]) @ Q.T
    nan = rng.normal(size=(C, C))
    nan[C // 2, C - 1] = np.nan
    hollow = rng.normal(size=(C, C))
    np.fill_diagonal(hollow, 0.0)
    h = C // 2
    split = np.zeros((C, C))
    split[:h, :h] = (np.diag(rng.normal(size=h))
                     + np.diag(rng.normal(size=h - 1), 1)
                     + np.diag(rng.normal(size=h - 1), -1)) if h else 0.0
    split[h:, h:] = rng.normal(size=(C - h, C - h))
    more = np.stack([B @ B.T, rng.normal(size=(C, C)), np.zeros((C, C)),
                     np.diag(rng.normal(size=C)), rep, hollow,
                     *[split] * 4, nan])
    return torch.cat([Wmat, torch.as_tensor(more)])


@pytest.mark.parametrize("C", [3, 10, 31, 32, 33, 50, 64])
def test_sym_eigvalsh_routes_match_plain(libs, C):
    A = _matrices(C)
    lam, sweeps = k6a.call(libs["sym_eigvalsh"], A, return_sweeps=True)
    want = k6a.sym_eigvalsh_plain(A)
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(lam), nan)
    assert bool(nan[-1].all()) and not bool(nan[:-1].any())
    lam, want = lam[:-1], want[:-1]
    scale = want.abs().amax(dim=1, keepdim=True).clamp(min=1e-300)
    assert float(((lam - want).abs() / scale).max()) <= 1e-12
    assert bool((lam[:, 1:] >= lam[:, :-1]).all()) and bool((lam >= 0).all())
    cap = k6a.MAX_SWEEPS if C <= k6a.WARP_MAX_C else k6a.MAX_BISECT
    assert 0 < int(sweeps[:-1].max()) < cap and int(sweeps[-1]) == 0
