"""K10: the covariates-only fits over the rho grid, one profiled fit per rho.

Per rho point: the lml on a grid of ``n_grid`` logit(delta) points, the
argmax, ``n_iters`` golden-section steps in the bracket around it, and the
final fit (cellregmap_tpu/engine.py:268-289 ``_fit_over_rho`` through
models/lmm.py:211-251,333-351 ``fit_delta_eig``).  ``restricted`` selects
REML (with logdet(A) and logdet(X^T X)) or ML; the association's null fit
is ML, ``mean_fit_kernel``'s fits are REML.

On a CUDA tensor :func:`null_fit` launches ``csrc/null_fit.cu`` (up to 16
mean columns every evaluation on a whole block over the rows staged in
shared memory: the grid a launch of blocks of 8 or more grid points, the
golden section and the final fit a block per rho point; above 16, up to
128, the wide instantiation: every evaluation a tensor-core product over
R and a factorization in registers, the grid a block per (grid point,
rho), each golden-section step one launch spreading its evaluations over
several blocks a rho point); on a CPU tensor it runs
:func:`null_fit_plain`, which is ``models.lmm.fit_delta_eig`` over the rho
axis.

The gene-batched association scans fit many phenotypes against one
covariance family (cellregmap_tpu/engine.py:1154-1173
``null_association_multigene_kernel``): the phenotype's operands (yt,
cxy, cyy) carry a leading gene axis, S, Xt and Cxx are shared, and the
fits gain the same leading axis.  One call serves every gene (the kernel
takes the genes as a grid axis; at p = 1 the grid takes them in tiles of
up to 16, one pass over the rows a grid point for the whole tile); the
plain version fits one gene at a time.

The float32 context (``ScanConfig(dtype="float32")``: the association's
null fits on f32 operands, the JAX engine's f32 ``null_association_kernel``
and its gene axis) takes f32 operands and returns f32 fits: an
instantiation of its own (``crm_null_fit_f32``), ML only, p + 1 <=
``MAX_FIXED_F32``, whose sums, factorization, grid and golden section run
in f32 as ``fit_delta_eig`` does on f32 tensors, in the narrow design
on f32 rows: the grid a launch of its own (a warp a grid point over rows
staged in shared memory, blocks of grid points, at p = 1 a block a tile
of up to 16 genes) into a scratch of the grid's values, then a block a
(rho, gene) for the argmax, the golden section and the final fit, every
evaluation on the whole block over its staged rows; its plain version is
the same ``fit_delta_eig`` on the f32 tensors.  It counts its launches in
``launches_f32`` too.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from ..models.lmm import EigData, FitResult, fit_delta_eig, lml_at_delta_eig

launches = 0
launches_f32 = 0  # of them, the float32 context's instantiation

MAX_FIXED = 128     # p of the CUDA kernel's wide instantiation
MAX_GRID = 1024     # grid points the kernel holds in shared memory
MAX_GENES = 65535   # genes of one launch (a grid axis)
MAX_FIXED_F32 = 16  # p + 1 of the float32 context's instantiation


def gene_data(data: EigData, g: int) -> EigData:
    """Gene ``g``'s problems of a gene-batched set (yt (genes, nrho, R),
    cxy (genes, nrho, p), cyy (genes, nrho)); S, Xt and Cxx are shared."""
    return data._replace(yt=data.yt[g], cxy=data.cxy[g], cyy=data.cyy[g])


def null_fit_plain(data: EigData, n, restricted, lo, hi, n_grid, n_iters):
    """Plain torch version: :func:`models.lmm.fit_delta_eig`, one gene at a
    time."""
    if data.yt.ndim == 3:
        return FitResult(*(torch.stack(f) for f in zip(*(
            fit_delta_eig(gene_data(data, g), n, restricted, lo, hi, n_grid,
                          n_iters)
            for g in range(data.yt.shape[0])))))
    return fit_delta_eig(data, n, restricted, lo, hi, n_grid, n_iters)


def fit_gaps(fits: FitResult, plain: FitResult, data: EigData, n,
             restricted) -> dict:
    """Largest relative gaps of a fit against the plain one.

    Two correct golden-section searches that sum in different orders stop
    ~sqrt(eps) apart in delta, where the lml is flat to eps * |lml|, so
    delta is not compared with delta: the plain objective is evaluated at
    the fit's delta instead.  ``lml``: the fit's lml vs the plain maximum;
    ``lml_at_delta``: the plain lml at the fit's delta vs the plain
    maximum (the fit's delta is an optimum of the same objective);
    ``beta``/``scale``: the fit's vs the plain ones at the fit's delta.
    A gene-batched set reports the largest gap over its genes.
    """
    if data.yt.ndim == 3:
        per = [fit_gaps(FitResult(*(t[g] for t in fits)),
                        FitResult(*(t[g] for t in plain)), gene_data(data, g),
                        n, restricted) for g in range(data.yt.shape[0])]
        return {k: max(gp[k] for gp in per) for k in per[0]}
    rel = lambda a, b: float(((a - b).abs() / b.abs()).max())  # noqa: E731
    lml, beta, scale, _ = (t[:, 0] for t in lml_at_delta_eig(
        fits.delta[:, None], data, n, restricted))
    return {"lml": rel(fits.lml, plain.lml),
            "lml_at_delta": rel(lml, plain.lml),
            "beta": rel(fits.beta, beta), "scale": rel(fits.scale, scale)}


def _bind(lib):
    vp, ci, cd = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    lib.crm_null_fit.restype = ci
    lib.crm_null_fit.argtypes = [vp] * 14 + [cd, cd] + [ci] * 8 + [vp]
    lib.crm_null_fit_scratch.restype = ctypes.c_longlong
    lib.crm_null_fit_scratch.argtypes = [ci] * 5
    lib.crm_null_fit_f32.restype = ci
    lib.crm_null_fit_f32.argtypes = [vp] * 14 + [cd, cd] + [ci] * 7 + [vp]


def null_fit(data: EigData, n, restricted, lo, hi, n_grid, n_iters):
    """:class:`FitResult` of each rho's fit, fields ([genes,] nrho) and
    beta ([genes,] nrho, p).  ``data`` holds S (nrho, R), Xt (nrho, R, p),
    yt ([genes,] nrho, R) and the complements Cxx (nrho, p, p), cxy
    ([genes,] nrho, p), cyy ([genes,] nrho), f64; or all f32 (the float32
    context: ML, p + 1 <= ``MAX_FIXED_F32``), whose fits are f32.
    """
    global launches, launches_f32
    S = data.S
    if S.device.type == "cpu":
        return null_fit_plain(data, n, restricted, lo, hi, n_grid, n_iters)
    nrho, R = S.shape
    p = data.Xt.shape[2]
    gs = tuple(data.yt.shape[:-2])
    if len(gs) > 1 or (gs and not 1 <= gs[0] <= MAX_GENES):
        raise ValueError(f"null_fit: a gene axis of 1..{MAX_GENES} genes, "
                         f"got yt of shape {tuple(data.yt.shape)}")
    if not 1 <= p <= MAX_FIXED:
        raise ValueError(f"null_fit: needs 1 <= p <= {MAX_FIXED} covariates, "
                         f"got {p}")
    if not 1 <= n_grid <= MAX_GRID:
        raise ValueError(f"null_fit: needs 1 <= n_grid <= {MAX_GRID}, "
                         f"got {n_grid}")
    dt = _build.context_dtype(S, "null_fit: S")
    if dt == torch.float32 and (restricted or p + 1 > MAX_FIXED_F32):
        raise ValueError(f"null_fit: the float32 context runs ML with p + 1 "
                         f"<= {MAX_FIXED_F32}, got p + 1 = {p + 1}, "
                         f"restricted={restricted}")
    _build.require_all("null_fit", dt, (
        (S, "S", (nrho, R)), (data.Xt, "Xt", (nrho, R, p)),
        (data.yt, "yt", gs + (nrho, R)), (data.Cxx, "Cxx", (nrho, p, p)),
        (data.cxy, "cxy", gs + (nrho, p)), (data.cyy, "cyy", gs + (nrho,))))
    out = call(_build.load("null_fit", _bind), data, n, restricted, lo, hi,
               n_grid, n_iters, _build.stream_ptr(S.device))
    launches += 1
    launches_f32 += dt == torch.float32
    return out


def call(lib, data: EigData, n, restricted, lo, hi, n_grid, n_iters,
         stream=None):
    """Allocate the fits and call ``lib``'s entry point (the card's
    library, or an emulation of it on CPU tensors)."""
    nrho, R = data.S.shape
    p = data.Xt.shape[2]
    gs = tuple(data.yt.shape[:-2])
    genes = math.prod(gs)
    problems = genes * nrho
    dev, dt = data.S.device, data.S.dtype
    f32 = dt == torch.float32
    # the scalar fields in one allocation (unbound into views), with the
    # grid's values behind them in the float32 context; beta apart
    buf = torch.empty((6 + (n_grid if f32 else 0)) * problems, dtype=dt,
                      device=dev)
    lml, delta, scale, v0, v1, rss = buf[:6 * problems].view(
        (6,) + gs + (nrho,)).unbind(0)
    out = FitResult(lml, delta, torch.empty(gs + (nrho, p), dtype=dt,
                                            device=dev),
                    scale, v0, v1, rss)
    if problems == 0:
        return out
    if f32:  # the float32 context: the grid's values are its scratch
        vals = buf[6 * problems:]
        _build.check(lib.crm_null_fit_f32(
            *(_build.ptr(t) for t in (*data, *out, vals)), lo, hi, n_grid,
            n_iters, n, nrho, R, p, genes, stream), "null_fit")
        return out
    # the logdets and grid values, the wide instantiation's golden-section
    # partial sums and states
    scratch = torch.empty((lib.crm_null_fit_scratch(p, nrho, R, n_grid,
                                                    genes),),
                          dtype=torch.float64, device=dev)
    _build.check(lib.crm_null_fit(*(_build.ptr(t)
                                    for t in (*data, *out, scratch)),
                                  lo, hi, n_grid, n_iters, n, nrho, R, p,
                                  int(restricted), genes, stream), "null_fit")
    return out
