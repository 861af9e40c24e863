"""K3 (and the Newton half of K7): safeguarded Newton on the analytic
derivative of the profiled lml, from the delta grid's brackets.

Two entry points, each with its plain torch version:

* :func:`reml_localize` (stages 1b and 2 of cellregmap_tpu/engine.py
  :628-670): ``steps`` Newton steps on every (variant, rho) problem from
  its bracket's midpoint, then one f64 lml evaluation at the localized
  optimum and the argmax over rho.  Under hybrid localization the steps run
  f64 arithmetic on f32-ROUNDED tensors (``round32``), as the reference's
  type promotion does; the evaluation uses the unrounded tensors, and an
  rss below 128 eps q there cannot win the argmax (:655).
* :func:`reml_converge` (stage 3, :672-734, and the association refit's
  Newton, :991-1062): at each variant's rho ``k_best`` (0 when None), f64
  steps on the unrounded tensors from ``x0`` (the localized optimum; the
  bracket midpoint when None) within the GRID bracket (:704-709), then the
  final evaluation.  REML floors the final rss at 128 eps q (:724); ML
  only at tiny (:1056) and has no logdet(A) trace terms (:1026-1028).

On a CUDA tensor the wrappers launch ``csrc/reml_newton.cu``; on a CPU
tensor they run the plain versions.  Up to p + 1 = 4 the localize is the
register route: a warp a (gene, variant, rho) problem, a block a rho
point and a tile of variants and genes, the rows its problems share
(the rho's eigenvalues and W, each variant's genotype, each gene's
phenotype, and the f32-rounded products of W and of the phenotype)
staged in shared memory once a block, every row at once where they fit,
else in chunks, then a small argmax kernel over rho; any number of rho
points.  From p + 1 = 5 the localize takes
the product route: per Newton step and rho, the sums over the pairs of
[W, y], which no variant's genotype enters, are one product of the
problems' weights and those pairs on the FP64 tensor cores, the
genotype's sums a pass of their own, and each problem's algebra an
epilogue; its scratch is one allocation sized by the source's workspace
query.  The converge lists each rho's (gene, variant) problems on the
card and gives a block a rho and a tile of four of its problems, whose
shared rows (the rho's eigenvalues and W, the problems' genotype
columns, the tile's phenotypes) it stages once for every Newton step and
the final fit (in chunks where they do not fit; a call with no steps
reads them in place); its scratch is the lists, sized by the source's
workspace query.  A gene-batched call gives
the phenotype's operands, the brackets and ``k_best``/``x0`` a leading
gene axis (as :mod:`.delta_grid` does); one launch of the wrapper serves
every gene.

The float32 context takes f32 operands, p + 1 <= ``MAX_FIXED_F32``: the
screen's localize (REML) runs the Newton steps in f32 arithmetic with f32
state (stage 1b as the reference computes it on an f32 context) and the
evaluation in f64 on the widened tensors, the converge f64 on the widened
tensors; the noise floors of both take eps(f32), the tensors'
(engine.py:655, :724), and the products are the f32 products.  The
converge also takes the ML objective on an f32 context: the association
refit's Newton half (K7, engine.py:991-1062, whose brackets are the grid's
f64 logits and whose steps and final fit are f64 arithmetic on the f32
tensors), its rss floored at tiny(f32) (:1056).  The f32 localize
(``crm_reml_localize_f32``) is, up to p + 1 = 4, the register localize
above on f32 rows (the rows and their products staged as f32, twice as
many a block; f32 steps, then the f64 evaluation on the same staged rows,
widened) and, from p + 1 = 5, a block a (rho, tile of problems) staging
their rows as the converge does, each problem's sums split over two or
four warps (a compile-time range of the packed triangle of [W, g, y]
each) that meet in the problem's shared-memory workspace, where one warp
runs the algebra; no scratch.  The f32 converge (``crm_reml_converge_f32``)
is the converge's design above on f32 rows (staged as f32, twice as many a
block), with the same lists and scratch.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from ._normal_eqs import (Complements, gene_comp, lml_value, ne_family,
                          newton_step, products, tensor_set)
from .delta_grid import check_operands, gene_shape
from ..ops.linalg import (unrolled_chol_factor, unrolled_chol_logdet,
                          unrolled_chol_solve)

launches = 0
launches_f32 = 0  # of them, the float32 context's instantiations

MAX_FIXED_F32 = 16  # p + 1 of the float32 context's kernels


def _eval(delta, TS, rs, ro, n, R, ld_xx, restricted):
    """(beta, rss, q, logdet(A), logdet(D)) of the GLS fit at ``delta``."""
    dx = delta[..., None]
    S = TS["S"][None] if (TS["S"].ndim == 2 and delta.ndim == 2) \
        else TS["S"]
    d = (1 - dx) * S + dx
    A, b, q = ne_family(1.0 / d, 1.0 / delta, TS, rs, ro)
    L = unrolled_chol_factor(A)
    beta = unrolled_chol_solve(L, b)
    rss = q - sum(b[j] * beta[j] for j in range(len(b)))
    logdet_d = torch.log(d).sum(dim=-1) + (n - R) * torch.log(delta)
    return beta, rss, q, unrolled_chol_logdet(L), logdet_d


def reml_localize_plain(S, WGt, yt, comp: Complements, ld_xx, br_lo, br_hi,
                        n, steps, round32):
    """Plain torch version: (x (S, nrho) localized logit(delta),
    lml_all (S, nrho) f64 REML lml there, k_best (S,) argmax over rho),
    one gene at a time."""
    if yt.ndim == 3:
        return tuple(torch.stack(o) for o in zip(*(
            reml_localize_plain(S, WGt, yt[g], gene_comp(comp, g), ld_xx,
                                br_lo[g], br_hi[g], n, steps, round32)
            for g in range(yt.shape[0]))))
    p = comp.CWW.shape[0]
    R = S.shape[1]
    ctx, f64, f32 = S.dtype, torch.float64, torch.float32
    prod = products(WGt[:, :, :p], yt, WGt[:, :, p:])
    # the context's tensors held in f64 (the float32 context's widened)
    TS64 = tensor_set(S, prod, comp, ctx, f64)
    ro = lambda w, t: torch.einsum("sor,or->so", w, t)  # noqa: E731
    rs = lambda w, t: torch.einsum("sor,ors->so", w, t)  # noqa: E731

    if ctx == f32:
        # stage 1b of the float32 context: f32 arithmetic, f32 state
        TS1b = tensor_set(S, prod, comp, f32)
        lo32, hi32 = br_lo.to(f32), br_hi.to(f32)
        st = (0.5 * (lo32 + hi32), lo32, hi32)
    else:
        TS1b = tensor_set(S, prod, comp, f32, f64) if round32 else TS64
        st = (0.5 * (br_lo + br_hi), br_lo, br_hi)
    for _ in range(steps):
        st = newton_step(st, TS1b, rs, ro, n, True)
    x = st[0].to(f64)
    delta = torch.sigmoid(x)                             # (S, nrho)

    beta, rss, q, logdet_a, logdet_d = _eval(delta, TS64, rs, ro, n, R,
                                             ld_xx, True)
    # the tensors' noise floor: eps of the context (engine.py:655)
    rss_bad = rss <= 128 * torch.finfo(ctx).eps * q
    rss = torch.clamp(rss, min=torch.finfo(f64).tiny)
    lml_all = lml_value(rss, logdet_d, logdet_a, ld_xx.to(f64)[:, None], n,
                        p + 1, True)
    # noise-floor or NaN evaluations must not win the rho argmax
    lml_all = torch.where(rss_bad | ~torch.isfinite(lml_all), -torch.inf,
                          lml_all)
    return x, lml_all, lml_all.argmax(dim=-1)


def reml_converge_plain(S, WGt, yt, comp: Complements, ld_xx, k_best, x0,
                        br_lo, br_hi, n, steps, restricted=True):
    """Plain torch version: (delta, lml, scale, beta) per variant at its
    rho ``k_best``; delta/lml/scale (S,), beta (S, p + 1); one gene at a
    time."""
    if yt.ndim == 3:
        at = lambda t, g: None if t is None else t[g]  # noqa: E731
        return tuple(torch.stack(o) for o in zip(*(
            reml_converge_plain(S, WGt, yt[g], gene_comp(comp, g), ld_xx,
                                at(k_best, g), at(x0, g), br_lo[g], br_hi[g],
                                n, steps, restricted)
            for g in range(yt.shape[0]))))
    p = comp.CWW.shape[0]
    R = S.shape[1]
    ctx, f64 = S.dtype, torch.float64
    nS = WGt.shape[2] - p
    ar = torch.arange(nS, device=S.device)
    if k_best is None:
        k_best = torch.zeros(nS, dtype=torch.int64, device=S.device)
    # each variant's rho rows (the same bits as the gathered products)
    prod = products(WGt[k_best, :, :p], yt[k_best],
                    WGt[k_best, :, p + ar][:, :, None])
    prod.update(GY=prod["GY"][..., 0], G2=prod["G2"][..., 0],
                GW=[a[..., 0] for a in prod["GW"]])
    # the context's tensors held in f64 (the float32 context's widened)
    TS = tensor_set(S[k_best], prod, comp, ctx, f64)
    red = lambda w, t: (w * t).sum(dim=-1)              # noqa: E731

    lo_b, hi_b = br_lo[ar, k_best], br_hi[ar, k_best]
    x = 0.5 * (lo_b + hi_b) if x0 is None else x0[ar, k_best]
    st = (x, lo_b, hi_b)
    for _ in range(steps):
        st = newton_step(st, TS, red, red, n, restricted)
    delta = torch.sigmoid(st[0])

    beta, rss, q, logdet_a, logdet_d = _eval(delta, TS, red, red, n, R,
                                             ld_xx, restricted)
    if restricted:
        # the tensors' cancellation noise floor keeps a near-degenerate
        # variant's scale finite (engine.py:722-724); eps of the context
        rss = torch.maximum(rss, 128 * torch.finfo(ctx).eps * q)
        ld_xx = ld_xx.to(f64)
        rss = torch.clamp(rss, min=torch.finfo(f64).tiny)
    else:
        # ML: tiny of the context (engine.py:1056)
        rss = torch.clamp(rss, min=torch.finfo(ctx).tiny)
    lml = lml_value(rss, logdet_d, logdet_a, ld_xx, n, p + 1, restricted)
    scale = rss / ((n - p - 1) if restricted else n)
    return delta, lml, scale, torch.stack(beta, dim=-1)


def _bind(lib):
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.crm_reml_localize.restype = ci
    lib.crm_reml_localize.argtypes = [vp] * 16 + [ci] * 8 + [vp]
    lib.crm_reml_localize_workspace.restype = ctypes.c_int64
    lib.crm_reml_localize_workspace.argtypes = [ci] * 5
    lib.crm_reml_converge_workspace.restype = ctypes.c_int64
    lib.crm_reml_converge_workspace.argtypes = [ci] * 3
    lib.crm_reml_converge.restype = ci
    lib.crm_reml_converge.argtypes = [vp] * 19 + [ci] * 8 + [vp]
    lib.crm_reml_localize_f32.restype = ci
    lib.crm_reml_localize_f32.argtypes = [vp] * 15 + [ci] * 7 + [vp]
    lib.crm_reml_converge_f32.restype = ci
    lib.crm_reml_converge_f32.argtypes = [vp] * 19 + [ci] * 8 + [vp]


def _check_f32(name, S, p):
    """The float32 context's limit: p + 1 <= MAX_FIXED_F32."""
    if S.dtype == torch.float32 and p + 1 > MAX_FIXED_F32:
        raise ValueError(f"{name}: the float32 context runs p + 1 <= "
                         f"{MAX_FIXED_F32}, got p + 1 = {p + 1}")


def reml_localize(S, WGt, yt, comp: Complements, ld_xx, br_lo, br_hi, n,
                  steps, round32):
    """(x ([genes,] S, nrho), lml_all ([genes,] S, nrho), k_best ([genes,]
    S) int64); see the module doc.  Operands as
    :func:`delta_grid.delta_grid`'s, plus the grid brackets br_lo/br_hi
    ([genes,] S, nrho) f64."""
    global launches, launches_f32
    if S.device.type == "cpu":
        return reml_localize_plain(S, WGt, yt, comp, ld_xx, br_lo, br_hi,
                                   n, steps, round32)
    nrho, R, p, nS, gs = check_operands("reml_localize", S, WGt, yt, comp,
                                        ld_xx, True)
    _check_f32("reml_localize", S, p)
    _build.require_all("reml_localize", torch.float64, (
        (br_lo, "br_lo", gs + (nS, nrho)), (br_hi, "br_hi", gs + (nS, nrho))))
    out = call_localize(_build.load("reml_newton", _bind), S, WGt, yt, comp,
                        ld_xx, br_lo, br_hi, n, steps, round32,
                        _build.stream_ptr(S.device))
    launches += 1
    launches_f32 += S.dtype == torch.float32
    return out


def call_localize(lib, S, WGt, yt, comp, ld_xx, br_lo, br_hi, n, steps,
                  round32, stream=None):
    """Allocate the outputs and the scratch and call ``lib``'s localize
    entry point (the card's library, or an emulation of it on CPU
    tensors)."""
    nrho, R = S.shape
    p = comp.CWW.shape[0]
    nS = WGt.shape[2] - p
    gs = gene_shape(yt)
    # x and lml_all in one allocation (unbound into views)
    x, lml_all = torch.empty((2,) + gs + (nS, nrho), dtype=torch.float64,
                             device=S.device).unbind(0)
    k_best = torch.empty(gs + (nS,), dtype=torch.int64, device=S.device)
    if k_best.numel() == 0:
        return x, lml_all, k_best
    if S.dtype == torch.float32:  # the float32 context: no scratch
        ptrs = [_build.ptr(t) for t in (S, WGt, yt, *comp, ld_xx, br_lo,
                                        br_hi, x, lml_all, k_best)]
        _build.check(lib.crm_reml_localize_f32(
            *ptrs, n, nrho, R, p, nS, math.prod(gs), steps, stream),
            "reml_localize")
        return x, lml_all, k_best
    nbytes = lib.crm_reml_localize_workspace(nrho, R, p, nS, int(round32))
    work = torch.empty(nbytes, dtype=torch.uint8, device=S.device)
    ptrs = [_build.ptr(t) for t in (S, WGt, yt, *comp, ld_xx, br_lo, br_hi,
                                    x, lml_all, k_best)]
    ptrs.append(_build.ptr(work) if nbytes else None)
    _build.check(lib.crm_reml_localize(*ptrs, n, nrho, R, p, nS,
                                       math.prod(gs), steps, int(round32),
                                       stream), "reml_localize")
    return x, lml_all, k_best


def reml_converge(S, WGt, yt, comp: Complements, ld_xx, k_best, x0, br_lo,
                  br_hi, n, steps, restricted=True):
    """(delta, lml, scale, beta) per variant; see the module doc.  k_best
    ([genes,] S) int64 or None, x0 ([genes,] S, nrho) f64 or None,
    br_lo/br_hi ([genes,] S, nrho)."""
    global launches, launches_f32
    if S.device.type == "cpu":
        return reml_converge_plain(S, WGt, yt, comp, ld_xx, k_best, x0,
                                   br_lo, br_hi, n, steps, restricted)
    nrho, R, p, nS, gs = check_operands("reml_converge", S, WGt, yt, comp,
                                        ld_xx, restricted)
    _check_f32("reml_converge", S, p)
    _build.require_all("reml_converge", torch.float64, tuple(
        (t, name, gs + (nS, nrho)) for t, name in (
            (br_lo, "br_lo"), (br_hi, "br_hi"), (x0, "x0")) if t is not None))
    if k_best is not None:
        _build.require(k_best, "reml_converge: k_best", torch.int64,
                       gs + (nS,))
    if math.prod(gs) * nS >= 2 ** 31:
        raise ValueError(f"reml_converge: genes x variants < 2^31, got "
                         f"{math.prod(gs)} x {nS}")
    out = call_converge(_build.load("reml_newton", _bind), S, WGt, yt, comp,
                        ld_xx, k_best, x0, br_lo, br_hi, n, steps, restricted,
                        _build.stream_ptr(S.device))
    launches += 1
    launches_f32 += S.dtype == torch.float32
    return out


def call_converge(lib, S, WGt, yt, comp, ld_xx, k_best, x0, br_lo, br_hi, n,
                  steps, restricted=True, stream=None):
    """Allocate the outputs and the scratch (the per-rho problem lists) and
    call ``lib``'s converge entry point (the card's library, or an
    emulation of it on CPU tensors)."""
    nrho, R = S.shape
    p = comp.CWW.shape[0]
    nS = WGt.shape[2] - p
    gs = gene_shape(yt)
    delta, lml, scale = (torch.empty(gs + (nS,), dtype=torch.float64,
                                     device=S.device) for _ in range(3))
    beta = torch.empty(gs + (nS, p + 1), dtype=torch.float64, device=S.device)
    if delta.numel() == 0:
        return delta, lml, scale, beta
    genes = math.prod(gs)
    work = torch.empty(lib.crm_reml_converge_workspace(nrho, nS, genes),
                       dtype=torch.uint8, device=S.device)
    opt = lambda t: None if t is None else _build.ptr(t)  # noqa: E731
    ptrs = [_build.ptr(t) for t in (S, WGt, yt, *comp)]
    ptrs += [opt(ld_xx if restricted else None), opt(k_best), opt(x0),
             _build.ptr(br_lo), _build.ptr(br_hi), _build.ptr(delta),
             _build.ptr(lml), _build.ptr(scale), _build.ptr(beta),
             _build.ptr(work)]
    fn = (lib.crm_reml_converge_f32 if S.dtype == torch.float32
          else lib.crm_reml_converge)
    _build.check(fn(*ptrs, n, nrho, R, p, nS, genes, steps, int(restricted),
                    stream), "reml_converge")
    return delta, lml, scale, beta
