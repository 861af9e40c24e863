"""K2 (and the grid half of K7): the coarse delta grid of the profiled fits.

For every variant s, rho point o and grid point k (delta_k = sigmoid of a
linspace over logit(delta)), the lml of the GLS fit with X = [W, g] under
the weights 1/((1 - delta_k) S_or + delta_k), then per (s, o) the argmax
over k and the bracket [logit_{k-1}, logit_{k+1}] around it.  Two
objectives share the code, and keep the reference's differences:

* REML, the interaction scan (cellregmap_tpu/engine.py:460-532): nu =
  n - p - 1, logdet(A) and logdet(X^T X); a grid point whose rss is below
  128 eps(fast) q is cancellation noise and excluded (:500);
* ML, the association refit (:957-989): n, no logdet terms; only an rss
  below 8 tiny(fast) is excluded (:978).

The grid runs in the working dtype ``fast`` (float32 under hybrid
localization): the rotated products are formed in f64 and rounded, as the
reference's tensor sets are.  On a CUDA tensor :func:`delta_grid` launches
``csrc/delta_grid.cu``; on a CPU tensor it runs :func:`delta_grid_plain`.

The gene-batched scan passes the phenotype's operands (yt, and the
complements CWy, Cyy, Cgy) with a leading gene axis; the genotype's are
shared, and the results gain the same leading axis.  One launch serves
every gene.

The float32 context (the screen's) takes f32 operands (S, WGt, yt, the
complements, ld_xx) and f32 working sums, p + 1 <= 16: an entry of its
own (``crm_delta_grid_f32``: the weights and the sums in one kernel, as
split-TF32 tensor-core products, then the epilogue), whose REML brackets
(the interaction's) are the grid logits rounded to f32 (engine.py:528),
widened exactly, and whose ML brackets (the association refit's) the f64
logits (:986-989); its plain version makes them alike.

The gene-batched association refit runs each gene at its own null's best
rho alone: ``slot`` (one int per gene) names the rho row of S and WGt (the
tile's distinct best rho, m of them) that the gene's grid runs, and the
gene's yt (genes, m, R) is read at that row.  The brackets keep their
(genes, S, m) layout, NaN outside each gene's slot column.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from . import _build
from ._normal_eqs import (Complements, gene_comp, lml_value, ne_family,
                          products, tensor_set)
from ..ops.linalg import (unrolled_chol_factor, unrolled_chol_logdet,
                          unrolled_chol_solve)

launches = 0
launches_f32 = 0  # of them, the float32 context's instantiation

MAX_FIXED = 33      # p + 1 of the CUDA kernel's small algebra
MAX_FIXED_F32 = 16  # p + 1 of the float32 context's entry
MAX_GENES = 65535   # genes of one launch (a grid axis)


def logit_grid(lo, hi, n_grid, device, ctx_dtype=torch.float64):
    """The grid's logits, f64, rounded to the context's dtype (the
    brackets' values)."""
    grid = torch.linspace(lo, hi, n_grid, dtype=torch.float64, device=device)
    return grid.to(ctx_dtype).to(torch.float64)


def delta_grid_plain(S, WGt, yt, comp: Complements, ld_xx, lo, hi, n_grid,
                     n, fast, restricted=True, return_lml=False, slot=None):
    """Plain torch version: the grid as snp-shared batched GEMMs of the
    (nrho, K, R) weights against the rotated products, one gene at a time.
    ``return_lml`` adds the (S, nrho, K) lml grid to the result (with
    ``slot``, each gene's (S, 1, K) grid at its slot)."""
    if slot is not None:
        return _slot_grid_plain(S, WGt, yt, comp, ld_xx, lo, hi, n_grid, n,
                                fast, restricted, return_lml, slot)
    if yt.ndim == 3:
        return tuple(torch.stack(o) for o in zip(*(
            delta_grid_plain(S, WGt, yt[g], gene_comp(comp, g), ld_xx, lo,
                             hi, n_grid, n, fast, restricted, return_lml)
            for g in range(yt.shape[0]))))
    p = comp.CWW.shape[0]
    R = S.shape[1]
    prod = products(WGt[:, :, :p], yt, WGt[:, :, p:])
    TS = tensor_set(S, prod, comp, fast)
    deltas = torch.sigmoid(logit_grid(lo, hi, n_grid, S.device)).to(fast)
    # the brackets: the interaction's (REML) logits rounded to the
    # context's dtype, the association refit's (ML) f64 (engine.py:986-989)
    logit = logit_grid(lo, hi, n_grid, S.device,
                       S.dtype if restricted else torch.float64)
    d_grid = (1 - deltas)[None, :, None] * TS["S"][:, None, :] \
        + deltas[None, :, None]                         # (nrho, K, R)
    Wd = 1.0 / d_grid
    logdet_grid = torch.log(d_grid).sum(dim=-1) \
        + (n - R) * torch.log(deltas)[None, :]          # (nrho, K)
    inv_d = (1.0 / deltas)[None, None]                  # (1, 1, K)

    red_o = lambda w, t: torch.einsum("okr,or->ok", Wd, t)[None]  # noqa
    red_s = lambda w, t: torch.bmm(Wd, t).permute(2, 0, 1)  # noqa: E731
    TSg = dict(TS, CWg=TS["CWg"][:, :, None, None],
               Cgy=TS["Cgy"][:, None, None], Cgg=TS["Cgg"][:, None, None])
    A, b, q = ne_family(None, inv_d, TSg, red_s, red_o)  # (S|1, nrho, K)
    L = unrolled_chol_factor(A)
    beta = unrolled_chol_solve(L, b)
    rss = q
    for j in range(p + 1):
        rss = rss - b[j] * beta[j]
    if restricted:
        # below ~eps(fast) * q the residual is cancellation noise: those
        # points form spurious maxima at tiny delta (engine.py:493-500)
        collapsed = rss <= 128 * torch.finfo(fast).eps * q
        logdet_a = unrolled_chol_logdet(L)
        ldx = ld_xx.to(fast)[:, None, None]
    else:
        collapsed = rss <= 8 * torch.finfo(fast).tiny   # engine.py:978
        logdet_a = ldx = None
    rss = torch.clamp(rss, min=torch.finfo(fast).tiny)
    lml = lml_value(rss, logdet_grid[None], logdet_a, ldx, n, p + 1,
                    restricted)                          # (S, nrho, K)
    lml = torch.where(collapsed | ~torch.isfinite(lml), -torch.inf, lml)
    # all-non-finite rows fall back to the full bracket
    row_bad = (~torch.isfinite(lml)).all(dim=-1)         # (S, nrho)
    k = lml.argmax(dim=-1)
    br_lo = torch.where(row_bad, logit[0],
                        logit[torch.clamp(k - 1, min=0)])
    br_hi = torch.where(row_bad, logit[-1],
                        logit[torch.clamp(k + 1, max=n_grid - 1)])
    return (br_lo, br_hi, lml) if return_lml else (br_lo, br_hi)


def _slot_grid_plain(S, WGt, yt, comp, ld_xx, lo, hi, n_grid, n, fast,
                     restricted, return_lml, slot):
    """Each gene's single-rho plain grid at its slot, its brackets placed in
    the (genes, S, m) layout (NaN elsewhere)."""
    m = S.shape[0]
    nS = WGt.shape[2] - comp.CWW.shape[0]
    br_lo = torch.full((len(slot), nS, m), math.nan, dtype=torch.float64,
                       device=S.device)
    br_hi = br_lo.clone()
    grids = []
    for g, k in enumerate(int(k) for k in slot):
        out = delta_grid_plain(S[k:k + 1], WGt[k:k + 1], yt[g, k:k + 1],
                               gene_comp(comp, g), ld_xx, lo, hi, n_grid, n,
                               fast, restricted, return_lml)
        br_lo[g, :, k], br_hi[g, :, k] = out[0][:, 0], out[1][:, 0]
        grids.append(out[2:])
    if return_lml:
        return br_lo, br_hi, torch.stack([lml for lml, in grids])
    return br_lo, br_hi


def bracket_shortfall(br_lo, br_hi, lml, lo, hi,
                      ctx_dtype=torch.float64) -> float:
    """How far a kernel's brackets fall short of the plain grid's argmax:
    the largest relative gap, over (variant, rho), between a row's plain
    maximum and the plain lml at the grid point the kernel's bracket was
    built around.  0 where the kernel chose the plain argmax; small at a
    near-tie (another summation order can pick the neighbouring point);
    inf where the bracket belongs to no grid point.  ``lml`` is the plain
    (S, nrho, K) grid; ``ctx_dtype`` the context's dtype, to which the
    brackets' logits are rounded."""
    K = lml.shape[-1]
    logit = logit_grid(lo, hi, K, lml.device, ctx_dtype)
    ar = torch.arange(K, device=lml.device)
    near = lambda a, b: (a - b).abs() <= 1e-12 * max(abs(lo), abs(hi))  # noqa
    match = near(br_lo[..., None], logit[torch.clamp(ar - 1, min=0)]) \
        & near(br_hi[..., None], logit[torch.clamp(ar + 1, max=K - 1)])
    best = lml.amax(dim=-1)
    at = torch.where(match, lml, -torch.inf).amax(dim=-1)
    gap = (best - at) / best.abs()
    # rows with no finite grid point take the full bracket
    full = near(br_lo, torch.as_tensor(lo)) & near(br_hi, torch.as_tensor(hi))
    gap = torch.where(torch.isfinite(best), gap,
                      torch.where(full, 0.0, torch.inf))
    return float(gap.max()) if gap.numel() else 0.0


def _bind(lib):
    vp, ci, cd = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    lib.crm_delta_grid.restype = ci
    lib.crm_delta_grid.argtypes = [vp] * 14 + [cd, cd] + [ci] * 9 + [vp]
    lib.crm_delta_grid_f32.restype = ci
    lib.crm_delta_grid_f32.argtypes = [vp] * 14 + [cd, cd] + [ci] * 8 + [vp]
    lib.crm_delta_grid_workspace.restype = ctypes.c_int64
    lib.crm_delta_grid_workspace.argtypes = [ci] * 7
    lib.crm_delta_grid_f32_workspace.restype = ctypes.c_int64
    lib.crm_delta_grid_f32_workspace.argtypes = [ci] * 6


def gene_shape(yt):
    """The leading gene axis of a call, () for a single phenotype."""
    return tuple(yt.shape[:-2])


def check_operands(name, S, WGt, yt, comp, ld_xx, restricted, slot=None):
    """Validate the operands of the K2/K3 kernels (and the host ``slot``
    index, where given): all float64, or all float32 (the float32
    context); returns (nrho, R, p, nS, gene axis)."""
    nrho, R = S.shape
    p = comp.CWW.shape[0]
    nS = WGt.shape[2] - p
    gs = gene_shape(yt)
    if p + 1 > MAX_FIXED:
        raise ValueError(f"{name}: needs p + 1 <= {MAX_FIXED} fixed effects, "
                         f"got {p + 1}")
    if len(gs) > 1 or (gs and not 1 <= gs[0] <= MAX_GENES):
        raise ValueError(f"{name}: a gene axis of 1..{MAX_GENES} genes, got "
                         f"yt of shape {tuple(yt.shape)}")
    if slot is not None and (len(gs) != 1 or len(slot) != gs[0] or not all(
            0 <= int(k) < nrho for k in slot)):
        raise ValueError(f"{name}: slot must name one of the {nrho} rho rows "
                         f"for each gene of yt {tuple(yt.shape)}, got "
                         f"{list(slot)}")
    f64 = _build.context_dtype(S, f"{name}: S")
    specs = ((S, "S", (nrho, R)), (WGt, "WGt", (nrho, R, p + nS)),
             (yt, "yt", gs + (nrho, R)), (comp.CWW, "CWW", (p, p)),
             (comp.CWy, "CWy", gs + (p,)), (comp.Cyy, "Cyy", gs),
             (comp.CWg, "CWg", (p, nS)), (comp.Cgy, "Cgy", gs + (nS,)),
             (comp.Cgg, "Cgg", (nS,)))
    if restricted:
        specs += ((ld_xx, "ld_xx", (nS,)),)
    _build.require_all(name, f64, specs)
    return nrho, R, p, nS, gs


def delta_grid(S, WGt, yt, comp: Complements, ld_xx, lo, hi, n_grid, n,
               fast, restricted=True, slot=None):
    """(br_lo, br_hi), each ([genes,] S, nrho) f64: the grid bracket of
    every (variant, rho) problem.

    S (nrho, R) eigenvalues; WGt (nrho, R, p + S) the rotated [W | G];
    yt ([genes,] nrho, R) the rotated phenotype; ``comp`` the complement
    Grams (see the module doc for the gene axis);
    ld_xx (S,) logdet(X^T X) (REML only, else None); the grid is
    ``n_grid`` points of logit(delta) from ``lo`` to ``hi``; ``fast`` the
    working dtype (float32 or float64; float32 in the float32 context,
    whose operands are f32); ``restricted`` REML or ML.
    ``slot`` (a host sequence, one int in [0, nrho) per gene of yt's gene
    axis): each gene's grid at that rho row alone (the module doc).
    """
    global launches, launches_f32
    if S.device.type == "cpu":
        return delta_grid_plain(S, WGt, yt, comp, ld_xx, lo, hi, n_grid, n,
                                fast, restricted, slot=slot)
    _, _, p, _, _ = check_operands("delta_grid", S, WGt, yt, comp, ld_xx,
                                   restricted, slot)
    if S.dtype == torch.float32 and fast != torch.float32:
        raise TypeError("delta_grid: the float32 context's grid runs in "
                        "float32")
    if S.dtype == torch.float32 and p + 1 > MAX_FIXED_F32:
        raise ValueError(f"delta_grid: the float32 context needs p + 1 <= "
                         f"{MAX_FIXED_F32} fixed effects, got {p + 1}")
    if slot is not None:
        slot = _build.upload(np.asarray(slot, dtype=np.int64), S.device)
    out = call(_build.load("delta_grid", _bind), S, WGt, yt, comp, ld_xx, lo,
               hi, n_grid, n, fast, restricted, _build.stream_ptr(S.device),
               slot=slot)
    launches += 1
    launches_f32 += S.dtype == torch.float32
    return out


def call(lib, S, WGt, yt, comp, ld_xx, lo, hi, n_grid, n, fast,
         restricted=True, stream=None, slot=None):
    """Allocate the brackets and call ``lib``'s entry point (the card's
    library, or an emulation of it on CPU tensors); ``slot`` an int64
    tensor on the operands' device, or None."""
    nrho, R = S.shape
    p = comp.CWW.shape[0]
    nS = WGt.shape[2] - p
    gs = gene_shape(yt)
    br_lo = torch.empty(gs + (nS, nrho), dtype=torch.float64, device=S.device)
    br_hi = torch.empty_like(br_lo)
    if br_lo.numel() == 0:
        return br_lo, br_hi
    if slot is not None:
        # only each gene's slot column is written
        br_lo.fill_(math.nan)
        br_hi.fill_(math.nan)
    genes, f32 = math.prod(gs), int(fast == torch.float32)
    # the kernels' scratch: (weights,) shared and per-variant sums
    nbytes = (lib.crm_delta_grid_f32_workspace(nrho, R, n_grid, p, nS, genes)
              if S.dtype == torch.float32 else
              lib.crm_delta_grid_workspace(nrho, R, n_grid, p, nS, genes,
                                           f32))
    work = torch.empty(nbytes, dtype=torch.uint8, device=S.device)
    ptrs = [_build.ptr(t) for t in (S, WGt, yt, *comp)]
    ptrs += [_build.ptr(ld_xx) if restricted else None,
             None if slot is None else _build.ptr(slot), _build.ptr(br_lo),
             _build.ptr(br_hi), _build.ptr(work)]
    if S.dtype == torch.float32:  # the float32 context
        err = lib.crm_delta_grid_f32(*ptrs, lo, hi, n_grid, n, nrho, R, p,
                                     nS, genes, int(restricted), stream)
    else:
        err = lib.crm_delta_grid(*ptrs, lo, hi, n_grid, n, nrho, R, p, nS,
                                 genes, f32, int(restricted), stream)
    _build.check(err, "delta_grid")
    return br_lo, br_hi
