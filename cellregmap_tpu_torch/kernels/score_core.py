"""K5: the per-variant score statistic Q = 1/2 ||A^T P y||^2 and the
weight matrix Wmat = 1/2 A^T P A at each variant's best rho.

On a CUDA tensor :func:`score_core` launches the hand-written kernels
(``csrc/score_core.cu``: the genotype columns of the distinct (slot,
variant) pairs gathered into a contiguous scratch, then a block a variant
taking its slots in turn, whose Grams run on the FP64 tensor cores); on a
CPU tensor it runs
:func:`score_core_plain`.  The arguments are the interaction batch's own
tensors; each variant gathers its best rho's rows (k_best) itself, and its
score factor from K4's slots: At_slots[slot[g, s], s]
(:mod:`.best_rho_rotate`).  The gene-batched scan gives the phenotype's
operands (yt, Wy, gy, Ay, k_best, v0, v1, slot) a leading gene axis; the
genotype's (and the slots, which the genes that share a best rho share)
are shared, and one call serves every gene: a block stages a slot's rows
once for all the genes there.

The float32 context (the screen's) gives the factors, the rotated rows and
the full-space Grams in f32 and v0, v1 in f64: the reference's type
promotion then runs the whole statistic in f64 on the widened values
(engine.py:234-265), and so do both versions here (the kernel widens each
value as it loads it, ``crm_score_core_f32``; the plain version widens the
operands first).  Q and Wmat are f64 in either context.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from .best_rho_rotate import gather

launches = 0
launches_f32 = 0  # of them, on the float32 context's operands

# shape limits of the CUDA kernel (csrc/score_core.cu, its wide instantiation)
MAX_COLUMNS = 98   # C + p + 2
MAX_FIXED = 33     # p + 1
MAX_GENES = 65535  # genes of one call (and slots: a grid axis)


def score_core_plain(Sv, WGt, yt, At, WW, Wy, Wg, gg, gy, AW, Ag, Ay, AtA,
                     k_best, v0, v1, slot):
    """Plain torch version: ``score_test_core`` batched over variants, one
    gene at a time, each on its factor At_slots[slot, s]; f32 operands (the
    float32 context) are widened to f64 first."""
    if WW.dtype != torch.float64:
        f64 = lambda t: t.to(torch.float64)  # noqa: E731
        Sv, WGt, yt, At, WW, Wy, Wg, gg, gy, AW, Ag, Ay, AtA = map(
            f64, (Sv, WGt, yt, At, WW, Wy, Wg, gg, gy, AW, Ag, Ay, AtA))
    if yt.ndim == 3:
        return tuple(torch.stack(o) for o in zip(*(
            score_core_plain(Sv, WGt, yt[g], At, WW, Wy[g], Wg, gg, gy[g],
                             AW, Ag, Ay[g], AtA, k_best[g], v0[g], v1[g],
                             slot[g])
            for g in range(yt.shape[0]))))
    At = gather(At, slot)                                    # (S, R, C)
    S = At.shape[0]
    p = WW.shape[0]
    ar = torch.arange(S, device=At.device)
    Sb = Sv[k_best]                                          # (S, R)
    Xt = torch.cat([WGt[k_best, :, :p],
                    WGt[k_best, :, p + ar][:, :, None]], dim=2)  # (S, R, p1)
    ytk = yt[k_best]                                         # (S, R)
    XX = torch.cat([
        torch.cat([WW.expand(S, p, p), Wg.T[:, :, None]], dim=2),
        torch.cat([Wg.T[:, None, :], gg[:, None, None]], dim=2)], dim=1)
    Xy = torch.cat([Wy.expand(S, p), gy[:, None]], dim=1)    # (S, p1)
    AX = torch.cat([AW.permute(2, 0, 1), Ag.T[:, :, None]], dim=2)
    omega = (v0[:, None] * Sb) / (v1[:, None] + v0[:, None] * Sb)
    v1b = v1[:, None, None]

    def kq(ut, vt, uv):
        """u^T K0^{-1} v = (u^T v - u^T diag(omega) v) / v1, batched."""
        return (uv - ut.transpose(1, 2) @ (omega[:, :, None] * vt)) / v1b

    XKX = kq(Xt, Xt, XX)
    XKy = kq(Xt, ytk[:, :, None], Xy[:, :, None])
    AKX = kq(At, Xt, AX)
    AKy = kq(At, ytk[:, :, None], Ay.T[:, :, None])
    AKA = kq(At, At, AtA.permute(2, 0, 1))

    diag = torch.diagonal(XKX, dim1=-2, dim2=-1)
    ridge = 1e-12 * torch.clamp(diag.abs().amax(dim=-1), min=1.0)
    eye = torch.eye(p + 1, dtype=XKX.dtype, device=XKX.device)
    L = torch.linalg.cholesky_ex(XKX + ridge[:, None, None] * eye,
                                 check_errors=False)[0]
    B = torch.cholesky_solve(torch.cat([XKy, AKX.transpose(1, 2)], dim=2), L)
    APy = AKy[:, :, 0] - (AKX @ B[:, :, :1])[:, :, 0]
    APA = AKA - AKX @ B[:, :, 1:]
    Q = 0.5 * (APy * APy).sum(dim=1)
    Wmat = 0.25 * (APA + APA.transpose(1, 2))
    return Q, Wmat


def _bind(lib):
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.crm_score_core.restype = ci
    lib.crm_score_core.argtypes = [vp] * 20 + [ci] * 7 + [vp]
    lib.crm_score_core_f32.restype = ci
    lib.crm_score_core_f32.argtypes = [vp] * 20 + [ci] * 7 + [vp]


def score_core(Sv, WGt, yt, At, WW, Wy, Wg, gg, gy, AW, Ag, Ay, AtA,
               k_best, v0, v1, slot):
    """(Q ([genes,] S), Wmat ([genes,] S, C, C)) for one variant batch.

    Sv (nrho, R) eigenvalues, WGt (nrho, R, p+S) rotated [W | G], yt
    ([genes,] nrho, R) rotated y, At (m, S, R, C) K4's best-rho score
    factors, WW (p, p), Wy ([genes,] p), Wg (p, S), gg (S,), gy ([genes,]
    S), AW (C, p, S), Ag (C, S), Ay ([genes,] C, S), AtA (C, C, S)
    full-space Grams, k_best ([genes,] S) int64 best-rho index, v0/v1
    ([genes,] S) variance components, slot ([genes,] S) int64 in [0, m):
    the factor's slot in At.  f64; in the float32 context every operand
    but v0 and v1 f32.
    """
    global launches, launches_f32
    if At.device.type == "cpu":
        return score_core_plain(Sv, WGt, yt, At, WW, Wy, Wg, gg, gy, AW,
                                Ag, Ay, AtA, k_best, v0, v1, slot)
    nrho, R = Sv.shape
    m, S, C = At.shape[0], At.shape[-3], At.shape[-1]
    p = WW.shape[0]
    gs = tuple(yt.shape[:-2])
    if C + p + 2 > MAX_COLUMNS or p + 1 > MAX_FIXED:
        raise ValueError(f"score_core: needs C + p + 2 <= {MAX_COLUMNS} and "
                         f"p + 1 <= {MAX_FIXED}, got C={C}, p={p}")
    if len(gs) > 1 or (gs and not 1 <= gs[0] <= MAX_GENES):
        raise ValueError(f"score_core: a gene axis of 1..{MAX_GENES} genes, "
                         f"got yt of shape {tuple(yt.shape)}")
    f64 = torch.float64
    dt = _build.context_dtype(At, "score_core: At")
    for t, name, shape in (
            (Sv, "Sv", (nrho, R)), (WGt, "WGt", (nrho, R, p + S)),
            (yt, "yt", gs + (nrho, R)), (At, "At", (m, S, R, C)),
            (WW, "WW", (p, p)), (Wy, "Wy", gs + (p,)), (Wg, "Wg", (p, S)),
            (gg, "gg", (S,)), (gy, "gy", gs + (S,)), (AW, "AW", (C, p, S)),
            (Ag, "Ag", (C, S)), (Ay, "Ay", gs + (C, S)),
            (AtA, "AtA", (C, C, S))):
        _build.require(t, name, dt, shape)
    for t, name in ((v0, "v0"), (v1, "v1")):
        _build.require(t, name, f64, gs + (S,))
    for t, name in ((k_best, "k_best"), (slot, "slot")):
        _build.require(t, name, torch.int64, gs + (S,))
    out = call(_build.load("score_core", _bind), Sv, WGt, yt, At, WW, Wy, Wg,
               gg, gy, AW, Ag, Ay, AtA, k_best, v0, v1, slot,
               _build.stream_ptr(At.device))
    launches += 1
    launches_f32 += dt == torch.float32
    return out


def call(lib, Sv, WGt, yt, At, WW, Wy, Wg, gg, gy, AW, Ag, Ay, AtA, k_best,
         v0, v1, slot, stream=None):
    """Allocate Q, Wmat and the scratch and call ``lib``'s entry point (the
    card's library, or an emulation of it on CPU tensors)."""
    nrho, R = Sv.shape
    m, S, C = At.shape[0], At.shape[-3], At.shape[-1]
    p = WW.shape[0]
    gs = tuple(yt.shape[:-2])
    Q = torch.empty(gs + (S,), dtype=torch.float64, device=At.device)
    Wmat = torch.empty(gs + (S, C, C), dtype=torch.float64, device=At.device)
    if Q.numel() == 0:
        return Q, Wmat
    # the gathered genotype column of each (slot, variant) pair, then each
    # pair's rho
    work = torch.empty(m * S * (R + 1), dtype=torch.float64,
                       device=At.device)
    ptrs = [_build.ptr(t) for t in (Sv, WGt, yt, At, WW, Wy, Wg, gg, gy, AW,
                                    Ag, Ay, AtA, k_best, v0, v1, slot, Q,
                                    Wmat, work)]
    entry = (lib.crm_score_core_f32 if At.dtype == torch.float32
             else lib.crm_score_core)
    _build.check(entry(*ptrs, nrho, R, C, p, S, math.prod(gs), m, stream),
                 "score_core")
    return Q, Wmat
