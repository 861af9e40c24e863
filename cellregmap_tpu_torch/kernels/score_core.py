"""K5: the per-variant score statistic Q = 1/2 ||A^T P y||^2 and the
weight matrix Wmat = 1/2 A^T P A at each variant's best rho.

On a CUDA tensor :func:`score_core` launches the hand-written kernel
(``csrc/score_core.cu``); on a CPU tensor it runs :func:`score_core_plain`.
The arguments are the interaction batch's own tensors; each variant
gathers its best rho's rows (k_best) itself.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

launches = 0

# shape limits of the CUDA kernel (csrc/score_core.cu)
MAX_COLUMNS = 63   # C + p + 2
MAX_FIXED = 8      # p + 1


def score_core_plain(Sv, WGt, yt, At, WW, Wy, Wg, gg, gy, AW, Ag, Ay, AtA,
                     k_best, v0, v1):
    """Plain torch version: ``score_test_core`` batched over variants."""
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
    lib.crm_score_core.argtypes = [vp] * 18 + [ci, ci, ci, ci, vp]


def score_core(Sv, WGt, yt, At, WW, Wy, Wg, gg, gy, AW, Ag, Ay, AtA,
               k_best, v0, v1):
    """(Q (S,), Wmat (S, C, C)) for one variant batch.

    Sv (nrho, R) eigenvalues, WGt (nrho, R, p+S) rotated [W | G], yt
    (nrho, R) rotated y, At (S, R, C) best-rho score factor, WW (p, p),
    Wy (p,), Wg (p, S), gg (S,), gy (S,), AW (C, p, S), Ag (C, S),
    Ay (C, S), AtA (C, C, S) full-space Grams, k_best (S,) int64 best-rho
    index, v0/v1 (S,) variance components.  f64.
    """
    global launches
    if At.device.type == "cpu":
        return score_core_plain(Sv, WGt, yt, At, WW, Wy, Wg, gg, gy, AW,
                                Ag, Ay, AtA, k_best, v0, v1)
    nrho, R = Sv.shape
    S, C = At.shape[0], At.shape[2]
    p = WW.shape[0]
    if C + p + 2 > MAX_COLUMNS or p + 1 > MAX_FIXED:
        raise ValueError(f"score_core: needs C + p + 2 <= {MAX_COLUMNS} and "
                         f"p + 1 <= {MAX_FIXED}, got C={C}, p={p}")
    f64 = torch.float64
    for t, name, shape in (
            (Sv, "Sv", (nrho, R)), (WGt, "WGt", (nrho, R, p + S)),
            (yt, "yt", (nrho, R)), (At, "At", (S, R, C)), (WW, "WW", (p, p)),
            (Wy, "Wy", (p,)), (Wg, "Wg", (p, S)), (gg, "gg", (S,)),
            (gy, "gy", (S,)), (AW, "AW", (C, p, S)), (Ag, "Ag", (C, S)),
            (Ay, "Ay", (C, S)), (AtA, "AtA", (C, C, S)), (v0, "v0", (S,)),
            (v1, "v1", (S,))):
        _build.require(t, name, f64, shape)
    _build.require(k_best, "k_best", torch.int64, (S,))
    Q = torch.empty((S,), dtype=f64, device=At.device)
    Wmat = torch.empty((S, C, C), dtype=f64, device=At.device)
    if S == 0:
        return Q, Wmat
    lib = _build.load("score_core", _bind)
    ptrs = [_build.ptr(t) for t in (Sv, WGt, yt, At, WW, Wy, Wg, gg, gy, AW,
                                    Ag, Ay, AtA, k_best, v0, v1, Q, Wmat)]
    err = lib.crm_score_core(*ptrs, R, C, p, S, _build.stream_ptr(At.device))
    _build.check(err, "score_core")
    launches += 1
    return Q, Wmat
