"""K4: the best-rho rotation At[s] = V[k_s]^T T[:, :, s] of the score factor.

On a CUDA tensor :func:`best_rho_rotate` launches the hand-written kernel
(``csrc/best_rho_rotate.cu``); on a CPU tensor it runs
:func:`best_rho_rotate_plain`.  T comes in K1's (R, C, S) layout.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

launches = 0


def best_rho_rotate_plain(V: torch.Tensor, T: torch.Tensor,
                          k_best: torch.Tensor) -> torch.Tensor:
    """Plain torch version: the JAX engine's masked accumulation over every
    rho (engine.py:684-688), nrho rotations of the whole batch."""
    At = torch.zeros((T.shape[2], T.shape[0], T.shape[1]), dtype=T.dtype,
                     device=T.device)
    for o in range(V.shape[0]):
        To = torch.einsum("rq,rcs->sqc", V[o], T)
        At = At + (k_best == o).to(T.dtype)[:, None, None] * To
    return At


def _bind(lib):
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.crm_best_rho_rotate.restype = ci
    lib.crm_best_rho_rotate.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, vp]


def best_rho_rotate(V: torch.Tensor, T: torch.Tensor,
                    k_best: torch.Tensor) -> torch.Tensor:
    """At (S, R, C) from V (nrho, R, R), T (R, C, S) f64, k_best (S,) int64."""
    global launches
    if V.device.type == "cpu":
        return best_rho_rotate_plain(V, T, k_best)
    nrho, R = V.shape[0], V.shape[1]
    C, S = T.shape[1], T.shape[2]
    if S > 65535:
        raise ValueError("best_rho_rotate: at most 65535 variants a call")
    _build.require(V, "V", torch.float64, (nrho, R, R))
    _build.require(T, "T", torch.float64, (R, C, S))
    _build.require(k_best, "k_best", torch.int64, (S,))
    At = torch.empty((S, R, C), dtype=T.dtype, device=T.device)
    if At.numel() == 0:
        return At
    # variants in k_best order: blocks that share one V[k] run together
    order = torch.argsort(k_best)
    lib = _build.load("best_rho_rotate", _bind)
    err = lib.crm_best_rho_rotate(_build.ptr(V), _build.ptr(T),
                                  _build.ptr(k_best), _build.ptr(order),
                                  _build.ptr(At), R, C, S,
                                  _build.stream_ptr(V.device))
    _build.check(err, "best_rho_rotate")
    launches += 1
    return At
