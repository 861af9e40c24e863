"""K4: the best-rho rotation At[s] = V[k_s]^T T[:, :, s] of the score factor.

On a CUDA tensor :func:`best_rho_rotate` launches the hand-written kernel
(``csrc/best_rho_rotate.cu``); on a CPU tensor it runs
:func:`best_rho_rotate_plain`.  T comes in K1's (R, C, S) layout.  The
gene-batched scan passes k_best (genes, S): every gene's variants are
rotated, each at its own rho, from the one shared T, in one launch.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

launches = 0

MAX_PAIRS = 65535   # (gene, variant) pairs of one launch (a grid axis)


def best_rho_rotate_plain(V: torch.Tensor, T: torch.Tensor,
                          k_best: torch.Tensor) -> torch.Tensor:
    """Plain torch version: the JAX engine's masked accumulation over every
    rho (engine.py:684-688), nrho rotations of the whole batch, one gene
    at a time."""
    if k_best.ndim == 2:
        return torch.stack([best_rho_rotate_plain(V, T, kb) for kb in k_best])
    At = torch.zeros((T.shape[2], T.shape[0], T.shape[1]), dtype=T.dtype,
                     device=T.device)
    for o in range(V.shape[0]):
        To = torch.einsum("rq,rcs->sqc", V[o], T)
        At = At + (k_best == o).to(T.dtype)[:, None, None] * To
    return At


def _bind(lib):
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.crm_best_rho_rotate.restype = ci
    lib.crm_best_rho_rotate.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, ci,
                                        vp]


def best_rho_rotate(V: torch.Tensor, T: torch.Tensor,
                    k_best: torch.Tensor) -> torch.Tensor:
    """At ([genes,] S, R, C) from V (nrho, R, R), T (R, C, S) f64 and
    k_best ([genes,] S) int64."""
    global launches
    if V.device.type == "cpu":
        return best_rho_rotate_plain(V, T, k_best)
    nrho, R = V.shape[0], V.shape[1]
    C, S = T.shape[1], T.shape[2]
    if k_best.ndim not in (1, 2) or k_best.numel() > MAX_PAIRS:
        raise ValueError(f"best_rho_rotate: k_best (S,) or (genes, S) with at "
                         f"most {MAX_PAIRS} entries, got "
                         f"{tuple(k_best.shape)}")
    _build.require(V, "V", torch.float64, (nrho, R, R))
    _build.require(T, "T", torch.float64, (R, C, S))
    _build.require(k_best, "k_best", torch.int64, k_best.shape[:-1] + (S,))
    At = call(_build.load("best_rho_rotate", _bind), V, T, k_best,
              _build.stream_ptr(V.device))
    launches += 1
    return At


def call(lib, V, T, k_best, stream=None):
    """Allocate At and call ``lib``'s entry point (the card's library, or
    an emulation of it on CPU tensors)."""
    R = V.shape[1]
    C, S = T.shape[1], T.shape[2]
    At = torch.empty(tuple(k_best.shape) + (R, C), dtype=T.dtype,
                     device=T.device)
    if At.numel() == 0:
        return At
    # (gene, variant) pairs in k_best order: blocks that share one V[k] run
    # together
    order = torch.argsort(k_best.reshape(-1))
    genes = k_best.numel() // S
    _build.check(lib.crm_best_rho_rotate(
        _build.ptr(V), _build.ptr(T), _build.ptr(k_best), _build.ptr(order),
        _build.ptr(At), R, C, S, genes, stream), "best_rho_rotate")
    return At
