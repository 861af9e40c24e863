"""K1: the Khatri-Rao contraction M[k, j, s] = sum_n U[n,k] V[n,j] G[n,s].

On a CUDA tensor :func:`kr_contract` launches the hand-written kernel
(``csrc/kr_contract.cu``); on a CPU tensor it runs :func:`kr_contract_plain`.
The scan calls it three times per variant batch: T = Z^T (E0 o G) as
(R, C, S), the context Grams A^T A as (C, C, S), and A^T W as (C, p, S).
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

launches = 0


def kr_contract_plain(U: torch.Tensor, V: torch.Tensor,
                      G: torch.Tensor) -> torch.Tensor:
    """Plain torch version, one (K, n) @ (n, S) product per column of V."""
    return torch.stack([U.T @ (V[:, j : j + 1] * G)
                        for j in range(V.shape[1])], dim=1)


def _bind(lib):
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.crm_kr_contract.restype = ci
    lib.crm_kr_contract.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, vp]


def kr_contract(U: torch.Tensor, V: torch.Tensor,
                G: torch.Tensor) -> torch.Tensor:
    """M (K, p, S) from U (n, K), V (n, p), G (n, S), all f64."""
    global launches
    if U.device.type == "cpu":
        return kr_contract_plain(U, V, G)
    n, K = U.shape
    p, S = V.shape[1], G.shape[1]
    _build.require(U, "U", torch.float64, (n, K))
    _build.require(V, "V", torch.float64, (n, p))
    _build.require(G, "G", torch.float64, (n, S))
    M = torch.empty((K, p, S), dtype=U.dtype, device=U.device)
    if M.numel() == 0:
        return M
    lib = _build.load("kr_contract", _bind)
    err = lib.crm_kr_contract(_build.ptr(U), _build.ptr(V), _build.ptr(G),
                              _build.ptr(M), n, K, p, S,
                              _build.stream_ptr(U.device))
    _build.check(err, "kr_contract")
    launches += 1
    return M
