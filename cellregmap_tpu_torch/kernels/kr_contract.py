"""K1: the Khatri-Rao contraction M[k, j, s] = sum_n U[n,k] V[n,j] G[n,s].

On a CUDA tensor :func:`kr_contract` launches the hand-written kernel
(``csrc/kr_contract.cu``); on a CPU tensor it runs :func:`kr_contract_plain`.
The scan calls it three times per variant batch: T = Z^T (E0 o G) as
(R, C, S), the context Grams A^T A as (C, C, S), and A^T W as (C, p, S).
The float32 context (the screen's) takes f32 operands and f32 sums
(``crm_kr_contract_f32``): for K > 32 split-TF32 products on the tensor
cores (each operand split into two TF32 values, three products a term),
for K <= 32 FP32 FMA with the cells split over warps and blocks, the
blocks' partial sums in scratch added in a fixed order.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

launches = 0
launches_f32 = 0  # of them, the float32 context's instantiation


def kr_contract_plain(U: torch.Tensor, V: torch.Tensor,
                      G: torch.Tensor) -> torch.Tensor:
    """Plain torch version, one (K, n) @ (n, S) product per column of V."""
    return torch.stack([U.T @ (V[:, j : j + 1] * G)
                        for j in range(V.shape[1])], dim=1)


def _bind(lib):
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.crm_kr_contract.restype = ci
    lib.crm_kr_contract.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, vp]
    lib.crm_kr_contract_f32.restype = ci
    lib.crm_kr_contract_f32.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, ci,
                                        vp]
    lib.crm_kr_contract_f32_workspace.restype = ctypes.c_int64
    lib.crm_kr_contract_f32_workspace.argtypes = [ci, ci, ci, ci]


def kr_contract(U: torch.Tensor, V: torch.Tensor,
                G: torch.Tensor) -> torch.Tensor:
    """M (K, p, S) from U (n, K), V (n, p), G (n, S), all f64 or all f32
    (the float32 context)."""
    global launches, launches_f32
    if U.device.type == "cpu":
        return kr_contract_plain(U, V, G)
    n, K = U.shape
    p, S = V.shape[1], G.shape[1]
    dt = _build.context_dtype(U, "kr_contract: U")
    _build.require(U, "U", dt, (n, K))
    _build.require(V, "V", dt, (n, p))
    _build.require(G, "G", dt, (n, S))
    M = call(_build.load("kr_contract", _bind), U, V, G,
             _build.stream_ptr(U.device))
    if M.numel():
        launches += 1
        launches_f32 += dt == torch.float32
    return M


def call(lib, U, V, G, stream=None):
    """Allocate M and call ``lib``'s entry point for the operands' dtype
    (the card's library, or an emulation of it on CPU tensors)."""
    n, K = U.shape
    p, S = V.shape[1], G.shape[1]
    M = torch.empty((K, p, S), dtype=U.dtype, device=U.device)
    if M.numel() == 0:
        return M
    ptrs = [_build.ptr(U), _build.ptr(V), _build.ptr(G), _build.ptr(M)]
    if U.dtype == torch.float32:
        # the small-K route's partial sums a split of the cells
        nbytes = lib.crm_kr_contract_f32_workspace(n, K, p, S)
        work = (torch.empty(nbytes, dtype=torch.uint8, device=U.device)
                if nbytes else None)
        err = lib.crm_kr_contract_f32(*ptrs, None if work is None
                                      else _build.ptr(work), n, K, p, S,
                                      stream)
    else:
        err = lib.crm_kr_contract(*ptrs, n, K, p, S, stream)
    _build.check(err, "kr_contract")
    return M
