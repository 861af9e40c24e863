"""K4: the best-rho rotation At[g, s] = V[k_gs]^T T[:, :, s] of the score
factor, each distinct (rho, variant) pair computed and stored once.

On a CUDA tensor :func:`best_rho_rotate` launches the hand-written kernel
(``csrc/best_rho_rotate.cu``); on a CPU tensor it runs
:func:`best_rho_rotate_plain`.  T comes in K1's (R, C, S) layout and
k_best is ([genes,] S): a single phenotype, or every gene of a tile of
the gene-batched scan, all rotating the one shared T.

Both return ``(At_slots, slot)``: at variant s the rho points that some
gene picks are ranked in ascending order (:func:`slots`), slot[g, s] is
the rank of k_best[g, s], and At_slots[slot[g, s], s] is gene g's
(R, C) factor.  At_slots is (m, S, R, C) with m = min(genes, nrho) (one
slot for a single phenotype); a slot past a variant's count of distinct
rho holds no value (the kernel leaves it unwritten).  K5 reads the
factor through the slot (:mod:`.score_core`); :func:`gather` returns the
per-gene layout.

The float32 context (the screen's) takes f32 V and T: an entry of its own
(``crm_best_rho_rotate_f32``: the same slots and lists, the product in FP32
FMA with f32 sums, a 128 x 128 tile of one rho's columns a block, 8 x 8
sums a thread over a three-stage cp.async ring of 32-row chunks), whose
factors are f32.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

launches = 0
launches_f32 = 0  # of them, the float32 context's instantiation


def slots(k_best: torch.Tensor, nrho: int):
    """(slot like k_best, rank (nrho, S)): rank[k, s] is the slot of rho k
    at variant s (its rank among the rho points some gene picks there,
    ascending; -1 where none does).  No host synchronisation."""
    S = k_best.shape[-1]
    kb = k_best.reshape(-1, S)
    ar = torch.arange(S, device=k_best.device)
    used = torch.zeros((nrho, S), dtype=torch.bool, device=k_best.device)
    used[kb, ar.expand_as(kb)] = True
    rank = torch.where(used, torch.cumsum(used, dim=0) - 1, -1)
    return rank[k_best, ar.expand_as(k_best)], rank


def gather(At_slots: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
    """The per-gene factor At ([genes,] S, R, C) = At_slots[slot, s]."""
    S = slot.shape[-1]
    ar = torch.arange(S, device=slot.device)
    return At_slots[slot, ar.expand_as(slot)]


def best_rho_rotate_plain(V: torch.Tensor, T: torch.Tensor,
                          k_best: torch.Tensor):
    """Plain torch version: each rho's rotation of the variants that some
    gene sends there (``einsum``), scattered to their slots."""
    nrho = V.shape[0]
    R, C, S = T.shape
    genes = k_best.numel() // S if S else 1
    slot, rank = slots(k_best, nrho)
    At = torch.zeros((min(genes, nrho), S, R, C), dtype=T.dtype,
                     device=T.device)
    for o in range(nrho):
        sel = torch.nonzero(rank[o] >= 0).flatten()
        if sel.numel():
            At[rank[o, sel], sel] = torch.einsum("rq,rcs->sqc", V[o],
                                                 T[:, :, sel])
    return At, slot


def _bind(lib):
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.crm_best_rho_rotate_workspace.restype = ctypes.c_int64
    lib.crm_best_rho_rotate_workspace.argtypes = [ci] * 4
    lib.crm_best_rho_rotate.restype = ci
    lib.crm_best_rho_rotate.argtypes = [vp] * 6 + [ci] * 5 + [vp]
    lib.crm_best_rho_rotate_f32_workspace.restype = ctypes.c_int64
    lib.crm_best_rho_rotate_f32_workspace.argtypes = [ci] * 4
    lib.crm_best_rho_rotate_f32.restype = ci
    lib.crm_best_rho_rotate_f32.argtypes = [vp] * 6 + [ci] * 5 + [vp]


def best_rho_rotate(V: torch.Tensor, T: torch.Tensor, k_best: torch.Tensor):
    """(At_slots (min(genes, nrho), S, R, C), slot ([genes,] S) int64) from
    V (nrho, R, R), T (R, C, S) f64 (or both f32: the float32 context) and
    k_best ([genes,] S) int64 in [0, nrho)."""
    global launches, launches_f32
    if V.device.type == "cpu":
        return best_rho_rotate_plain(V, T, k_best)
    nrho, R = V.shape[0], V.shape[1]
    C, S = T.shape[1], T.shape[2]
    if k_best.ndim not in (1, 2):
        raise ValueError(f"best_rho_rotate: k_best (S,) or (genes, S), got "
                         f"{tuple(k_best.shape)}")
    dt = _build.context_dtype(V, "best_rho_rotate: V")
    _build.require(V, "V", dt, (nrho, R, R))
    _build.require(T, "T", dt, (R, C, S))
    _build.require(k_best, "k_best", torch.int64, k_best.shape[:-1] + (S,))
    out = call(_build.load("best_rho_rotate", _bind), V, T, k_best,
               _build.stream_ptr(V.device))
    launches += 1
    launches_f32 += dt == torch.float32
    return out


def call(lib, V, T, k_best, stream=None):
    """Allocate At_slots, slot and the scratch and call ``lib``'s entry
    point (the card's library, or an emulation of it on CPU tensors)."""
    nrho, R = V.shape[0], V.shape[1]
    C, S = T.shape[1], T.shape[2]
    genes = k_best.numel() // S if S else 1
    At = torch.empty((min(genes, nrho), S, R, C), dtype=T.dtype,
                     device=T.device)
    slot = torch.empty(k_best.shape, dtype=torch.int64, device=T.device)
    if At.numel() == 0:
        return At, slot
    f32 = T.dtype == torch.float32  # the float32 context
    nbytes = (lib.crm_best_rho_rotate_f32_workspace if f32
              else lib.crm_best_rho_rotate_workspace)(nrho, R, C, S)
    work = torch.empty(nbytes, dtype=torch.uint8, device=T.device)
    entry = lib.crm_best_rho_rotate_f32 if f32 else lib.crm_best_rho_rotate
    _build.check(entry(
        _build.ptr(V), _build.ptr(T), _build.ptr(k_best), _build.ptr(At),
        _build.ptr(slot), _build.ptr(work), nrho, R, C, S, genes, stream),
        "best_rho_rotate")
    return At, slot
