"""K6b: the device tails of the score statistic, mod-Liu and the Kuonen
saddlepoint, per (Q, lambda) pair in one fused pass.

The JAX package's ``liu_sf`` / ``_ncx2_sf`` / ``saddlepoint_sf``
(cellregmap_tpu/models/pvalues.py:31-145) as called by
``interaction_batch`` (engine.py:794-801).  On a CUDA tensor
:func:`mixture_tails` launches ``csrc/mixture_tails.cu`` (a group of lanes
a pair, the power of two >= C / 2 of them, two weights a lane, so that
the sums over the weights are butterflies of shuffles; the bisection keeps
the reference's midpoints; a noncentral Liu series on the whole warp); on
a CPU tensor it runs :func:`mixture_tails_plain`, the torch ports in
``models.pvalues``.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from ..models.pvalues import liu_sf_torch, saddlepoint_sf_torch

launches = 0
MAX_C = 64  # weights a pair the kernel takes (api.CARD_MAX_CONTEXTS)


def mixture_tails_plain(Q, lam, n_iters: int = 40):
    """Plain torch version: (pv_liu, pv_saddlepoint) of Q (P,) against the
    weights lam (P, C)."""
    return liu_sf_torch(Q, lam), saddlepoint_sf_torch(Q, lam, n_iters)


def _bind(lib):
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.crm_mixture_tails.restype = ci
    lib.crm_mixture_tails.argtypes = [vp, vp, vp, vp, ctypes.c_int64, ci, ci,
                                      vp]


def mixture_tails(Q: torch.Tensor, lam: torch.Tensor, n_iters: int = 40):
    """(pv_liu (P,), pv_saddlepoint (P,)) of Q (P,) f64 against the
    mixture weights lam (P, C) f64; the saddlepoint bisects ``n_iters +
    60`` times, as the JAX package's."""
    global launches
    if Q.device.type == "cpu":
        return mixture_tails_plain(Q, lam, n_iters)
    P, C = lam.shape
    if C > MAX_C:
        raise ValueError(f"mixture_tails: at most {MAX_C} weights a pair, "
                         f"got {C}")
    _build.require(Q, "mixture_tails: Q", torch.float64, (P,))
    _build.require(lam, "mixture_tails: lam", torch.float64, (P, C))
    out = call(_build.load("mixture_tails", _bind), Q, lam, n_iters,
               _build.stream_ptr(Q.device))
    launches += 1
    return out


def call(lib, Q, lam, n_iters=40, stream=None):
    """Allocate the p-values and call ``lib``'s entry point (the card's
    library, or an emulation of it on CPU tensors)."""
    P, C = lam.shape
    pv_liu = torch.empty((P,), dtype=torch.float64, device=Q.device)
    pv_sp = torch.empty_like(pv_liu)
    if P:
        _build.check(lib.crm_mixture_tails(
            _build.ptr(Q), _build.ptr(lam), _build.ptr(pv_liu),
            _build.ptr(pv_sp), P, C, n_iters + 60, stream), "mixture_tails")
    return pv_liu, pv_sp
