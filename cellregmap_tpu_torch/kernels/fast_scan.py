"""K8: the fast association scan's closed-form alternative lmls.

At the null's fixed delta, every variant's ML alternative [W, g] is
re-profiled by a rank-1 update of the GLS normal equations
(cellregmap_tpu/engine.py:1132-1151 ``fast_scan_kernel`` through
models/lmm.py:863-909 ``fast_scan``).  On a CUDA tensor :func:`fast_scan`
launches ``csrc/fast_scan.cu`` (a block per 32 variants, the rows split over
its warps); on a CPU tensor it runs :func:`fast_scan_plain`, which is
``models.lmm.fast_scan``.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from ..models.lmm import FastScanResult
from ..models.lmm import fast_scan as fast_scan_plain

launches = 0

MAX_FIXED = 16      # p of the CUDA kernel's small algebra


def _bind(lib):
    vp, ci, cd = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    lib.crm_fast_scan.restype = ci
    lib.crm_fast_scan.argtypes = [vp] * 14 + [cd] + [ci] * 4 + [vp]


def fast_scan(delta, S, Wt, yt, CWW, cWy, cyy, Gt, CWG, cGy, cGG,
              n: int) -> FastScanResult:
    """:class:`FastScanResult` of every variant: S (R,), Wt (R, p), yt
    (R,), CWW (p, p), cWy (p,), cyy (), Gt (R, nS), CWG (p, nS), cGy (nS,),
    cGG (nS,), f64; ``delta`` the null's variance ratio (a number)."""
    global launches
    if S.device.type == "cpu":
        return fast_scan_plain(delta, S, Wt, yt, CWW, cWy, cyy, Gt, CWG, cGy,
                               cGG, n)
    R, p = Wt.shape
    nS = Gt.shape[1]
    if not 1 <= p <= MAX_FIXED:
        raise ValueError(f"fast_scan: needs 1 <= p <= {MAX_FIXED} "
                         f"covariates, got {p}")
    for t, name, shape in ((S, "S", (R,)), (Wt, "Wt", (R, p)),
                           (yt, "yt", (R,)), (CWW, "CWW", (p, p)),
                           (cWy, "cWy", (p,)), (cyy, "cyy", ()),
                           (Gt, "Gt", (R, nS)),
                           (CWG, "CWG", (p, nS)), (cGy, "cGy", (nS,)),
                           (cGG, "cGG", (nS,))):
        _build.require(t, f"fast_scan: {name}", torch.float64, shape)
    out = call(_build.load("fast_scan", _bind), delta, S, Wt, yt, CWW, cWy,
               cyy, Gt, CWG, cGy, cGG, n, _build.stream_ptr(S.device))
    launches += 1
    return out


def call(lib, delta, S, Wt, yt, CWW, cWy, cyy, Gt, CWG, cGy, cGG, n,
         stream=None) -> FastScanResult:
    """Allocate the results and call ``lib``'s entry point (the card's
    library, or an emulation of it on CPU tensors)."""
    R, p = Wt.shape
    nS = Gt.shape[1]
    new = lambda *shape: torch.empty(shape, dtype=torch.float64,  # noqa
                                     device=Gt.device)
    out = FastScanResult(lml=new(nS), effsizes_g=new(nS),
                         effsizes_W=new(nS, p), scale=new(nS))
    if nS == 0:
        return out
    _build.check(lib.crm_fast_scan(
        *(_build.ptr(t) for t in (S, Wt, yt, CWW, cWy, cyy, Gt, CWG, cGy,
                                  cGG, *out)),
        float(delta), n, R, p, nS, stream), "fast_scan")
    return out
