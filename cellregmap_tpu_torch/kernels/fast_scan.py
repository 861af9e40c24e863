"""K8: the fast association scan's closed-form alternative lmls.

At the null's fixed delta, every variant's ML alternative [W, g] is
re-profiled by a rank-1 update of the GLS normal equations
(cellregmap_tpu/engine.py:1132-1151 ``fast_scan_kernel`` through
models/lmm.py:863-909 ``fast_scan``).  On a CUDA tensor :func:`fast_scan`
launches ``csrc/fast_scan.cu`` (two launches: the sums over the rows split
across blocks, beside one block a gene computing its shared terms and A's
factor; then an epilogue a block a (32 variants, gene) adding the splits
in a fixed order); on a CPU tensor it runs :func:`fast_scan_plain`, which
is ``models.lmm.fast_scan``.  Its scratch (the splits' sums, the genes'
terms) is sized by ``crm_fast_scan_workspace``.

The gene-batched scan (``engine.fast_scan_multigene_batch``; the JAX
engine's ``fast_scan_multigene_kernel``, engine.py:1176-1206) passes
``slot``: each gene is re-profiled at its own null's best rho and delta,
the rotated operands come once per distinct best rho of the tile (a slot:
S, Wt, CWW, Gt, CWG and cGG gain a leading slot axis), the phenotype's
(delta, yt, cWy, cyy, cGy) a leading gene axis, and ``slot[g]`` names gene
g's.  One call serves every gene (its slot index uploaded once for each
slot pattern); the plain version runs ``models.lmm.fast_scan`` one gene at
a time.

The float32 context (``ScanConfig(dtype="float32")``: the JAX engine's
f32 ``fast_scan_kernel`` and its gene axis) takes f32 operands and returns
f32 results: the same kernels on the operand type float
(``crm_fast_scan_f32``, ``crm_fast_scan_genes_f32``), p <= ``MAX_FIXED_F32``,
every sum, solve and lml in f32 as ``models.lmm.fast_scan`` computes them
on f32 tensors.  They count their launches in ``launches_f32`` too.
"""
from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from . import _build
from ..models.lmm import FastScanResult
from ..models.lmm import fast_scan as fast_scan_plain

launches = 0
launches_f32 = 0  # of them, the float32 context's instantiations
_INDEX: dict = {}   # (device, m, slot) -> (slot index, most genes a slot)
_INDEX_LOCK = threading.Lock()

MAX_FIXED = 32      # p of the CUDA kernel's small algebra
MAX_FIXED_F32 = 16  # p of the float32 context's instantiations
MAX_SLOTS = 65535   # distinct best rho of one gene-batched launch


def _bind(lib):
    vp, ci, cd = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    lib.crm_fast_scan_workspace.restype = ctypes.c_int64
    lib.crm_fast_scan_workspace.argtypes = [ci] * 7
    for name in ("crm_fast_scan", "crm_fast_scan_f32"):
        getattr(lib, name).restype = ci
        getattr(lib, name).argtypes = [vp] * 15 + [cd] + [ci] * 4 + [vp]
    for name in ("crm_fast_scan_genes", "crm_fast_scan_genes_f32"):
        getattr(lib, name).restype = ci
        getattr(lib, name).argtypes = [vp] * 18 + [ci] * 7 + [vp]


def _limit(name, S, p) -> torch.dtype:
    """The call's dtype (float64, or float32: the float32 context) after
    checking p against its instantiations' limit."""
    dt = _build.context_dtype(S, f"{name}: S")
    top = MAX_FIXED_F32 if dt == torch.float32 else MAX_FIXED
    if not 1 <= p <= top:
        raise ValueError(f"{name}: needs 1 <= p <= {top} covariates, got {p}"
                         f" ({dt})")
    return dt


def fast_scan_genes_plain(delta, S, Wt, yt, CWW, cWy, cyy, Gt, CWG, cGy,
                          cGG, n, slot) -> FastScanResult:
    """Plain torch version of the gene axis: ``models.lmm.fast_scan`` for
    each gene at its slot."""
    return FastScanResult(*(torch.stack(f) for f in zip(*(
        fast_scan_plain(delta[g], S[k], Wt[k], yt[g], CWW[k], cWy[g],
                        cyy[g], Gt[k], CWG[k], cGy[g], cGG[k], n)
        for g, k in enumerate(int(k) for k in slot)))))


def slot_order(slot, m):
    """(genes ordered by slot, each slot's start in that order and the
    end): the (genes + m + 1,) int32 index of the gene-axis kernel."""
    slot = np.asarray(slot, dtype=np.int64)
    order = np.argsort(slot, kind="stable")
    starts = np.searchsorted(slot[order], np.arange(m + 1))
    return np.concatenate([order, starts]).astype(np.int32)


def fast_scan(delta, S, Wt, yt, CWW, cWy, cyy, Gt, CWG, cGy, cGG,
              n: int, slot=None) -> FastScanResult:
    """:class:`FastScanResult` of every variant: S (R,), Wt (R, p), yt
    (R,), CWW (p, p), cWy (p,), cyy (), Gt (R, nS), CWG (p, nS), cGy (nS,),
    cGG (nS,), f64 (or all f32: the float32 context); ``delta`` the
    null's variance ratio (a number).

    With ``slot`` (a host sequence of ``genes`` ints in [0, m)), the gene
    axis: delta (genes,), yt (genes, R), cWy (genes, p), cyy (genes,), cGy
    (genes, nS) per gene; S (m, R), Wt (m, R, p), CWW (m, p, p), Gt (m, R,
    nS), CWG (m, p, nS), cGG (m, nS) per slot; the results gain a leading
    gene axis.
    """
    global launches, launches_f32
    if slot is not None:
        return _fast_scan_genes(delta, S, Wt, yt, CWW, cWy, cyy, Gt, CWG,
                                cGy, cGG, n, slot)
    if S.device.type == "cpu":
        return fast_scan_plain(delta, S, Wt, yt, CWW, cWy, cyy, Gt, CWG, cGy,
                               cGG, n)
    R, p = Wt.shape
    nS = Gt.shape[1]
    dt = _limit("fast_scan", S, p)
    _build.require_all("fast_scan", dt, (
        (S, "S", (R,)), (Wt, "Wt", (R, p)), (yt, "yt", (R,)),
        (CWW, "CWW", (p, p)), (cWy, "cWy", (p,)), (cyy, "cyy", ()),
        (Gt, "Gt", (R, nS)), (CWG, "CWG", (p, nS)), (cGy, "cGy", (nS,)),
        (cGG, "cGG", (nS,))))
    out = call(_build.load("fast_scan", _bind), delta, S, Wt, yt, CWW, cWy,
               cyy, Gt, CWG, cGy, cGG, n, _build.stream_ptr(S.device))
    launches += 1
    launches_f32 += dt == torch.float32
    return out


def call(lib, delta, S, Wt, yt, CWW, cWy, cyy, Gt, CWG, cGy, cGG, n,
         stream=None) -> FastScanResult:
    """Allocate the results and call ``lib``'s entry point (the card's
    library, or an emulation of it on CPU tensors)."""
    R, p = Wt.shape
    nS = Gt.shape[1]
    f32 = Gt.dtype == torch.float32
    out, work = _outputs(lib, Gt, (), nS, p, (R, p, nS, 1, 1, 1, int(f32)))
    if nS == 0:
        return out
    fn = lib.crm_fast_scan_f32 if f32 else lib.crm_fast_scan
    _build.check(fn(
        *(_build.ptr(t) for t in (S, Wt, yt, CWW, cWy, cyy, Gt, CWG, cGy,
                                  cGG, *out, work)),
        float(delta), n, R, p, nS, stream), "fast_scan")
    return out


def _outputs(lib, Gt, gs, nS, p, plan):
    """The results (lml, beta_g, beta_W, scale with the leading axes
    ``gs``) and the scratch of ``crm_fast_scan_workspace(*plan)`` bytes."""
    new = lambda *shape: torch.empty(shape, dtype=Gt.dtype,  # noqa
                                     device=Gt.device)
    out = FastScanResult(lml=new(*gs, nS), effsizes_g=new(*gs, nS),
                         effsizes_W=new(*gs, nS, p), scale=new(*gs, nS))
    work = torch.empty(lib.crm_fast_scan_workspace(*plan) if nS else 0,
                       dtype=torch.uint8, device=Gt.device)
    return out, work


def _fast_scan_genes(delta, S, Wt, yt, CWW, cWy, cyy, Gt, CWG, cGy, cGG, n,
                     slot) -> FastScanResult:
    global launches, launches_f32
    if S.device.type == "cpu":
        return fast_scan_genes_plain(delta, S, Wt, yt, CWW, cWy, cyy, Gt, CWG,
                                     cGy, cGG, n, slot)
    m, R, p = Wt.shape
    genes = len(slot)
    nS = Gt.shape[2]
    dt = _limit("fast_scan", S, p)
    if not 1 <= m <= MAX_SLOTS:
        raise ValueError(f"fast_scan: 1..{MAX_SLOTS} slots, got {m}")
    if genes > MAX_SLOTS:
        raise ValueError(f"fast_scan: at most {MAX_SLOTS} genes a launch, "
                         f"got {genes}")
    _build.require_all("fast_scan", dt, (
        (delta, "delta", (genes,)), (S, "S", (m, R)), (Wt, "Wt", (m, R, p)),
        (yt, "yt", (genes, R)), (CWW, "CWW", (m, p, p)),
        (cWy, "cWy", (genes, p)), (cyy, "cyy", (genes,)),
        (Gt, "Gt", (m, R, nS)), (CWG, "CWG", (m, p, nS)),
        (cGy, "cGy", (genes, nS)), (cGG, "cGG", (m, nS))))
    index, max_genes = _slot_index(slot, m, S.device)
    out = call_genes(_build.load("fast_scan", _bind), delta, S, Wt, yt, CWW,
                     cWy, cyy, Gt, CWG, cGy, cGG, n, slot, index,
                     _build.stream_ptr(S.device), max_genes)
    launches += 1
    launches_f32 += dt == torch.float32
    return out


def _slot_index(slot, m, device):
    """(:func:`slot_order` of ``slot`` on ``device``, the most genes of a
    slot), made and uploaded once for each slot pattern (a gene-batched
    scan repeats its tile's for every batch; the 64 most recent are
    kept)."""
    s = np.asarray(slot, dtype=np.int64)
    key = (str(device), m, s.tobytes())
    with _INDEX_LOCK:
        hit = _INDEX.get(key)
        if hit is None:
            if s.ndim != 1 or not s.size or s.min() < 0 or s.max() >= m:
                raise ValueError(f"fast_scan: slot must name one of the {m} "
                                 f"slots for each of at least one gene, got "
                                 f"{s.tolist()}")
            hit = (_build.upload(slot_order(s, m), device),
                   int(np.bincount(s, minlength=m).max()))
            if len(_INDEX) >= 64:
                _INDEX.pop(next(iter(_INDEX)))
            _INDEX[key] = hit
    return hit


def call_genes(lib, delta, S, Wt, yt, CWW, cWy, cyy, Gt, CWG, cGy, cGG, n,
               slot, index, stream=None, max_genes=None) -> FastScanResult:
    """Allocate the gene axis's results and call ``lib``'s entry point
    (the card's library, or an emulation of it on CPU tensors); ``index``
    is :func:`slot_order` of the host ``slot``, as an int32 tensor on the
    operands' device; ``max_genes`` the most genes of a slot (counted from
    ``slot`` when None)."""
    m, R, p = Wt.shape
    genes = yt.shape[0]
    nS = Gt.shape[2]
    f32 = Gt.dtype == torch.float32
    if max_genes is None:
        max_genes = int(np.bincount(np.asarray(slot, dtype=np.int64),
                                    minlength=m).max())
    out, work = _outputs(lib, Gt, (genes,), nS, p,
                         (R, p, nS, genes, m, max_genes, int(f32)))
    if nS == 0:
        return out
    order = index[:genes]
    starts = index[genes:]
    fn = lib.crm_fast_scan_genes_f32 if f32 else lib.crm_fast_scan_genes
    _build.check(fn(
        *(_build.ptr(t) for t in (delta, S, Wt, yt, CWW, cWy, cyy, Gt, CWG,
                                  cGy, cGG, order, starts, *out, work)),
        n, R, p, nS, m, max_genes, genes, stream), "fast_scan")
    return out
