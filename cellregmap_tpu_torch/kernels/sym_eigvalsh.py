"""K6a: the eigenvalues of the score test's weight matrices, ascending and
clamped at 0: the mixture weights of Q's null law under the Liu,
saddlepoint and auto p-value methods.

The JAX package computes them as max(eigh(sym(A) + eps I) - eps, 0), eps =
1e-12 max(max|diag|, 1) (cellregmap_tpu/ops/linalg.py ``safe_eigh``,
:238-249, clamped in ``per_snp``, engine.py:759-769); a matrix with a
non-finite entry gives NaNs, as ``eigh`` does there.  On a CUDA tensor
:func:`sym_eigvalsh` launches ``csrc/sym_eigvalsh.cu`` (neither route
needs the shift: up to ``WARP_MAX_C`` cyclic Jacobi, a warp a matrix;
above it Householder tridiagonalization and Sturm bisection, a block a
matrix); on a CPU tensor it runs :func:`sym_eigvalsh_plain`, the shifted
form through ``torch.linalg.eigvalsh``.  The float32 context takes the
weight matrices rounded to f32 and returns f32 eigenvalues (the
reference's ``safe_eigh(Wmat.astype(ctx dtype))``, engine.py:767): both
routes have an f32 instantiation (``crm_sym_eigvalsh_f32``), and the plain
version runs in the input's dtype.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

launches = 0
launches_f32 = 0  # of them, the float32 context's instantiation

MAX_C = 64          # matrix size the card takes (api.CARD_MAX_CONTEXTS)
WARP_MAX_C = 32     # the Jacobi route's largest matrix, a warp a matrix
MAX_SWEEPS = 30     # Jacobi sweeps, at most
MAX_BISECT = 128    # bisection steps an eigenvalue, at most


def sym_eigvalsh_plain(A: torch.Tensor) -> torch.Tensor:
    """Plain torch version: eigvalsh of the symmetrized matrix shifted by
    eps I, shifted back and clamped at 0 (the JAX package's form); NaN for
    a matrix with a non-finite entry (whose eigvalsh would raise)."""
    sym = 0.5 * (A + A.transpose(-1, -2))
    bad = ~torch.isfinite(sym).all(dim=-1).all(dim=-1)
    sym = torch.where(bad[..., None, None], 0.0, sym)
    diag = torch.diagonal(sym, dim1=-2, dim2=-1)
    eps = 1e-12 * torch.clamp(diag.abs().amax(dim=-1), min=1.0)
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    lam = torch.linalg.eigvalsh(sym + eps[..., None, None] * eye)
    lam = torch.clamp(lam - eps[..., None], min=0.0)
    return torch.where(bad[..., None], float("nan"), lam)


def _bind(lib):
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.crm_sym_eigvalsh.restype = ci
    lib.crm_sym_eigvalsh.argtypes = [vp, vp, vp, ci, ci, vp]
    lib.crm_sym_eigvalsh_f32.restype = ci
    lib.crm_sym_eigvalsh_f32.argtypes = [vp, vp, vp, ci, ci, vp]


def sym_eigvalsh(A: torch.Tensor, return_sweeps: bool = False):
    """(S, C) eigenvalues, ascending and clamped at 0, of the symmetric
    parts of A (S, C, C) f64 (or f32, the float32 context: the result in
    the input's dtype); with ``return_sweeps`` also each matrix's
    iteration count (S,) int32 (on the CPU: None): the Jacobi sweeps it
    took up to ``WARP_MAX_C``, above it the most bisection steps of its
    eigenvalues (0 for a matrix with a non-finite entry; the f32
    instantiation's steps to f32 resolution, fewer than f64's)."""
    global launches, launches_f32
    if A.device.type == "cpu":
        lam = sym_eigvalsh_plain(A)
        return (lam, None) if return_sweeps else lam
    S, C = A.shape[0], A.shape[-1]
    if C > MAX_C:
        raise ValueError(f"sym_eigvalsh: at most {MAX_C} x {MAX_C} matrices, "
                         f"got C={C}")
    _build.require(A, "sym_eigvalsh: A",
                   _build.context_dtype(A, "sym_eigvalsh: A"), (S, C, C))
    out = call(_build.load("sym_eigvalsh", _bind), A, return_sweeps,
               _build.stream_ptr(A.device))
    launches += 1
    launches_f32 += A.dtype == torch.float32
    return out


def call(lib, A, return_sweeps=False, stream=None):
    """Allocate the outputs and call ``lib``'s entry point (the card's
    library, or an emulation of it on CPU tensors)."""
    S, C = A.shape[0], A.shape[-1]
    lam = torch.empty((S, C), dtype=A.dtype, device=A.device)
    # the counts only where asked for (the kernel writes every matrix's)
    sweeps = (torch.empty((S,), dtype=torch.int32, device=A.device)
              if return_sweeps else None)
    entry = (lib.crm_sym_eigvalsh_f32 if A.dtype == torch.float32
             else lib.crm_sym_eigvalsh)
    if lam.numel():
        _build.check(entry(
            _build.ptr(A), _build.ptr(lam),
            _build.ptr(sweeps) if return_sweeps else None, S, C, stream),
            "sym_eigvalsh")
    return (lam, sweeps) if return_sweeps else lam
