"""Profiled linear-mixed-model fits on the eig backend, in torch.

The port's copy of ``cellregmap_tpu.models.lmm`` (FitResult, the normal
equations' tail, the eig-backend lml and the grid + golden-section fit),
written over a leading batch axis: one problem per rho point.  The model is

    y ~ N(X beta, s * ((1 - delta) Sigma + delta I)),

with ``v0 = s (1 - delta)`` and ``v1 = s delta``; beta and s are profiled
out in closed form (GLS in the eigenbasis of Sigma), leaving a 1-D
objective over delta maximized by a coarse logit grid followed by a
fixed number of golden-section steps.  These functions are the plain
version of the null-fit kernel (``kernels/null_fit.py``).

Zero eigenvalues are inert (a direction with S_i = 0 enters every formula
exactly like the orthogonal complement), so rank padding needs no masking.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..ops.linalg import sym_pseudo_logdet, sym_pseudo_solve_and_logdet

_INVPHI = 0.6180339887498949
_INVPHI2 = 0.3819660112501051


class FitResult(NamedTuple):
    lml: torch.Tensor
    delta: torch.Tensor
    beta: torch.Tensor
    scale: torch.Tensor
    v0: torch.Tensor
    v1: torch.Tensor
    rss: torch.Tensor


class EigData(NamedTuple):
    """Per-problem data of the eig backend, batched over a leading axis B.

    S:    (B, r) eigenvalues of Sigma (zeros = padding, inert).
    Xt:   (B, r, p) rotated covariates Q^T X.
    yt:   (B, r) rotated phenotype Q^T y.
    Cxx:  (B, p, p) complement Gram X^T X - Xt^T Xt.
    cxy:  (B, p) complement X^T y - Xt^T yt.
    cyy:  (B,) complement y^T y - yt^T yt.
    """

    S: torch.Tensor
    Xt: torch.Tensor
    yt: torch.Tensor
    Cxx: torch.Tensor
    cxy: torch.Tensor
    cyy: torch.Tensor


def _lml_from_normal_eqs(A, b, yDy, logdet_d, logdet_xx, n, p, restricted):
    """GLS solve + profiled scale + (restricted) lml; A (..., p, p)."""
    beta, logdet_a = sym_pseudo_solve_and_logdet(A, b)
    rss = torch.clamp(yDy - (b * beta).sum(dim=-1),
                      min=torch.finfo(b.dtype).tiny)
    if restricted:
        nu = n - p
        scale = rss / nu
        lml = -0.5 * (nu * torch.log(2 * math.pi * scale) + logdet_d
                      + logdet_a - logdet_xx + nu)
    else:
        scale = rss / n
        lml = -0.5 * (n * torch.log(2 * math.pi * scale) + logdet_d + n)
    return lml, beta, scale, rss


def lml_at_delta_eig(delta, data: EigData, n: int, restricted: bool,
                     logdet_xx=None):
    """(lml, beta, scale, rss) at ``delta`` (B, M): M points per problem."""
    S, Xt, yt, Cxx, cxy, cyy = data
    r = S.shape[-1]
    p = Xt.shape[-1]
    dl = delta[..., None]
    d = (1 - dl) * S[:, None, :] + dl                        # (B, M, r)
    w = 1.0 / d
    XtT = Xt.transpose(-1, -2)[:, None]                      # (B, 1, p, r)
    A = XtT @ (Xt[:, None] * w[..., None]) \
        + Cxx[:, None] / delta[..., None, None]
    b = (XtT @ (yt[:, None] * w)[..., None])[..., 0] \
        + cxy[:, None] / dl
    yDy = ((yt * yt)[:, None] * w).sum(dim=-1) + cyy[:, None] / delta
    logdet_d = torch.log(d).sum(dim=-1) + (n - r) * torch.log(delta)
    if restricted and logdet_xx is None:
        logdet_xx = sym_pseudo_logdet(Xt.transpose(-1, -2) @ Xt + Cxx)
    if restricted:
        logdet_xx = logdet_xx[:, None]
    else:
        logdet_xx = 0.0
    return _lml_from_normal_eqs(A, b, yDy, logdet_d, logdet_xx, n, p,
                                restricted)


def _golden(lml_fn, a, b, n_iters):
    """Golden-section maximization of lml_fn(sigmoid(x)) on [a, b], (B,)
    problems in lockstep; ``lml_fn`` maps (B, 1) deltas to (B, 1)."""
    f = lambda x: lml_fn(torch.sigmoid(x)[:, None])[:, 0]  # noqa: E731
    h = b - a
    x1 = a + _INVPHI2 * h
    x2 = a + _INVPHI * h
    f1, f2 = f(x1), f(x2)
    for _ in range(n_iters):
        left = f1 > f2
        a = torch.where(left, a, x1)
        b = torch.where(left, x2, b)
        h = b - a
        x1n = torch.where(left, a + _INVPHI2 * h, x2)
        x2n = torch.where(left, x1, a + _INVPHI * h)
        fe = f(torch.where(left, x1n, x2n))
        f1, f2 = torch.where(left, fe, f2), torch.where(left, f1, fe)
        x1, x2 = x1n, x2n
    return torch.sigmoid(torch.where(f1 > f2, x1, x2))


def _fit_delta(lml_fn, lo, hi, n_grid, n_iters, batch, dtype, device):
    """Coarse logit-grid argmax, then golden-section refinement."""
    grid = torch.linspace(lo, hi, n_grid, dtype=dtype, device=device)
    vals = lml_fn(torch.sigmoid(grid).expand(batch, n_grid))  # (B, K)
    k = vals.argmax(dim=-1)
    a = grid[torch.clamp(k - 1, min=0)]
    b = grid[torch.clamp(k + 1, max=n_grid - 1)]
    return _golden(lml_fn, a, b, n_iters)


def fit_delta_eig(data: EigData, n: int, restricted: bool, lo=-18.0,
                  hi=18.0, n_grid=64, n_iters=60) -> FitResult:
    """Full profiled fit of each problem of the batch (eig backend)."""
    ld_xx = (sym_pseudo_logdet(data.Xt.transpose(-1, -2) @ data.Xt
                               + data.Cxx) if restricted else None)
    lml_only = lambda delta: lml_at_delta_eig(  # noqa: E731
        delta, data, n, restricted, ld_xx)[0]
    delta = _fit_delta(lml_only, lo, hi, n_grid, n_iters, data.S.shape[0],
                       data.yt.dtype, data.yt.device)
    lml, beta, scale, rss = (t[:, 0] for t in lml_at_delta_eig(
        delta[:, None], data, n, restricted, ld_xx))
    return FitResult(lml=lml, delta=delta, beta=beta, scale=scale,
                     v0=scale * (1 - delta), v1=scale * delta, rss=rss)
