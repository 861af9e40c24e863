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

Also here, as plain versions of their kernels: the fast scanner's
closed-form alternative lmls at the null's fixed delta (:func:`fast_scan`,
K8, ``kernels/fast_scan.py``) and the Woodbury family evaluator of the
effect sizes (:func:`_family_eval_batch`, K9,
``kernels/woodbury_family.py``), with the zoom-round fitter
:func:`fit_delta_woodbury_family` that drives K9.

Zero eigenvalues are inert (a direction with S_i = 0 enters every formula
exactly like the orthogonal complement), so rank padding needs no masking.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..ops.linalg import (_ridge, sym_pseudo_logdet, sym_pseudo_solve,
                          sym_pseudo_solve_and_logdet)

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
    """Coarse logit-grid argmax, then golden-section refinement.  In
    float32 a grid point whose factorization failed (a NaN lml) never wins
    the argmax: the JAX engine's argmax takes it and that rho's whole fit
    is NaN (ROADMAP queue 3, "In the reference", items j and k)."""
    grid = torch.linspace(lo, hi, n_grid, dtype=dtype, device=device)
    vals = lml_fn(torch.sigmoid(grid).expand(batch, n_grid))  # (B, K)
    if dtype == torch.float32:
        vals = torch.where(torch.isnan(vals), -torch.inf, vals)
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


# --------------------------------------------------------------------------
# Fast scanner (closed-form per-variant alternative lmls)
# --------------------------------------------------------------------------
class FastScanResult(NamedTuple):
    lml: torch.Tensor         # (S,) alternative ML lmls
    effsizes_g: torch.Tensor  # (S,) candidate effect sizes
    effsizes_W: torch.Tensor  # (S, p) covariate effect sizes
    scale: torch.Tensor       # (S,) profiled scales


def fast_scan(delta, S, Wt, yt, CWW, cWy, cyy, Gt, CWG, cGy, cGG,
              n: int) -> FastScanResult:
    """Closed-form alternative-model lmls for all candidates at once
    (glimix-core ``FastScanner.fast_scan``, consumed at
    _cellregmap.py:308-309).

    The null's ``delta`` is held fixed; per candidate g the fixed effects
    [W g] and the scale are re-profiled by a rank-1 update of the GLS normal
    equations.  S (r,) eigenvalues, Wt (r, p), yt (r,); CWW/cWy/cyy the
    complement Grams of (W, y); Gt (r, S) rotated candidates, CWG (p, S),
    cGy (S,), cGG (S,) their complements.
    """
    delta = torch.as_tensor(delta, dtype=S.dtype, device=S.device)
    d = (1 - delta) * S + delta
    w = 1.0 / d
    A = Wt.T @ (Wt * w[:, None]) + CWW / delta          # (p, p)
    bw = Wt.T @ (yt * w) + cWy / delta                  # (p,)
    yy_w = (yt * yt * w).sum() + cyy / delta

    U = Wt.T @ (Gt * w[:, None]) + CWG / delta          # (p, S)
    cgg = (Gt * Gt * w[:, None]).sum(dim=0) + cGG / delta
    cgy = (yt * w) @ Gt + cGy / delta

    Ai_b = sym_pseudo_solve(A, bw[:, None])[:, 0]       # (p,)
    Ai_U = sym_pseudo_solve(A, U)                       # (p, S)
    schur = cgg - (U * Ai_U).sum(dim=0)
    resid = cgy - bw @ Ai_U
    beta_g = resid / schur
    beta_W = Ai_b[:, None] - Ai_U * beta_g[None, :]
    rss = torch.clamp(yy_w - bw @ Ai_b - resid * resid / schur,
                      min=torch.finfo(yt.dtype).tiny)
    logdet_d = torch.log(d).sum() + (n - S.shape[0]) * torch.log(delta)
    scale = rss / n
    lml = -0.5 * (n * torch.log(2 * math.pi * scale) + logdet_d + n)
    return FastScanResult(lml=lml, effsizes_g=beta_g, effsizes_W=beta_W.T,
                          scale=scale)


# --------------------------------------------------------------------------
# Woodbury family evaluator of the effect sizes
# --------------------------------------------------------------------------
class FamilyCols(NamedTuple):
    """The rotated columns [Ua | UB, ug | uy] of a betas batch, each stored
    once: Ua (Rk, C, S) and ug (Rk, S) per variant (the Khatri-Rao
    contraction's layout), UB (Rk, pB) and uy (Rk,) shared by every
    variant."""

    Ua: torch.Tensor
    UB: torch.Tensor
    ug: torch.Tensor
    uy: torch.Tensor


def stack_cols(cols: FamilyCols) -> torch.Tensor:
    """The (S, Rk, q) per-variant column stack [Ua | UB | ug | uy]."""
    Rk, _, S = cols.Ua.shape
    return torch.cat([cols.Ua.permute(2, 0, 1),
                      cols.UB.expand(S, Rk, -1),
                      cols.ug.T[:, :, None],
                      cols.uy.expand(S, Rk)[:, :, None]], dim=2)


def _chol_nan(A: torch.Tensor) -> torch.Tensor:
    """Cholesky factor with every failed factorization NaN throughout, as
    the JAX engine's ``jnp.linalg.cholesky`` returns it."""
    L, info = torch.linalg.cholesky_ex(A, check_errors=False)
    return torch.where((info == 0)[..., None, None], L,
                       torch.full_like(L, float("nan")))


def _lml_tail(rss, logdet_d, logdet_a, ld_xx, n, p, restricted):
    if restricted:
        nu = n - p
        return -0.5 * (nu * torch.log(2 * math.pi * rss / nu) + logdet_d
                       + logdet_a - ld_xx[:, None] + nu)
    return -0.5 * (n * torch.log(2 * math.pi * rss / n) + logdet_d + n)


def _mask_f32(lml, rss_raw):
    """f32 rounds: a collapsed residual (clamped at tiny it would become a
    huge finite lml that wins the argmax) or a non-finite value is -inf."""
    bad = (rss_raw <= 8 * torch.finfo(torch.float32).tiny) \
        | ~torch.isfinite(lml)
    return torch.where(bad, torch.full_like(lml, -math.inf), lml)


def _family_eval_batch(logits, rho, colsS, compS, Lam, C, n, restricted,
                       logdet_xxS, rcond, want_beta=False):
    """lml (and with ``want_beta`` beta/rss) at per-variant (logit, rho)
    points: the plain version of K9 (cellregmap_tpu/models/lmm.py:435-555).

    ``logits``/``rho``: (S, L) paired points per variant.  ``colsS``: (S,
    rB, q) rotated columns [Ua | Ux | uy], independent of rho and delta.
    ``compS``: (S, q, q) complement Grams ``Gfull - cols^T cols``.  The rB
    contraction runs in chunks of points (the (S, chunk, rB, q) weighted
    columns bounded at ~250 MB); the lml-only path then factors the bordered
    Gram

        J = [[I + cvec H,  s hX,  s hy ],      s = sqrt(cvec)
             [s hX^T,      XmX,   Xmy  ],
             [s hy^T,      Xmy^T, ymy  ]]

    once per point: its pivots give det(cap), the GLS normal matrix's
    determinant and (the last) the GLS residual.
    """
    S_, rB, q = colsS.shape
    L = logits.shape[1]
    p = q - C - 1
    dt = colsS.dtype
    chunk = max(1, min(L, int(2.5e8 / max(S_ * rB * q * colsS.element_size(),
                                          1))))
    dl = torch.sigmoid(logits)                           # (S, L)
    cvec = (1 - dl) * rho
    i1 = 1.0 / dl
    Mi, logm = [], []
    for c0 in range(0, L, chunk):
        d, rh = dl[:, c0 : c0 + chunk], rho[:, c0 : c0 + chunk]
        m = (1 - d)[..., None] * ((1 - rh)[..., None] * Lam) \
            + d[..., None]                               # (S, c, rB)
        wc = colsS[:, None, :, :] * (1.0 / m)[..., None]  # (S, c, rB, q)
        Mi.append(torch.matmul(wc.transpose(-1, -2), colsS[:, None]))
        logm.append(torch.log(m).sum(dim=-1))
    Mi = torch.cat(Mi, dim=1) + compS[:, None] * i1[..., None, None]
    logm = torch.cat(logm, dim=1)

    if want_beta:
        lml, beta, rss_raw = _family_blocks_matrix(
            Mi, logm, cvec, dl, rB, C, p, n, restricted, logdet_xxS, rcond)
        return lml, beta, torch.clamp(rss_raw, min=torch.finfo(dt).tiny)

    s_b = torch.sqrt(cvec)
    w = torch.cat([s_b[..., None].expand(S_, L, C),
                   torch.ones((S_, L, p + 1), dtype=dt, device=dl.device)],
                  dim=-1)                                # (S, L, q)
    diagC = torch.cat([torch.ones(C, dtype=dt, device=dl.device),
                       torch.zeros(p + 1, dtype=dt, device=dl.device)])
    J = Mi * (w[..., :, None] * w[..., None, :]) + torch.diag(diagC)
    # no ridge in f32: marginally non-PD f32 points give NaN pivots and
    # are masked to -inf below instead
    JL = _chol_nan(J if dt == torch.float32 else _ridge(J, rcond))
    pivots = torch.diagonal(JL, dim1=-2, dim2=-1)        # (S, L, q)
    logdet_cap = 2.0 * torch.log(pivots[..., :C]).sum(dim=-1)
    logdet_a = 2.0 * torch.log(pivots[..., C:-1]).sum(dim=-1)
    rss_raw = pivots[..., -1] ** 2
    rss = torch.clamp(rss_raw, min=torch.finfo(dt).tiny)
    logdet_d = logm + (n - rB) * torch.log(dl) + logdet_cap
    lml = _lml_tail(rss, logdet_d, logdet_a, logdet_xxS, n, p, restricted)
    return _mask_f32(lml, rss_raw) if dt == torch.float32 else lml


def _family_blocks_matrix(Mi, logm, cvec, dl, rB, C, p, n, restricted,
                          logdet_xxS, rcond):
    """Matrix-form phase 2 of :func:`_family_eval_batch` with the GLS
    coefficients (cellregmap_tpu/models/lmm.py:558-602): the capacitance
    Cholesky, the Schur complement (A, b, yDy) of the covariate block, its
    ridge Cholesky, beta and the raw residual.  Returns (lml, beta, rss_raw).
    """
    dt = Mi.dtype
    H = Mi[..., :C, :C]
    hX = Mi[..., :C, C : C + p]
    hy = Mi[..., :C, -1]
    XmX = Mi[..., C : C + p, C : C + p]
    Xmy = Mi[..., C : C + p, -1]
    ymy = Mi[..., -1, -1]
    eye = torch.eye(C, dtype=dt, device=Mi.device)
    cap = eye + cvec[..., None, None] * H
    if dt == torch.float32:
        cap = cap + 1e-6 * eye
    cap_chol = _chol_nan(cap)
    sol = torch.cholesky_solve(torch.cat([hX, hy[..., None]], dim=-1),
                               cap_chol)
    hX_s, hy_s = sol[..., :p], sol[..., p]
    A = XmX - cvec[..., None, None] * (hX.transpose(-1, -2) @ hX_s)
    b = Xmy - cvec[..., None] * (hX * hy_s[..., None]).sum(dim=-2)
    yDy = ymy - cvec * (hy * hy_s).sum(dim=-1)
    logdet_d = logm + (n - rB) * torch.log(dl) + 2 * torch.log(
        torch.diagonal(cap_chol, dim1=-2, dim2=-1)).sum(dim=-1)
    A_chol = _chol_nan(_ridge(A, rcond))
    beta = torch.cholesky_solve(b[..., None], A_chol)[..., 0]
    logdet_a = 2 * torch.log(
        torch.diagonal(A_chol, dim1=-2, dim2=-1)).sum(dim=-1)
    rss_raw = yDy - (b * beta).sum(dim=-1)
    rss = torch.clamp(rss_raw, min=torch.finfo(dt).tiny)
    lml = _lml_tail(rss, logdet_d, logdet_a, logdet_xxS, n, p, restricted)
    if dt == torch.float32:
        lml = _mask_f32(lml, rss_raw)
    return lml, beta, rss_raw


_K2 = 16   # points of each zoom round's grid


def fit_delta_woodbury_family(cols: FamilyCols, GfullS, Lam, rho_vec,
                              n: int, restricted: bool, C: int, lo=-18.0,
                              hi=18.0, localize_f32: bool = False, *,
                              evaluate):
    """Profiled fits of a whole (variant x rho) family, returning each
    variant's best-rho fit (cellregmap_tpu/models/lmm.py:605-753).

    ``cols`` the batch's rotated columns, ``GfullS`` (S, q, q) the
    full-space Grams of [A | X | y], ``evaluate`` the family evaluator (K9,
    ``kernels.woodbury_family.family_eval``: its signature is
    :func:`_family_eval_batch`'s with ``cols`` for ``colsS``).  Every zoom
    round evaluates all (variant, rho, 16-point grid) points in one call.
    With ``localize_f32`` the first five rounds run in float32 over every
    rho (rows whose f32 lml spread is below the f32 noise floor freeze
    their bracket), the family is pruned to each variant's top-2 rho, and
    three f64 rounds follow; otherwise five f64 rounds over every rho.
    A parabolic vertex on the last grid and one f64 evaluation with the
    coefficients end the fit.  Returns per-variant (lml, delta, beta (S,
    p), scale, v0, v1, rho1).
    """
    dtype = GfullS.dtype
    dev = GfullS.device
    colsS = stack_cols(cols)
    S_, _, q = colsS.shape
    nrho = rho_vec.shape[0]
    p = q - C - 1
    compS = GfullS - colsS.transpose(1, 2) @ colsS
    del colsS
    if restricted:
        ld_xx = sym_pseudo_logdet(GfullS[:, C : C + p, C : C + p])
    else:
        ld_xx = torch.zeros((S_,), dtype=dtype, device=dev)

    use32 = bool(localize_f32) and dtype == torch.float64
    if use32:
        f32 = torch.float32
        cols32 = FamilyCols(*(t.to(f32) for t in cols))
        comp32, Lam32, ld32 = compS.to(f32), Lam.to(f32), ld_xx.to(f32)

    def family_vals(logits3d, rho2d, f32_round):
        """logits3d (S, nr, K), rho2d (S, nr) -> (S, nr, K) lmls."""
        nr, K = logits3d.shape[1:]
        flat = logits3d.reshape(S_, nr * K)
        rho_flat = torch.repeat_interleave(rho2d, K, dim=-1)
        if f32_round:
            v = evaluate(flat.to(f32), rho_flat.to(f32), cols32, comp32,
                         Lam32, C, n, restricted, ld32, 1e-6)
            return v.reshape(S_, nr, K).to(dtype)
        v = evaluate(flat, rho_flat, cols, compS, Lam, C, n, restricted,
                     ld_xx, 1e-12)
        return v.reshape(S_, nr, K)

    t = torch.linspace(0.0, 1.0, _K2, dtype=dtype, device=dev)

    def zoom_round(state, rho2d, f32_round, pad):
        a, bb = state[:2]
        logits = a[..., None] + (bb - a)[..., None] * t   # (S, nr, K2)
        vals = family_vals(logits, rho2d, f32_round)
        kz = vals.argmax(dim=-1)
        cell = (bb - a) / (_K2 - 1)
        center = a + cell * kz
        a_new = torch.maximum(center - pad * cell, a)
        bb_new = torch.minimum(center + pad * cell, bb)
        if f32_round:
            # once a row's f32 lml spread is below the f32 noise floor its
            # argmax is noise: the row keeps its bracket for the f64 rounds
            finite = torch.isfinite(vals)
            ninf = torch.full_like(vals, -math.inf)
            vmax = torch.where(finite, vals, ninf).amax(dim=-1)
            vmin = torch.where(finite, vals, -ninf).amin(dim=-1)
            noise = 64 * torch.finfo(torch.float32).eps \
                * torch.clamp(vmax.abs(), min=1.0)
            freeze = ~finite.any(dim=-1) | ((vmax - vmin) < noise)
            a_new = torch.where(freeze, a, a_new)
            bb_new = torch.where(freeze, bb, bb_new)
        return a_new, bb_new, logits, vals, kz

    def init_bracket(nr):
        return (torch.full((S_, nr), lo, dtype=dtype, device=dev),
                torch.full((S_, nr), hi, dtype=dtype, device=dev))

    if use32:
        rho_all = rho_vec[None].expand(S_, nrho)
        st = init_bracket(nrho)
        for _ in range(5):
            st = zoom_round(st, rho_all, True, 2.0)
        # prune to each variant's top-2 rho (a stable sort: ties keep the
        # lower rho first, as lax.top_k)
        k2 = min(2, nrho)
        top2 = torch.sort(st[3].amax(dim=-1), dim=1, descending=True,
                          stable=True).indices[:, :k2]
        rho_sel = torch.gather(rho_all, 1, top2)
        st = (torch.gather(st[0], 1, top2), torch.gather(st[1], 1, top2))
        n_f64 = 3
    else:
        rho_sel = rho_vec[None].expand(S_, nrho)
        st = init_bracket(nrho)
        n_f64 = 5
    for _ in range(n_f64):
        st = zoom_round(st, rho_sel, False, 1.0)
    _, _, logits, vals, kz = st

    # parabolic vertex on the last grid
    km = torch.clamp(kz, 1, _K2 - 2)
    h = logits[..., 1] - logits[..., 0]                  # (S, nr)
    take = lambda a, idx: torch.gather(a, -1, idx[..., None])[..., 0]  # noqa
    f0, f1, f2 = take(vals, km - 1), take(vals, km), take(vals, km + 1)
    denom = f0 - 2 * f1 + f2
    step = torch.where(denom < 0, 0.5 * h * (f0 - f2) / denom,
                       torch.zeros_like(denom))
    x_star = take(logits, km) + torch.minimum(torch.maximum(step, -h), h)

    lml, beta, rss = evaluate(x_star, rho_sel.contiguous(), cols, compS, Lam,
                              C, n, restricted, ld_xx, 1e-12, want_beta=True)
    delta = torch.sigmoid(x_star)
    scale = rss / ((n - p) if restricted else n)

    k = lml.argmax(dim=-1)                               # (S,)
    sel = lambda a: torch.gather(  # noqa: E731
        a, 1, k.reshape((S_, 1) + (1,) * (a.ndim - 2)).expand(
            (S_, 1) + a.shape[2:]))[:, 0]
    lml_b, delta_b, beta_b, scale_b = sel(lml), sel(delta), sel(beta), \
        sel(scale)
    return (lml_b, delta_b, beta_b, scale_b, scale_b * (1 - delta_b),
            scale_b * delta_b, sel(rho_sel))
