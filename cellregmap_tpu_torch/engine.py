"""The interaction scan's compute core, in PyTorch.

A port of ``cellregmap_tpu.engine``'s interaction path.  The scan is built
around one orthonormal *workspace basis* Z spanning every covariance factor
([E1, L_1..L_C]):

* Sigma(rho) = Z Gz(rho) Z^T with Gz(rho) = rho Ge + (1-rho) Gk small
  (R x R); one eigh per rho point on the host replaces per-rho thin SVDs of
  n x m factors (:func:`build_null_context`).
* Every n-length contraction of a variant batch happens once, rho
  independent: the Khatri-Rao products (kernel K1) and plain GEMMs.
* The per-variant work (REML fits over the rho grid, the best-rho score
  factor rotation K4, the score statistic K5) is batched over the variant
  axis: one sequence of device launches per batch, with no host
  synchronisation inside :func:`interaction_batch`.

Zero eigenvalues are inert in every formula, so rank padding needs no
masking and all shapes are static.
"""
from __future__ import annotations

import math
from typing import Mapping, NamedTuple, Optional, Sequence

import numpy as np
import scipy.linalg as sla
import torch

from .kernels.best_rho_rotate import best_rho_rotate
from .kernels.kr_contract import kr_contract
from .kernels.score_core import score_core
from .ops.linalg import (sym_components_full, sym_components_matvec,
                         sym_pseudo_logdet, unrolled_chol_factor,
                         unrolled_chol_logdet, unrolled_chol_solve,
                         unrolled_chol_solve_logdet)


class NullContext(NamedTuple):
    """Precomputed per-dataset state of the interaction scan (tensors)."""

    y: torch.Tensor        # (n,)
    W: torch.Tensor        # (n, p)
    E0: torch.Tensor       # (n, C)  score-part contexts (possibly permuted)
    Z: torch.Tensor        # (n, R)  workspace basis
    V: torch.Tensor        # (n_rho, R, R) eigenvectors of Gz(rho)
    S: torch.Tensor        # (n_rho, R) eigenvalues of Gz(rho), >= 0
    rho: torch.Tensor      # (n_rho,)
    Zy: torch.Tensor       # (R,)
    ZW: torch.Tensor       # (R, p)
    WW: torch.Tensor       # (p, p)
    Wy: torch.Tensor       # (p,)
    yy: torch.Tensor       # ()


def null_context_from_numpy(arrays: Mapping[str, np.ndarray], device,
                            dtype=torch.float64) -> NullContext:
    """A :class:`NullContext` on ``device`` from its fields as arrays (for
    instance the JAX engine's context, field by field)."""
    return NullContext(**{
        f: torch.tensor(np.asarray(arrays[f], float), dtype=dtype,
                        device=device)
        for f in NullContext._fields})


def _gram_basis(F):
    """Orthonormal basis Z of range(F) plus T = Z^T F, via the Gram route.

    The small eigh of F^T F is rank-revealing (exactly rank-deficient
    stacks drop their null directions) and a CholQR polish restores
    eps-level orthonormality.  Directions with singular value below
    ~sqrt(m eps) sigma_max fall under the cut; dropped directions are inert
    downstream, so every result is basis-invariant.
    """
    n, m = F.shape
    if m == 0:
        return np.zeros((n, 0)), np.zeros((0, 0))
    G = F.T @ F
    lam, V = np.linalg.eigh(G)
    cut = (max(m, 1) * np.finfo(float).eps * lam[-1]
           if lam.size and lam[-1] > 0 else 0.0)
    keep = lam > cut
    B = V[:, keep] / np.sqrt(lam[keep])
    Z0 = F @ B
    M = Z0.T @ Z0
    Lch = np.linalg.cholesky(M)
    Linv = sla.solve_triangular(Lch, np.eye(Lch.shape[0]), lower=True)
    Z = Z0 @ Linv.T
    T = Linv @ (B.T @ G)
    return Z, T


def build_null_context(y, W, E1, E0=None, Ls: Optional[Sequence] = None,
                       hK=None, rho_grid=None, *, device,
                       dtype=torch.float64) -> NullContext:
    """Factorize the null covariance family once (host NumPy + one upload).

    Three background modes, as in the reference CellRegMap.__init__: E-only
    (rho = [1.0]), E + K (hK given), E + K (.) EE^T (Ls given; Ls takes
    precedence).
    """
    y_np = np.asarray(y, float).ravel()
    n = y_np.shape[0]
    W_np = np.ones((n, 1)) if W is None else np.asarray(W, float)
    if W_np.ndim == 1:
        W_np = W_np[:, None]
    E1_np = np.asarray(E1, float)
    E0_np = E1_np if E0 is None else np.asarray(E0, float)

    if Ls is not None and len(Ls) > 0:
        bg_np = [np.asarray(L, float) for L in Ls]
    elif hK is not None:
        bg_np = [np.asarray(hK, float)]
    else:
        bg_np = []
    if rho_grid is None:
        rho_grid = np.linspace(0.0, 1.0, 11) if bg_np else np.array([1.0])
    rho_np = np.asarray(rho_grid, float)

    F = np.concatenate([E1_np] + bg_np, axis=1)
    Z_np, R_np = _gram_basis(F)
    C1 = E1_np.shape[1]
    Re = R_np[:, :C1]
    Ge = Re @ Re.T
    if bg_np:
        Rk = R_np[:, C1:]
        Gk = Rk @ Rk.T
    else:
        Gk = np.zeros_like(Ge)
    Gz = rho_np[:, None, None] * Ge[None] \
        + (1 - rho_np)[:, None, None] * Gk[None]
    # serial: LAPACK's eigh already threads over every core
    eigs = [np.linalg.eigh(g) for g in Gz]
    return null_context_from_numpy(dict(
        y=y_np, W=W_np, E0=E0_np, Z=Z_np,
        V=np.stack([e[1] for e in eigs]),
        S=np.maximum(np.stack([e[0] for e in eigs]), 0.0),
        rho=rho_np, Zy=Z_np.T @ y_np, ZW=Z_np.T @ W_np, WW=W_np.T @ W_np,
        Wy=W_np.T @ y_np, yy=np.asarray(y_np @ y_np)), device, dtype)


def interaction_batch(ctx: NullContext, G: torch.Tensor,
                      G_score: torch.Tensor, n: int,
                      delta_cfg=(-18.0, 18.0, 64, 60), newton_f32: int = 6,
                      newton_f64: int = 3, localize_f32: bool = True) -> dict:
    """Score-test interaction scan of one variant batch.

    Per variant: the REML null fit over the rho grid with X = [W, g], then
    the score statistic Q = 1/2 ||(g o E0)^T P y||^2 and the C x C weight
    matrix 1/2 A^T P A.  ``G_score`` carries the (possibly idx_G-permuted)
    genotypes of the score part; the null fits use ``G``.  No host
    synchronisation: every branch is a ``torch.where``/argmax on the card.

    Returns a dict of (S,)-leading tensors: Q, Wmat, rho1, e2, g2, eps2,
    v0, v1, delta, lml.
    """
    Z, E0, y, W = ctx.Z, ctx.E0, ctx.y, ctx.W
    p = W.shape[1]
    dev = y.device
    f64 = y.dtype
    nS = G.shape[1]

    # --- rho-independent contractions: K1 three times, plain GEMMs ---
    ZG = Z.T @ G                                   # (R, S)
    T = kr_contract(Z, E0, G_score)                # (R, C, S)
    AtA = kr_contract(E0, E0, G_score * G_score)   # (C, C, S)
    AW = kr_contract(E0, W, G_score)               # (C, p, S)
    Ay = E0.T @ (G_score * y[:, None])             # (C, S)
    Ag = E0.T @ (G_score * G)                      # (C, S)  A^T g (unpermuted)
    Wg = W.T @ G                                   # (p, S)
    gg = (G * G).sum(dim=0)                        # (S,)
    gy = G.T @ y                                   # (S,)

    # --- per-rho rotations of [W | G] and y (batched GEMMs) ---
    WG_rot = torch.matmul(ctx.V.transpose(1, 2),
                          torch.cat([ctx.ZW, ZG], dim=1))  # (nrho, R, p+S)
    Wt_all = WG_rot[:, :, :p]
    Gt_all = WG_rot[:, :, p:]
    yt_all = ctx.V.transpose(1, 2) @ ctx.Zy              # (nrho, R)

    lo, hi, n_grid, _ = delta_cfg

    # --- complement Grams (rotations are orthonormal: rho-independent) ---
    CWW = ctx.WW - ctx.ZW.T @ ctx.ZW
    CWy = ctx.Wy - ctx.ZW.T @ ctx.Zy
    Cyy = ctx.yy - ctx.Zy @ ctx.Zy
    CWg = Wg - ctx.ZW.T @ ZG
    Cgy = gy - ZG.T @ ctx.Zy
    Cgg = gg - (ZG * ZG).sum(dim=0)
    # When the basis rank approaches n the complements are ~0 and the
    # subtractions return cancellation noise, which the 1/delta weights
    # amplify into spurious lml maxima.  The complement Gram of [W, g, y] is
    # PSD, so clamp its diagonal to the noise floor and Cauchy-Schwarz-clip
    # the cross terms against the clamped diagonal.
    eps_c = 128 * torch.finfo(f64).eps
    dCWW = torch.maximum(torch.diagonal(CWW), eps_c * torch.diagonal(ctx.WW))
    CWW = CWW - torch.diag(torch.diagonal(CWW)) + torch.diag(dCWW)
    Cyy = torch.maximum(Cyy, eps_c * ctx.yy)
    Cgg = torch.maximum(Cgg, eps_c * gg)
    cwy_b = torch.sqrt(dCWW * Cyy)
    CWy = torch.clamp(CWy, -cwy_b, cwy_b)
    cwg_b = torch.sqrt(dCWW[:, None] * Cgg[None, :])
    CWg = torch.clamp(CWg, -cwg_b, cwg_b)
    cgy_b = torch.sqrt(Cgg * Cyy)
    Cgy = torch.clamp(Cgy, -cgy_b, cgy_b)

    # --- normal-equation component tensors ---
    # Hybrid precision: the delta grid runs in f32 (``fast``); the Newton
    # steps run on the f32-rounded tensors with f64 state, exactly as the
    # JAX engine's type promotion does; the best-rho stages and the score
    # statistic are f64.
    R = ctx.S.shape[1]
    p1 = p + 1
    nu = n - p1
    fast = torch.float32 if (f64 == torch.float64 and localize_f32) else f64

    yy_t = yt_all * yt_all                              # (nrho, R)
    Wy_c = [Wt_all[:, :, j] * yt_all for j in range(p)]
    WWt_c = [[Wt_all[:, :, i] * Wt_all[:, :, j] for j in range(i + 1)]
             for i in range(p)]
    GY_t = Gt_all * yt_all[:, :, None]                  # (nrho, R, S)
    G2_t = Gt_all * Gt_all
    GW_c = [Gt_all * Wt_all[:, :, j][:, :, None] for j in range(p)]
    CWg_sT = CWg.T                                      # (S, p)

    def _tset(dt, hold=None):
        """The component tensors rounded to ``dt``, held in ``hold``."""
        c = lambda a: a.to(dt).to(hold or dt)  # noqa: E731
        return dict(
            S=c(ctx.S), e=c(1.0 - ctx.S), e2=c((1.0 - ctx.S) ** 2),
            yy=c(yy_t), Wy=[c(a) for a in Wy_c],
            WW=[[c(a) for a in row] for row in WWt_c],
            GY=c(GY_t), G2=c(G2_t), GW=[c(a) for a in GW_c],
            CWW=c(CWW), CWy=c(CWy), Cyy=c(Cyy),
            CWg=c(CWg_sT), Cgy=c(Cgy), Cgg=c(Cgg))

    TS64 = _tset(f64)
    TS32 = _tset(fast) if fast != f64 else TS64
    TS1b = _tset(fast, f64) if fast != f64 else TS64

    def _colvec(v, like):
        """(S,) per-variant vector against (S, nrho) or (S,) weights."""
        return v[:, None] if like.ndim == 2 else v

    def _ne_family(w, ic, TS, rs, ro):
        """Normal-equation components under eigen-weights ``w`` plus the
        complement's scalar weight ``ic`` (a power of 1/delta);
        ``ro``/``rs`` reduce the eigen axis of snp-shared / per-snp
        tensors."""
        A = [[ro(w, TS["WW"][i][j]) + TS["CWW"][i, j] * ic
              for j in range(i + 1)] for i in range(p)]
        g_row = [rs(w, TS["GW"][j]) + _colvec(TS["CWg"][:, j], ic) * ic
                 for j in range(p)]
        g_row.append(rs(w, TS["G2"]) + _colvec(TS["Cgg"], ic) * ic)
        A.append(g_row)
        b = [ro(w, TS["Wy"][j]) + TS["CWy"][j] * ic for j in range(p)]
        b.append(rs(w, TS["GY"]) + _colvec(TS["Cgy"], ic) * ic)
        q = ro(w, TS["yy"]) + TS["Cyy"] * ic
        return A, b, q

    # --- stage 1a: coarse delta grid as snp-shared batched GEMMs (K2) ---
    TS = TS32
    logit_grid = torch.linspace(lo, hi, n_grid, dtype=f64, device=dev)
    deltas = torch.sigmoid(logit_grid).to(fast)
    d_grid = (1 - deltas)[None, :, None] * TS["S"][:, None, :] \
        + deltas[None, :, None]                         # (nrho, K, R)
    Wd = 1.0 / d_grid
    logdet_grid = torch.log(d_grid).sum(dim=-1) \
        + (n - R) * torch.log(deltas)[None, :]          # (nrho, K)
    inv_d = (1.0 / deltas)[None, None]                  # (1, 1, K)

    red_o = lambda t: torch.einsum("okr,or->ok", Wd, t)[None]  # noqa: E731
    red_s = lambda t: torch.bmm(Wd, t).permute(2, 0, 1)  # noqa: E731

    A_rows = [[red_o(TS["WW"][i][j]) + TS["CWW"][i, j] * inv_d
               for j in range(i + 1)] for i in range(p)]
    g_row = [red_s(TS["GW"][j]) + TS["CWg"][:, j][:, None, None] * inv_d
             for j in range(p)]
    g_row.append(red_s(TS["G2"]) + TS["Cgg"][:, None, None] * inv_d)
    A_rows.append(g_row)
    b_comp = [red_o(TS["Wy"][j]) + TS["CWy"][j] * inv_d for j in range(p)]
    b_comp.append(red_s(TS["GY"]) + TS["Cgy"][:, None, None] * inv_d)
    yy_grid = red_o(TS["yy"]) + TS["Cyy"] * inv_d       # (1, nrho, K)

    beta_c, logdet_a_grid = unrolled_chol_solve_logdet(A_rows, b_comp)
    rss_grid = yy_grid
    for j in range(p1):
        rss_grid = rss_grid - b_comp[j] * beta_c[j]
    # below ~eps(fast) * q the residual is cancellation noise; exclude those
    # points from the argmax (they form spurious maxima at tiny delta)
    rss_collapsed = rss_grid <= 128 * torch.finfo(fast).eps * yy_grid
    rss_grid = torch.clamp(rss_grid, min=torch.finfo(fast).tiny)

    # logdet(X^T X) is delta-independent: once per variant, f64
    XX = torch.cat([
        torch.cat([ctx.WW.expand(nS, p, p), Wg.T[:, :, None]], dim=2),
        torch.cat([Wg.T[:, None, :], gg[:, None, None]], dim=2)], dim=1)
    ld_xx = sym_pseudo_logdet(XX)                       # (S,)

    lml_grid = -0.5 * (
        nu * torch.log(2 * math.pi * rss_grid / nu)
        + logdet_grid[None]
        + logdet_a_grid
        - ld_xx.to(fast)[:, None, None]
        + nu)                                           # (S, nrho, K)
    lml_grid = torch.where(rss_collapsed | ~torch.isfinite(lml_grid),
                           -math.inf, lml_grid)
    # all-non-finite rows fall back to the full bracket
    row_bad = (~torch.isfinite(lml_grid)).all(dim=-1)   # (S, nrho)
    k_grid = lml_grid.argmax(dim=-1)                    # (S, nrho)
    br_lo = torch.where(row_bad, lo,
                        logit_grid[torch.clamp(k_grid - 1, min=0)])
    br_hi = torch.where(row_bad, hi,
                        logit_grid[torch.clamp(k_grid + 1, max=n_grid - 1)])

    # --- Newton machinery (K3) ---
    def _bcast(t, delta):
        """A shared (nrho, R) tensor against (S, nrho) deltas; per-variant
        (S, R) tensors pass as they are."""
        return t[None] if (t.ndim == 2 and delta.ndim == 2) else t

    def _derivs(delta, TS, rs, ro):
        """(dL/d delta, d2L/d delta2) of the restricted profiled objective,
        in component form."""
        dx = delta[..., None]
        d = (1 - dx) * _bcast(TS["S"], delta) + dx
        w1 = 1.0 / d
        we2 = _bcast(TS["e"], delta) * w1 * w1
        we3 = _bcast(TS["e2"], delta) * w1 * w1 * w1
        i1 = 1.0 / delta
        i2 = i1 * i1
        i3 = i2 * i1

        A1, b1, q1 = _ne_family(w1, i1, TS, rs, ro)
        A2, b2, q2 = _ne_family(we2, i2, TS, rs, ro)
        A3, b3, q3 = _ne_family(we3, i3, TS, rs, ro)

        L1 = unrolled_chol_factor(A1)
        beta = unrolled_chol_solve(L1, b1)
        rss = q1 - sum(b1[j] * beta[j] for j in range(p1))
        rss = torch.clamp(rss, min=torch.finfo(delta.dtype).tiny)

        A2b = sym_components_matvec(A2, beta)
        A3b = sym_components_matvec(A3, beta)
        beta_p = unrolled_chol_solve(
            L1, [A2b[j] - b2[j] for j in range(p1)])
        A2bp = sym_components_matvec(A2, beta_p)
        rss_p = -q2 + 2 * sum(b2[j] * beta[j] for j in range(p1)) \
            - sum(beta[j] * A2b[j] for j in range(p1))
        rss_pp = (2 * q3
                  - 4 * sum(b3[j] * beta[j] for j in range(p1))
                  + 2 * sum(b2[j] * beta_p[j] for j in range(p1))
                  - 2 * sum(beta[j] * A2bp[j] for j in range(p1))
                  + 2 * sum(beta[j] * A3b[j] for j in range(p1)))

        ld_d_p = ro(w1, TS["e"]) + (n - R) * i1
        ld_d_pp = -ro(w1 * w1, TS["e2"]) - (n - R) * i2

        # trace terms via explicit A1^{-1} columns (p1 unit solves)
        ones = torch.ones_like(q1)
        zeros = torch.zeros_like(q1)
        A1inv = [unrolled_chol_solve(
            L1, [ones if i == kc else zeros for i in range(p1)])
            for kc in range(p1)]        # A1inv[kc][i] = (A1^{-1})_{i,kc}
        A2f = sym_components_full(A2)
        A3f = sym_components_full(A3)
        T2 = [[sum(A1inv[k][i] * A2f[k][j] for k in range(p1))
               for j in range(p1)] for i in range(p1)]
        tr_T2 = sum(T2[i][i] for i in range(p1))
        tr_T3 = sum(A1inv[k][i] * A3f[k][i]
                    for i in range(p1) for k in range(p1))
        tr_T2sq = sum(T2[i][j] * T2[j][i]
                      for i in range(p1) for j in range(p1))

        u = rss_p / rss
        L_p = -0.5 * (nu * u + ld_d_p - tr_T2)
        L_pp = -0.5 * (nu * (rss_pp / rss - u * u) + ld_d_pp
                       + 2 * tr_T3 - tr_T2sq)
        return L_p, L_pp

    def _newton_step(st, TS, rs, ro):
        x, lo_b, hi_b = st
        delta = torch.sigmoid(x)
        Lp, Lpp = _derivs(delta, TS, rs, ro)
        g_sig = delta * (1 - delta)
        Lx_p = Lp * g_sig
        Lx_pp = Lpp * g_sig * g_sig + Lp * g_sig * (1 - 2 * delta)
        lo2 = torch.where(Lx_p > 0, x, lo_b)
        hi2 = torch.where(Lx_p > 0, hi_b, x)
        x_newton = x - Lx_p / Lx_pp
        # inclusive bounds: at convergence x_newton == x == a bracket end
        ok = (Lx_pp < 0) & (x_newton >= lo2) & (x_newton <= hi2) \
            & torch.isfinite(x_newton)
        return torch.where(ok, x_newton, 0.5 * (lo2 + hi2)), lo2, hi2

    # --- stage 1b: Newton over all (variant, rho) problems ---
    reduce_oo = lambda w, t: torch.einsum("sor,or->so", w, t)  # noqa: E731
    reduce_os = lambda w, t: torch.einsum("sor,ors->so", w, t)  # noqa: E731
    st = (0.5 * (br_lo + br_hi), br_lo, br_hi)
    for _ in range(newton_f32):
        st = _newton_step(st, TS1b, reduce_os, reduce_oo)
    x32 = st[0]
    delta32 = torch.sigmoid(x32)                        # (S, nrho)

    # --- stage 2: one f64 lml evaluation at the localized optimum ---
    d_star = (1 - delta32)[..., None] * ctx.S[None] + delta32[..., None]
    A1s, b1s, q1s = _ne_family(1.0 / d_star, 1.0 / delta32, TS64,
                               reduce_os, reduce_oo)
    L1s = unrolled_chol_factor(A1s)
    beta_s = unrolled_chol_solve(L1s, b1s)
    rss_s = q1s - sum(b1s[j] * beta_s[j] for j in range(p1))
    rss_bad = rss_s <= 128 * torch.finfo(f64).eps * q1s
    rss_s = torch.clamp(rss_s, min=torch.finfo(f64).tiny)
    logdet_d_s = torch.log(d_star).sum(dim=-1) + (n - R) * torch.log(delta32)
    lml_all = -0.5 * (
        nu * torch.log(2 * math.pi * rss_s / nu) + logdet_d_s
        + unrolled_chol_logdet(L1s) - ld_xx[:, None] + nu)  # (S, nrho)
    # noise-floor or NaN evaluations must not win the rho argmax
    lml_all = torch.where(rss_bad | ~torch.isfinite(lml_all), -math.inf,
                          lml_all)
    k_best = lml_all.argmax(dim=-1)                     # (S,)

    # --- stage 3: f64 Newton at each variant's best rho (gathers) ---
    At_all = best_rho_rotate(ctx.V, T, k_best)          # (S, R, C)  K4
    ar = torch.arange(nS, device=dev)
    gather_o = lambda t: t[k_best]                      # noqa: E731
    gather_s = lambda t: t[k_best, :, ar]               # noqa: E731
    TS_k = dict(
        S=gather_o(ctx.S), e=gather_o(1.0 - ctx.S),
        e2=gather_o((1.0 - ctx.S) ** 2),
        yy=gather_o(yy_t), Wy=[gather_o(a) for a in Wy_c],
        WW=[[gather_o(a) for a in row] for row in WWt_c],
        GY=gather_s(GY_t), G2=gather_s(G2_t),
        GW=[gather_s(a) for a in GW_c],
        CWW=CWW, CWy=CWy, Cyy=Cyy, CWg=CWg_sT, Cgy=Cgy, Cgg=Cgg)
    reduce_ko = lambda w, t: (w * t).sum(dim=-1)        # noqa: E731

    # restart from the GRID bracket, not the f32-Newton shrunk one: near the
    # optimum the localized derivative signs are noise
    st_k = (x32[ar, k_best], br_lo[ar, k_best], br_hi[ar, k_best])
    for _ in range(newton_f64):
        st_k = _newton_step(st_k, TS_k, reduce_ko, reduce_ko)
    delta_k = torch.sigmoid(st_k[0])                    # (S,)

    # final f64 REML evaluation at (best rho, converged delta)
    d_k = (1 - delta_k)[:, None] * TS_k["S"] + delta_k[:, None]  # (S, R)
    A1k, b1k, q1k = _ne_family(1.0 / d_k, 1.0 / delta_k, TS_k,
                               reduce_ko, reduce_ko)
    L1k = unrolled_chol_factor(A1k)
    beta_k = unrolled_chol_solve(L1k, b1k)
    rss_k = q1k - sum(b1k[j] * beta_k[j] for j in range(p1))
    # clamp to the tensors' cancellation noise floor: keeps a
    # near-degenerate variant's scale finite instead of exploding Q
    rss_k = torch.maximum(rss_k, 128 * torch.finfo(f64).eps * q1k)
    rss_k = torch.clamp(rss_k, min=torch.finfo(f64).tiny)
    lml_k = -0.5 * (
        nu * torch.log(2 * math.pi * rss_k / nu)
        + torch.log(d_k).sum(dim=-1) + (n - R) * torch.log(delta_k)
        + unrolled_chol_logdet(L1k) - ld_xx + nu)      # (S,)
    scale_k = rss_k / nu
    v0_k = scale_k * (1 - delta_k)
    v1_k = scale_k * delta_k

    # --- score statistic at the best rho (K5) ---
    Q, Wmat = score_core(ctx.S, WG_rot, yt_all, At_all, ctx.WW, ctx.Wy, Wg,
                         gg, gy, AW, Ag, Ay, AtA, k_best, v0_k, v1_k)
    rho1 = ctx.rho[k_best]
    return {"Q": Q, "Wmat": Wmat, "rho1": rho1, "e2": v0_k * rho1,
            "g2": v0_k * (1 - rho1), "eps2": v1_k, "v0": v0_k, "v1": v1_k,
            "delta": delta_k, "lml": lml_k}
