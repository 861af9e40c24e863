"""The profiled-GLS normal equations in component form, shared by the plain
versions of the delta grid (K2/K7) and the Newton stages (K3/K7).

For one (variant, rho) problem with X = [W, g] rotated into the rho
eigenbasis (eigenvalues S_r), eigen-weights w_r and the complement's scalar
weight ic (a power of 1/delta), the normal equations are

    A = sum_r w_r x_r x_r^T + C_XX ic,  b = sum_r w_r x_r y_r + C_Xy ic,
    q = sum_r w_r y_r^2 + C_yy ic,

every entry kept as its own tensor ("component form") so that each op is
elementwise over the (variant, rho) batch.  The rotated products
(W_i W_j, W_j y, y^2 shared by every variant; g W_j, g^2, g y per variant)
are formed here from the rotated stacks; the CUDA kernels form them on the
fly and never write them.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..ops.linalg import (sym_components_full, sym_components_matvec,
                          unrolled_chol_factor, unrolled_chol_solve)


class Complements(NamedTuple):
    """Complement Grams of [W, g, y] (full space minus the eigenbasis):
    CWW (p, p), CWy (p,), Cyy (), CWg (p, S), Cgy (S,), Cgg (S,).  In a
    gene-batched call the phenotype's CWy, Cyy and Cgy carry a leading gene
    axis."""

    CWW: torch.Tensor
    CWy: torch.Tensor
    Cyy: torch.Tensor
    CWg: torch.Tensor
    Cgy: torch.Tensor
    Cgg: torch.Tensor


def gene_comp(comp: Complements, g: int) -> Complements:
    """Gene ``g``'s complements of a gene-batched set (CWy (genes, p), Cyy
    (genes,), Cgy (genes, S)); the genotype's (CWW, CWg, Cgg) are shared."""
    return comp._replace(CWy=comp.CWy[g], Cyy=comp.Cyy[g], Cgy=comp.Cgy[g])


def products(Wt, yt, Gt):
    """The rotated products, f64: snp-shared yy (.., R), Wy[j], WW[i][j]
    (j <= i) and per-variant GY, G2, GW[j] (Gt's shape)."""
    p = Wt.shape[-1]
    yg = yt[..., None]
    return dict(
        yy=yt * yt, Wy=[Wt[..., j] * yt for j in range(p)],
        WW=[[Wt[..., i] * Wt[..., j] for j in range(i + 1)]
            for i in range(p)],
        GY=Gt * yg, G2=Gt * Gt, GW=[Gt * Wt[..., j][..., None]
                                    for j in range(p)])


def tensor_set(S, prod, comp: Complements, dt, hold=None):
    """Eigenvalue families, products and complements rounded to ``dt`` and
    held in ``hold`` (default ``dt``); CWg is stored (S, p)."""
    c = lambda a: a.to(dt).to(hold or dt)  # noqa: E731
    return dict(
        S=c(S), e=c(1.0 - S), e2=c((1.0 - S) ** 2),
        yy=c(prod["yy"]), Wy=[c(a) for a in prod["Wy"]],
        WW=[[c(a) for a in row] for row in prod["WW"]],
        GY=c(prod["GY"]), G2=c(prod["G2"]), GW=[c(a) for a in prod["GW"]],
        CWW=c(comp.CWW), CWy=c(comp.CWy), Cyy=c(comp.Cyy),
        CWg=c(comp.CWg.T), Cgy=c(comp.Cgy), Cgg=c(comp.Cgg))


def _colvec(v, like):
    """(S,) per-variant vector against (S, nrho) or (S,) weights."""
    return v[:, None] if like.ndim == 2 else v


def ne_family(w, ic, TS, rs, ro):
    """Normal-equation components (A rows, b, q) under eigen-weights ``w``
    plus the complement's weight ``ic``; ``ro``/``rs`` reduce the eigen
    axis of snp-shared / per-variant tensors."""
    p = len(TS["Wy"])
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


def _bcast(t, delta):
    """A shared (nrho, R) tensor against (S, nrho) deltas; per-variant
    (S, R) tensors pass as they are."""
    return t[None] if (t.ndim == 2 and delta.ndim == 2) else t


def derivs(delta, TS, rs, ro, n, restricted):
    """(dL/d delta, d2L/d delta2) of the profiled objective in component
    form: restricted (REML, with the logdet(A) trace terms) or ML."""
    R = TS["S"].shape[-1]
    p1 = len(TS["Wy"]) + 1
    dx = delta[..., None]
    d = (1 - dx) * _bcast(TS["S"], delta) + dx
    w1 = 1.0 / d
    we2 = _bcast(TS["e"], delta) * w1 * w1
    we3 = _bcast(TS["e2"], delta) * w1 * w1 * w1
    i1 = 1.0 / delta
    i2 = i1 * i1
    i3 = i2 * i1

    A1, b1, q1 = ne_family(w1, i1, TS, rs, ro)
    A2, b2, q2 = ne_family(we2, i2, TS, rs, ro)
    A3, b3, q3 = ne_family(we3, i3, TS, rs, ro)

    L1 = unrolled_chol_factor(A1)
    beta = unrolled_chol_solve(L1, b1)
    rss = q1 - sum(b1[j] * beta[j] for j in range(p1))
    rss = torch.clamp(rss, min=torch.finfo(delta.dtype).tiny)

    A2b = sym_components_matvec(A2, beta)
    A3b = sym_components_matvec(A3, beta)
    beta_p = unrolled_chol_solve(L1, [A2b[j] - b2[j] for j in range(p1)])
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
    u = rss_p / rss
    if not restricted:
        # ML objective (cellregmap_tpu/engine.py:1026-1028): no logdet(A)
        return (-0.5 * (n * u + ld_d_p),
                -0.5 * (n * (rss_pp / rss - u * u) + ld_d_pp))

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
    nu = n - p1
    L_p = -0.5 * (nu * u + ld_d_p - tr_T2)
    L_pp = -0.5 * (nu * (rss_pp / rss - u * u) + ld_d_pp
                   + 2 * tr_T3 - tr_T2sq)
    return L_p, L_pp


def newton_step(st, TS, rs, ro, n, restricted):
    """One safeguarded Newton step on logit(delta) within its bracket."""
    x, lo_b, hi_b = st
    delta = torch.sigmoid(x)
    Lp, Lpp = derivs(delta, TS, rs, ro, n, restricted)
    g_sig = delta * (1 - delta)
    Lx_p = Lp * g_sig
    Lx_pp = Lpp * g_sig * g_sig + Lp * g_sig * (1 - 2 * delta)
    lo2 = torch.where(Lx_p > 0, x, lo_b)
    hi2 = torch.where(Lx_p > 0, hi_b, x)
    x_newton = x - Lx_p / Lx_pp
    # inclusive bounds: at convergence x_newton == x == a bracket end
    # (cellregmap_tpu/engine.py:620-624)
    ok = (Lx_pp < 0) & (x_newton >= lo2) & (x_newton <= hi2) \
        & torch.isfinite(x_newton)
    return torch.where(ok, x_newton, 0.5 * (lo2 + hi2)), lo2, hi2


def lml_value(rss, logdet_d, logdet_a, ld_xx, n, p1, restricted):
    """The profiled lml from its parts: REML with nu = n - p1, logdet(A)
    and logdet(X^T X), or ML with n alone."""
    if restricted:
        nu = n - p1
        return -0.5 * (nu * torch.log(2 * math.pi * rss / nu) + logdet_d
                       + logdet_a - ld_xx + nu)
    return -0.5 * (n * torch.log(2 * math.pi * rss / n) + logdet_d + n)
