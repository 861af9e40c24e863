"""The interaction scan's and the association test's compute core, in
PyTorch.

A port of ``cellregmap_tpu.engine``'s interaction and association paths.
Both are built around one orthonormal *workspace basis* Z spanning every
covariance factor ([E1, L_1..L_C]):

* Sigma(rho) = Z Gz(rho) Z^T with Gz(rho) = rho Ge + (1-rho) Gk small
  (R x R); one eigh per rho point on the host replaces per-rho thin SVDs of
  n x m factors (:func:`build_null_context`).
* Every n-length contraction of a variant batch happens once, rho
  independent: the Khatri-Rao products (kernel K1) and plain GEMMs.
* The per-variant work (the REML fits over the rho grid: the delta grid
  K2 and the Newton stages K3; the best-rho score factor rotation K4; the
  score statistic K5; under the Liu, saddlepoint and auto p-value methods
  the mixture weights K6a and the device tails K6b) is batched over the
  variant axis: one sequence of device launches per batch, with no host
  synchronisation inside :func:`interaction_batch`.  The gene-batched
  scan (:func:`interaction_multigene_batch`) adds a gene axis to the
  phenotype's terms and runs every gene of a tile in the same launches.
* The association test fits the covariates-only null once per phenotype
  (K10, :func:`null_association_fit`) and refits each variant by ML at the
  null's best rho (K7: K2's and K3's kernels with the ML objective,
  :func:`association_refit_batch`), or re-profiles it in closed form at
  the null's delta (K8, :func:`fast_scan_batch`).  The gene-batched
  association scans fit a tile of phenotypes' nulls in one launch
  (:func:`null_association_multigene_fit`) and run each gene at its own
  null's best rho: the rotations are made once per distinct best rho of
  the tile, and K7 and K8 take a per-gene index into them
  (:func:`association_refit_multigene_batch`,
  :func:`fast_scan_multigene_batch`).
* The effect sizes fit each variant's own covariance family rho (g E0)
  (g E0)^T + (1 - rho) K (.) E E^T on the background's eigenbasis
  (:func:`build_betas_context`): three Khatri-Rao contractions (K1) and the
  Woodbury family evaluator (K9) in the zoom rounds of
  ``models.lmm.fit_delta_woodbury_family``
  (:func:`predict_interaction_batch`).  The aggregate environment's fits
  over the null's rho grid are K10 with REML (:func:`mean_fit`).

In the float32 context (every field of the context f32, as the JAX
engine's on an f32 context) the association's null fits (K10), the fast
scan (K8), the refit's grid (K7's K2 kernels) and the effect sizes (K1,
K9) run in f32; the refit's Newton steps and final fit (K7's converge)
are f64 arithmetic on the f32 tensors, from brackets at the grid's f64
logits, as the reference's type promotion makes them.  A rho whose f32
null fit is NaN is never the best rho (:func:`_best_rho`).

Zero eigenvalues are inert in every formula, so rank padding needs no
masking and all shapes are static.
"""
from __future__ import annotations

import functools
from typing import Mapping, NamedTuple, Optional, Sequence

import numpy as np
import scipy.linalg as sla
import torch

from .kernels import _build
from .kernels._normal_eqs import Complements
from .kernels.best_rho_rotate import best_rho_rotate
from .kernels.delta_grid import delta_grid
from .kernels.fast_scan import fast_scan
from .kernels.kr_contract import kr_contract
from .kernels.mixture_tails import mixture_tails
from .kernels.null_fit import null_fit
from .kernels.reml_newton import reml_converge, reml_localize
from .kernels.score_core import score_core
from .kernels.sym_eigvalsh import sym_eigvalsh
from .kernels.woodbury_family import family_eval
from .models.lmm import (EigData, FamilyCols, FitResult, FastScanResult,
                         fit_delta_woodbury_family)
from .ops.linalg import sym_pseudo_logdet


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
        f: torch.tensor(np.array(arrays[f], float, order="C"), dtype=dtype,
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


def _complements(ctx: NullContext, ZG, Wg, gg, gy) -> Complements:
    """Complement Grams of [W, g, y]: full space minus the workspace basis
    (the per-rho rotations are orthonormal, so these are rho-independent)."""
    return Complements(
        CWW=ctx.WW - ctx.ZW.T @ ctx.ZW, CWy=ctx.Wy - ctx.ZW.T @ ctx.Zy,
        Cyy=ctx.yy - ctx.Zy @ ctx.Zy, CWg=Wg - ctx.ZW.T @ ZG,
        Cgy=gy - ZG.T @ ctx.Zy, Cgg=gg - (ZG * ZG).sum(dim=0))


def _phenotype_terms(y, Zy, Wy, yy, *, ctx, G, G_score, ZG, dCWW, Cgg):
    """One phenotype's terms of an interaction batch: the rotated y, A^T y,
    g^T y and the clamped y complements (CWy, Cyy, Cgy).  The gene-batched
    scan maps it over the genes (``torch.func.vmap``); a single phenotype
    calls it as it is."""
    Ay = ctx.E0.T @ (G_score * y[:, None])             # (C, S)
    gy = G.T @ y                                       # (S,)
    yt_all = ctx.V.transpose(1, 2) @ Zy                # (nrho, R)
    CWy = Wy - ctx.ZW.T @ Zy
    Cyy = yy - Zy @ Zy
    Cgy = gy - ZG.T @ Zy
    # the complement Gram of [W, g, y] is PSD: Cyy clamped to its noise
    # floor, the cross terms Cauchy-Schwarz-clipped (interaction_batch)
    Cyy = torch.maximum(Cyy, 128 * torch.finfo(y.dtype).eps * yy)
    cwy_b = torch.sqrt(dCWW * Cyy)
    CWy = torch.clamp(CWy, -cwy_b, cwy_b)
    cgy_b = torch.sqrt(Cgg * Cyy)
    Cgy = torch.clamp(Cgy, -cgy_b, cgy_b)
    return Ay, gy, yt_all, CWy, Cyy, Cgy


def interaction_batch(ctx: NullContext, G: torch.Tensor,
                      G_score: torch.Tensor, n: int,
                      delta_cfg=(-18.0, 18.0, 64, 60), newton_f32: int = 6,
                      newton_f64: int = 3, localize_f32: bool = True,
                      device_pvalues: bool = False) -> dict:
    """Score-test interaction scan of one variant batch.

    Per variant: the REML null fit over the rho grid with X = [W, g], then
    the score statistic Q = 1/2 ||(g o E0)^T P y||^2 and the C x C weight
    matrix 1/2 A^T P A.  ``G_score`` carries the (possibly idx_G-permuted)
    genotypes of the score part; the null fits use ``G``.  No host
    synchronisation: every branch is a ``torch.where``/argmax on the card.

    ``ctx``'s phenotype fields (y, Zy, Wy, yy) may carry a leading gene
    axis (:func:`interaction_multigene_batch`): the genotype's terms are
    computed once and every kernel takes all the genes in one launch.

    Returns a dict of ([genes,] S)-leading tensors: Q, Wmat, rho1, e2, g2,
    eps2, v0, v1, delta, lml; with ``device_pvalues`` also the mixture
    weights ``lambdas`` (K6a) and the device tails ``pv_liu`` and
    ``pv_saddlepoint`` (K6b).

    A float32 context (every field f32, with G and G_score: the screen's,
    the JAX engine's f32 ``interaction_batch``) is mixed precision as the
    reference's type promotion makes it: the contractions (K1), the
    rotations, the complements, logdet(X^T X), the delta grid (K2), the
    localizing Newton steps (K3) and the best-rho rotation (K4) run in f32;
    the per-variant statistics (K3's evaluation and converge, the score
    statistic K5) in f64 on the widened f32 tensors; the mixture weights
    (K6a) are the f32 eigenvalues of Wmat rounded to f32.  The results are
    f64 either way.
    """
    Z, E0, W = ctx.Z, ctx.E0, ctx.W
    p = W.shape[1]
    f64 = ctx.y.dtype
    nS = G.shape[1]

    # --- rho-independent contractions: K1 three times, plain GEMMs ---
    ZG = Z.T @ G                                   # (R, S)
    T = kr_contract(Z, E0, G_score)                # (R, C, S)
    AtA = kr_contract(E0, E0, G_score * G_score)   # (C, C, S)
    AW = kr_contract(E0, W, G_score)               # (C, p, S)
    Ag = E0.T @ (G_score * G)                      # (C, S)  A^T g (unpermuted)
    Wg = W.T @ G                                   # (p, S)
    gg = (G * G).sum(dim=0)                        # (S,)

    # --- per-rho rotations of [W | G] (batched GEMMs) ---
    WG_rot = torch.matmul(ctx.V.transpose(1, 2),
                          torch.cat([ctx.ZW, ZG], dim=1))  # (nrho, R, p+S)

    lo, hi, n_grid, _ = delta_cfg

    # the genotype's complements.  When the basis rank approaches n the
    # complements are ~0 and the subtractions return cancellation noise,
    # which the 1/delta weights amplify into spurious lml maxima.  The
    # complement Gram of [W, g, y] is PSD, so clamp its diagonal to the
    # noise floor and Cauchy-Schwarz-clip the cross terms against the
    # clamped diagonal (the y terms in _phenotype_terms).
    eps_c = 128 * torch.finfo(f64).eps
    CWW = ctx.WW - ctx.ZW.T @ ctx.ZW
    CWg = Wg - ctx.ZW.T @ ZG
    Cgg = gg - (ZG * ZG).sum(dim=0)
    dCWW = torch.maximum(torch.diagonal(CWW), eps_c * torch.diagonal(ctx.WW))
    CWW = CWW - torch.diag(torch.diagonal(CWW)) + torch.diag(dCWW)
    Cgg = torch.maximum(Cgg, eps_c * gg)
    cwg_b = torch.sqrt(dCWW[:, None] * Cgg[None, :])
    CWg = torch.clamp(CWg, -cwg_b, cwg_b)

    # --- the phenotype's terms, per gene ---
    terms = functools.partial(_phenotype_terms, ctx=ctx, G=G,
                              G_score=G_score, ZG=ZG, dCWW=dCWW, Cgg=Cgg)
    if ctx.y.ndim == 2:
        # the kernels take contiguous operands; vmap may return views
        mapped = torch.func.vmap(terms)
        terms = lambda *a: [t.contiguous() for t in mapped(*a)]  # noqa: E731
    Ay, gy, yt_all, CWy, Cyy, Cgy = terms(ctx.y, ctx.Zy, ctx.Wy, ctx.yy)

    # --- the REML fits over the rho grid: K2, then K3 ---
    # Hybrid precision: the delta grid runs in f32 (``fast``); the
    # localizing Newton steps run f64 arithmetic on the f32-rounded
    # tensors, exactly as the JAX engine's type promotion does; the
    # best-rho stages and the score statistic are f64.
    fast = torch.float32 if (f64 == torch.float64 and localize_f32) else f64
    comp = Complements(CWW, CWy, Cyy, CWg, Cgy, Cgg)
    # logdet(X^T X) is delta-independent: once per variant, f64
    XX = torch.cat([
        torch.cat([ctx.WW.expand(nS, p, p), Wg.T[:, :, None]], dim=2),
        torch.cat([Wg.T[:, None, :], gg[:, None, None]], dim=2)], dim=1)
    ld_xx = sym_pseudo_logdet(XX)                       # (S,)
    br_lo, br_hi = delta_grid(ctx.S, WG_rot, yt_all, comp, ld_xx, lo, hi,
                              n_grid, n, fast)          # (S, nrho)  K2
    x32, _, k_best = reml_localize(ctx.S, WG_rot, yt_all, comp, ld_xx,
                                   br_lo, br_hi, n, newton_f32,
                                   fast != f64)         # K3
    # each distinct (rho, variant) pair's factor once: (m, S, R, C), m =
    # min(genes, nrho) slots (one for a single phenotype)
    At_slots, slot = best_rho_rotate(ctx.V, T, k_best)  # K4
    # restart from the GRID bracket, not the Newton-shrunk one: near the
    # optimum the localized derivative signs are noise (engine.py:704-709)
    delta_k, lml_k, scale_k, _ = reml_converge(
        ctx.S, WG_rot, yt_all, comp, ld_xx, k_best, x32, br_lo, br_hi, n,
        newton_f64)                                     # K3
    v0_k = scale_k * (1 - delta_k)
    v1_k = scale_k * delta_k

    # --- score statistic at the best rho (K5) ---
    Q, Wmat = score_core(ctx.S, WG_rot, yt_all, At_slots, ctx.WW, ctx.Wy,
                         Wg, gg, gy, AW, Ag, Ay, AtA, k_best, v0_k, v1_k,
                         slot)
    rho1 = ctx.rho[k_best].to(torch.float64)
    out = {"Q": Q, "Wmat": Wmat, "rho1": rho1, "e2": v0_k * rho1,
           "g2": v0_k * (1 - rho1), "eps2": v1_k, "v0": v0_k, "v1": v1_k,
           "delta": delta_k, "lml": lml_k}
    if device_pvalues:
        # the mixture weights (K6a: in the context's dtype, the weight
        # matrices rounded to it, engine.py:759-769) and both device tails
        # (K6b, f64)
        C = Wmat.shape[-1]
        lam = sym_eigvalsh(Wmat.reshape(-1, C, C).to(f64)).to(torch.float64)
        pv_liu, pv_sp = mixture_tails(Q.reshape(-1), lam)
        out.update(lambdas=lam.reshape(Wmat.shape[:-1]),
                   pv_liu=pv_liu.reshape(Q.shape),
                   pv_saddlepoint=pv_sp.reshape(Q.shape))
    return out


def interaction_multigene_batch(ctx: NullContext, G, G_score, n: int,
                                delta_cfg=(-18.0, 18.0, 64, 60),
                                newton_f32: int = 6, newton_f64: int = 3,
                                localize_f32: bool = True,
                                device_pvalues: bool = False) -> dict:
    """Gene-batched interaction scan: genes x variants in one sequence of
    launches (the JAX engine's ``interaction_multigene_batch``,
    engine.py:813-846).

    ``ctx``'s phenotype fields (y (genes, n), Zy (genes, R), Wy (genes,
    p), yy (genes,)) carry a leading gene axis; everything else is the
    shared per-dataset state.  The genotype's contractions (K1 x3), the
    per-rho rotation of [W | G] and the genotype's complements are computed
    once per batch and shared by every gene; K2, K3, K4 and K5 (and K6
    with ``device_pvalues``) launch once for all the genes.  Returns
    :func:`interaction_batch`'s dict with (genes, S)-leading tensors; the
    arguments and their defaults are :func:`interaction_batch`'s.
    """
    if ctx.y.ndim != 2:
        raise ValueError("interaction_multigene_batch: ctx.y must be "
                         "(genes, n)")
    return interaction_batch(ctx, G, G_score, n, delta_cfg=delta_cfg,
                             newton_f32=newton_f32, newton_f64=newton_f64,
                             localize_f32=localize_f32,
                             device_pvalues=device_pvalues)


# --------------------------------------------------------------------------
# association scan
# --------------------------------------------------------------------------
def _fit_over_rho(ctx: NullContext, Xz, X_gram, X_y, n: int,
                  restricted: bool, delta_cfg) -> FitResult:
    """REML/ML fits over the rho grid for one mean matrix X (K10): Xz
    (R, p) workspace-rotated covariates, X_gram (p, p) = X^T X, X_y (p,)
    = X^T y.  Fields of the result carry a leading rho axis."""
    lo, hi, n_grid, n_iters = delta_cfg
    Vt = ctx.V.transpose(1, 2)
    Xt = Vt @ Xz                                        # (nrho, R, p)
    yt = Vt @ ctx.Zy                                    # (nrho, R)
    XtT = Xt.transpose(1, 2)
    data = EigData(S=ctx.S, Xt=Xt, yt=yt, Cxx=X_gram - XtT @ Xt,
                   cxy=X_y - (XtT @ yt[:, :, None])[:, :, 0],
                   cyy=ctx.yy - (yt * yt).sum(dim=1))
    return null_fit(data, n, restricted, lo, hi, n_grid, n_iters)


def _best_rho(lml: torch.Tensor) -> torch.Tensor:
    """The argmax over the last (rho) axis.  In the float32 context a NaN
    lml (an f32 fit that failed) is never the best rho: the JAX package's
    argmax takes it, and its f32 association scans and aggregate
    environment are NaN from it (ROADMAP queue 3, "In the reference",
    items j and k)."""
    if lml.dtype == torch.float32:
        lml = torch.where(torch.isnan(lml), -torch.inf, lml)
    return lml.argmax(dim=-1)


def null_association_fit(ctx: NullContext, n: int, restricted: bool = False,
                         delta_cfg=(-18.0, 18.0, 64, 60)):
    """Covariate-only null fits over the rho grid and the best rho's index
    (a 0-d tensor on the context's device); reference :246-266."""
    fits = _fit_over_rho(ctx, ctx.ZW, ctx.WW, ctx.Wy, n, restricted,
                         delta_cfg)
    return fits, _best_rho(fits.lml)


def association_refit_batch(ctx: NullContext, G: torch.Tensor, k_rho: int,
                            n: int, delta_cfg=(-18.0, 18.0, 64, 60),
                            newton_f64: int = 10,
                            localize_f32: bool = True):
    """Per-variant ML alternative fits (X = [W, g]) at the null's best rho
    ``k_rho`` (K7): the delta grid (K2's kernel with the ML objective, one
    rho), then ``newton_f64`` f64 Newton steps and the final fit (K3's
    converge kernel, ML).  Returns (alt lml (S,), beta (S, p + 1)), f64
    in either context (the float32 context's grid is f32, its steps f64
    arithmetic on the f32 tensors, as the JAX engine's)."""
    f64 = ctx.y.dtype
    fast = torch.float32 if (f64 == torch.float64 and localize_f32) else f64
    lo, hi, n_grid, _ = delta_cfg
    Vt = ctx.V[k_rho : k_rho + 1].transpose(1, 2)       # (1, R, R)
    S = ctx.S[k_rho : k_rho + 1]                        # (1, R)
    ZG = ctx.Z.T @ G                                    # (R, S)
    WG_rot = Vt @ torch.cat([ctx.ZW, ZG], dim=1)        # (1, R, p+S)
    yt = Vt @ ctx.Zy                                    # (1, R)
    comp = _complements(ctx, ZG, ctx.W.T @ G, (G * G).sum(dim=0),
                        G.T @ ctx.y)
    br_lo, br_hi = delta_grid(S, WG_rot, yt, comp, None, lo, hi, n_grid, n,
                              fast, restricted=False)
    _, lml, _, beta = reml_converge(S, WG_rot, yt, comp, None, None, None,
                                    br_lo, br_hi, n, newton_f64,
                                    restricted=False)
    return _best_of_grid_ends(S, WG_rot, yt, comp, None, br_lo, br_hi, n,
                              lml, beta, lo, hi)


def _best_of_grid_ends(S, WGt, yt, comp, k_best, br_lo, br_hi, n, lml, beta,
                       lo, hi):
    """The refit's (lml, beta) or the f64 fit at either end of the delta
    grid, whichever has the larger lml (K3's converge kernel with no steps,
    at x0 = lo and x0 = hi).

    Under hybrid localization a variant whose ML profile rises flat to the
    grid's end has its float32 grid argmax at float32 noise: its bracket
    lies short of the end, and the f64 Newton steps stop at the bracket's
    edge, up to ~3e-6 below the f64 optimum (the JAX package's
    ``association_refit_batch`` keeps that shortfall).  A profile that
    rises to the end of the grid has its grid optimum there, so the f64
    value at the end repairs it; for any other profile the ends score
    lower and change nothing."""
    for end in (lo, hi):
        _, lml_e, _, beta_e = reml_converge(
            S, WGt, yt, comp, None, k_best, torch.full_like(br_lo, end),
            br_lo, br_hi, n, 0, restricted=False)
        better = lml_e > lml
        lml = torch.where(better, lml_e, lml)
        beta = torch.where(better[..., None], beta_e, beta)
    return lml, beta


def fast_scan_batch(ctx: NullContext, G: torch.Tensor, k_rho: int, delta,
                    n: int) -> FastScanResult:
    """Closed-form alternative lmls of a variant batch at the null's best
    rho ``k_rho`` and its ``delta`` (K8; the JAX engine's
    ``fast_scan_kernel``, reference _cellregmap.py:306-309 through
    glimix-core's FastScanner).  The complements are those of the JAX
    kernel, computed through the rotated columns and neither clamped nor
    clipped."""
    Vb, Sb = ctx.V[k_rho], ctx.S[k_rho]
    Wt = Vb.T @ ctx.ZW
    yt = Vb.T @ ctx.Zy
    Gt = Vb.T @ (ctx.Z.T @ G)                           # (R, S)
    CWG = ctx.W.T @ G - Wt.T @ Gt
    cGy = G.T @ ctx.y - Gt.T @ yt
    cGG = (G * G).sum(dim=0) - (Gt * Gt).sum(dim=0)
    return fast_scan(delta, Sb, Wt, yt, ctx.WW - Wt.T @ Wt,
                     ctx.Wy - Wt.T @ yt, ctx.yy - yt @ yt, Gt, CWG, cGy, cGG,
                     n)


def _require_genes(ctx: NullContext, name: str) -> int:
    if ctx.y.ndim != 2:
        raise ValueError(f"{name}: ctx.y must be (genes, n)")
    return ctx.y.shape[0]


def null_association_multigene_fit(ctx: NullContext, n: int,
                                   restricted: bool = False,
                                   delta_cfg=(-18.0, 18.0, 64, 60)):
    """Covariate-only null fits over the rho grid for a tile of phenotypes
    (the JAX engine's ``null_association_multigene_kernel``,
    engine.py:1154-1173), in one K10 launch.

    ``ctx``'s phenotype fields carry a leading gene axis (y (genes, n), Zy
    (genes, R), Wy (genes, p), yy (genes,)).  The rotated covariates V[o]^T
    Z^T W and their complement are formed once for the tile; only the
    phenotype's rotations and complements are per gene.  Returns the fits,
    fields (genes, nrho) and beta (genes, nrho, p), and each gene's best
    rho index (genes,) on the context's device.
    """
    _require_genes(ctx, "null_association_multigene_fit")
    lo, hi, n_grid, n_iters = delta_cfg
    Vt = ctx.V.transpose(1, 2)
    Xt = Vt @ ctx.ZW                                    # (nrho, R, p)
    XtT = Xt.transpose(1, 2)
    yt = torch.matmul(Vt, ctx.Zy.T).permute(2, 0, 1).contiguous()
    data = EigData(S=ctx.S, Xt=Xt, yt=yt, Cxx=ctx.WW - XtT @ Xt,
                   cxy=ctx.Wy[:, None, :] - (XtT @ yt[..., None])[..., 0],
                   cyy=ctx.yy[:, None] - (yt * yt).sum(dim=-1))
    fits = null_fit(data, n, restricted, lo, hi, n_grid, n_iters)
    return fits, _best_rho(fits.lml)


def _slots(ctx: NullContext, k, genes: int):
    """The tile's distinct best rho: (their rows of V^T (m, R, R) and S
    (m, R), each gene's slot index (genes,) int64 on the host)."""
    k = np.asarray(k, dtype=np.int64).ravel()
    if k.shape != (genes,) or k.min() < 0 or k.max() >= ctx.S.shape[0]:
        raise ValueError(f"k must hold one rho index in [0, "
                         f"{ctx.S.shape[0]}) per gene, got {k}")
    kd, slot = np.unique(k, return_inverse=True)
    Vt = torch.stack([ctx.V[int(j)] for j in kd]).transpose(1, 2)
    Sd = torch.stack([ctx.S[int(j)] for j in kd])
    return Vt, Sd, slot.reshape(genes)


def fast_scan_multigene_batch(ctx: NullContext, G: torch.Tensor, k, delta,
                              n: int) -> FastScanResult:
    """Closed-form alternative lmls of every (gene, variant) pair, each gene
    at its own null's best rho ``k`` (genes,) (host ints) and ``delta``
    (genes,) (K8 with the gene axis; the JAX engine's
    ``fast_scan_multigene_kernel``, engine.py:1176-1206).

    Z^T G, W^T G, g^T g and G^T y are computed once; the V[k]^T rotations
    (plain GEMMs) once per distinct k of the tile, and the kernel reads
    each slot's rotated candidates once for all its genes.  The complements
    are the JAX kernel's, neither clamped nor clipped.  Returns a
    :class:`FastScanResult` with (genes, S)-leading fields.
    """
    genes = _require_genes(ctx, "fast_scan_multigene_batch")
    Vt, Sd, slot = _slots(ctx, k, genes)
    m = Sd.shape[0]
    delta = torch.as_tensor(delta, dtype=ctx.y.dtype, device=ctx.y.device)
    ZG = ctx.Z.T @ G                                    # (R, S)
    WG = ctx.W.T @ G                                    # (p, S)
    gg = (G * G).sum(dim=0)                             # (S,)
    GY = ctx.y @ G                                      # (genes, S)
    Wt = Vt @ ctx.ZW                                    # (m, R, p)
    Gt = Vt @ ZG                                        # (m, R, S)
    WtT = Wt.transpose(1, 2)
    # each gene's phenotype rotated at its own slot: every slot's rotation
    # masked to the gene's (a one-hot sum selects it exactly)
    onehot = (_build.upload(slot, ctx.y.device)[None, :]
              == torch.arange(m, device=ctx.y.device)[:, None]
              ).to(ctx.y.dtype)                         # (m, genes)
    Ym = (Vt @ ctx.Zy.T) * onehot[:, None, :]           # (m, R, genes)
    yt = Ym.sum(dim=0).T.contiguous()                   # (genes, R)
    cWy = ctx.Wy - (WtT @ Ym).sum(dim=0).T              # (genes, p)
    cGy = GY - (Gt.transpose(1, 2) @ Ym).sum(dim=0).T   # (genes, S)
    return fast_scan(delta, Sd, Wt, yt, ctx.WW - WtT @ Wt, cWy.contiguous(),
                     ctx.yy - (yt * yt).sum(dim=1), Gt, WG - WtT @ Gt,
                     cGy.contiguous(), gg - (Gt * Gt).sum(dim=1), n,
                     slot=slot)


def association_refit_multigene_batch(ctx: NullContext, G: torch.Tensor, k,
                                      n: int,
                                      delta_cfg=(-18.0, 18.0, 64, 60),
                                      newton_f64: int = 10,
                                      localize_f32: bool = True):
    """Per-(gene, variant) ML alternative fits, each gene at its own null's
    best rho ``k`` (genes,) (host ints): K7 with a per-gene rho (the JAX
    engine's ``association_refit_multigene_batch``, engine.py:1070-1098).

    The genotype's contractions and complements are computed once; [W | G]
    is rotated once per distinct k of the tile (a slot), and the delta
    grid runs each gene at its slot alone, the converge kernel at the same
    slot (k_best).  Returns (lml (genes, S), beta (genes, S, p + 1)).
    """
    genes = _require_genes(ctx, "association_refit_multigene_batch")
    Vt, Sd, slot = _slots(ctx, k, genes)
    f64 = ctx.y.dtype
    fast = torch.float32 if (f64 == torch.float64 and localize_f32) else f64
    lo, hi, n_grid, _ = delta_cfg
    nS = G.shape[1]
    ZG = ctx.Z.T @ G                                    # (R, S)
    WGt = Vt @ torch.cat([ctx.ZW, ZG], dim=1)           # (m, R, p+S)
    yt = torch.matmul(Vt, ctx.Zy.T).permute(2, 0, 1).contiguous()
    comp = Complements(
        CWW=ctx.WW - ctx.ZW.T @ ctx.ZW, CWy=ctx.Wy - ctx.Zy @ ctx.ZW,
        Cyy=ctx.yy - (ctx.Zy * ctx.Zy).sum(dim=1),
        CWg=ctx.W.T @ G - ctx.ZW.T @ ZG, Cgy=ctx.y @ G - ctx.Zy @ ZG,
        Cgg=(G * G).sum(dim=0) - (ZG * ZG).sum(dim=0))
    br_lo, br_hi = delta_grid(Sd, WGt, yt, comp, None, lo, hi, n_grid, n,
                              fast, restricted=False, slot=slot)
    k_best = _build.upload(np.repeat(slot[:, None], nS, axis=1),
                           ctx.y.device)
    _, lml, _, beta = reml_converge(Sd, WGt, yt, comp, None, k_best, None,
                                    br_lo, br_hi, n, newton_f64,
                                    restricted=False)
    return _best_of_grid_ends(Sd, WGt, yt, comp, k_best, br_lo, br_hi, n,
                              lml, beta, lo, hi)


def mean_fit(ctx: NullContext, M: torch.Tensor, n: int,
             restricted: bool = True, delta_cfg=(-18.0, 18.0, 64, 60)):
    """Fits over the null's rho grid with a mean matrix M (n, pM) (K10; the
    JAX engine's ``mean_fit_kernel``, used by the aggregate environment,
    reference :207-230)."""
    return _fit_over_rho(ctx, ctx.Z.T @ M, M.T @ M, M.T @ ctx.y, n,
                         restricted, delta_cfg)


# --------------------------------------------------------------------------
# effect sizes (Woodbury backend)
# --------------------------------------------------------------------------
class BetasContext(NamedTuple):
    """State of the effect sizes: the fixed background U Lam U^T = sum_i
    L_i L_i^T and the reduced mean design.

    The mean design is D = [B, g] with B the full-rank economic-SVD
    reduction of [W, E0] (glimix-core's tX = U S convention): the
    reference's M = [W, g, E0] (_cellregmap.py:155) is often exactly rank
    deficient.  beta_g is the last coefficient of the reduced design.
    """

    y: torch.Tensor       # (n,)
    B: torch.Tensor       # (n, pB) reduced design basis of [W, E0]
    E0: torch.Tensor      # (n, C)
    Zk: torch.Tensor      # (n, Rk) eigenbasis of the background
    Lam: torch.Tensor     # (Rk,)
    rho: torch.Tensor     # (n_rho,)
    uy: torch.Tensor      # (Rk,)  Zk^T y
    UB: torch.Tensor      # (Rk, pB)
    BB: torch.Tensor      # (pB, pB)
    By: torch.Tensor      # (pB,)
    yy: torch.Tensor      # ()


def betas_context_from_numpy(arrays: Mapping[str, np.ndarray], device,
                             dtype=torch.float64) -> BetasContext:
    """A :class:`BetasContext` on ``device`` from its fields as arrays (for
    instance the JAX engine's context, field by field)."""
    return BetasContext(**{
        f: torch.tensor(np.array(arrays[f], float, order="C"), dtype=dtype,
                        device=device)
        for f in BetasContext._fields})


def reduced_design_basis(W, E0):
    """Full-rank basis of span[W, E0] in glimix's tX = U S convention
    (host NumPy)."""
    WE = np.concatenate([np.asarray(W, float), np.asarray(E0, float)], axis=1)
    U, sv, _ = np.linalg.svd(WE, full_matrices=False)
    keep = sv >= np.sqrt(np.finfo(float).eps)
    return U[:, keep] * sv[keep]


def build_betas_context(y, W, E0, Ls: Optional[Sequence], rho_grid=None, *,
                        device, dtype=torch.float64) -> BetasContext:
    """Factorize the background once (host NumPy + one upload): the Gram
    route basis of [L_1..L_C], the eigendecomposition of the covariance it
    represents folded into Zk, and the reduced design."""
    y_np = np.asarray(y, float).ravel()
    n = y_np.shape[0]
    W_np = np.ones((n, 1)) if W is None else np.asarray(W, float)
    E0_np = np.asarray(E0, float)
    B_np = reduced_design_basis(W_np, E0_np)
    parts = [np.asarray(L, float) for L in (Ls or [])]
    if parts:
        Z0, T = _gram_basis(np.concatenate(parts, axis=1))
        Lam, Vk = np.linalg.eigh(T @ T.T)
        Lam = np.maximum(Lam, 0.0)
        Zk = Z0 @ Vk
    else:
        # degenerate background (the reference still runs, with
        # hSigma_p = sqrt(rho) gE only: _cellregmap.py:164-166)
        Zk, Lam = np.zeros((n, 1)), np.zeros((1,))
    rho_np = np.asarray(np.linspace(0.0, 1.0, 11) if rho_grid is None
                        else rho_grid, float)
    return betas_context_from_numpy(dict(
        y=y_np, B=B_np, E0=E0_np, Zk=Zk, Lam=Lam, rho=rho_np, uy=Zk.T @ y_np,
        UB=Zk.T @ B_np, BB=B_np.T @ B_np, By=B_np.T @ y_np,
        yy=np.asarray(y_np @ y_np)), device, dtype)


def predict_interaction_batch(ctx: BetasContext, G: torch.Tensor,
                              norm: torch.Tensor, n: int,
                              delta_cfg=(-18.0, 18.0, 64, 60),
                              localize_f32: bool = False):
    """Per-variant REML fits with the covariance rho (g E0)(g E0)^T + (1 -
    rho) K (.) E E^T, and the effect sizes at each variant's best rho (the
    JAX engine's ``predict_interaction_kernel``; reference
    _cellregmap.py:152-198).

    Returns (beta_g (S,), alpha (C, S), info) with beta_gxe = E0 @ alpha
    computed by the caller, and info = {rho1, v0, v1, lml} (S,).  No host
    synchronisation.
    """
    B, E0, y = ctx.B, ctx.E0, ctx.y
    pB = B.shape[1]
    C = E0.shape[1]
    nS = G.shape[1]
    lo, hi = delta_cfg[:2]

    # the n-long contractions, once a batch: K1 three times, plain GEMMs
    G2 = G * G
    Ua = kr_contract(ctx.Zk, E0, G)                    # (Rk, C, S)
    ZkG = ctx.Zk.T @ G                                 # (Rk, S)
    M2 = kr_contract(E0, E0, G2)                       # (C, C, S)  A^T A
    AB = kr_contract(E0, B, G)                         # (C, pB, S)  A^T B
    ay = E0.T @ (G * y[:, None])                       # (C, S)
    Ag2 = E0.T @ G2                                    # (C, S)  A^T g
    Bg = B.T @ G                                       # (pB, S)
    gg = G2.sum(dim=0)
    gy = G.T @ y

    # full-space Grams of [A | B, g | y]: (S, q, q)
    Ax = torch.cat([AB, Ag2[:, None]], dim=1).permute(2, 0, 1)  # (S, C, p)
    xx = torch.cat([
        torch.cat([ctx.BB.expand(nS, pB, pB), Bg.T[:, :, None]], dim=2),
        torch.cat([Bg.T[:, None, :], gg[:, None, None]], dim=2)], dim=1)
    xy = torch.cat([ctx.By.expand(nS, pB), gy[:, None]], dim=1)  # (S, p)
    ayS = ay.T
    GfullS = torch.cat([
        torch.cat([M2.permute(2, 0, 1), Ax, ayS[:, :, None]], dim=2),
        torch.cat([Ax.transpose(1, 2), xx, xy[:, :, None]], dim=2),
        torch.cat([ayS[:, None, :], xy[:, None, :],
                   ctx.yy.expand(nS, 1, 1)], dim=2)], dim=1)

    cols = FamilyCols(Ua=Ua, UB=ctx.UB, ug=ZkG, uy=ctx.uy)
    lml, delta, beta, scale, v0, v1, rho1 = fit_delta_woodbury_family(
        cols, GfullS, ctx.Lam, ctx.rho, n, True, C, lo, hi,
        localize_f32=localize_f32, evaluate=family_eval)
    beta_g = beta[:, pB]

    # alpha = (v0 rho1) (g E0)^T v with v = (v0 Sigma + v1 I)^{-1} (y - M
    # beta) = D^{-1} r / scale: batched small algebra at one (rho, delta)
    UaS = Ua.permute(2, 0, 1)                          # (S, Rk, C)
    Ux = torch.cat([ctx.UB.expand(nS, -1, -1), ZkG.T[:, :, None]], dim=2)
    c = (1 - delta) * rho1
    m = ((1 - delta) * (1 - rho1))[:, None] * ctx.Lam + delta[:, None]
    wm = 1.0 / m                                       # (S, Rk)
    ur = ctx.uy - (Ux @ beta[:, :, None])[..., 0]      # (S, Rk)
    ar = ayS - (Ax @ beta[:, :, None])[..., 0]         # (S, C)
    UaT = UaS.transpose(1, 2)
    AmR = (UaT @ (ur * wm)[:, :, None])[..., 0] \
        + (ar - (UaT @ ur[:, :, None])[..., 0]) / delta[:, None]
    H = UaT @ (UaS * wm[:, :, None]) \
        + (M2.permute(2, 0, 1) - UaT @ UaS) / delta[:, None, None]
    cap = torch.eye(C, dtype=H.dtype, device=H.device) + c[:, None, None] * H
    sol = torch.cholesky_solve(AmR[:, :, None],
                               torch.linalg.cholesky_ex(cap)[0])
    AdR = AmR - c[:, None] * (H @ sol)[..., 0]
    alpha = (v0 * rho1)[:, None] * AdR / scale[:, None] * norm[:, None]
    return beta_g, alpha.T, {"rho1": rho1, "v0": v0, "v1": v1, "lml": lml}
