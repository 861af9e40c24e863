"""Public CellRegMap API of the PyTorch port (NumPy in / NumPy out).

Mirrors ``cellregmap_tpu.api`` for the interaction scan, the association
tests and the effect sizes: ``CellRegMap``, ``run_interaction`` (the
reference's _cellregmap.py:23-440 and :547-587, with the permutation index
forwarded to ``idx_G``), ``run_interaction_multigene`` (many genes sharing
one factorization, a capability the reference lacks), ``run_association``
(:246-281, :471-500),
``run_association_fast`` (:284-314, :502-531), ``estimate_betas``
(:137-205, :640-682) and ``CellRegMap.estimate_aggregate_environment``
(:207-244).  Every entry
point runs on ``device``: CUDA unless the caller passes ``device="cpu"``.
Without a card and without an explicit device it raises; it never falls
back to the CPU.
"""
from __future__ import annotations

import numpy as np
import torch

from . import engine
from ._config import DEFAULT_CONFIG, ScanConfig
from .models import pvalues as pv_mod
from .ops.hadamard import get_L_values
from .utils import trace
from .utils.maf import compute_maf

# per-variant results copied back from each device batch: the info
# entries, plus what the p-value ladder consumes: the weight matrices (the
# host eigenvalues of the davies and auto methods) and the device tails
_INFO_KEYS = ("Q", "rho1", "e2", "g2", "eps2")
_TAIL_KEYS = ("pv_liu", "pv_saddlepoint")
_PVALUE_METHODS = ("davies", "liu", "saddlepoint", "auto")
# K4 launches one grid row per (gene, variant) pair: CUDA's grid y-extent
# limit
_MAX_BATCH = 65535


def _result_keys(method: str):
    """(the device results a batch copies back, the info entries among
    them) under ``method``: the device tails appear in info only off
    davies (the JAX package's info contract)."""
    info = _INFO_KEYS + (_TAIL_KEYS if method != "davies" else ())
    keys = info + (("Wmat",) if method in ("davies", "auto") else ())
    return keys + (("lambdas",) if method != "davies" else ()), info


def _resolve_device(device=None) -> torch.device:
    """``device`` as a torch.device; None means the card, and raises
    without one."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def _pad_batch(G, batch):
    """Pad the variant axis to a multiple of ``batch`` by repeating col 0."""
    n_snps = G.shape[1]
    rem = (-n_snps) % batch
    if rem:
        G = np.concatenate([G, np.repeat(G[:, :1], rem, axis=1)], axis=1)
    return G, n_snps


def _batch_starts(total, batch, progress, desc):
    """Batch starts (an int total stepped by ``batch``, or a list), with an
    optional tqdm bar."""
    starts = range(0, total, batch) if isinstance(total, int) else total
    if progress:
        try:
            from tqdm import tqdm
        except ImportError:
            return starts
        return tqdm(starts, desc=desc, unit="batch")
    return starts


def _pipelined(starts, launch, consume, timers, kind, device, window=4):
    """Run ``launch(start)`` (a dict of device tensors) for each batch start
    with up to ``window`` batches in flight: each batch's results are
    copied to pinned host memory behind a CUDA event, and
    ``consume(host arrays)`` of batch i runs while later batches compute."""
    pending: list = []

    def drain(k):
        while len(pending) > k:
            with trace.trace_scope(f"{kind}/device_get", timers):
                host, event = pending.pop(0)
                if event is not None:
                    event.synchronize()
                out = {kk: v.numpy() for kk, v in host.items()}
            consume(out)

    for start in starts:
        with trace.trace_scope(f"{kind}/device", timers, device):
            pending.append(_to_host_async(launch(start)))
        drain(window - 1)
    drain(0)


def _to_host_async(out: dict):
    """Start copying a batch's results to pinned host memory; returns
    (host tensors, CUDA event recorded after the copies, or None)."""
    first = next(iter(out.values()))
    if first.device.type != "cuda":
        return out, None
    host = {}
    for k, t in out.items():
        host[k] = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host[k].copy_(t, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return host, event


class CellRegMap:
    """Mixed model with genetic effect heterogeneity (PyTorch engine).

        y = W a + g b1 + g (.) b2 + e + u + eps,
        b2 ~ N(0, v3 E0 E0^T),          e ~ N(0, v1 rho1 E1 E1^T),
        u ~ N(0, v1 (1-rho1) K (.) E2 E2^T),   eps ~ N(0, v2 I).

    Interaction test: H0: v3 = 0 vs H1: v3 > 0 (score test).  Association
    test: H0: b1 = 0 vs H1: b1 != 0 (LRT with per-variant ML refits).
    """

    def __init__(self, y, E, W=None, Ls=None, E1=None, hK=None,
                 config: ScanConfig = DEFAULT_CONFIG, device=None):
        if config.dtype != "float64":
            raise NotImplementedError(
                "the port runs float64 contexts only; the float32 screen "
                "context comes with the screen slice")
        self._cfg = config
        self._device = _resolve_device(device)
        self._dtype = torch.float64

        y = np.asarray(y, float).ravel()
        E0 = np.asarray(E, float)
        E1 = E0 if E1 is None else np.asarray(E1, float)
        n = y.shape[0]
        W = np.ones((n, 1)) if W is None else np.asarray(W, float)
        if W.ndim == 1:
            W = W[:, None]
        Ls = [] if Ls is None else [np.asarray(L, float) for L in Ls]
        if not (W.ndim == 2 and E0.ndim == 2 and E1.ndim == 2):
            raise ValueError("W, E and E1 must be 2-D")
        if not y.shape[0] == W.shape[0] == E0.shape[0] == E1.shape[0]:
            raise ValueError("y, W, E and E1 must have one row per cell")
        for L in Ls:
            if L.ndim != 2 or L.shape[0] != n:
                raise ValueError("each L must be 2-D with one row per cell")
        for name, arr in (("y", y), ("W", W), ("E", E0), ("E1", E1)):
            if not np.isfinite(arr).all():
                raise ValueError(f"{name} contains non-finite values")

        if len(Ls) or hK is not None:
            self._rho_grid = np.linspace(0, 1, config.n_rho)
        else:
            self._rho_grid = np.array([1.0])
        self._y, self._W, self._E0, self._E1 = y, W, E0, E1
        self._Ls, self._hK = Ls, hK
        self._n = n
        self._ctx_cache = None
        self._null_assoc = None
        self._bctx = None

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def _ctx(self) -> engine.NullContext:
        """Null-covariance factorization, built on first use."""
        if self._ctx_cache is None:
            self._ctx_cache = engine.build_null_context(
                self._y, self._W, self._E1, E0=self._E0,
                Ls=self._Ls if len(self._Ls) else None, hK=self._hK,
                rho_grid=self._rho_grid, device=self._device,
                dtype=self._dtype)
        return self._ctx_cache

    @property
    def n_samples(self) -> int:
        return self._y.shape[0]

    def with_phenotype(self, y) -> "CellRegMap":
        """A scanner for another phenotype sharing this factorization (the
        basis and per-rho eigendecompositions depend only on E, W, K); only
        the phenotype rotations are recomputed."""
        y = np.asarray(y, float).ravel()
        if y.shape[0] != self._n:
            raise ValueError("phenotype length mismatch")
        if not np.isfinite(y).all():
            raise ValueError("y contains non-finite values")
        new = object.__new__(CellRegMap)
        new.__dict__ = dict(self.__dict__)
        new._y = y
        new._null_assoc = None
        ctx = self._ctx
        yt = self._upload(y)
        new._ctx_cache = ctx._replace(y=yt, Zy=ctx.Z.T @ yt, Wy=ctx.W.T @ yt,
                                      yy=yt @ yt)
        # the betas context's y-independent parts (background eigenbasis,
        # reduced design) are shared; only the y-rotations are recomputed
        if self._bctx is not None:
            b = self._bctx
            new._bctx = b._replace(y=yt, uy=b.Zk.T @ yt, By=b.B.T @ yt,
                                   yy=yt @ yt)
        return new

    def _upload(self, a) -> torch.Tensor:
        """A host array on the scan's device: through pinned memory and a
        non-blocking copy on the card."""
        t = torch.from_numpy(np.ascontiguousarray(a, dtype=np.float64))
        if self._device.type == "cuda":
            return t.pin_memory().to(self._device, non_blocking=True)
        return t.to(self._device)

    # -- interaction -------------------------------------------------------
    def scan_interaction(self, G, idx_E=None, idx_G=None, checkpoint=None,
                         checkpoint_every: int = 1):
        """Score test for GxC interaction per variant (reference :317-440).

        Returns ``(pvalues, info)`` with info = {rho1, e2, g2, eps2, Q,
        lambdas} arrays, plus the device tails pv_liu and pv_saddlepoint
        under the liu, saddlepoint and auto methods (and ``timers`` when
        ``config.trace``).

        Up to four batches are in flight on the device: each batch's
        results are copied to pinned host memory behind a CUDA event, and
        the host p-value ladder of batch i runs while batches i+1..i+3
        compute.
        """
        cfg = self._cfg
        if checkpoint is not None:
            raise NotImplementedError(
                "checkpointed scans come with the durability slice")
        method = self._pvalue_method()
        G = np.asarray(G, float)
        if G.ndim == 1:
            G = G[:, None]
        timers = trace.PhaseTimers() if cfg.trace else None
        dev = self._device
        # the null factorization is built on first use: the setup phase
        with trace.trace_scope("interaction/setup", timers, dev):
            ctx = self._ctx
        if idx_E is not None:
            ctx = ctx._replace(E0=self._upload(self._E0[np.asarray(idx_E)]))
        Gs = G if idx_G is None else G[np.asarray(idx_G), :]

        batch = min(cfg.snp_batch, self._auto_batch_cap(), _MAX_BATCH,
                    max(G.shape[1], 1))
        Gp, n_snps = _pad_batch(G, batch)
        Gsp, _ = _pad_batch(Gs, batch)
        delta_cfg = (cfg.delta_logit_lo, cfg.delta_logit_hi,
                     cfg.n_delta_grid_interaction, cfg.n_golden_iters)

        keys, info_keys = _result_keys(method)
        outs: list = []
        pv_parts: list = []
        lam_parts: list = []

        def launch(start):
            gb = self._upload(Gp[:, start : start + batch])
            gsb = (gb if idx_G is None
                   else self._upload(Gsp[:, start : start + batch]))
            out = engine.interaction_batch(
                ctx, gb, gsb, self._n, delta_cfg=delta_cfg,
                localize_f32=cfg.hybrid_localization,
                device_pvalues=method != "davies")
            return {k: out[k] for k in keys}

        def consume(out):
            outs.append({k: out[k] for k in info_keys})
            with trace.trace_scope("interaction/pvalue_ladder", timers):
                pv_b, lam_b = self._pvalue_ladder(out)
            pv_parts.append(pv_b)
            lam_parts.append(lam_b)

        _pipelined(_batch_starts(Gp.shape[1], batch, cfg.progress,
                                 "scan_interaction"),
                   launch, consume, timers, "interaction", dev)

        info = {k: np.concatenate([o[k] for o in outs])[:n_snps]
                for k in info_keys}
        pvalues = np.concatenate(pv_parts)[:n_snps]
        info["lambdas"] = np.concatenate(lam_parts)[:n_snps]
        if timers is not None:
            info["timers"] = timers.summary()
            trace.log_event("scan_interaction", n_snps=n_snps, batch=batch,
                            **{f"s_{k.rsplit('/', 1)[-1]}": v
                               for k, v in timers.summary().items()})
        return np.asarray(pvalues, float), info

    def _auto_batch_cap(self, kind: str = "interaction",
                        genes: int = 1) -> int:
        """Variant-batch cap keeping the batch's temporaries within half of
        the device's free memory (2 GB on the CPU).

        Per variant, in f64 (8 B/element; the card stores f64 as 8 bytes).
        ``interaction``: the (nrho, R) families of the Newton stages
        (rotated genotype products in three precisions, the weight families
        and their reductions: ~48 live tensors at most, in the plain
        versions), the (R, C) score factor in K1 and K4 layouts (~4
        copies) and the (n, C + p) genotype-weighted operands (~3 copies).
        ``association``: the (n,) genotype column and its upload (~3
        copies), the rotated (R,) column with its products and weight
        families (~32 live tensors in the plain Newton), and the plain
        grid's (K,) reductions (~p + 8 per grid point).  ``betas``: the
        (Rk, q) column stack of the complement Grams, the (Rk, C) Ua with
        its f32 copy (4 B) and the (Rk, C) products of the effect-size
        algebra (~3 copies), and the (n,) genotype column (~3 copies); Rk
        is the background's width, read without the null context.
        ``multigene``: per (gene, variant) of a ``genes``-gene tile, the
        interaction kind's Newton families, score factor and weight matrix;
        per variant, the genotype-weighted operands once.
        """
        C = int(self._E0.shape[1])
        p = int(self._W.shape[1])
        if kind == "betas":
            Rk = max(sum(int(L.shape[1]) for L in self._Ls), 1)
            q = C + p + C + 2          # [A | B, g | y], pB <= p + C
            per_variant = (8 * (Rk * q + 4 * Rk * C + 3 * self._n)
                           + 4 * Rk * (C + 2))
        else:
            nrho, R = (int(d) for d in self._ctx.S.shape)
            R = max(R, 1)
            if kind == "interaction":
                per_variant = 8 * (48 * nrho * R + 4 * R * C
                                   + 3 * self._n * (C + p))
            elif kind == "multigene":
                per_variant = 8 * (genes * (48 * nrho * R + 4 * R * C
                                            + C * C)
                                   + 3 * self._n * (C + p))
            else:  # association
                per_variant = 8 * (3 * self._n + 32 * R
                                   + self._cfg.n_delta_grid * (p + 8))
        if self._device.type == "cuda":
            budget = torch.cuda.mem_get_info(self._device)[0] / 2
        else:
            budget = 2e9
        return max(16, int(budget / per_variant))

    # -- association -------------------------------------------------------
    def _fit_null_association(self):
        """The covariate-only ML fits over the rho grid (K10) and the best
        rho's index, as host arrays; built on first use."""
        if self._null_assoc is None:
            cfg = self._cfg
            delta_cfg = (cfg.delta_logit_lo, cfg.delta_logit_hi,
                         cfg.n_delta_grid, cfg.n_golden_iters)
            fits, k = engine.null_association_fit(
                self._ctx, self._n, restricted=False, delta_cfg=delta_cfg)
            self._null_assoc = (
                engine.FitResult(*(t.cpu().numpy() for t in fits)), int(k))
        return self._null_assoc

    def _assoc_info(self, fits, k):
        rho_grid = self._ctx.rho.cpu().numpy()
        rho1 = float(rho_grid[k] if rho_grid.shape[0] > 1 else 1.0)
        v0 = float(fits.v0[k])
        return {"rho1": np.asarray([rho1]), "e2": np.asarray([v0 * rho1]),
                "g2": np.asarray([v0 * (1 - rho1)]),
                "eps2": np.asarray([float(fits.v1[k])])}

    def scan_association(self, G, checkpoint=None,
                         checkpoint_every: int = 1):
        """LRT association scan with per-variant ML refits (reference
        :246-281).  Returns ``(pvalues, info)`` with info = {rho1, e2, g2,
        eps2} of the null fit (and ``timers`` when ``config.trace``).

        Batches are pipelined as in :meth:`scan_interaction`: up to four
        in flight, each batch's alternative lmls copied back behind a CUDA
        event.
        """
        cfg = self._cfg
        if checkpoint is not None:
            raise NotImplementedError(
                "checkpointed scans come with the durability slice")
        G = np.asarray(G, float)
        if G.ndim == 1:
            G = G[:, None]
        timers = trace.PhaseTimers() if cfg.trace else None
        dev = self._device
        with trace.trace_scope("association/setup", timers, dev):
            fits, k = self._fit_null_association()
        null_lml = float(fits.lml[k])
        batch = min(cfg.snp_batch, self._auto_batch_cap("association"),
                    max(G.shape[1], 1))
        Gp, n_snps = _pad_batch(G, batch)
        delta_cfg = (cfg.delta_logit_lo, cfg.delta_logit_hi,
                     cfg.n_delta_grid, cfg.n_golden_iters)
        ctx = self._ctx
        parts: list = []

        def launch(start):
            lml, _ = engine.association_refit_batch(
                ctx, self._upload(Gp[:, start : start + batch]), k,
                self._n, delta_cfg=delta_cfg,
                localize_f32=cfg.hybrid_localization)
            return {"lml": lml}

        _pipelined(_batch_starts(Gp.shape[1], batch, cfg.progress,
                                 "scan_association"),
                   launch, lambda out: parts.append(out["lml"]), timers,
                   "association", dev)
        alt_lmls = np.concatenate(parts)[:n_snps]
        pv = pv_mod.lrt_pvalues(null_lml, alt_lmls, dof=1,
                                clip_lo=cfg.pv_clip_lo,
                                clip_hi=cfg.pv_clip_hi)
        info = self._assoc_info(fits, k)
        if timers is not None:
            info["timers"] = timers.summary()
        return np.asarray(pv, float), info

    def scan_association_fast(self, G, checkpoint=None,
                              checkpoint_every: int = 1):
        """LRT association scan with the closed-form fast scanner (reference
        :284-314): the null's ML fit (K10) once, then every variant's
        alternative re-profiled at the null's delta and best rho (K8).
        Returns ``(pvalues, info)`` as :meth:`scan_association`; batches
        are pipelined in the same way."""
        cfg = self._cfg
        if checkpoint is not None:
            raise NotImplementedError(
                "checkpointed scans come with the durability slice")
        G = np.asarray(G, float)
        if G.ndim == 1:
            G = G[:, None]
        timers = trace.PhaseTimers() if cfg.trace else None
        dev = self._device
        with trace.trace_scope("association_fast/setup", timers, dev):
            fits, k = self._fit_null_association()
        null_lml = float(fits.lml[k])
        delta = float(fits.delta[k])
        batch = min(cfg.snp_batch, max(G.shape[1], 1))
        Gp, n_snps = _pad_batch(G, batch)
        ctx = self._ctx
        parts: list = []

        def launch(start):
            out = engine.fast_scan_batch(
                ctx, self._upload(Gp[:, start : start + batch]), k, delta,
                self._n)
            return {"lml": out.lml}

        _pipelined(_batch_starts(Gp.shape[1], batch, cfg.progress,
                                 "scan_association_fast"),
                   launch, lambda out: parts.append(out["lml"]), timers,
                   "association_fast", dev)
        alt_lmls = np.concatenate(parts)[:n_snps]
        pv = pv_mod.lrt_pvalues(null_lml, alt_lmls, dof=1,
                                clip_lo=cfg.pv_clip_lo,
                                clip_hi=cfg.pv_clip_hi)
        info = self._assoc_info(fits, k)
        if timers is not None:
            info["timers"] = timers.summary()
        return np.asarray(pv, float), info

    # -- effect sizes ------------------------------------------------------
    def _betas_context(self) -> engine.BetasContext:
        """The background factorization of the effect sizes, built once.
        It never builds the null context: the rho grid is the scanner's
        own (``Ls`` or ``hK`` given: n_rho points on [0, 1], else [1])."""
        if self._bctx is None:
            self._bctx = engine.build_betas_context(
                self._y, self._W, self._E0, self._Ls,
                rho_grid=self._rho_grid, device=self._device,
                dtype=self._dtype)
        return self._bctx

    def predict_interaction(self, G, MAF, checkpoint=None,
                            checkpoint_every: int = 1):
        """Effect-size decomposition per variant (reference :137-205):
        returns ``(beta_g (S,), beta_gxe (n, S))``.  Each variant's REML fit
        over its own covariance family runs on the device (K1, K9); batches
        are pipelined as in :meth:`scan_interaction`."""
        cfg = self._cfg
        if checkpoint is not None:
            raise NotImplementedError(
                "checkpointed scans come with the durability slice")
        G = np.asarray(G, float)
        if G.ndim == 1:
            G = G[:, None]
        maf = np.atleast_1d(np.asarray(MAF, float))
        norm = 1.0 / np.sqrt(2 * maf * (1 - maf))
        timers = trace.PhaseTimers() if cfg.trace else None
        dev = self._device
        with trace.trace_scope("betas/setup", timers, dev):
            bctx = self._betas_context()
        delta_cfg = (cfg.delta_logit_lo, cfg.delta_logit_hi,
                     min(16, cfg.n_delta_grid), cfg.n_golden_iters)
        batch = min(cfg.snp_batch, self._auto_batch_cap("betas"),
                    max(G.shape[1], 1))
        Gp, n_snps = _pad_batch(G, batch)
        normp = np.concatenate([norm, np.repeat(norm[:1],
                                                Gp.shape[1] - len(norm))])
        bg_parts: list = []
        alpha_parts: list = []

        def launch(start):
            beta_g, alpha, _ = engine.predict_interaction_batch(
                bctx, self._upload(Gp[:, start : start + batch]),
                self._upload(normp[start : start + batch]), self._n,
                delta_cfg=delta_cfg, localize_f32=cfg.hybrid_localization)
            return {"beta_g": beta_g, "alpha": alpha}

        def consume(out):
            bg_parts.append(out["beta_g"])
            alpha_parts.append(out["alpha"])

        _pipelined(_batch_starts(Gp.shape[1], batch, cfg.progress,
                                 "predict_interaction"),
                   launch, consume, timers, "betas", dev)
        beta_g = np.concatenate(bg_parts)[:n_snps]
        alpha = np.concatenate(alpha_parts, axis=1)[:, :n_snps]
        if timers is not None:
            trace.log_event("predict_interaction", n_snps=n_snps,
                            batch=batch,
                            **{f"s_{k.rsplit('/', 1)[-1]}": v
                               for k, v in timers.summary().items()})
        return beta_g, self._E0 @ alpha

    def estimate_aggregate_environment(self, g):
        """Per-cell aggregate GxC environment E0 @ beta_gxe of one variant
        (reference :207-244).  The REML fits over the null's rho grid with
        the mean [B, g] run on the device (K10); the per-g covariance
        solve is a Woodbury solve on the host."""
        cfg = self._cfg
        g = np.asarray(g, float).ravel()
        n = self._n
        E0, W, y = self._E0, self._W, self._y
        gE = g[:, None] * E0
        # the reduced full-rank design (see engine.BetasContext)
        M = np.concatenate((engine.reduced_design_basis(W, E0), g[:, None]),
                           axis=1)
        delta_cfg = (cfg.delta_logit_lo, cfg.delta_logit_hi,
                     cfg.n_delta_grid, cfg.n_golden_iters)
        fits = engine.mean_fit(self._ctx, self._upload(M), n, True,
                               delta_cfg)
        fits = engine.FitResult(*(t.cpu().numpy() for t in fits))
        k = int(np.argmax(fits.lml))
        rho1 = float(self._rho_grid[k])
        v0, v1 = float(fits.v0[k]), float(fits.v1[k])
        yadj = y - M @ fits.beta[k]
        # cov = B + c A A^T with B = v0 (1 - rho1) F F^T + v1 I, c = v0 rho1
        F = (np.concatenate(self._Ls, axis=1) if len(self._Ls)
             else np.zeros((n, 1)))
        c = v0 * rho1
        Bv = _lowrank_plus_diag_solve(F, v0 * (1 - rho1), v1, yadj)
        BiA = _lowrank_plus_diag_solve(F, v0 * (1 - rho1), v1, gE)
        cap = np.eye(E0.shape[1]) + c * (gE.T @ BiA)
        v = Bv - BiA @ np.linalg.solve(cap, c * (gE.T @ Bv))
        return E0 @ ((v0 * rho1) * (gE.T @ v))

    def _pvalue_method(self) -> str:
        method = self._cfg.pvalue_method
        if method not in _PVALUE_METHODS:
            raise ValueError(f"unknown pvalue_method {method!r}")
        return method

    def _pvalue_ladder(self, out):
        """P-values of one batch's host results ``out`` (the JAX package's
        ladder, cellregmap_tpu/api.py:779-817); returns (pvalues,
        lambdas).

        ``davies``: host LAPACK eigenvalues of the weight matrices, then
        the Davies ladder.  ``liu`` / ``saddlepoint``: the device tails as
        they are.  ``auto``: the saddlepoint value, with the pairs below
        ``davies_threshold`` refined by host eigenvalues of their weight
        matrices and the Davies ladder.  The lambdas returned are the host
        ones under davies and the device ones (K6a) otherwise.
        """
        cfg = self._cfg
        method = self._pvalue_method()
        if method == "liu":
            return out["pv_liu"], out["lambdas"]
        if method == "saddlepoint":
            return out["pv_saddlepoint"], out["lambdas"]
        if method == "davies":
            lambdas = _host_eigvalsh(out["Wmat"])
            pv = pv_mod.davies_pvalue_batch(
                out["Q"], lambdas, lim=cfg.davies_lim, acc=cfg.davies_acc,
                lambda_filter_ratio=cfg.lambda_filter_ratio)
            return pv, lambdas
        pv = np.asarray(out["pv_saddlepoint"], float).copy()
        refine = pv < cfg.davies_threshold
        if refine.any():
            pv[refine] = pv_mod.davies_pvalue_batch(
                np.asarray(out["Q"])[refine],
                _host_eigvalsh(out["Wmat"][refine]), lim=cfg.davies_lim,
                acc=cfg.davies_acc,
                lambda_filter_ratio=cfg.lambda_filter_ratio)
        return pv, out["lambdas"]

    # -- many genes --------------------------------------------------------
    def scan_interaction_multigene(self, Y, G, gene_batch: int = 16,
                                   checkpoint=None,
                                   checkpoint_every: int = 1):
        """Interaction scan for many genes sharing this factorization (the
        JAX package's ``scan_interaction_multigene``, api.py:597-711).

        ``Y`` is (n_cells, n_genes).  Genes run in tiles of ``gene_batch``:
        per (tile, variant batch) the genotype's contractions and rotations
        are computed once and every kernel launches once for all the
        tile's genes (``engine.interaction_multigene_batch``).  Variant
        batches of a tile are pipelined as in :meth:`scan_interaction`,
        the p-value ladder of a batch running while later ones compute.
        Returns ``(pvalues (n_genes, n_snps), info)`` with info arrays
        shaped (n_genes, n_snps) (lambdas (n_genes, n_snps, C)).
        """
        cfg = self._cfg
        if checkpoint is not None:
            raise NotImplementedError(
                "checkpointed scans come with the durability slice")
        method = self._pvalue_method()
        Y = np.asarray(Y, float)
        if Y.ndim == 1:
            Y = Y[:, None]
        if Y.shape[0] != self._n or Y.shape[1] < 1:
            raise ValueError("Y must be (n_cells, n_genes) with at least one "
                             "gene column")
        if not np.isfinite(Y).all():
            raise ValueError("Y contains non-finite values")
        G = np.asarray(G, float)
        if G.ndim == 1:
            G = G[:, None]
        if G.shape[1] < 1:
            raise ValueError("G must have at least one variant column")
        n_genes = Y.shape[1]
        gtile = max(1, min(gene_batch, n_genes))
        timers = trace.PhaseTimers() if cfg.trace else None
        dev = self._device
        with trace.trace_scope("multigene/setup", timers, dev):
            ctx = self._ctx
        batch = min(cfg.snp_batch, self._auto_batch_cap("multigene", gtile),
                    _MAX_BATCH // gtile, max(G.shape[1], 1))
        Gp, n_snps = _pad_batch(G, batch)
        Yp, _ = _pad_batch(Y, gtile)
        delta_cfg = (cfg.delta_logit_lo, cfg.delta_logit_hi,
                     cfg.n_delta_grid_interaction, cfg.n_golden_iters)
        keys, info_keys = _result_keys(method)
        tiles: list = []
        for g0 in range(0, Yp.shape[1], gtile):
            # the tile's phenotypes, gene-major (the kernels take
            # contiguous operands)
            Yg = self._upload(np.ascontiguousarray(Yp[:, g0 : g0 + gtile].T))
            ctx_g = ctx._replace(y=Yg, Zy=Yg @ ctx.Z, Wy=Yg @ ctx.W,
                                 yy=(Yg * Yg).sum(dim=1))
            parts: list = []

            def launch(start):
                gb = self._upload(Gp[:, start : start + batch])
                out = engine.interaction_multigene_batch(
                    ctx_g, gb, gb, self._n, delta_cfg=delta_cfg,
                    device_pvalues=method != "davies",
                    localize_f32=cfg.hybrid_localization)
                return {k: out[k] for k in keys}

            def consume(out):
                # flatten (gene, variant) for the ladder, one batch at a time
                flat = {k: v.reshape((-1,) + v.shape[2:])
                        for k, v in out.items()}
                with trace.trace_scope("multigene/pvalue_ladder", timers):
                    pv_b, lam_b = self._pvalue_ladder(flat)
                res = {k: out[k] for k in info_keys}
                res["pv"] = np.reshape(pv_b, out["Q"].shape)
                res["lambdas"] = np.reshape(lam_b, out["Q"].shape + (-1,))
                parts.append(res)

            _pipelined(_batch_starts(Gp.shape[1], batch, cfg.progress,
                                     "scan_multigene"),
                       launch, consume, timers, "multigene", dev)
            tiles.append({k: np.concatenate([r[k] for r in parts],
                                            axis=1)[:, :n_snps]
                          for k in parts[0]})
        res = {k: np.concatenate([t[k] for t in tiles])[:n_genes]
               for k in tiles[0]}
        pvalues = np.asarray(res.pop("pv"), float)
        info = res
        if timers is not None:
            info["timers"] = timers.summary()
            trace.log_event("scan_interaction_multigene", n_genes=n_genes,
                            n_snps=n_snps, gene_batch=gtile, batch=batch,
                            **{f"s_{k.rsplit('/', 1)[-1]}": v
                               for k, v in timers.summary().items()})
        return pvalues, info


def _host_eigvalsh(Wmat):
    """Host LAPACK eigenvalues of the symmetrized weight matrices."""
    Wm = np.asarray(Wmat, float)
    return np.linalg.eigvalsh((Wm + np.swapaxes(Wm, -1, -2)) / 2)


def run_interaction(y, E, G, W=None, E1=None, E2=None, hK=None, idx_G=None,
                    config: ScanConfig = DEFAULT_CONFIG, device=None):
    """Interaction test: cell-level GxC genetic effects (score test).

    Reference _cellregmap.py:547-587, with the permutation index forwarded
    to ``idx_G``.  Runs on ``device`` (the card unless "cpu" is given).
    """
    E1 = E if E1 is None else E1
    E2 = E if E2 is None else E2
    Ls = None if hK is None else get_L_values(hK, E2)
    crm = CellRegMap(y=y, E=E, W=W, E1=E1, Ls=Ls, config=config,
                     device=device)
    return crm.scan_interaction(G, idx_G=idx_G)


def run_interaction_multigene(Y, E, G, W=None, E1=None, E2=None, hK=None,
                              Ls=None, gene_batch: int = 16,
                              config: ScanConfig = DEFAULT_CONFIG,
                              device=None):
    """Interaction scan across many genes sharing one factorization (the
    JAX package's ``run_interaction_multigene``, api.py:1250-1271).

    ``Y`` is (n_cells, n_genes); the covariance family (E, W, K) is
    factorized once and genes x variants run through the gene-batched
    kernels.  Returns ``(pvalues (n_genes, n_snps), info)``.  Runs on
    ``device`` (the card unless "cpu" is given).
    """
    Y = np.asarray(Y, float)
    if Y.ndim == 1:
        Y = Y[:, None]
    E1 = E if E1 is None else E1
    E2 = E if E2 is None else E2
    if Ls is None and hK is not None:
        Ls = get_L_values(hK, E2)
    base = CellRegMap(y=Y[:, 0], E=E, W=W, E1=E1, Ls=Ls, config=config,
                      device=device)
    return base.scan_interaction_multigene(Y, G, gene_batch=gene_batch)


def run_association(y, W, E, G, hK=None, config: ScanConfig = DEFAULT_CONFIG,
                    device=None):
    """Association test (LRT, per-variant ML refits).  Reference :471-500.
    Runs on ``device`` (the card unless "cpu" is given)."""
    crm = CellRegMap(y=y, E=E, W=W, hK=hK, config=config, device=device)
    return crm.scan_association(G)


def _lowrank_plus_diag_solve(F, a, b, rhs):
    """(a F F^T + b I)^{-1} rhs via the capacitance identity (host)."""
    if a == 0.0 or F.shape[1] == 0:
        return rhs / b
    cap = np.eye(F.shape[1]) + (a / b) * (F.T @ F)
    return (rhs - F @ np.linalg.solve(cap, (a / b) * (F.T @ rhs))) / b


def run_association_fast(y, W, E, G, hK=None,
                         config: ScanConfig = DEFAULT_CONFIG, device=None):
    """Association test (LRT, closed-form fast scanner).  Reference
    :502-531.  Runs on ``device`` (the card unless "cpu" is given)."""
    crm = CellRegMap(y=y, E=E, W=W, hK=hK, config=config, device=device)
    return crm.scan_association_fast(G)


def estimate_betas(y, W, E, G, maf=None, E1=None, E2=None, hK=None,
                   checkpoint=None, config: ScanConfig = DEFAULT_CONFIG,
                   device=None):
    """Effect sizes: persistent beta_G and cell-level beta_GxC.  Reference
    :640-682.  Runs on ``device`` (the card unless "cpu" is given)."""
    E1 = E if E1 is None else E1
    E2 = E if E2 is None else E2
    Ls = None if hK is None else get_L_values(hK, E2)
    crm = CellRegMap(y=y, E=E, W=W, E1=E1, Ls=Ls, config=config,
                     device=device)
    if maf is None:
        maf = compute_maf(G)
    return crm.predict_interaction(G, maf, checkpoint=checkpoint)
