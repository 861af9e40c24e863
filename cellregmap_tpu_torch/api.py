"""Public CellRegMap API of the PyTorch port (NumPy in / NumPy out).

Mirrors ``cellregmap_tpu.api`` for the interaction scan: ``CellRegMap``
and ``run_interaction`` (the reference's _cellregmap.py:23-440 and
:547-587, with the permutation index forwarded to ``idx_G``).  Every entry
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

# per-variant results copied back from each device batch: the info
# entries, plus the weight matrices that the host ladder consumes
_INFO_KEYS = ("Q", "rho1", "e2", "g2", "eps2")
_RESULT_KEYS = _INFO_KEYS + ("Wmat",)
# K4 launches one grid row per variant: CUDA's grid y-extent limit
_MAX_BATCH = 65535


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

    Interaction test: H0: v3 = 0 vs H1: v3 > 0 (score test).
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
        ctx = self._ctx
        yt = self._upload(y)
        new._ctx_cache = ctx._replace(y=yt, Zy=ctx.Z.T @ yt, Wy=ctx.W.T @ yt,
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
        lambdas} arrays (and ``timers`` when ``config.trace``).

        Up to four batches are in flight on the device: each batch's
        results are copied to pinned host memory behind a CUDA event, and
        the host p-value ladder of batch i runs while batches i+1..i+3
        compute.
        """
        cfg = self._cfg
        if checkpoint is not None:
            raise NotImplementedError(
                "checkpointed scans come with the durability slice")
        if cfg.pvalue_method != "davies":
            raise NotImplementedError(
                f"pvalue_method={cfg.pvalue_method!r}: the device tails "
                "(Liu, saddlepoint) are not ported yet; use 'davies'")
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

        window = 4
        pending: list = []
        outs: list = []
        pv_parts: list = []
        lam_parts: list = []

        def _drain(k):
            while len(pending) > k:
                with trace.trace_scope("interaction/device_get", timers):
                    host, event = pending.pop(0)
                    if event is not None:
                        event.synchronize()
                    out = {kk: v.numpy() for kk, v in host.items()}
                outs.append({kk: out[kk] for kk in _INFO_KEYS})
                with trace.trace_scope("interaction/pvalue_ladder", timers):
                    pv_b, lam_b = self._pvalue_ladder(out["Q"], out["Wmat"])
                pv_parts.append(pv_b)
                lam_parts.append(lam_b)

        for start in _batch_starts(Gp.shape[1], batch, cfg.progress,
                                   "scan_interaction"):
            with trace.trace_scope("interaction/device", timers, dev):
                gb = self._upload(Gp[:, start : start + batch])
                gsb = (gb if idx_G is None
                       else self._upload(Gsp[:, start : start + batch]))
                out = engine.interaction_batch(
                    ctx, gb, gsb, self._n, delta_cfg=delta_cfg,
                    localize_f32=cfg.hybrid_localization)
                pending.append(_to_host_async(
                    {k: out[k] for k in _RESULT_KEYS}))
            _drain(window - 1)
        _drain(0)

        info = {k: np.concatenate([o[k] for o in outs])[:n_snps]
                for k in _INFO_KEYS}
        pvalues = np.concatenate(pv_parts)[:n_snps]
        info["lambdas"] = np.concatenate(lam_parts)[:n_snps]
        if timers is not None:
            info["timers"] = timers.summary()
            trace.log_event("scan_interaction", n_snps=n_snps, batch=batch,
                            **{f"s_{k.rsplit('/', 1)[-1]}": v
                               for k, v in timers.summary().items()})
        return np.asarray(pvalues, float), info

    def _auto_batch_cap(self) -> int:
        """Variant-batch cap keeping the batch's temporaries within half of
        the device's free memory (2 GB on the CPU).

        Per variant, in f64 (8 B/element): the (nrho, R) families of the
        Newton stages (rotated genotype products in three precisions, the
        weight families and their reductions: ~48 live tensors at most),
        the (R, C) score factor in K1 and K4 layouts (~4 copies) and the
        (n, C + p) genotype-weighted operands (~3 copies).
        """
        C = int(self._E0.shape[1])
        p = int(self._W.shape[1])
        nrho, R = (int(d) for d in self._ctx.S.shape)
        per_variant = 8 * (48 * nrho * max(R, 1) + 4 * max(R, 1) * C
                           + 3 * self._n * (C + p))
        if self._device.type == "cuda":
            budget = torch.cuda.mem_get_info(self._device)[0] / 2
        else:
            budget = 2e9
        return max(16, int(budget / per_variant))

    def _pvalue_ladder(self, Q, Wmat):
        """Host LAPACK eigenvalues of the weight matrices, then the Davies
        ladder; returns (pvalues, lambdas)."""
        cfg = self._cfg
        Wm = np.asarray(Wmat, float)
        lambdas = np.linalg.eigvalsh((Wm + np.swapaxes(Wm, -1, -2)) / 2)
        pv = pv_mod.davies_pvalue_batch(
            Q, lambdas, lim=cfg.davies_lim, acc=cfg.davies_acc,
            lambda_filter_ratio=cfg.lambda_filter_ratio)
        return pv, lambdas


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
