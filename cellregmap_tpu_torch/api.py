"""Public CellRegMap API of the PyTorch port (NumPy in / NumPy out).

Mirrors ``cellregmap_tpu.api`` for the interaction scan, the association
tests and the effect sizes: ``CellRegMap``, ``run_interaction`` (the
reference's _cellregmap.py:23-440 and :547-587, with the permutation index
forwarded to ``idx_G``), ``run_interaction_multigene`` (many genes sharing
one factorization, a capability the reference lacks), ``run_association``
(:246-281, :471-500),
``run_association_fast`` (:284-314, :502-531), ``estimate_betas``
(:137-205, :640-682), ``CellRegMap.estimate_aggregate_environment``
(:207-244), the gene-batched association scans
``run_association_multigene`` and ``run_association_fast_multigene``
(many genes sharing one factorization), and the two-pass interaction
scans ``run_interaction_screen`` / ``CellRegMap.scan_interaction_screen``
and ``CellRegMap.scan_interaction_multigene_screen`` (a float32 screen of
every pair, then the float64 Davies scan of the candidate hits).
``ScanConfig(dtype="float32")`` runs every scan and the effect sizes in
the float32 context, as the JAX package does; the aggregate environment
refuses it (the JAX package's float32 result is NaN).  Every entry
point runs on ``device``: CUDA unless the caller passes ``device="cpu"``.
Without a card and without an explicit device it raises; it never falls
back to the CPU.  Every scan takes ``checkpoint=``, a directory where
completed units of work (variant batches, or gene tiles) are made durable
and from which a restarted call with the same inputs resumes.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os

import numpy as np
import torch

from . import engine
from ._config import DEFAULT_CONFIG, ScanConfig
from .kernels import delta_grid, reml_newton, score_core, sym_eigvalsh
from .kernels.delta_grid import MAX_GENES
from .models import pvalues as pv_mod
from .ops.hadamard import get_L_values
from .parallel.checkpoint import ScanCheckpoint
from .utils import trace
from .utils.maf import compute_maf

# per-variant results copied back from each device batch: the info
# entries, plus what the p-value ladder consumes: the weight matrices (the
# host eigenvalues of the davies and auto methods) and the device tails
_INFO_KEYS = ("Q", "rho1", "e2", "g2", "eps2")
_TAIL_KEYS = ("pv_liu", "pv_saddlepoint")
# what a screen batch copies back: the device tails and the info entries
_SCREEN_KEYS = _TAIL_KEYS + _INFO_KEYS
_PVALUE_METHODS = ("davies", "liu", "saddlepoint", "auto")
# the most variants a batch takes, with or without a gene tile: the
# kernels' grids put the variants on their 2^31-wide dimension and the
# genes on a 65535-wide one, so a gene tile does not shrink it
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


# The card's envelope: the widest shapes every kernel on the scans' paths
# takes (csrc/*.cu), checked when a scanner on the card is made, so that a
# refused shape costs no setup time.  p counts W's columns, the intercept
# included (K2, K3 and K5: p + 1 <= 33; K8: p <= 32); C the score
# contexts (K6a: C <= 64; K5: C + p + 2 <= 98).  The rho grid has no
# limit of its own.  Inside it rank[W, E] <= p + C <= 96, which the effect
# sizes (K9: q = C + rank[W, E] + 2 <= 162 columns) and the aggregate
# environment (K10: rank[W, E] + 1 <= 128 mean columns) take.
# The float32 context's Newton kernels take p + 1 <= 16 (K3's f32
# instantiations).
CARD_MAX_COVARIATES = min(delta_grid.MAX_FIXED, score_core.MAX_FIXED) - 1
CARD_MAX_COVARIATES_F32 = reml_newton.MAX_FIXED_F32 - 1
CARD_MAX_CONTEXTS = sym_eigvalsh.MAX_C


def _check_card_envelope(p: int, C: int, f32: bool = False) -> None:
    """Raise ValueError, naming the limit and the shape, where the card's
    kernels would refuse the scanner's shapes (``f32``: the float32
    context's)."""
    for what, got, limit in (("covariates (columns of W)", p,
                              CARD_MAX_COVARIATES_F32 if f32
                              else CARD_MAX_COVARIATES),
                             ("contexts (columns of E)", C,
                              CARD_MAX_CONTEXTS)):
        if got > limit:
            raise ValueError(
                f"the card's kernels take at most {limit} {what}, got {got}; "
                f"pass device='cpu' to run this shape on the CPU")


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
    """Run ``launch(start)`` (a dict of device tensors, or of host arrays)
    for each batch start with up to ``window`` batches in flight: each
    batch's results are copied to pinned host memory behind a CUDA event,
    and ``consume(host arrays)`` of batch i runs while later batches
    compute."""
    pending: list = []

    def drain(k):
        while len(pending) > k:
            with trace.trace_scope(f"{kind}/device_get", timers):
                host, event = pending.pop(0)
                if event is not None:
                    event.synchronize()
                out = {kk: v.numpy() if isinstance(v, torch.Tensor) else v
                       for kk, v in host.items()}
            consume(out)

    for start in starts:
        with trace.trace_scope(f"{kind}/device", timers, device):
            pending.append(_to_host_async(launch(start)))
        drain(window - 1)
    drain(0)


def _run_checkpointed(starts, launch, checkpoint, ck_meta, timers, kind,
                      device, checkpoint_every: int = 1, axes=None,
                      finish=None, progress=False, desc="scan", keep=False):
    """Run ``launch(start)`` for every start (the JAX package's
    ``_run_checkpointed``, api.py:60-106) and return the results
    concatenated on the host, key by key (along ``axes.get(key, 0)``).

    Without a checkpoint the units run pipelined (:func:`_pipelined`,
    window 4).  With one (a directory), they run one at a time and every
    ``checkpoint_every``-th completed unit (and the last) is durable before
    the next is launched; a call whose ``ck_meta`` (shapes and content
    fingerprints) matches the stored one resumes at its cursor, any other
    call starts over.  The checkpoint is cleared at the end, unless
    ``keep`` (a pass that later work depends on: the screen's, which a
    stop in the confirm pass must not lose); a kept, complete checkpoint
    resumes with no unit left to run.  ``finish`` maps a unit's host
    results to what is kept (a batch's p-value ladder, run while later
    batches compute).
    """
    axes = axes or {}
    starts = list(starts)
    ckpt = None if checkpoint is None else ScanCheckpoint(checkpoint)
    done, acc = 0, []
    if ckpt is not None:
        state = ckpt.load()
        if state is not None and all(state["meta"].get(k) == v
                                     for k, v in ck_meta.items()):
            done = state["cursor"]
            acc = [dict(state["results"])]

    def cat(parts):
        return {k: np.concatenate([a[k] for a in parts], axis=axes.get(k, 0))
                for k in parts[0]}

    def consume(out):
        nonlocal done
        acc.append(finish(out) if finish is not None else out)
        if ckpt is not None:
            done += 1
            if done % checkpoint_every == 0 or done == len(starts):
                flat = cat(acc)
                ckpt.save(done, flat, ck_meta)
                acc[:] = [flat]

    _pipelined(_batch_starts(starts[done:], 1, progress, desc), launch,
               consume, timers, kind, device,
               window=4 if ckpt is None else 1)
    if ckpt is not None and not keep:
        ckpt.clear()
    return cat(acc)


def _content_sha(*arrays) -> str:
    """Short content fingerprint of a scan's inputs (resume safety)."""
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(np.asarray(a, float)).tobytes())
    return h.hexdigest()[:16]


def _to_host_async(out: dict):
    """Start copying a batch's results to pinned host memory; returns
    (host tensors, CUDA event recorded after the copies, or None)."""
    first = next(iter(out.values()))
    if not isinstance(first, torch.Tensor) or first.device.type != "cuda":
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

    ``config.dtype``: "float64", or "float32" (the float32 context, as the
    JAX package's: the interaction scans' heavy tensors f32 and their
    statistics f64; the association scans, their null fits and the effect
    sizes in f32 as the JAX package computes them on an f32 context; the
    aggregate environment refuses it).
    """

    def __init__(self, y, E, W=None, Ls=None, E1=None, hK=None,
                 config: ScanConfig = DEFAULT_CONFIG, device=None):
        if config.dtype not in ("float64", "float32"):
            raise ValueError(f"unknown dtype {config.dtype!r}")
        self._cfg = config
        self._device = _resolve_device(device)
        self._dtype = (torch.float64 if config.dtype == "float64"
                       else torch.float32)

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
        if self._device.type == "cuda":
            _check_card_envelope(W.shape[1], E0.shape[1],
                                 self._dtype == torch.float32)
        self._y, self._W, self._E0, self._E1 = y, W, E0, E1
        self._Ls, self._hK = Ls, hK
        self._n = n
        self._ctx_cache = None
        self._ctx32_cache = None
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
        new._ctx32_cache = None
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

    def _inputs_sha(self, *arrays) -> str:
        """Fingerprint of a scan's inputs for its checkpoint: ``arrays`` and
        the scanner's own (y, W, E, E1 and the background)."""
        bg = list(self._Ls) + ([] if self._hK is None else [self._hK])
        return _content_sha(self._y, self._W, self._E0, self._E1, *bg,
                            *arrays)

    def _upload(self, a, dtype=None) -> torch.Tensor:
        """A host array on the scan's device in ``dtype`` (the scanner's
        context dtype by default): through pinned memory and a
        non-blocking copy on the card."""
        dtype = self._dtype if dtype is None else dtype
        t = torch.from_numpy(np.ascontiguousarray(
            a, dtype=np.float32 if dtype == torch.float32 else np.float64))
        if self._device.type == "cuda":
            return t.pin_memory().to(self._device, non_blocking=True)
        return t.to(self._device)

    def _require_float64(self, path: str) -> None:
        """Refuse the float32 context where the JAX package's float32 result
        is wrong: the aggregate environment (ROADMAP queue 3, "In the
        reference", item j)."""
        if self._dtype != torch.float64:
            raise NotImplementedError(
                f"{path} runs in float64 only: in the JAX package's float32 "
                f"context its REML fits over rho return a NaN lml at some "
                f"rho (mean_fit_kernel; seen at n = 400, C = 4, rho 0.2 and "
                f"0.3), np.argmax picks it and the aggregate environment is "
                f"NaN; the port does not copy that fault")

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

        ``checkpoint``: optional directory; completed variant batches (and
        their p-values) are persisted there, every ``checkpoint_every``
        batches, and a restarted scan with the same inputs resumes from the
        cursor.  Checkpointed batches run one at a time.
        """
        cfg = self._cfg
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

        def launch(start):
            gb = self._upload(Gp[:, start : start + batch])
            gsb = (gb if idx_G is None
                   else self._upload(Gsp[:, start : start + batch]))
            out = engine.interaction_batch(
                ctx, gb, gsb, self._n, delta_cfg=delta_cfg,
                localize_f32=cfg.hybrid_localization,
                device_pvalues=method != "davies")
            return {k: out[k] for k in keys}

        def ladder(out):
            with trace.trace_scope("interaction/pvalue_ladder", timers):
                pv_b, lam_b = self._pvalue_ladder(out)
            return dict({k: out[k] for k in info_keys}, pv=pv_b,
                        lambdas=lam_b)

        idx = [np.asarray(i) for i in (idx_E, idx_G) if i is not None]
        ck_meta = {"scan": "interaction", "n_snps": n_snps, "batch": batch,
                   "method": method, "idx_E": idx_E is not None,
                   "idx_G": idx_G is not None,
                   "inputs_sha": (self._inputs_sha(G, *idx)
                                  if checkpoint is not None else None)}
        res = _run_checkpointed(
            range(0, Gp.shape[1], batch), launch, checkpoint, ck_meta,
            timers, "interaction", dev, checkpoint_every, finish=ladder,
            progress=cfg.progress, desc="scan_interaction")
        pvalues = res.pop("pv")[:n_snps]
        info = {k: v[:n_snps] for k, v in res.items()}
        if timers is not None:
            info["timers"] = timers.summary()
            trace.log_event("scan_interaction", n_snps=n_snps, batch=batch,
                            **{f"s_{k.rsplit('/', 1)[-1]}": v
                               for k, v in timers.summary().items()})
        return np.asarray(pvalues, float), info

    # -- two-pass screen -> confirm (f32 screen, f64 + Davies confirm) -----
    def _with_config(self, config: ScanConfig) -> "CellRegMap":
        """A view of this scanner with another config (shared caches)."""
        new = object.__new__(CellRegMap)
        new.__dict__ = dict(self.__dict__)
        new._cfg = config
        return new

    @property
    def _ctx32(self) -> engine.NullContext:
        """The float32 copy of the null context for the screen pass: a
        device cast of the float64 context, built once (no second host
        factorization)."""
        if self._ctx32_cache is None:
            self._ctx32_cache = engine.NullContext(
                *(t.to(torch.float32) for t in self._ctx))
        return self._ctx32_cache

    def _confirm_scanner(self) -> "CellRegMap":
        """The confirm pass's scanner: Davies tails always, on a float64
        base config."""
        if self._cfg.dtype != "float64":
            raise ValueError(
                "screen->confirm scans need a float64 base config (the "
                "confirm pass re-tests hits at full precision)")
        if self._cfg.pvalue_method == "davies":
            return self
        return self._with_config(dataclasses.replace(
            self._cfg, pvalue_method="davies"))

    @staticmethod
    def _screen_pvalues(scr, thr):
        """(screen_pv, hits, info) of a screen's results: the saddlepoint
        value where it is finite, else Liu; the hits below ``thr`` or not
        finite; the info entries as f64."""
        sp = np.asarray(scr["pv_saddlepoint"], float)
        screen_pv = np.where(np.isfinite(sp), sp,
                             np.asarray(scr["pv_liu"], float))
        hits = (~np.isfinite(screen_pv)) | (screen_pv < thr)
        info = {k: np.asarray(scr[k], float) for k in _INFO_KEYS}
        return screen_pv, hits, info

    def _confirm(self, confirm, G, idx, checkpoint=None,
                 checkpoint_every: int = 1):
        """The f64 Davies scan of the variants ``idx`` of G, padded to one
        canonical width by repeating the first hit's column (hit sets are
        small by design: the JAX package's 64, api.py:475-481)."""
        cb = min(64, self._cfg.snp_batch, self._auto_batch_cap())
        Gh = G[:, idx]
        pad = (-Gh.shape[1]) % cb
        if pad:
            Gh = np.concatenate([Gh, np.repeat(Gh[:, :1], pad, axis=1)],
                                axis=1)
        pv_c, info_c = confirm.scan_interaction(
            Gh, checkpoint=checkpoint, checkpoint_every=checkpoint_every)
        return pv_c[: idx.size], {k: np.asarray(info_c[k], float)[: idx.size]
                                  for k in _INFO_KEYS}

    def scan_interaction_screen(self, G, significance: float = 5e-8,
                                screen_margin: float = 100.0,
                                checkpoint=None, checkpoint_every: int = 1):
        """Two-pass interaction scan (the JAX package's, api.py:402-501): a
        float32 screen of every variant, then the float64 Davies re-test
        of the candidate hits.

        Pass 1 runs the interaction batch in the float32 context (the
        f32 instantiations of K1-K4 and K6a, K5 on f32 operands; the
        statistics f64) with the device tails.  Pass 2 re-tests every
        variant whose screen p-value (the saddlepoint value, else Liu) is
        below ``significance * screen_margin`` (capped at 1) or not finite,
        through :meth:`scan_interaction` with Davies tails, in batches of
        one canonical width.

        Contract: a variant whose f64 p-value is below ``significance`` is
        confirmed and reported with its f64 Davies p-value, as long as the
        screen's error stays within ``screen_margin``; the others carry
        their screen p-value.  Returns ``(pvalues, info)``: info holds
        rho1, e2, g2, eps2, Q (the confirm's where confirmed),
        ``screen_pv``, ``confirmed``, ``screen_threshold`` and
        ``n_confirmed``.

        ``checkpoint``: optional directory; the screen's batches are made
        durable under ``screen/`` and the confirm's under ``confirm/``.
        The screen's checkpoint is kept until the confirm pass is done, so
        that a stop in the confirm pass resumes without the screen.
        """
        cfg = self._cfg
        confirm = self._confirm_scanner()
        G = np.asarray(G, float)
        if G.ndim == 1:
            G = G[:, None]
        n_snps = G.shape[1]
        thr = min(1.0, float(significance) * float(screen_margin))
        timers = trace.PhaseTimers() if cfg.trace else None
        dev = self._device
        with trace.trace_scope("screen/setup", timers, dev):
            ctx32 = self._ctx32
        batch = min(cfg.snp_batch * 2, 4 * self._auto_batch_cap(),
                    _MAX_BATCH, max(n_snps, 1))
        Gp, _ = _pad_batch(G, batch)
        delta_cfg = (cfg.delta_logit_lo, cfg.delta_logit_hi,
                     cfg.n_delta_grid_interaction, cfg.n_golden_iters)

        def launch(start):
            gb = self._upload(Gp[:, start : start + batch], torch.float32)
            out = engine.interaction_batch(ctx32, gb, gb, self._n,
                                           delta_cfg=delta_cfg,
                                           device_pvalues=True)
            return {k: out[k] for k in _SCREEN_KEYS}

        ck = (None, None) if checkpoint is None else (
            os.path.join(str(checkpoint), "screen"),
            os.path.join(str(checkpoint), "confirm"))
        ck_meta = {"scan": "interaction_screen", "n_snps": n_snps,
                   "batch": batch,
                   "inputs_sha": (self._inputs_sha(G)
                                  if checkpoint is not None else None)}
        scr = _run_checkpointed(
            range(0, Gp.shape[1], batch), launch, ck[0], ck_meta, timers,
            "screen", dev, checkpoint_every, progress=cfg.progress,
            desc="screen", keep=True)
        screen_pv, hits, info = self._screen_pvalues(
            {k: v[:n_snps] for k, v in scr.items()}, thr)
        idx = np.flatnonzero(hits)
        pvalues = screen_pv.copy()
        if idx.size:
            with trace.trace_scope("screen/confirm", timers, dev):
                pvalues[idx], info_c = self._confirm(confirm, G, idx, ck[1],
                                                     checkpoint_every)
            for k in info:
                info[k][idx] = info_c[k]
        if ck[0] is not None:
            ScanCheckpoint(ck[0]).clear()
        info.update(screen_pv=screen_pv, confirmed=hits,
                    screen_threshold=thr, n_confirmed=int(idx.size))
        if timers is not None:
            info["timers"] = timers.summary()
        return pvalues, info

    def scan_interaction_multigene_screen(self, Y, G, gene_batch: int = 16,
                                          significance: float = 5e-8,
                                          screen_margin: float = 100.0):
        """Gene-batched two-pass interaction scan (the JAX package's,
        api.py:503-595): the float32 screen of every (gene, variant) pair
        through the gene-batched interaction batch, then each gene's
        candidate hits re-tested through the single-gene float64 Davies
        scan (see :meth:`scan_interaction_screen` for the contract).

        Returns ``(pvalues (n_genes, n_snps), info)`` with ``confirmed`` /
        ``screen_pv`` shaped like pvalues.  No ``checkpoint=``: the JAX
        method has none.
        """
        cfg = self._cfg
        confirm = self._confirm_scanner()
        Y, G = self._gene_inputs(Y, G)
        n_genes, n_snps = Y.shape[1], G.shape[1]
        gtile = max(1, min(gene_batch, n_genes, MAX_GENES))
        thr = min(1.0, float(significance) * float(screen_margin))
        dev = self._device
        ctx32 = self._ctx32
        nrho, R = (int(d) for d in ctx32.S.shape)
        C = int(ctx32.E0.shape[1])
        # the JAX package's accounting: the statistics stages hold the
        # f64 (gene, S, nrho, R) weight families (its api.py:532-537)
        per_gv = (nrho * R * 2 + (3 * C + 6) * R) * 8 * 8
        batch = min(cfg.snp_batch * 2, max(16, int(5e9 / per_gv / gtile)),
                    _MAX_BATCH, max(n_snps, 1))
        Gp, _ = _pad_batch(G, batch)
        Yp, _ = _pad_batch(Y, gtile)
        delta_cfg = (cfg.delta_logit_lo, cfg.delta_logit_hi,
                     cfg.n_delta_grid_interaction, cfg.n_golden_iters)

        tiles = []
        for g0 in _batch_starts(range(0, Yp.shape[1], gtile), gtile,
                                cfg.progress, "screen_multigene"):
            ctx_g = self._gene_tile(ctx32, Yp, g0, gtile)
            parts: list = []

            def launch(start):
                gb = self._upload(Gp[:, start : start + batch],
                                  torch.float32)
                out = engine.interaction_multigene_batch(
                    ctx_g, gb, gb, self._n, delta_cfg=delta_cfg,
                    device_pvalues=True)
                return {k: out[k] for k in _SCREEN_KEYS}

            _pipelined(range(0, Gp.shape[1], batch), launch, parts.append,
                       None, "screen_multigene", dev, window=2)
            tiles.append({k: np.concatenate([o[k] for o in parts],
                                            axis=1)[:, :n_snps]
                          for k in parts[0]})
        scr = {k: np.concatenate([t[k] for t in tiles])[:n_genes]
               for k in tiles[0]}
        screen_pv, hits, info = self._screen_pvalues(scr, thr)
        pvalues = screen_pv.copy()
        for g in range(n_genes):
            idx = np.flatnonzero(hits[g])
            if idx.size:
                pvalues[g, idx], info_c = self._confirm(
                    confirm.with_phenotype(Y[:, g]), G, idx)
                for k in info:
                    info[k][g, idx] = info_c[k]
        info.update(screen_pv=screen_pv, confirmed=hits,
                    screen_threshold=thr, n_confirmed=int(hits.sum()))
        return pvalues, info

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
        interaction kind's Newton families and the weight matrix; per
        variant, the score factor in K1's layout and in K4's transposed
        scratch, K4's m = min(genes, nrho) factor slots, and the
        genotype-weighted operands once.
        ``association_multigene``: per variant, the genotype column (~3
        copies) and [W | G] rotated at each of the tile's m <=
        min(genes, nrho) distinct best rho; per (gene, variant), the
        association kind's Newton and grid temporaries and the (m,)
        brackets (x2).  ``association_fast_multigene``: per variant, the
        genotype column (~3 copies), Z^T G and the m rotated candidates
        with their complements; per (gene, variant), the plain version's
        three (R,) weighted products, the slot-masked phenotype products
        (m) and the results (p + 6).
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
                m = min(genes, nrho)
                per_variant = 8 * (genes * (48 * nrho * R + C * C)
                                   + (2 + m) * R * C
                                   + 3 * self._n * (C + p))
            elif kind == "association_multigene":
                m = min(genes, nrho)
                per_variant = 8 * (3 * self._n + m * R
                                   + genes * (32 * R + 2 * m
                                              + self._cfg.n_delta_grid
                                              * (p + 8)))
            elif kind == "association_fast_multigene":
                m = min(genes, nrho)
                per_variant = 8 * (3 * self._n + (1 + m) * (R + p + 1)
                                   + genes * (3 * R + m + p + 6))
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
        event.  ``checkpoint``: as in :meth:`scan_interaction`, per
        variant batch.
        """
        cfg = self._cfg
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

        def launch(start):
            lml, _ = engine.association_refit_batch(
                ctx, self._upload(Gp[:, start : start + batch]), k,
                self._n, delta_cfg=delta_cfg,
                localize_f32=cfg.hybrid_localization)
            return {"lml": lml}

        ck_meta = {"scan": "association", "n_snps": n_snps, "batch": batch,
                   "k_rho": int(k),
                   "inputs_sha": (self._inputs_sha(G)
                                  if checkpoint is not None else None)}
        res = _run_checkpointed(
            range(0, Gp.shape[1], batch), launch, checkpoint, ck_meta,
            timers, "association", dev, checkpoint_every,
            progress=cfg.progress, desc="scan_association")
        alt_lmls = res["lml"][:n_snps]
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
        are pipelined, and ``checkpoint`` taken, in the same way."""
        cfg = self._cfg
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

        def launch(start):
            out = engine.fast_scan_batch(
                ctx, self._upload(Gp[:, start : start + batch]), k, delta,
                self._n)
            return {"lml": out.lml}

        ck_meta = {"scan": "association_fast", "n_snps": n_snps,
                   "batch": batch, "k_rho": int(k),
                   "inputs_sha": (self._inputs_sha(G)
                                  if checkpoint is not None else None)}
        res = _run_checkpointed(
            range(0, Gp.shape[1], batch), launch, checkpoint, ck_meta,
            timers, "association_fast", dev, checkpoint_every,
            progress=cfg.progress, desc="scan_association_fast")
        alt_lmls = res["lml"][:n_snps]
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
        are pipelined, and ``checkpoint`` taken, as in
        :meth:`scan_interaction`."""
        cfg = self._cfg
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

        def launch(start):
            beta_g, alpha, _ = engine.predict_interaction_batch(
                bctx, self._upload(Gp[:, start : start + batch]),
                self._upload(normp[start : start + batch]), self._n,
                delta_cfg=delta_cfg, localize_f32=cfg.hybrid_localization)
            return {"beta_g": beta_g, "alpha": alpha}

        ck_meta = {"scan": "betas", "n_snps": n_snps, "batch": batch,
                   "inputs_sha": (self._inputs_sha(G, norm)
                                  if checkpoint is not None else None)}
        res = _run_checkpointed(
            range(0, Gp.shape[1], batch), launch, checkpoint, ck_meta,
            timers, "betas", dev, checkpoint_every, axes={"alpha": 1},
            progress=cfg.progress, desc="predict_interaction")
        beta_g = res["beta_g"][:n_snps]
        alpha = res["alpha"][:, :n_snps]
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
        self._require_float64("estimate_aggregate_environment")
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
    def _gene_inputs(self, Y, G):
        """``Y`` (n_cells, n_genes) and ``G`` (n_cells, n_snps) as float
        arrays, validated as the JAX package's gene-batched scans do."""
        Y = np.asarray(Y, float)
        if Y.ndim == 1:
            Y = Y[:, None]
        if Y.ndim != 2 or Y.shape[0] != self._n or Y.shape[1] < 1:
            raise ValueError("Y must be (n_cells, n_genes) with at least one "
                             "gene column")
        if not np.isfinite(Y).all():
            raise ValueError("Y contains non-finite values")
        G = np.asarray(G, float)
        if G.ndim == 1:
            G = G[:, None]
        if G.ndim != 2 or G.shape[0] != self._n or G.shape[1] < 1:
            raise ValueError("G must be (n_cells, n_snps) with at least one "
                             "variant column")
        return Y, G

    def _gene_tile(self, ctx, Yp, g0, gtile):
        """The context of the gene tile at ``g0``: its phenotypes uploaded
        gene-major (the kernels take contiguous operands) in ``ctx``'s
        dtype, with their rotations."""
        Yg = self._upload(np.ascontiguousarray(Yp[:, g0 : g0 + gtile].T),
                          ctx.y.dtype)
        return ctx._replace(y=Yg, Zy=Yg @ ctx.Z, Wy=Yg @ ctx.W,
                            yy=(Yg * Yg).sum(dim=1))

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

        ``checkpoint``: optional directory; completed gene tiles (the unit
        of work) are persisted, and a restarted scan with the same inputs
        resumes from the tile cursor.
        """
        cfg = self._cfg
        method = self._pvalue_method()
        Y, G = self._gene_inputs(Y, G)
        n_genes = Y.shape[1]
        gtile = max(1, min(gene_batch, n_genes, MAX_GENES))
        timers = trace.PhaseTimers() if cfg.trace else None
        dev = self._device
        with trace.trace_scope("multigene/setup", timers, dev):
            ctx = self._ctx
        batch = min(cfg.snp_batch, self._auto_batch_cap("multigene", gtile),
                    _MAX_BATCH, max(G.shape[1], 1))
        Gp, n_snps = _pad_batch(G, batch)
        Yp, _ = _pad_batch(Y, gtile)
        delta_cfg = (cfg.delta_logit_lo, cfg.delta_logit_hi,
                     cfg.n_delta_grid_interaction, cfg.n_golden_iters)
        keys, info_keys = _result_keys(method)

        def tile(g0):
            ctx_g = self._gene_tile(ctx, Yp, g0, gtile)
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

            _pipelined(range(0, Gp.shape[1], batch), launch, consume, timers,
                       "multigene", dev)
            return {k: np.concatenate([r[k] for r in parts],
                                      axis=1)[:, :n_snps]
                    for k in parts[0]}

        ck_meta = {"scan": "interaction_multigene", "n_snps": n_snps,
                   "n_genes": n_genes, "gtile": gtile, "batch": batch,
                   "method": method,
                   "inputs_sha": (self._inputs_sha(Y, G)
                                  if checkpoint is not None else None)}
        res = _run_checkpointed(
            range(0, Yp.shape[1], gtile), tile, checkpoint, ck_meta, None,
            "multigene_tile", dev, checkpoint_every, progress=cfg.progress,
            desc="scan_multigene")
        res = {k: v[:n_genes] for k, v in res.items()}
        pvalues = np.asarray(res.pop("pv"), float)
        info = res
        if timers is not None:
            info["timers"] = timers.summary()
            trace.log_event("scan_interaction_multigene", n_genes=n_genes,
                            n_snps=n_snps, gene_batch=gtile, batch=batch,
                            **{f"s_{k.rsplit('/', 1)[-1]}": v
                               for k, v in timers.summary().items()})
        return pvalues, info

    def _association_multigene(self, Y, G, gene_batch, checkpoint,
                               checkpoint_every, fast):
        """The gene-batched association scans (JAX api.py:916-1080): per
        gene tile, the tile's null fits in one K10 launch, then the variant
        batches pipelined through the gene-batched refit (K7) or fast scan
        (K8), each gene at its own null's best rho; LRT p-values on the
        host.  Gene tiles run through :func:`_run_checkpointed`."""
        cfg = self._cfg
        kind = "association_fast_multigene" if fast else \
            "association_multigene"
        Y, G = self._gene_inputs(Y, G)
        n_genes = Y.shape[1]
        gtile = max(1, min(gene_batch, n_genes, MAX_GENES))
        timers = trace.PhaseTimers() if cfg.trace else None
        dev = self._device
        with trace.trace_scope(f"{kind}/setup", timers, dev):
            ctx = self._ctx
        batch = min(cfg.snp_batch, self._auto_batch_cap(kind, gtile),
                    _MAX_BATCH, max(G.shape[1], 1))
        Gp, n_snps = _pad_batch(G, batch)
        Yp, _ = _pad_batch(Y, gtile)
        delta_cfg = (cfg.delta_logit_lo, cfg.delta_logit_hi,
                     cfg.n_delta_grid, cfg.n_golden_iters)
        rho_grid = ctx.rho.cpu().numpy()

        def tile(g0):
            ctx_g = self._gene_tile(ctx, Yp, g0, gtile)
            with trace.trace_scope(f"{kind}/null_fit", timers, dev):
                fits, k = engine.null_association_multigene_fit(
                    ctx_g, self._n, restricted=False, delta_cfg=delta_cfg)
                fits = engine.FitResult(*(t.cpu().numpy() for t in fits))
                k = k.cpu().numpy()
            rows = np.arange(k.shape[0])
            if fast:
                delta = self._upload(fits.delta[rows, k])
            parts: list = []

            def launch(start):
                gb = self._upload(Gp[:, start : start + batch])
                if fast:
                    return {"lml": engine.fast_scan_multigene_batch(
                        ctx_g, gb, k, delta, self._n).lml}
                return {"lml": engine.association_refit_multigene_batch(
                    ctx_g, gb, k, self._n, delta_cfg=delta_cfg,
                    localize_f32=cfg.hybrid_localization)[0]}

            _pipelined(range(0, Gp.shape[1], batch), launch,
                       lambda out: parts.append(out["lml"]), timers, kind,
                       dev)
            alt = np.concatenate(parts, axis=1)[:, :n_snps]  # (gtile, S)
            with trace.trace_scope(f"{kind}/lrt", timers):
                pv = pv_mod.lrt_pvalues(fits.lml[rows, k][:, None], alt,
                                        dof=1, clip_lo=cfg.pv_clip_lo,
                                        clip_hi=cfg.pv_clip_hi)
            rho1 = (rho_grid[k] if rho_grid.shape[0] > 1
                    else np.ones(k.shape[0]))
            v0 = fits.v0[rows, k]
            return {"pv": np.asarray(pv, float), "rho1": rho1,
                    "e2": v0 * rho1, "g2": v0 * (1 - rho1),
                    "eps2": fits.v1[rows, k]}

        ck_meta = {"scan": kind, "n_snps": n_snps, "n_genes": n_genes,
                   "gtile": gtile, "batch": batch,
                   "inputs_sha": (self._inputs_sha(Y, G)
                                  if checkpoint is not None else None)}
        res = _run_checkpointed(
            range(0, Yp.shape[1], gtile), tile, checkpoint, ck_meta, None,
            f"{kind}_tile", dev, checkpoint_every, progress=cfg.progress,
            desc=kind)
        pvalues = np.asarray(res.pop("pv")[:n_genes], float)
        info = {k: v[:n_genes] for k, v in res.items()}
        if timers is not None:
            info["timers"] = timers.summary()
            trace.log_event(f"scan_{kind}", n_genes=n_genes, n_snps=n_snps,
                            gene_batch=gtile, batch=batch,
                            **{f"s_{k.rsplit('/', 1)[-1]}": v
                               for k, v in timers.summary().items()})
        return pvalues, info

    def scan_association_multigene(self, Y, G, gene_batch: int = 16,
                                   checkpoint=None,
                                   checkpoint_every: int = 1):
        """LRT association scan with per-variant ML refits for many genes
        sharing this factorization (the JAX package's
        ``scan_association_multigene``, api.py:916-995).

        ``Y`` is (n_cells, n_genes).  Per gene tile of ``gene_batch``: the
        covariate-only null fits over the rho grid of every gene in one
        launch (K10), then every (gene, variant) pair refit by ML at its
        gene's null best rho (K7 with a per-gene rho: the genotype's
        contractions shared, [W | G] rotated once per distinct best rho).
        Returns ``(pvalues (n_genes, n_snps), info)`` with per-gene info
        arrays rho1, e2, g2, eps2 (n_genes,) (and ``timers`` when
        ``config.trace``).  ``checkpoint``: as in
        :meth:`scan_interaction_multigene`, per gene tile.
        """
        return self._association_multigene(Y, G, gene_batch, checkpoint,
                                           checkpoint_every, fast=False)

    def scan_association_fast_multigene(self, Y, G, gene_batch: int = 64,
                                        checkpoint=None,
                                        checkpoint_every: int = 1):
        """Closed-form LRT association scan for many genes sharing this
        factorization (the JAX package's
        ``scan_association_fast_multigene``, api.py:997-1080): per gene
        tile, the null fits in one launch (K10), then every (gene, variant)
        alternative re-profiled at its gene's null delta and best rho (K8
        with the gene axis: the rotated candidates read once per distinct
        best rho).  Returns and ``checkpoint`` as
        :meth:`scan_association_multigene`.
        """
        return self._association_multigene(Y, G, gene_batch, checkpoint,
                                           checkpoint_every, fast=True)


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


def _multigene_base(Y, E, W, hK, Ls, config, device):
    """The scanner of a gene-batched run: the factorization built once, on
    the first gene's phenotype."""
    Y = np.asarray(Y, float)
    if Y.ndim == 1:
        Y = Y[:, None]
    return Y, CellRegMap(y=Y[:, 0], E=E, W=W, hK=hK, Ls=Ls, config=config,
                         device=device)


def run_association_multigene(Y, E, G, W=None, hK=None, Ls=None,
                              gene_batch: int = 16,
                              config: ScanConfig = DEFAULT_CONFIG,
                              device=None):
    """Association scan with per-variant ML refits across many genes
    sharing one factorization (the JAX package's
    ``run_association_multigene``, api.py:1274-1284); see
    :meth:`CellRegMap.scan_association_multigene`.  ``Ls`` selects the
    K (.) EE^T background, ``hK`` the plain-K one.  Runs on ``device``
    (the card unless "cpu" is given)."""
    Y, base = _multigene_base(Y, E, W, hK, Ls, config, device)
    return base.scan_association_multigene(Y, G, gene_batch=gene_batch)


def run_association_fast_multigene(Y, E, G, W=None, hK=None, Ls=None,
                                   gene_batch: int = 64,
                                   config: ScanConfig = DEFAULT_CONFIG,
                                   device=None):
    """Closed-form association scan across many genes sharing one
    factorization (the JAX package's ``run_association_fast_multigene``,
    api.py:1287-1306); see
    :meth:`CellRegMap.scan_association_fast_multigene`.  Returns
    ``(pvalues (n_genes, n_snps), info)`` with per-gene info arrays.  Runs
    on ``device`` (the card unless "cpu" is given)."""
    Y, base = _multigene_base(Y, E, W, hK, Ls, config, device)
    return base.scan_association_fast_multigene(Y, G, gene_batch=gene_batch)


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


def run_interaction_screen(y, E, G, W=None, E1=None, E2=None, hK=None,
                           significance: float = 5e-8,
                           screen_margin: float = 100.0,
                           config: ScanConfig = DEFAULT_CONFIG, device=None):
    """Two-pass interaction scan: a float32 screen of every variant, the
    float64 Davies re-test of the candidate hits (screen p-value below
    ``significance * screen_margin``); the JAX package's
    ``run_interaction_screen`` (api.py:1220-1235).  See
    :meth:`CellRegMap.scan_interaction_screen` for the contract.  Runs on
    ``device`` (the card unless "cpu" is given)."""
    E1 = E if E1 is None else E1
    E2 = E if E2 is None else E2
    Ls = None if hK is None else get_L_values(hK, E2)
    crm = CellRegMap(y=y, E=E, W=W, E1=E1, Ls=Ls, config=config,
                     device=device)
    return crm.scan_interaction_screen(G, significance=significance,
                                       screen_margin=screen_margin)
