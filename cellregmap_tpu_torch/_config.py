"""Configuration for the PyTorch engine.

The port's own copy of ``cellregmap_tpu._config`` (same fields, same
defaults), so the port imports nothing of the JAX package.  The reference
(limix/CellRegMap) hard-codes its hyper-parameters inline: rho-grid
``linspace(0, 1, 11)`` (_cellregmap.py:108,119), eigenvalue cutoff 1e-16
(_math.py:128), p-value clipping (_cellregmap.py:467-469).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ScanConfig:
    """Hyper-parameters of the scan engine.

    Attributes
    ----------
    n_rho:
        Number of points of the rho1 grid ``linspace(0, 1, n_rho)`` mixing the
        E1*E1^T context kernel with the K (x) E2*E2^T background.
    delta_logit_lo / delta_logit_hi / n_delta_grid:
        Coarse grid over logit(delta) for the profiled 1-D variance-ratio
        objective (delta = v1/(v0+v1)).
    n_delta_grid_interaction:
        Grid size of the interaction scan, which only needs basin-level
        localization (safeguarded Newton converges from the bracket).
    n_golden_iters:
        Golden-section steps of the association/betas fitters (not on the
        interaction path; kept for config parity).
    snp_batch:
        Number of variants per device batch; the scan pads the last one.
    pvalue_method:
        "davies" - host-side exact Davies tail for every test.  The device
        tails ("auto", "saddlepoint", "liu") are not ported yet.
    davies_threshold:
        Refinement threshold for pvalue_method="auto".
    davies_acc / davies_lim:
        Absolute accuracy target and integration-term limit of Davies'
        algorithm.
    lambda_filter_ratio:
        Mixture-weight filter: keep eigenvalues > mean(positive)/ratio.
    dtype:
        "float64" (statistical parity).  The float32 screen context is not
        ported yet.
    hybrid_localization:
        Localize the REML optimum (delta grid + first Newton steps) in f32,
        then converge and score in f64.
    trace:
        Time the scan's phases with ``utils.trace.PhaseTimers`` (each phase
        synchronises the CUDA stream) and return them as info["timers"].
    """

    n_rho: int = 11
    delta_logit_lo: float = -18.0
    delta_logit_hi: float = 18.0
    n_delta_grid: int = 256
    n_delta_grid_interaction: int = 64
    n_golden_iters: int = 60
    snp_batch: int = 256
    pvalue_method: str = "davies"
    davies_threshold: float = 1e-2
    davies_acc: float = 1e-8
    davies_lim: int = 20_000_000
    lambda_filter_ratio: float = 1e5
    dtype: str = "float64"
    hybrid_localization: bool = True
    pv_clip_lo: float = 1e-300
    pv_clip_hi: float = 1.0 - 1.1e-16
    progress: bool = False
    trace: bool = False

    @property
    def rho_grid(self) -> Tuple[float, ...]:
        if self.n_rho == 1:
            return (1.0,)
        return tuple(i / (self.n_rho - 1) for i in range(self.n_rho))


DEFAULT_CONFIG = ScanConfig()
