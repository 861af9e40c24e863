"""Phase timers and trace scopes for the scans.

``trace_scope(name, timers)`` times a scope on the host clock and annotates
it for ``torch.profiler`` (``record_function``).  PyTorch returns before the
card finishes, so when a scope is given a CUDA ``device`` it synchronises
that device on exit: the phase time then includes the device work enqueued
inside it.  Tracing is off unless ``ScanConfig.trace`` is set; when on, the
synchronisation serialises the scan's batch pipeline, so traced runs give
the phase split, and untraced runs the throughput.
"""
from __future__ import annotations

import contextlib
import json
import logging
import time
from typing import Dict, Iterator, Optional

import torch

logger = logging.getLogger("cellregmap_tpu_torch")


def log_event(event: str, **fields) -> None:
    """Emit one structured JSON log line (INFO) on the package logger."""
    if logger.isEnabledFor(logging.INFO):
        logger.info("%s", json.dumps({"event": event, **fields}, default=str,
                                     sort_keys=True))


class PhaseTimers:
    """Accumulates wall-clock seconds per named phase."""

    def __init__(self) -> None:
        self.seconds: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str, device: Optional[torch.device] = None
              ) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            with torch.profiler.record_function(name):
                yield
                if device is not None and device.type == "cuda":
                    torch.cuda.synchronize(device)
        finally:
            dt = time.perf_counter() - t0
            self.seconds[name] = self.seconds.get(name, 0.0) + dt

    def summary(self) -> Dict[str, float]:
        return dict(sorted(self.seconds.items(), key=lambda kv: -kv[1]))


def trace_scope(name: str, timers: Optional[PhaseTimers],
                device: Optional[torch.device] = None):
    """A timed, synchronised phase when ``timers`` is given, else a no-op."""
    if timers is None:
        return contextlib.nullcontext()
    return timers.phase(name, device)
