"""Build-on-first-use + ctypes loader for the port's Davies library.

``cellregmap_tpu_torch/native/qfc.cc`` is compiled with g++ into the
package's ``build/`` directory (ignored by git), keyed by a hash of the
source.  The build writes a temporary file and renames it, so concurrent
processes (test workers) never load a half-written library.  Without a
toolchain the p-value ladder falls back to the Imhof quadrature and
modified Liu, only slower.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
BUILD_DIR = _PKG / "build"
_LOCK = threading.Lock()
_LIB = None
_TRIED = False


def build_qfc() -> Path | None:
    """Compile native/qfc.cc into build/ (no-op when already built)."""
    src = _PKG / "native" / "qfc.cc"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    out = BUILD_DIR / f"libqfc_{digest}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC",
           "-o", str(tmp), str(src), "-lpthread"]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=300)
    except (OSError, subprocess.SubprocessError):
        return None
    os.replace(tmp, out)
    return out


class QfcLib:
    """Typed wrapper over the shared library."""

    def __init__(self, cdll: ctypes.CDLL):
        dp = ctypes.POINTER(ctypes.c_double)
        ip = ctypes.POINTER(ctypes.c_int)
        self._lib = cdll
        self._lib.qfc_survival.restype = ctypes.c_double
        self._lib.qfc_survival.argtypes = [
            dp, dp, ip, ctypes.c_int, ctypes.c_double, ctypes.c_double,
            ctypes.c_int, ctypes.c_double, ip]
        self._lib.qfc_survival_batch.restype = None
        self._lib.qfc_survival_batch.argtypes = [
            dp, dp, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_double, ctypes.c_double, ctypes.c_int, dp, ip]

    def davies(self, lambdas: np.ndarray, q: float, lim: int, acc: float):
        """P(Q > q) for the central chi2(1) mixture; returns (pv, ifault)."""
        lam = np.ascontiguousarray(lambdas, dtype=np.float64)
        ifault = ctypes.c_int(0)
        pv = self._lib.qfc_survival(
            lam.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            None, None, lam.shape[0], 0.0, float(q), int(lim), float(acc),
            ctypes.byref(ifault))
        return float(pv), int(ifault.value)

    def davies_batch_raw(self, lambda_rows, qs, lim, acc, filter_ratio,
                         n_threads=0):
        """Threaded batch over (S, C) zero-padded spectra; returns
        (pv (S,), ifault (S,))."""
        lam = np.ascontiguousarray(lambda_rows, dtype=np.float64)
        qs = np.ascontiguousarray(qs, dtype=np.float64)
        n, c = lam.shape
        pv = np.empty(n, dtype=np.float64)
        fault = np.empty(n, dtype=np.int32)
        self._lib.qfc_survival_batch(
            lam.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            qs.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            n, c, int(lim), float(acc), float(filter_ratio), int(n_threads),
            pv.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            fault.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
        return pv, fault


def get_qfc() -> QfcLib | None:
    """The loaded library, built on first use; None without a toolchain."""
    global _LIB, _TRIED
    with _LOCK:
        if not _TRIED:
            _TRIED = True
            path = build_qfc()
            if path is not None:
                _LIB = QfcLib(ctypes.CDLL(str(path)))
        return _LIB
