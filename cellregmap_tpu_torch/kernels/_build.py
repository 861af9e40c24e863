"""Build and load the hand-written CUDA kernels (nvcc + ctypes).

Each ``csrc/<name>.cu`` exposes a plain C entry point and is compiled on
first use with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC

into ``cellregmap_tpu_torch/build/`` (ignored by git), keyed by a hash of
the source, the shared headers (``csrc/*.cuh``) and the flags.  Nothing
is built at import time.  :func:`build_all` starts one nvcc per source at
once and waits for all of them.  Entry points take ``c_void_p`` pointers
and the stream, launch on it, and return ``cudaGetLastError()``;
:func:`check` raises on non-zero.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]
SOURCES = ("kr_contract", "delta_grid", "reml_newton", "best_rho_rotate",
           "score_core", "null_fit", "fast_scan", "woodbury_family",
           "sym_eigvalsh", "mixture_tails")

_LOCK = threading.Lock()
_LIBS: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    default = Path(home) / "bin" / "nvcc"
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _target(name: str) -> Path:
    # the source and the headers it may include
    src = (CSRC / f"{name}.cu").read_bytes() + b"".join(
        h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:16]}.so"


def build_all(names=SOURCES, verbose: bool = False) -> dict:
    """Compile every missing library in parallel; returns name -> path.

    ``verbose`` adds ``-Xptxas -v`` and returns its report per source under
    the key ``"<name>.ptxas"``.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs, out = {}, {}
    for name in names:
        target = _target(name)
        out[name] = target
        if target.exists() and not verbose:
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, target)
    errors = []
    for name, (proc, tmp, target) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc {name}.cu failed:\n{log}")
            continue
        os.replace(tmp, target)
        out[f"{name}.ptxas"] = log
    if errors:
        raise RuntimeError("\n".join(errors))
    return out


def load(name: str, bind) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use;
    ``bind(lib)`` declares its entry points' argtypes once."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            target = _target(name)
            if not target.exists():
                build_all((name,))
            lib = ctypes.CDLL(str(target))
            bind(lib)
            _LIBS[name] = lib
        return lib


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")


def ptr(t) -> int:
    """A tensor's address, for an entry point's ``c_void_p`` argument."""
    return t.data_ptr()


def stream_ptr(device) -> int:
    """The handle of ``device``'s current CUDA stream, for an entry
    point's ``cudaStream_t`` argument: the raw handle, with no Stream
    object made on every call (``scripts/profile_wrapper_host.py`` times
    both)."""
    import torch

    index = torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(index)


def upload(a, device):
    """A small host array (an index) on ``device``: on the card through
    pinned memory and a non-blocking copy, so that the stream is not
    synchronised."""
    import numpy as np
    import torch

    t = torch.from_numpy(np.ascontiguousarray(a))
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def context_dtype(t, name: str):
    """The dtype of a kernel call's context (float64, or float32 for the
    float32 context) from its first operand; raises on any other."""
    import torch

    if t.dtype not in (torch.float64, torch.float32):
        raise TypeError(f"{name}: expected float64 or float32 (the float32 "
                        f"context), got {t.dtype}")
    return t.dtype


def require_all(name: str, dtype, specs) -> None:
    """:func:`require` of each (tensor, its name, shape) of ``specs``: one
    quick pass, and only where it finds a fault the checks that name it."""
    for t, _, shape in specs:
        if not (t.is_cuda and t.dtype == dtype and t.is_contiguous()
                and t.shape == shape):
            break
    else:
        return
    for t, tn, shape in specs:
        require(t, f"{name}: {tn}", dtype, shape)


def require(t, name: str, dtype, shape=None) -> None:
    """Validate a kernel operand: on the card, dtype, contiguity, shape."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
