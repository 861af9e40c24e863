"""Where one evaluation of the wide K10 (``csrc/null_fit.cu``, p > 16)
spends its time, at the aggregate environment's mean fit at 50 contexts
(``chip_smoke.WIDE``: p = 52, R = 2000, 11 rho, 256 grid points, 60
golden-section steps), on the card:

* the clock64 sections of the golden section's steps on one block of rho
  point 0 (the previous point's factorization from its gathered partial
  sums, then this point's partial sums over the block's rows), from a
  build of the source with ``-DNULL_FIT_CLOCKS`` (cycles a step);
* the profiler's device milliseconds of each of the three kernels at
  ``n_iters`` 60 and 0 and at R and R / 2 rows, so that an evaluation's
  cost and its part that scales with R read as differences.

    python3 scripts/profile_wide_fit.py [--out FILE] [--source FILE ...]

``--source`` times other versions of the source (variants made for an
experiment) in the same process, by their clock64 sections alone.
"""
import argparse
import ctypes
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(1, str(ROOT))
import chip_smoke as cs  # noqa: E402
from cellregmap_tpu_torch.kernels import _build  # noqa: E402
from cellregmap_tpu_torch.kernels import null_fit as k10  # noqa: E402

SECTIONS = ("factorization", "partial sums")


def clocks_library(source=_build.CSRC / "null_fit.cu", tag="clocks"):
    """``source`` built with -DNULL_FIT_CLOCKS beside the package's build
    (the package's headers on the include path)."""
    out = _build.BUILD_DIR / f"libnull_fit_{tag}.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-DNULL_FIT_CLOCKS",
                    "-I", str(_build.CSRC), "-o", str(out), str(source)],
                   check=True)
    lib = ctypes.CDLL(str(out))
    k10._bind(lib)
    lib.crm_null_fit_clocks.restype = ctypes.c_int
    lib.crm_null_fit_clocks.argtypes = [ctypes.c_void_p]
    return lib


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", type=Path)
    ap.add_argument("--source", type=Path, nargs="*", default=[])
    opt = ap.parse_args()
    spec = importlib.util.spec_from_file_location(
        "profile_kernel_ab", ROOT / "scripts" / "profile_kernel_ab.py")
    ab = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ab)
    args, kw = ab.k10_wide_call()
    data, n, restricted, lo, hi, n_grid, n_iters = args
    out = {"card": cs.card_line(), "shapes": dict(
        nrho=data.S.shape[0], R=data.S.shape[1], p=data.Xt.shape[2],
        n_grid=n_grid, n_iters=n_iters)}

    def sections(lib):
        buf = (ctypes.c_ulonglong * len(SECTIONS))()
        assert lib.crm_null_fit_clocks(buf) == 0            # zeroed
        k10.call(lib, *args, **kw, stream=_build.stream_ptr(data.S.device))
        torch.cuda.synchronize()
        assert lib.crm_null_fit_clocks(buf) == 0
        return dict(zip(SECTIONS, (v / (n_iters + 3) for v in buf)))

    cyc = sections(clocks_library())
    out["cycles_a_step"] = cyc
    out["share"] = {k: c / sum(cyc.values()) for k, c in cyc.items()}
    out["variants"] = {
        str(src): sections(clocks_library(src, f"variant{i}"))
        for i, src in enumerate(opt.source)}

    half = data.S.shape[1] // 2
    halved = data._replace(S=data.S[:, :half].contiguous(),
                           Xt=data.Xt[:, :half].contiguous(),
                           yt=data.yt[:, :half].contiguous())
    runs = {}
    for label, d, it in (("R, 60 steps", data, n_iters),
                         ("R, 0 steps", data, 0),
                         ("R/2, 60 steps", halved, n_iters)):
        a = (d, n, restricted, lo, hi, n_grid, it)
        runs[label] = cs.device_split(lambda a=a: k10.null_fit(*a, **kw))
    out["device_ms"] = runs
    line = json.dumps(out)
    print(line, flush=True)
    if opt.out:
        opt.out.parent.mkdir(parents=True, exist_ok=True)
        opt.out.write_text(line + "\n")


if __name__ == "__main__":
    main()
