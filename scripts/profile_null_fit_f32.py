"""K10-f32 (``csrc/null_fit.cu``, ``crm_null_fit_f32``) in variants of its
golden-section block, against each other on the card: the float32 Ls
scanner's null fit (2000 cells, R = 1000, 11 rho, the association's
256-point grid and 60 golden-section steps, ML) and the
``assoc_multigene_16`` tile's (16 genes), as ``profile_kernel_ab.py``'s
``k10f32`` entry takes them:

* ``as built``: every evaluation on the whole block of ``NF32_GT``
  threads (256), the warps' sums met by one barrier;
* ``gold512``, ``gold128`` and ``gold64``: sixteen, four and two warps a
  block;
* ``gold32``: one warp a problem, its rows reduced by shuffles alone (no
  block barrier in the golden section).

Each variant is an edit of the source's text, built beside the package.

Each variant is held to the plain version (``chip_smoke.null_fits_agree``'s
f32 budget).  Per call and variant: the CUDA-event median of 10 wrapper
calls (in the order given, then reversed) and the profiler's device
milliseconds by kernel.  Prints one JSON line a call and one of the
whole; ``--out`` also writes that line to a file.

    python3 scripts/profile_null_fit_f32.py [--out FILE]
"""
import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(1, str(ROOT))
sys.path.insert(1, str(ROOT / "scripts"))
import chip_smoke as cs  # noqa: E402
import cellregmap_tpu_torch as crp  # noqa: E402
from cellregmap_tpu_torch.kernels import _build  # noqa: E402
from cellregmap_tpu_torch.kernels import null_fit as k10  # noqa: E402
from profile_kernel_ab import f32_null_fit_calls  # noqa: E402

SOURCE = (_build.CSRC / "null_fit.cu").read_text()
THREADS = "constexpr int NF32_GT = 256;"
# the golden section's meeting of the warps' sums, after the shuffle tree
MEET = SOURCE[SOURCE.index("    const int buf = parity;"):
              SOURCE.index("  auto evaluate = [&](float d) {")]


def edit(text, old, new):
    assert old in text, old
    return text.replace(old, new)


def threads(text, nt):
    return edit(text, THREADS, THREADS.replace("256", str(nt)))


# name -> the source's text
VARIANTS = {"as built": SOURCE, "gold512": threads(SOURCE, 512),
            "gold128": threads(SOURCE, 128), "gold64": threads(SOURCE, 64),
            "gold32": edit(threads(SOURCE, 32), MEET, "  };\n")}


def build(work):
    """Every variant built in parallel."""
    work.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, text) in enumerate(VARIANTS.items()):
        src = work / f"null_fit_{i}.cu"
        src.write_text(text)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-I",
               str(_build.CSRC), "-o", str(work / f"libnull_fit_{i}.so"),
               str(src)]
        procs[name] = (i, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT,
                                           text=True))
    _build.build_all()  # the package, for the engine's paths, meanwhile
    libs, ptxas = {}, {}
    for name, (i, proc) in procs.items():
        log, _ = proc.communicate()
        assert proc.returncode == 0, log
        ptxas[name] = [r for r in cs.ptxas_report(log) if "_f32_" in r]
        lib = ctypes.CDLL(str(work / f"libnull_fit_{i}.so"))
        k10._bind(lib)
        libs[name] = lib
    return libs, ptxas


def main():
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--out", type=Path)
    opt = ap.parse_args()
    libs, ptxas = build(_build.BUILD_DIR / "profile_null_fit_f32")
    out = {"card": cs.card_line(), "ptxas": ptxas, "calls": []}
    d = cs.make_dataset(**cs.HEADLINE)
    n = len(d["y"])
    stream = _build.stream_ptr(torch.device("cuda"))
    for label, (args, kw) in f32_null_fit_calls(
            d, n, crp.get_L_values(d["hK"], d["E"])):
        plain = k10.null_fit_plain(*args, **kw)
        row = {"call": label, "ms": {}, "device_ms": {}}
        order = list(libs.items())
        for name, lib in order + order[::-1]:
            fn = lambda lib=lib: k10.call(  # noqa: E731
                lib, *args, **kw, stream=stream)
            cs.null_fits_agree(fn(), plain, args[0], args[1], args[2],
                               f"K10-f32 {label} ({name})")
            row["ms"].setdefault(name, []).append(cs.cuda_ms(fn, reps=10))
        for name, lib in order:
            row["device_ms"][name] = cs.device_split(
                lambda lib=lib: k10.call(lib, *args, **kw, stream=stream))
        print(json.dumps(row), flush=True)
        out["calls"].append(row)
    line = json.dumps(out)
    print(line, flush=True)
    if opt.out:
        opt.out.parent.mkdir(parents=True, exist_ok=True)
        opt.out.write_text(line + "\n")


if __name__ == "__main__":
    main()
