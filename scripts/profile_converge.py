"""Variants of K3's converge (``csrc/reml_newton.cu``) against each other on
the card, on the batches of ``profile_kernel_ab.py``'s ``k3conv`` entry
(the interaction's stage 3 at the headline, ``multigene_16``,
``cells10k``, ``covariates_24`` and ``n_rho = 80``; each call of K7's
refit batch, of K7 with the gene axis and of the wide K7):

* ``as built``;
* ``one_warp``: one warp a problem at p + 1 <= 2 in every call (its rows
  not split between two);
* ``log_each_row``: one log a row in the final fit's sums, not one a
  product of 8 rows;
* ``smem40`` (``-DCRM_CONV_SMEM_KB=40``): the rows staged in chunks of
  128 (p = 1), re-staged every pass;
* ``no_rows``, timed but not held: no sums over the rows in the Newton
  passes (what the staging, the barriers, the algebra and the final fit
  cost alone).

With ``--f32`` the float32 converge instead, on ``profile_kernel_ab.py``'s
``k3conv32`` calls (the screen's stage 3 at S = 1024, K7's three calls and
K7 with 16 genes, on the float32 scanner): ``as built`` and ``f32_blocks4``
(the f32 one-warp instantiation, which serves the zero-step calls of
4096 problems and more, at the f64 one's four blocks an SM instead of
eight).

Each held variant matches the plain version (delta, lml, scale, beta
within rel 1e-9).  Per call and variant: the CUDA-event median of 10
wrapper calls (in the order given, then reversed) and the profiler's
device milliseconds of the converge kernel (None where the profiler
saw no kernel of the variant's library).  Prints one JSON line a call
and one of the whole; ``--out`` also writes that line to a file.

    python3 scripts/profile_converge.py [--f32] [--out FILE]
"""
import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(1, str(ROOT))
sys.path.insert(1, str(ROOT / "scripts"))
import chip_smoke as cs  # noqa: E402
import cellregmap_tpu_torch as crp  # noqa: E402
from cellregmap_tpu_torch.kernels import _build  # noqa: E402
from cellregmap_tpu_torch.kernels import reml_newton as k3  # noqa: E402
from profile_kernel_ab import (f32_converge_calls,  # noqa: E402
                               score_converge_calls)

SOURCE = (_build.CSRC / "reml_newton.cu").read_text()


def edit(text, old, new):
    assert old in text, old
    return text.replace(old, new)


ONE_WARP = edit(SOURCE, "const int wpp =\n      !wide && p + 1 <= 2 && "
                "(steps > 0 || P < CONV_SPLIT_BELOW) ? 2 : 1;",
                "const int wpp = 1;")
LOG_EACH_ROW = edit(SOURCE, "constexpr int LOG_GROUP = 8;",
                    "constexpr int LOG_GROUP = 1;")
NO_ROWS = edit(SOURCE, "        if (active)\n          conv_rows<P1MAX, 3>",
               "        if (false)\n          conv_rows<P1MAX, 3>")
F32_BLOCKS4 = edit(SOURCE, "WPP == 2 ? 2 : es == 4 ? 8 : 4;",
                  "WPP == 2 ? 2 : 4;")
F32_VARIANTS = {
    "as built": (SOURCE, (), True),
    "f32_blocks4": (F32_BLOCKS4, (), True),
}
# name -> (source text, -D defines, held to the plain version)
VARIANTS = {
    "as built": (SOURCE, (), True),
    "one_warp": (ONE_WARP, (), True),
    "log_each_row": (LOG_EACH_ROW, (), True),
    "smem40": (SOURCE, ("CRM_CONV_SMEM_KB=40",), True),
    "no_rows": (NO_ROWS, (), False),
}


def build(work, variants):
    """Every variant built in parallel."""
    work.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, (text, defines, _)) in enumerate(variants.items()):
        src = work / f"reml_newton_{i}.cu"
        src.write_text(text)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v",
               *(f"-D{d}" for d in defines), "-I", str(_build.CSRC), "-o",
               str(work / f"libreml_newton_{i}.so"), str(src)]
        procs[name] = (i, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT,
                                           text=True))
    libs, ptxas = {}, {}
    for name, (i, proc) in procs.items():
        log, _ = proc.communicate()
        assert proc.returncode == 0, log
        ptxas[name] = [r for r in cs.ptxas_report(log)
                       if r.startswith("converge_kernel")]
        lib = ctypes.CDLL(str(work / f"libreml_newton_{i}.so"))
        k3._bind(lib)
        libs[name] = lib
    return libs, ptxas


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", type=Path)
    ap.add_argument("--f32", action="store_true")
    opt = ap.parse_args()
    variants = F32_VARIANTS if opt.f32 else VARIANTS
    libs, ptxas = build(_build.BUILD_DIR / "profile_converge", variants)
    out = {"card": cs.card_line(), "ptxas": ptxas, "calls": []}
    d = cs.make_dataset(**cs.HEADLINE)
    n = len(d["y"])
    G = torch.as_tensor(d["G"][:, :cs.BATCH], device="cuda").contiguous()
    stream = _build.stream_ptr(G.device)
    Ls = crp.get_L_values(d["hK"], d["E"])
    if opt.f32:
        batches = [(label, None, conv) for label, conv in
                   f32_converge_calls(d, n, G, Ls) if "f32" in label]
    else:
        batches = score_converge_calls(d, n, G, Ls)
    for label, _, conv in batches:
        for i, (args, kw) in enumerate(conv):
            want = k3.reml_converge_plain(*args, **kw)
            row = {"call": f"{label}, call {i}, steps {args[10]}", "ms": {},
                   "device_ms": {}}
            order = list(libs.items())
            for name, lib in order + order[::-1]:
                fn = lambda lib=lib: k3.call_converge(  # noqa: E731
                    lib, *args, **kw, stream=stream)
                if variants[name][2]:
                    got = fn()
                    torch.cuda.synchronize()
                    for g, w in zip(got, want):
                        assert cs._rel(g, w) <= 1e-9, (name, label, i)
                row["ms"].setdefault(name, []).append(cs.cuda_ms(fn, reps=10))
            for name, lib in order:
                try:
                    row["device_ms"][name] = cs.device_split(
                        lambda lib=lib: k3.call_converge(lib, *args, **kw,
                                                         stream=stream))
                except AssertionError:  # the profiler saw no kernel
                    row["device_ms"][name] = None
            print(json.dumps(row), flush=True)
            out["calls"].append(row)
    line = json.dumps(out)
    print(line, flush=True)
    if opt.out:
        opt.out.parent.mkdir(parents=True, exist_ok=True)
        opt.out.write_text(line + "\n")


if __name__ == "__main__":
    main()
