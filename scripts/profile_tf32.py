"""The float32 context's split-TF32 kernels (K1-f32 at K > 32 and K2-f32's
sums, ``csrc/kr_contract.cu``, ``csrc/delta_grid.cu``, ``csrc/tf32mma.cuh``)
in variants of their source, each built beside the package's and timed in
one process on the card, on the operands of one screen batch (the
headline's context cast to f32, 1024 variants: K1's T, A^T A and A^T W,
K2's REML grid), K2 on that batch's 16-gene tile and on K7-f32's ML grid
(``profile_kernel_ab.f32_calls``), and K1 on seeded inputs of the screen's
T shape (n = 2000, K = 1000, p = 10, S = 1024) whose terms all have one
sign (|N(0, 1)|, rng 14: where a long chain of the tensor core's own sums
would drift):

* ``as built`` (a fresh partial each 8-row step, the rounding to TF32 in
  integer arithmetic);
* ``fresh2`` / ``fresh4``: a fresh partial each two steps / each 32-row
  chunk (held only where they meet the tolerance);
* ``cvt``: the rounding by cvt.rna.tf32.f32;
* ``hi_only`` (timed, not held): one TF32 product a term, what the two
  small products cost.

For each variant and call: the CUDA-event median of 20 runs (in the order
given, then reversed), the device milliseconds by kernel
(``chip_smoke.device_split``), and the error against the f64 product of
the same f32 operands in eps(f32) of the terms' magnitudes (K1; the
tolerance is sqrt(n)) or the bracket shortfall (K2, within 1e-5).  Prints
one JSON line a call and one of the whole; ``--out`` writes the last to a
file.

    python3 scripts/profile_tf32.py [--out FILE]
"""
import argparse
import json
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(1, str(ROOT))
sys.path.insert(1, str(ROOT / "scripts"))
import chip_smoke as cs  # noqa: E402
import cellregmap_tpu_torch as crp  # noqa: E402
from cellregmap_tpu_torch.kernels import _build  # noqa: E402
from cellregmap_tpu_torch.kernels import delta_grid as k2  # noqa: E402
from cellregmap_tpu_torch.kernels import kr_contract as k1  # noqa: E402
from profile_kernel_ab import f32_calls  # noqa: E402

HEADER = (_build.CSRC / "tf32mma.cuh").read_text()
EPS32 = 2.0 ** -23


def edit(text, old, new):
    assert old in text, old
    return text.replace(old, new)


def fresh(kr, dg, steps):
    return (edit(kr, "constexpr int T_FRESH = 1;",
                 f"constexpr int T_FRESH = {steps};"),
            edit(dg, "constexpr int F_FRESH = 1;",
                 f"constexpr int F_FRESH = {steps};"))


CVT = [("  return (f32_bits(x) + 0x1000u) & 0xffffe000u;",
        "  uint32_t r;\n  asm(\"cvt.rna.tf32.f32 %0, %1;\" : \"=r\"(r) : "
        "\"f\"(x));\n  return r & 0xffffe000u;")]
HI_ONLY = [("tf32_m16n8k8_zero(part[m][n], al[m], bh[n]);",
            "tf32_m16n8k8_zero(part[m][n], ah[m], bh[n]);"),
           ("for (int n = 0; n < NT; ++n) tf32_m16n8k8(part[m][n], al[m], "
            "bh[n]);", "for (int n = 0; n < NT; ++n) tf32_m16n8k8(part[m][n]"
            ", ah[m], bh[n]);"),
           ("    for (int n = 0; n < NT; ++n) tf32_m16n8k8(part[m][n], ah[m], "
            "bl[n]);", "    for (int n = 0; n < NT; ++n) {}"),
           ("    for (int n = 0; n < NT; ++n) tf32_m16n8k8(part[m][n], ah[m], "
            "bh[n]);\n}", "    for (int n = 0; n < NT; ++n) {}\n}")]


def header(edits=()):
    text = HEADER
    for old, new in edits:
        text = edit(text, old, new)
    return text


# name -> (K1's source, K2's source, the header, held to the tolerance)
def variants():
    kr = (_build.CSRC / "kr_contract.cu").read_text()
    dg = (_build.CSRC / "delta_grid.cu").read_text()
    return {
        "as built": (kr, dg, header(), True),
        "fresh2": (*fresh(kr, dg, 2), header(), False),
        "fresh4": (*fresh(kr, dg, 4), header(), False),
        "cvt": (kr, dg, header(CVT), True),
        "hi_only": (kr, dg, header(HI_ONLY), False),
    }


def build(work, table):
    """Every variant's two libraries built in parallel, each beside its own
    copy of the header; returns name -> (K1's library, K2's library) and
    the new kernels' ptxas lines."""
    procs = {}
    for i, (name, (kr, dg, hdr, _)) in enumerate(table.items()):
        d = work / f"v{i}"
        d.mkdir(parents=True, exist_ok=True)
        (d / "tf32mma.cuh").write_text(hdr)
        for src, text in (("kr_contract", kr), ("delta_grid", dg)):
            (d / f"{src}.cu").write_text(text)
            cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v",
                   "-I", str(d), "-I", str(_build.CSRC), "-o",
                   str(d / f"lib{src}.so"), str(d / f"{src}.cu")]
            procs[(name, src)] = (d, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
    libs, ptxas = {}, {}
    import ctypes
    for (name, src), (d, proc) in procs.items():
        log, _ = proc.communicate()
        assert proc.returncode == 0, log
        ptxas.setdefault(name, []).extend(
            r for r in cs.ptxas_report(log)
            if r.startswith(("kr_tf32", "sums_f32", "kr_small_f32")))
        lib = ctypes.CDLL(str(d / f"lib{src}.so"))
        (k1 if src == "kr_contract" else k2)._bind(lib)
        libs.setdefault(name, {})[src] = lib
    return libs, ptxas


def k1_error(got, args):
    """K1's largest error against the f64 product of its f32 operands, in
    eps(f32) of the terms' magnitudes."""
    exact = k1.kr_contract_plain(*(a.double() for a in args))
    mags = k1.kr_contract_plain(*(a.double().abs() for a in args))
    return float(((got.double() - exact).abs() / (mags + 1e-300)).max()
                 / EPS32)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", type=Path)
    opt = ap.parse_args()
    table = variants()
    libs, ptxas = build(_build.BUILD_DIR / "profile_tf32", table)
    out = {"card": cs.card_line(), "ptxas": ptxas, "calls": []}
    print(json.dumps({"ptxas": ptxas}), flush=True)
    d = cs.make_dataset(**cs.HEADLINE)
    n = len(d["y"])
    k1_calls, k2_calls = f32_calls(d, n, crp.get_L_values(d["hK"], d["E"]))
    rng = np.random.default_rng(14)
    pos = tuple(torch.as_tensor(np.abs(rng.normal(size=s)),
                                dtype=torch.float32, device="cuda")
                for s in ((2000, 1000), (2000, 10), (2000, 1024)))
    stream = _build.stream_ptr(torch.device("cuda"))
    calls = [(f"kr_contract ({name}, f32)", "kr_contract", a)
             for (a, _), name in zip(k1_calls, cs.K1_CALLS)]
    calls.append(("kr_contract (T shape, terms of one sign)", "kr_contract",
                  pos))
    calls += [(f"delta_grid ({label}, f32)", "delta_grid", (a, kw))
              for label, (a, kw) in k2_calls]
    order = list(table)
    for label, src, a in calls:
        row = {"call": label, "ms": {}, "device": {}, "err": {}}
        if src == "kr_contract":
            fns = {v: (lambda lib=libs[v][src], a=a: k1.call(lib, *a, stream))
                   for v in order}
        else:
            args, kw = a
            dkw = (dict(kw, slot=_build.upload(
                np.asarray(kw["slot"], dtype=np.int64), args[0].device))
                if "slot" in kw else kw)
            fns = {v: (lambda lib=libs[v][src], args=args, dkw=dkw:
                       k2.call(lib, *args, stream=stream, **dkw))
                   for v in order}
            lml = k2.delta_grid_plain(*args, **kw, return_lml=True)[2]
            ctx_dt = (torch.float32 if kw.get("restricted", True)
                      else torch.float64)
        for v in order:
            got = fns[v]()
            torch.cuda.synchronize()
            if src == "kr_contract":
                err = k1_error(got, a)
                ok = err <= math.sqrt(a[0].shape[0])
            else:
                err = max(k2.bracket_shortfall(
                    got[0][g], got[1][g], lml[g], args[5], args[6], ctx_dt)
                    for g in np.ndindex(*got[0].shape[:-2])) \
                    if "slot" not in kw else None
                ok = err is None or err <= 1e-5
            assert ok or not table[v][3], (v, label, err)
            row["err"][v] = err
        for v in order + order[::-1]:
            row["ms"].setdefault(v, []).append(cs.cuda_ms(fns[v], reps=20))
        for v in order:
            row["device"][v] = cs.device_split(fns[v])
        print(json.dumps(row), flush=True)
        out["calls"].append(row)
    line = json.dumps(out)
    print(line, flush=True)
    if opt.out:
        opt.out.parent.mkdir(parents=True, exist_ok=True)
        opt.out.write_text(line + "\n")


if __name__ == "__main__":
    main()
