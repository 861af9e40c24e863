"""K4's float32 product (``csrc/best_rho_rotate.cu``,
``crm_best_rho_rotate_f32``) and K6b (``csrc/mixture_tails.cu``) in
variants of their sources, against each other on the card, in one
process:

* K4-f32 on seeded f32 operands at a screen batch (R = 1000, C = 10, 11
  rho, S = 1024, one gene) and at ``screen_multigene_16``'s (16 genes
  drawn at random over the 11 rho, m = 11 slots), with the SM clock and
  power that nvidia-smi reads while ``as built`` runs back to back and
its product's SASS opcode counts (``cuobjdump``):
  ``as built`` (threads 16 x 16 over the tile, two blocks an SM, a
  chunk's 32 row steps unrolled 8 at a time, a row of sums at a time),
  ``rows unrolled whole``, ``one block an SM`` (``__launch_bounds__(256,
  1)``: no register cap), ``warp 4 x 8`` (each warp a 32 x 64 part of the
  tile, its lanes 4 x 8), ``FMAs interleaved`` (the four 4 x 4 quarters'
  FMAs interleaved, the first design's order), and three that time a
  part alone (their sums are wrong): ``V[k] from one address`` and
  ``columns from one address`` (every thread's float4s of one operand
  from the row's first ones: a broadcast) and ``fragments once a chunk``
  (no shared-memory reads in the row steps);
* K6b on the real batches of ``profile_kernel_ab.py``'s ``k6b`` (the
  headline's auto batch, a screen batch, its 16-gene tile and the
  multigene screen's first batch) and on
  ``tests/_torch_inputs.tail_battery``'s pairs at P = 1024, 4096 and
  16 384 (C = 10): ``as built`` (up to 2048 pairs a warp a pair, the
  bisection speculated two steps a round; above, 8 lanes a pair),
  ``grouped`` (8 lanes a pair at every P), ``speculated`` (a warp a pair
  at every P), ``divisions`` (IEEE divisions in K'(t) and the series),
  ``no bisection`` (0 steps), ``no gammaincc`` (the Liu tail's gammaincc
  skipped), ``a warp a pair`` (L = 32 without speculation: lanes past C
  add zeros) and ``one lane a pair`` (L = 1, 32 pairs a warp: timing
  alone, a lane holds two of the weights, so its sums are wrong).

A variant is an edit of the source's text, built beside the package; the
timings are CUDA-event medians of 20 wrapper calls (the variants in the
order given, then reversed) and the profiler's device milliseconds.  Each
``as built`` result is held to its plain version (K4-f32: the slots equal,
the factors within sqrt(R) eps(f32) of the terms' magnitudes; K6b:
``chip_smoke.check_tails``), and each K6b variant that computes the tails
has its gaps to that rule recorded (``chip_smoke.tails_gaps``: which part
of the design parts from the plain version near the mean).  Prints one
JSON line a call and one of the whole; ``--out`` also writes that line to
a file; ``--kernels`` picks the sources (both by default).

    python3 scripts/profile_k4f32_k6b.py [--out FILE]
        [--kernels best_rho_rotate,mixture_tails]
"""
import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(1, str(ROOT))
sys.path.insert(1, str(ROOT / "tests"))
import chip_smoke as cs  # noqa: E402
import cellregmap_tpu_torch as crp  # noqa: E402
from _torch_inputs import tail_battery  # noqa: E402
from cellregmap_tpu_torch.kernels import _build  # noqa: E402
from cellregmap_tpu_torch.kernels import best_rho_rotate as k4  # noqa: E402
from cellregmap_tpu_torch.kernels import mixture_tails as k6b  # noqa: E402


def edit(text, old, new):
    assert old in text, old
    return text.replace(old, new)


K4_SOURCE = (_build.CSRC / "best_rho_rotate.cu").read_text()
K6B_SOURCE = (_build.CSRC / "mixture_tails.cu").read_text()
# the text the K4-f32 variants edit: the thread's rows and columns, the
# row steps' unrolling, their float4 reads and FMAs, the block's
# occupancy
TILE = ("  const int qa = 4 * (tid / 16), qb = qa + 64;\n"
        "  const int ca = 4 * (tid % 16), cb = ca + 64;")
WARP_4X8 = ("  const int qa = 32 * (tid / 32 % 4) + 4 * (tid % 32 / 8), "
            "qb = qa + 16;\n"
            "  const int ca = 64 * (tid / 128) + 4 * (tid % 8), cb = ca + 32;")
ROWS = "#pragma unroll 8\n    for (int rr = 0; rr < P32_NC; ++rr) {"
FRAGS = ("      load4(as + rr * P32_BM + qa, a0);\n"
         "      load4(as + rr * P32_BM + qb, a1);\n"
         "      load4(bs + rr * P32_BN + ca, b0);\n"
         "      load4(bs + rr * P32_BN + cb, b1);\n")
FMAS = K4_SOURCE[K4_SOURCE.index("      const float av[8]"):
                 K4_SOURCE.rindex("    }\n  }\n  cp_async_wait<0>();")]
INTERLEAVED = """#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[i][j] = fmaf(a0[i], b0[j], acc[i][j]);
          acc[i][j + 4] = fmaf(a0[i], b1[j], acc[i][j + 4]);
          acc[i + 4][j] = fmaf(a1[i], b0[j], acc[i + 4][j]);
          acc[i + 4][j + 4] = fmaf(a1[i], b1[j], acc[i + 4][j + 4]);
        }
"""
ONE_BLOCK = ("__launch_bounds__(P32_THREADS, 2)",
             "__launch_bounds__(P32_THREADS, 1)")
# the K6b variants': the speculation limit, K'(t)'s term, the lane groups
SPEC = "#define CRM_MT_SPEC_MAX_PAIRS 2048"
KP_TERM = "      return l * rcp_nr(1.0 - 2.0 * mid * l);"
LANES = "  while (L < 32 && 2 * L < C) L *= 2;"


def edits(text, *pairs):
    for old, new in pairs:
        text = edit(text, old, new)
    return text


VARIANTS = {
    "best_rho_rotate": {
        "as built": K4_SOURCE,
        "rows unrolled whole": edits(K4_SOURCE,
                                     (ROWS, ROWS.replace(" 8", ""))),
        "one block an SM": edits(K4_SOURCE, ONE_BLOCK),
        "warp 4 x 8": edits(K4_SOURCE, (TILE, WARP_4X8)),
        "FMAs interleaved": edits(K4_SOURCE, (FMAS, INTERLEAVED)),
        # timing alone (their sums are wrong): one operand's float4s from
        # one address of the row (a broadcast), or no shared-memory reads
        # in the row steps
        "V[k] from one address": edits(K4_SOURCE, (FRAGS, FRAGS.replace(
            "+ qa", "").replace("+ qb", "+ 64"))),
        "columns from one address": edits(K4_SOURCE, (FRAGS, FRAGS.replace(
            "+ ca", "").replace("+ cb", "+ 64"))),
        "fragments once a chunk": edits(K4_SOURCE, (FRAGS, FRAGS.replace(
            "rr * P32_BM", "0").replace("rr * P32_BN", "0")))},
    "mixture_tails": {
        "as built": K6B_SOURCE,
        "grouped": edits(K6B_SOURCE, (SPEC, SPEC.replace("2048", "0"))),
        "speculated": edits(K6B_SOURCE,
                            (SPEC, SPEC.replace("2048", "(1ll << 40)"))),
        "divisions": edits(
            K6B_SOURCE,
            (KP_TERM, "      return l / (1.0 - 2.0 * mid * l);"),
            ("term *= x * rcp_nr(ap);", "term *= x / ap;")),
        "no bisection": edits(K6B_SOURCE, ("int steps = n_bisect;",
                                           "int steps = 0;")),
        "no gammaincc": edits(K6B_SOURCE, (
            "series ? 0.0 : gammaincc_d(dof / 2.0, xh)", "series ? 0.0 : xh")),
        "a warp a pair": edits(K6B_SOURCE, (LANES, "  L = 32;")),
        "one lane a pair": edits(K6B_SOURCE, (LANES, ""),
                                 (SPEC, SPEC.replace("2048", "0")))}}
BIND = {"best_rho_rotate": k4._bind, "mixture_tails": k6b._bind}
# the K6b variants that time a part alone (their tails are wrong)
TIMING_ONLY = ("no bisection", "no gammaincc", "one lane a pair")


def build(work, picked):
    """Every variant of the ``picked`` sources built in parallel: name ->
    {variant: library}, and their ptxas lines."""
    work.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in picked:
        variants = VARIANTS[name]
        for i, (label, text) in enumerate(variants.items()):
            src = work / f"{name}_{i}.cu"
            src.write_text(text)
            lib = work / f"lib{name}_{i}.so"
            cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v",
                   "-I", str(_build.CSRC), "-o", str(lib), str(src)]
            procs.append((name, label, lib, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
    _build.build_all()  # the package, for the engine's paths, meanwhile
    libs, ptxas = {}, {}
    for name, label, lib, proc in procs:
        log, _ = proc.communicate()
        assert proc.returncode == 0, log
        libs.setdefault(name, {})[label] = ctypes.CDLL(str(lib))
        BIND[name](libs[name][label])
        ptxas[f"{name} {label}"] = cs.ptxas_report(log)
        if name == "best_rho_rotate" and label == "as built":
            ptxas["rotate_product_f32_kernel SASS"] = sass_mix(
                lib, "rotate_product_f32_kernel")
    return libs, ptxas


def sass_mix(lib, kernel):
    """Opcode counts of ``kernel``'s SASS in ``lib`` (``cuobjdump
    -sass``; None where the toolkit has no cuobjdump)."""
    import re
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    try:
        text = subprocess.run([tool, "-sass", str(lib)], check=True,
                              capture_output=True, text=True,
                              timeout=120).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    counts, inside = {}, False
    for ln in text.splitlines():
        if "Function :" in ln:
            inside = kernel in ln
        elif inside:
            m = re.search(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?"
                          r"([A-Z][A-Z0-9_]*)", ln)
            if m:
                counts[m.group(1)] = counts.get(m.group(1), 0) + 1
    return dict(sorted(counts.items(), key=lambda kv: -kv[1]))


def timed(fns, reps=20):
    """CUDA-event medians of each (label, fn), in the order given and
    then reversed, and each one's profiler device milliseconds."""
    ms = {}
    for label, fn in fns + fns[::-1]:
        ms.setdefault(label, []).append(cs.cuda_ms(fn, reps=reps))
    return {label: dict(ms=ms[label], device=cs.device_ms(fn))
            for label, fn in fns}


def clocks_under_load(fn, seconds=3.0):
    """nvidia-smi's SM clock (MHz), its maximum and the power draw (W)
    every 100 ms while ``fn`` runs back to back for ``seconds``."""
    import time

    mon = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "100"],
        stdout=subprocess.PIPE, text=True)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
    mon.terminate()
    rows = [[float(v) for v in ln.split(",")]
            for ln in mon.communicate()[0].strip().splitlines()
            if ln.count(",") == 2]
    rows = rows[len(rows) // 3:]  # past the ramp
    return {k: float(np.median([r[i] for r in rows]))
            for i, k in enumerate(("sm_mhz", "max_sm_mhz", "power_w"))}


def k4_calls():
    """(label, (V, T, k_best)) of the module doc's K4-f32 calls."""
    out = []
    for genes in (1, 16):
        rng = np.random.default_rng(genes)
        R, C, S, nrho = 1000, 10, 1024, 11
        V = torch.as_tensor(rng.standard_normal((nrho, R, R),
                                                dtype=np.float32)
                            / np.float32(np.sqrt(R)), device="cuda")
        T = torch.as_tensor(rng.standard_normal((R, C, S), dtype=np.float32),
                            device="cuda")
        kb = torch.as_tensor(rng.integers(0, nrho, size=(genes, S)),
                             device="cuda")
        out.append((f"{genes} gene(s) x 1024", (V, T, kb[0] if genes == 1
                                                else kb)))
    return out


def k6b_calls():
    """(label, (Q, lam)) of the module doc's K6b calls."""
    from profile_kernel_ab import k4f32_k6b_calls

    d = cs.make_dataset(**cs.HEADLINE)
    _, real = k4f32_k6b_calls(d, len(d["y"]),
                              crp.get_L_values(d["hK"], d["E"]))
    return real + [
        (f"tail_battery, P = {P}",
         tuple(torch.as_tensor(a, device="cuda")
               for a in tail_battery(P, n=P, C=10)))
        for P in (1024, 4096, 16384)]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", type=Path)
    ap.add_argument("--kernels", default="best_rho_rotate,mixture_tails")
    opt = ap.parse_args()
    picked = opt.kernels.split(",")
    assert set(picked) <= set(VARIANTS), f"--kernels: some of {VARIANTS}"
    libs, ptxas = build(_build.BUILD_DIR / "variants_k4f32_k6b", picked)
    out = {"card": cs.card_line(), "ptxas": ptxas, "calls": []}
    print(json.dumps({"ptxas": ptxas}), flush=True)
    stream = _build.stream_ptr(torch.device("cuda"))
    for label, (V, T, kb) in (k4_calls() if "best_rho_rotate" in picked
                              else []):
        lib = libs["best_rho_rotate"]["as built"]
        At, slot = k4.call(lib, V, T, kb, stream)
        At_p, slot_p = k4.best_rho_rotate_plain(V, T, kb)
        assert torch.equal(slot, slot_p), label
        mags = k4.gather(k4.best_rho_rotate_plain(V.double().abs(),
                                                  T.double().abs(), kb)[0],
                         slot_p)
        cs._f32_sums_check(k4.gather(At, slot), k4.gather(At_p, slot_p),
                           mags, V.shape[1], f"K4-f32 {label}")
        del At, At_p, mags
        torch.cuda.empty_cache()
        row = dict(call=f"best_rho_rotate ({label}, f32)",
                   bound=cs.k4_bound(V, T, kb),
                   clocks=clocks_under_load(lambda: k4.call(lib, V, T, kb,
                                                            stream)),
                   variants=timed(
                       [(v, lambda lib=lib_: k4.call(lib, V, T, kb, stream))
                        for v, lib_ in libs["best_rho_rotate"].items()]))
        out["calls"].append(row)
        print(json.dumps(row), flush=True)
    for label, (Q, lam) in (k6b_calls() if "mixture_tails" in picked
                            else []):
        want = k6b.mixture_tails_plain(Q, lam)
        # each variant that computes the tails, by chip_smoke's rule
        # measured (as built asserted): which part of a design parts
        # from the plain version near the mean
        gaps = {v: cs.tails_gaps(k6b.call(lib_, Q, lam, 40, stream), want,
                                 Q, lam)
                for v, lib_ in libs["mixture_tails"].items()
                if v not in TIMING_ONLY}
        cs.check_tails(k6b.call(libs["mixture_tails"]["as built"], Q, lam,
                                40, stream), want, Q, lam, label)
        ops = cs.k6b_operations(Q.cpu().numpy(), lam.cpu().numpy(), 100)
        row = dict(call=f"mixture_tails ({label})", operations=ops,
                   gaps=gaps,
                   variants=timed(
                       [(v, lambda lib=lib_: k6b.call(lib, Q, lam, 40,
                                                      stream))
                        for v, lib_ in libs["mixture_tails"].items()]))
        out["calls"].append(row)
        print(json.dumps(row), flush=True)
    line = json.dumps(out)
    print(line, flush=True)
    if opt.out:
        opt.out.parent.mkdir(parents=True, exist_ok=True)
        opt.out.write_text(line + "\n")


if __name__ == "__main__":
    main()
