"""Where K3's register localize (``csrc/reml_newton.cu``, p + 1 <= 4)
spends its time, on the card, at the headline interaction batch (2000
cells, 10 contexts, 100 donors, 512 variants, 11 rho), at
``multigene_16`` (the same batch, Y = y + 0.1 N(0, 1) over 16 genes, rng
9) and at ``cells10k`` (10 000 cells, 20 contexts, R = 2500, its first
512 variants: the rows staged in chunks), on the batch's own K2 brackets:

* the kernel as it is built, and, from a copy of the source with clock64
  counters added (``clocks``), every warp's sections summed over a call
  (the first Newton pass with the staging, the other Newton passes, the
  passes' epilogues, the final evaluation's pass), as shares of the whole;
* variants of the source, each timed beside the rest in one process
  (CUDA-event medians of 10, in the order given and then reversed):
  ``chunked`` (``-DCRM_LOC_CHUNKED``: the rows staged in chunks through
  two raw buffers, as where they do not fit), ``g_only`` (the variants'
  g W and g g never staged but formed in the sums, as where they do not
  fit: at ``multigene_16`` the one resident layout against the other),
  ``no_min_blocks`` (launch
  bounds with no minimum of blocks: the compiler then keeps 64
  registers), ``drcp`` (the weights' reciprocal by ``__drcp_rn``), and,
  timed but not held to the plain version, ``no_div`` (no reciprocal) and
  ``no_rows`` (no sums: what the staging, the barriers and the
  epilogues cost alone).

Each variant that is held matches the plain version (k_best equal, x
within rel 1e-9, lml within rel 1e-10).  Prints one JSON line;
``--out`` also writes it to a file.

With ``--f32`` the float32 localize (``crm_reml_localize_f32``) instead,
on ``profile_kernel_ab.py``'s ``k3loc32`` screen batches (1024 variants
of the headline's context cast to f32, p = 1 and p = 7), each variant
held by ``chip_smoke.check_localize_f32``'s rule: the kernel as built,
``clocks`` (the same sections: at p = 7 the wide kernel's rows with
their shuffle trees, and as "epilogues" its barriers and algebra),
``products`` (the variants' g W and g g staged too, by the f64 path's
synchronous staging), ``even_stride`` (the resident rows rch values
apart, a multiple of 32), ``reg8x3`` (p = 1: eight warps a block, three
blocks an SM, 80 registers), ``reg8x3_unroll1`` and ``reg16x2_unroll1``
(three blocks of eight warps, or two of sixteen, an SM, the rows' loop
not unrolled), ``wide_g4`` (p = 7: four warps a problem,
two problems a block), ``wide_blocks1`` (p = 7: one block an SM) and,
not held, ``no_rows``.

    python3 scripts/profile_localize.py [--f32] [--variants a,b]
        [--out FILE]
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
from profile_kernel_ab import (f32_localize_calls,  # noqa: E402
                               rotate_localize_calls)

SOURCE = (_build.CSRC / "reml_newton.cu").read_text()
SECTIONS = ("first pass", "other passes", "epilogues", "final pass")


def edit(text, old, new):
    assert old in text, old
    return text.replace(old, new)


def no_rows(text):
    for a in ("    if (active && products)\n", "    else if (active)\n",
              "    if (active)  // the fields, and W and g from the raw"):
        text = edit(text, a, a.replace("active", "active && delta < -1.0", 1))
    a = "      if (active)\n        lw_rows_of<P1MAX, G, 3>"
    return edit(text, a, a.replace("active", "active && delta < -1.0f", 1))


# the clock64 sections: every warp's lane 0 adds the clocks since its last
# mark to one of four device counters, which crm_reml_localize_clocks
# copies out and zeroes
CLOCKS = """
__device__ unsigned long long loc_clocks[4];
#define LOC_CLOCK(k)                                                  \\
  if (lane == 0) {                                                    \\
    const long long now = clock64();                                  \\
    atomicAdd(&loc_clocks[k], (unsigned long long)(now - loc_t0));    \\
    loc_t0 = now;                                                     \\
  }
"""
CLOCKS_OUT = """
extern "C" int crm_reml_localize_clocks(unsigned long long* out) {
  int err = (int)cudaMemcpyFromSymbol(out, loc_clocks, sizeof(loc_clocks));
  const unsigned long long zero[4] = {0, 0, 0, 0};
  if (!err) err = (int)cudaMemcpyToSymbol(loc_clocks, zero, sizeof(zero));
  return err;
}
"""


def clocks(text):
    smem = "constexpr int LOC_SMEM = CRM_LOC_SMEM_KB * 1024;"
    text = edit(text, smem, smem + CLOCKS)
    a = "  // stage 1b: Newton on the (possibly f32-rounded) tensors\n"
    text = edit(text, a, "  long long loc_t0 = clock64();\n" + a)
    a = "                       ex2);\n    if (active) {\n"
    text = edit(text, a, a.replace("    if",
                                   "    LOC_CLOCK(it == 0 ? 0 : 1)\n    if"))
    a = "      newton_update(delta, Lp, Lpp, x, lo, hi);\n    }\n"
    text = edit(text, a, a + "    LOC_CLOCK(2)\n")
    a = "                     logd, unused);\n  if (!active) return;\n"
    text = edit(text, a, a.replace("  if (!", "  LOC_CLOCK(3)\n  if (!"))
    a = "                                                logd, beta, rss, bad);\n"
    text = edit(text, a, a + "  LOC_CLOCK(2)\n")
    # the wide f32 kernel: its rows and trees, its barriers and algebra
    a = "  // stage 1b: f32 steps\n"
    text = edit(text, a, "  long long loc_t0 = clock64();\n" + a)
    a = "    if (active) lw_publish<P1MAX, G, 3>(j, wsf, acc);\n"
    text = edit(text, a, a + "    LOC_CLOCK(it == 0 ? 0 : 1)\n")
    a = "    if (active) x = xs[v];  // the problem's other warps take its iterate\n"
    text = edit(text, a, a + "    LOC_CLOCK(2)\n")
    a = "  if (active) lw_publish<P1MAX, G, 1>(j, wsd, acc);\n"
    text = edit(text, a, a + "  LOC_CLOCK(3)\n")
    return text + CLOCKS_OUT


W1 = ("  if constexpr (std::is_same<T, double>::value) return A(1) / d;\n"
      "  else if constexpr (std::is_same<A, float>::value) return __frcp_rn(d);"
      "\n  else return rcp_nr(d);")
BOUNDS = "__launch_bounds__(32 * loc_warps<T, P1MAX>(), 1)"
ROWS = "  for (int rr = threadIdx.x % 32; rr < rows; rr += 32) {\n    const A d ="
WIDE_BOUNDS = "__launch_bounds__(32 * LW_WARPS, P1MAX <= 8 ? 2 : 1)"
# name -> (source text, -D defines, held to the plain version)
VARIANTS = {
    "as built": (SOURCE, (), True),
    "clocks": (clocks(SOURCE), (), True),
    "chunked": (SOURCE, ("CRM_LOC_CHUNKED",), True),
    "g_only": (edit(SOURCE, "!F32 && fits(LOC_PRODUCTS) ? LOC_PRODUCTS",
                    "false ? LOC_PRODUCTS"), (), True),
    "no_min_blocks": (edit(SOURCE, BOUNDS, BOUNDS.replace(", 1)", ")")), (),
                      True),
    "drcp": (edit(SOURCE, W1, W1.replace("A(1) / d", "__drcp_rn(d)", 1)),
             (), True),
    "no_div": (edit(SOURCE, W1, W1.replace("A(1) / d", "d", 1)), (), False),
    "no_rows": (no_rows(SOURCE), (), False),
}
F32_VARIANTS = {
    "as built": (SOURCE, (), True),
    "clocks": (clocks(SOURCE), (), True),
    "products": (edit(edit(SOURCE, "!F32 && fits(LOC_PRODUCTS)",
                           "fits(LOC_PRODUCTS)"),
                      "if constexpr (std::is_same<T, float>::value)  // LOC_G",
                      "if constexpr (false)  // LOC_G"), (), True),
    "even_stride": (edit(SOURCE, "(F32 ? 1 : 0)", "0"), (), True),
    "reg8x3": (edit(edit(SOURCE, BOUNDS, BOUNDS.replace(
        ", 1)", ", std::is_same<T, float>::value && P1MAX == 2 ? 3 : 1)")),
        "return std::is_same<T, float>::value && P1MAX > 2 && LOC_MAX_WARPS > 8",
        "return std::is_same<T, float>::value && LOC_MAX_WARPS > 8"), (), True),
    "reg8x3_unroll1": (edit(edit(edit(SOURCE, BOUNDS, BOUNDS.replace(
        ", 1)", ", std::is_same<T, float>::value && P1MAX == 2 ? 3 : 1)")),
        "return std::is_same<T, float>::value && P1MAX > 2 && LOC_MAX_WARPS > 8",
        "return std::is_same<T, float>::value && LOC_MAX_WARPS > 8"), ROWS,
        "#pragma unroll 1\n" + ROWS), (), True),
    "reg16x2_unroll1": (edit(edit(SOURCE, BOUNDS, BOUNDS.replace(
        ", 1)", ", std::is_same<T, float>::value && P1MAX == 2 ? 2 : 1)")),
        ROWS, "#pragma unroll 1\n" + ROWS), (), True),
    "wide_g4": (edit(SOURCE, "launch_localize_wide<8, 2>",
                     "launch_localize_wide<8, 4>"), (), True),
    "wide_blocks1": (edit(SOURCE, WIDE_BOUNDS,
                          WIDE_BOUNDS.replace("P1MAX <= 8 ? 2 : 1", "1")),
                     (), True),
    "no_rows": (no_rows(SOURCE), (), False),
}


def build(work, variants):
    """Every variant built in parallel beside the package's build."""
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
    _build.build_all()  # the package, for the engine's paths, meanwhile
    libs, ptxas = {}, {}
    for name, (i, proc) in procs.items():
        log, _ = proc.communicate()
        assert proc.returncode == 0, log
        ptxas[name] = [r for r in cs.ptxas_report(log)
                       if r.startswith("localize_")]
        lib = ctypes.CDLL(str(work / f"libreml_newton_{i}.so"))
        k3._bind(lib)
        libs[name] = lib
    lib = libs["clocks"]
    lib.crm_reml_localize_clocks.restype = ctypes.c_int
    lib.crm_reml_localize_clocks.argtypes = [ctypes.c_void_p]
    return libs, ptxas


def held_f32(got, want):
    """``chip_smoke.check_localize_f32``'s rule."""
    _, lml, kb = got
    fin = torch.isfinite(want[1])
    assert torch.equal(torch.isfinite(lml), fin)
    scale = want[1].abs().clamp(min=1.0)
    assert float(((lml - want[1]).abs() / scale)[fin].max()) <= 1e-6
    best = want[1].amax(dim=-1)
    at_k = want[1].gather(-1, kb[..., None])[..., 0]
    assert float(((best - at_k) / best.abs().clamp(min=1.0)).max()) <= 1e-6


def held_f64(got, want):
    x, lml, kb = got
    assert torch.equal(kb, want[2])
    assert cs._rel(x, want[0]) <= 1e-9
    assert cs._rel(lml, want[1]) <= 1e-10


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", type=Path)
    ap.add_argument("--f32", action="store_true")
    ap.add_argument("--variants", help="some of the variants, by name")
    opt = ap.parse_args()
    variants = F32_VARIANTS if opt.f32 else VARIANTS
    if opt.variants:
        picked = ["as built", "clocks", *opt.variants.split(",")]
        variants = {k: v for k, v in variants.items() if k in picked}
    libs, ptxas = build(_build.BUILD_DIR / "profile_localize", variants)
    out = {"card": cs.card_line(), "ptxas": ptxas, "calls": []}
    d = cs.make_dataset(**cs.HEADLINE)
    n = len(d["y"])
    G = torch.as_tensor(d["G"][:, :cs.BATCH], device="cuda").contiguous()
    stream = _build.stream_ptr(G.device)
    Ls = crp.get_L_values(d["hK"], d["E"])
    if opt.f32:
        calls = [(label, call) for label, call in
                 f32_localize_calls(d, n, Ls) if "screen" in label]
    else:
        calls = [(label, call) for label, _, call, _ in
                 rotate_localize_calls(d, n, G, Ls)]
    held = held_f32 if opt.f32 else held_f64
    for label, (args, kw) in calls:
        want = k3.reml_localize_plain(*args, **kw)
        row = {"call": label, "ms": {}, "device_ms": {}}
        order = list(libs.items())
        for name, lib in order + order[::-1]:
            fn = lambda lib=lib: k3.call_localize(  # noqa: E731
                lib, *args, **kw, stream=stream)
            if variants[name][2]:
                got = fn()
                torch.cuda.synchronize()
                try:
                    held(got, want)
                except AssertionError as e:
                    raise AssertionError(f"{name}, {label}") from e
            row["ms"].setdefault(name, []).append(cs.cuda_ms(fn, reps=10))
        for name, lib in order:
            try:
                row["device_ms"][name] = cs.device_split(
                    lambda lib=lib: k3.call_localize(lib, *args, **kw,
                                                     stream=stream))
            except AssertionError:  # the profiler saw no kernel
                row["device_ms"][name] = None
        buf = (ctypes.c_ulonglong * len(SECTIONS))()
        assert libs["clocks"].crm_reml_localize_clocks(buf) == 0  # zeroed
        k3.call_localize(libs["clocks"], *args, **kw, stream=stream)
        torch.cuda.synchronize()
        assert libs["clocks"].crm_reml_localize_clocks(buf) == 0
        total = sum(buf)  # 0 where the register localize did not run
        row["clock_share"] = ({k: v / total for k, v in zip(SECTIONS, buf)}
                              if total else None)
        print(json.dumps(row), flush=True)
        out["calls"].append(row)
    line = json.dumps(out)
    print(line, flush=True)
    if opt.out:
        opt.out.parent.mkdir(parents=True, exist_ok=True)
        opt.out.write_text(line + "\n")


if __name__ == "__main__":
    main()
