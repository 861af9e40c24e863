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

    python3 scripts/profile_localize.py [--out FILE]
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
from profile_kernel_ab import rotate_localize_calls  # noqa: E402

SOURCE = (_build.CSRC / "reml_newton.cu").read_text()
SECTIONS = ("first pass", "other passes", "epilogues", "final pass")


def edit(text, old, new):
    assert old in text, old
    return text.replace(old, new)


def no_rows(text):
    for a in ("    if (active && products)\n", "    else if (active)\n",
              "    if (active)  // the fields, and W and g from the raw"):
        text = edit(text, a, a.replace("active", "active && delta < -1.0", 1))
    return text


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
    a = "                                            logd, beta, rss, bad);\n"
    text = edit(text, a, a + "  LOC_CLOCK(2)\n")
    return text + CLOCKS_OUT


W1 = "    const double w1 = 1.0 / d;\n    double wf[NF];\n    wf[0] = w1;"
# name -> (source text, -D defines, held to the plain version)
VARIANTS = {
    "as built": (SOURCE, (), True),
    "clocks": (clocks(SOURCE), (), True),
    "chunked": (SOURCE, ("CRM_LOC_CHUNKED",), True),
    "g_only": (edit(SOURCE, "fits(LOC_PRODUCTS) ? LOC_PRODUCTS",
                    "false ? LOC_PRODUCTS"), (), True),
    "no_min_blocks": (edit(SOURCE, "__launch_bounds__(32 * LOC_MAX_WARPS, 1)",
                           "__launch_bounds__(32 * LOC_MAX_WARPS)"), (), True),
    "drcp": (edit(SOURCE, W1, W1.replace("1.0 / d", "__drcp_rn(d)")), (),
             True),
    "no_div": (edit(SOURCE, W1, W1.replace("1.0 / d", "d")), (), False),
    "no_rows": (no_rows(SOURCE), (), False),
}


def build(work):
    """Every variant built in parallel beside the package's build."""
    work.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, (text, defines, _)) in enumerate(VARIANTS.items()):
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
                       if r.startswith("localize_kernel")]
        lib = ctypes.CDLL(str(work / f"libreml_newton_{i}.so"))
        k3._bind(lib)
        libs[name] = lib
    lib = libs["clocks"]
    lib.crm_reml_localize_clocks.restype = ctypes.c_int
    lib.crm_reml_localize_clocks.argtypes = [ctypes.c_void_p]
    return libs, ptxas


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", type=Path)
    opt = ap.parse_args()
    libs, ptxas = build(_build.BUILD_DIR / "profile_localize")
    out = {"card": cs.card_line(), "ptxas": ptxas, "calls": []}
    d = cs.make_dataset(**cs.HEADLINE)
    n = len(d["y"])
    G = torch.as_tensor(d["G"][:, :cs.BATCH], device="cuda").contiguous()
    stream = _build.stream_ptr(G.device)
    for label, _, (args, kw) in rotate_localize_calls(
            d, n, G, crp.get_L_values(d["hK"], d["E"])):
        xp, lp, kbp = k3.reml_localize_plain(*args, **kw)
        row = {"call": label, "ms": {}}
        order = list(libs.items())
        for name, lib in order + order[::-1]:
            fn = lambda lib=lib: k3.call_localize(  # noqa: E731
                lib, *args, **kw, stream=stream)
            if VARIANTS[name][2]:
                x, lml, kb = fn()
                torch.cuda.synchronize()
                assert torch.equal(kb, kbp), (name, label)
                assert cs._rel(x, xp) <= 1e-9, (name, label)
                assert cs._rel(lml, lp) <= 1e-10, (name, label)
            row["ms"].setdefault(name, []).append(cs.cuda_ms(fn, reps=10))
        buf = (ctypes.c_ulonglong * len(SECTIONS))()
        assert libs["clocks"].crm_reml_localize_clocks(buf) == 0  # zeroed
        k3.call_localize(libs["clocks"], *args, **kw, stream=stream)
        torch.cuda.synchronize()
        assert libs["clocks"].crm_reml_localize_clocks(buf) == 0
        total = sum(buf)
        row["clock_share"] = {k: v / total for k, v in zip(SECTIONS, buf)}
        print(json.dumps(row), flush=True)
        out["calls"].append(row)
    line = json.dumps(out)
    print(line, flush=True)
    if opt.out:
        opt.out.parent.mkdir(parents=True, exist_ok=True)
        opt.out.write_text(line + "\n")


if __name__ == "__main__":
    main()
