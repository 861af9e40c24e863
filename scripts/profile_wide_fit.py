"""Where K10 (``csrc/null_fit.cu``) spends its time, on the card, from a copy
of the source with clock64 sections added (``clocks``; the package's
source has none):

* the narrow instantiation (p <= 16), at the headline's association null
  fit (the Ls scanner: p = 1, R = 1000, 11 rho, 256 grid points, 60
  golden-section steps, ML), the aggregate environment's mean fit (p =
  12, REML) and the ``assoc_multigene_16`` tile's null fit (16 genes, p =
  1): on block (0, 0, 0) of each launch, the grid kernel's evaluations,
  the golden section (its argmax and 2 + n_iters evaluations) and the
  final fit, and every pass over the rows (an evaluation) split into the
  rows (the weights and the tiles' sums, the
  chunks' barriers included), the shuffles (with the partials' stores),
  the wait at the barrier after them, the factorization (warp 0, or a
  warp a delta at p = 1) and the wait at the barrier that ends the pass,
  in cycles a pass (the second wait holds the last warp's work for the
  golden section's next step);
* variants of the source (``VARIANTS``), each built and run the same way,
  with its device milliseconds (among them p = 1 through the 2 x 2 tiles'
  path, and the gene axis's grid a block a gene instead of a block a tile
  of genes);
* the wide instantiation (p > 16), at the aggregate environment's mean
  fit at 50 contexts (``chip_smoke.WIDE``: p = 52, R = 2000, 11 rho, 256
  grid points, 60 golden-section steps): the golden section's steps on
  one block of rho point 0 (the previous point's factorization from its
  gathered partial sums, then this point's partial sums over the block's
  rows), in cycles a step;
* the profiler's device milliseconds of each kernel of each call, and of
  the wide fit at ``n_iters`` 60 and 0 and at R and R / 2 rows, so that
  an evaluation's cost and its part that scales with R read as
  differences.

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
import cellregmap_tpu_torch as crp  # noqa: E402
from cellregmap_tpu_torch import engine  # noqa: E402
from cellregmap_tpu_torch.kernels import _build  # noqa: E402
from cellregmap_tpu_torch.kernels import null_fit as k10  # noqa: E402

SOURCE = (_build.CSRC / "null_fit.cu").read_text()
SECTIONS = ("wide factorization", "wide partial sums", "narrow grid",
            "narrow golden section", "narrow final fit", "eval rows",
            "eval wait 1", "eval wait 2", "eval shuffles", "eval factor")
PASS = ("eval rows", "eval shuffles", "eval wait 1", "eval factor",
        "eval wait 2")

# the clock64 sections: thread 0 of block (0, 0, 0) adds the clocks since
# its last mark to a device counter, which crm_null_fit_clocks copies out
# and zeroes
CLOCKS = """
__device__ unsigned long long nf_clocks[10];
#define NF_FIRST (threadIdx.x == 0 && blockIdx.x == 0 && blockIdx.y == 0 && \\
                  blockIdx.z == 0)
#define NF_CLOCK(k)                                                   \\
  if (NF_FIRST) {                                                     \\
    const long long now = clock64();                                  \\
    atomicAdd(&nf_clocks[k], (unsigned long long)(now - nf_t0));      \\
    nf_t0 = now;                                                      \\
  }
#define NF_ECLOCK(k)                                                  \\
  if (NF_FIRST) {                                                     \\
    const long long now = clock64();                                  \\
    atomicAdd(&nf_clocks[k], (unsigned long long)(now - nf_e0));      \\
    nf_e0 = now;                                                      \\
  }
"""
CLOCKS_OUT = """
extern "C" int crm_null_fit_clocks(unsigned long long* out) {
  int err = (int)cudaMemcpyFromSymbol(out, nf_clocks, sizeof(nf_clocks));
  const unsigned long long zero[10] = {0};
  if (!err) err = (int)cudaMemcpyToSymbol(nf_clocks, zero, sizeof(zero));
  return err;
}
"""


def edit(text, old, new):
    assert old in text, old
    return text.replace(old, new, 1)


def after(text, anchor, add):
    return edit(text, anchor, anchor + add)


def before(text, anchor, add):
    return edit(text, anchor, add + anchor)


def clocks(text):
    text = before(text, "struct WideSh {", CLOCKS)
    # the wide golden step: the factorization, then the partial sums
    text = after(text, "  double* st_now = state + ((step & 1) * problems "
                 "+ gr) * NSTATE;\n", "  long long nf_t0 = clock64();\n")
    text = before(text, "  const double dl = sigmoid(x);\n", "  NF_CLOCK(0)\n")
    text = after(text, "  if (threadIdx.x == 0) part_now[split * nsum + nsum "
                 "- 1] = logd;\n", "  NF_CLOCK(1)\n")
    # a narrow evaluation (a pass over the rows): rows, reduction, factor
    text = after(text, "  const double invd = 1.0 / delta;    // off the "
                 "factorization's path\n", "  long long nf_e0 = clock64();\n")
    text = before(text, "  // the tile's row groups (xor shuffles within "
                  "their segment of the warp)\n", "  NF_ECLOCK(5)\n")
    text = before(text, "  __syncthreads();\n  if (warp == 0) {\n    if "
                  "(fused)\n", "  NF_ECLOCK(8)\n")
    text = before(text, "  if (warp == 0) {\n    if (fused)\n",
                  "  NF_ECLOCK(6)\n")
    text = before(text, "  if (tid == 32 * (NT / 32 - 1)) side();",
                  "  NF_ECLOCK(9)\n")
    text = before(text, "  scale = sh.val[1];\n  rss = sh.val[2];\n  return "
                  "sh.val[0];\n", "  NF_ECLOCK(7)\n")
    # the narrow grid, golden section and final fit
    text = after(text, "  const int k0 = blockIdx.x * gpb, k1 = min(n_grid, "
                 "k0 + gpb);\n", "  long long nf_t0 = clock64();\n")
    text = after(text, "    if (threadIdx.x == 0) vals[gr * n_grid + k] = "
                 "v;\n  }\n", "  NF_CLOCK(2)\n")
    # the gene-tiled grid (p = 1): its points, after the staging
    text = after(text, "  const double nn = reml ? n - 1 : n;\n",
                 "  long long nf_t0 = clock64();\n")
    text = after(text, "               : -0.5 * (nn * l2pi + logdet_d + nn);"
                 "\n    }\n  }\n", "  NF_CLOCK(2)\n")
    text = before(text, "  // argmax (a NaN wins and stops the scan, as "
                  "torch's and jnp's argmax)\n  const double* vr",
                  "  long long nf_t0 = clock64();\n")
    text = before(text, "    if (last) {\n      lml = f;\n",
                  "    if (last) { NF_CLOCK(4) } else { NF_CLOCK(3) }\n")
    return text + CLOCKS_OUT


def edit_variant(text, old, new):
    assert old in text, old
    return text.replace(old, new)


# name -> the source; each is held to the plain version
VARIANTS = {
    "as built": SOURCE,
    # the weights by the library's division
    "library division": edit_variant(edit_variant(
        SOURCE, "    const double w = gram ? 1.0 : rcp_nr(d);\n",
        "    const double w = gram ? 1.0 : 1.0 / d;\n"),
        "    wv[r] = gram ? 1.0 : rcp_nr(d);\n",
        "    wv[r] = gram ? 1.0 : 1.0 / d;\n"),
    # the grid kernel's registers not held down (one to three blocks an SM)
    "grid registers free": edit_variant(
        SOURCE, "__global__ void __launch_bounds__(NT, TS == 2 ? 4 : 1)\n"
        "null_fit_narrow_grid_kernel(",
        "__global__ void __launch_bounds__(NT)\n"
        "null_fit_narrow_grid_kernel("),
    # the next point made by every thread after the decision
    "no speculation": edit_variant(
        SOURCE, "                                     scale, rss, next);\n",
        "                                     scale, rss);\n    next();\n"),
    # p = 1 through the 2 x 2 tiles' path (the weights a pass of their own,
    # the factorization in shared memory) instead of its fused one
    "p = 1 on the tiles": edit_variant(
        SOURCE, "const bool fused = g.ntiles == 1;",
        "const bool fused = false;"),
    # the gene axis's grid a block per (points, rho, gene), as at p > 1,
    # instead of a block per (points, rho, tile of genes)
    "grid a gene a block": edit_variant(
        SOURCE, "  if (p != 1 || genes < 2) return 0;\n", "  return 0;\n"),
}


def clocks_libraries(texts):
    """Each of ``texts`` (name -> source) built beside the package's build
    (the package's headers on the include path), with ``-Xptxas -v``, one
    nvcc each, all at once; returns (name -> library, name -> report)."""
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, text) in enumerate(texts.items()):
        src = _build.BUILD_DIR / f"null_fit_clocks{i}.cu"
        out = _build.BUILD_DIR / f"libnull_fit_clocks{i}.so"
        src.write_text(text)
        procs[name] = (out, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-I",
             str(_build.CSRC), "-o", str(out), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs, reports = {}, {}
    for name, (out, proc) in procs.items():
        log, _ = proc.communicate()
        assert proc.returncode == 0, log
        lib = ctypes.CDLL(str(out))
        k10._bind(lib)
        lib.crm_null_fit_clocks.restype = ctypes.c_int
        lib.crm_null_fit_clocks.argtypes = [ctypes.c_void_p]
        libs[name], reports[name] = lib, [
            r for r in cs.ptxas_report(log) if "narrow" in r]
    return libs, reports


def gene_tiles(args, variant):
    """Blocks of genes of a narrow fit's grid launch (``narrow_gene_tile``:
    at p = 1, up to 16 genes a tile while the rows fit in 200 KB; else a
    gene a block)."""
    data = args[0]
    genes = data.yt.shape[0] if data.yt.ndim == 3 else 1
    R, p = data.S.shape[1], data.Xt.shape[2]
    most = min(16, 200 * 1024 // (8 * R) - 2)
    if variant == "grid a gene a block" or p != 1 or genes < 2 or most < 2:
        return genes
    return -(-genes // most)


def grid_points_of_block0(args, variant):
    """The grid points of block (0, 0, 0) of a narrow fit's grid launch."""
    data, _, _, _, _, n_grid, _ = args
    problems = gene_tiles(args, variant) * data.S.shape[0]
    return min(n_grid, max(8, -(-problems * n_grid // 1056)))


def passes_of_block0(args, variant):
    """Passes over the rows (evaluations) that block (0, 0, 0) of a narrow
    fit's launches makes: logdet(X^T X) (REML), the first grid tile's
    points (none where a tile of genes takes the grid: its passes have no
    sections), the golden section's 2 + n_iters and the final fit."""
    _, _, restricted, _, _, _, n_iters = args
    yt = args[0].yt
    tiled = gene_tiles(args, variant) < (yt.shape[0] if yt.ndim == 3 else 1)
    grid = 0 if tiled else grid_points_of_block0(args, variant)
    return int(restricted) + grid + n_iters + 3


def sections(lib, args, kw):
    """The clock64 sections of one call through ``lib``."""
    buf = (ctypes.c_ulonglong * len(SECTIONS))()
    assert lib.crm_null_fit_clocks(buf) == 0            # zeroed
    got = k10.call(lib, *args, **kw, stream=_build.stream_ptr("cuda"))
    torch.cuda.synchronize()
    assert lib.crm_null_fit_clocks(buf) == 0
    return dict(zip(SECTIONS, buf)), got


def narrow_calls():
    """(label, (args, kw)) of the narrow fits the module doc lists."""
    d = cs.make_dataset(**cs.HEADLINE)
    n = len(d["y"])
    ctx = engine.build_null_context(d["y"], d["W"], d["E"],
                                    Ls=crp.get_L_values(d["hK"], d["E"]),
                                    device="cuda")
    ctx_g = cs._gene_ctx(ctx, cs._multigene_genes(d))
    cap = lambda run: cs.capture_kernel_inputs(  # noqa: E731
        run, ["null_fit"])["null_fit"][0]
    return [("headline Ls, p = 1", cap(lambda: engine.null_association_fit(
                ctx, n, delta_cfg=cs.ASSOC_DELTA_CFG))),
            ("aggregate environment, p = 12",
             cs.aggregate_fit_call(d, crp.ScanConfig())),
            ("genes", cap(lambda: engine.null_association_multigene_fit(
                ctx_g, n, delta_cfg=cs.ASSOC_DELTA_CFG)))]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", type=Path)
    ap.add_argument("--source", type=Path, nargs="*", default=[])
    opt = ap.parse_args()
    spec = importlib.util.spec_from_file_location(
        "profile_kernel_ab", ROOT / "scripts" / "profile_kernel_ab.py")
    ab = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ab)
    out = {"card": cs.card_line(), "ptxas": {}, "narrow": {}}
    texts = {name: clocks(text) for name, text in VARIANTS.items()}
    texts.update({str(src): clocks(src.read_text()) for src in opt.source})
    libs, out["ptxas"] = clocks_libraries(texts)
    lib = libs["as built"]

    for label, (args, kw) in narrow_calls():
        data, n, restricted, _, _, n_grid, n_iters = args
        plain = k10.null_fit_plain(*args, **kw)
        problems = data.yt.numel() // data.yt.shape[-1]
        rows = {}
        for name, vlib in libs.items():
            passes = passes_of_block0(args, name)
            gpb = grid_points_of_block0(args, name)
            cyc, got = sections(vlib, args, kw)
            gaps = k10.fit_gaps(got, plain, data, n, restricted)
            assert max(gaps.values()) <= 1e-10, f"{label} {name}: {gaps}"
            rows[name] = dict(
                cycles_a_grid_eval=cyc["narrow grid"] / gpb,
                cycles_a_golden_step=cyc["narrow golden section"]
                / (n_iters + 2),
                cycles_final_fit=cyc["narrow final fit"],
                cycles_a_pass={k: cyc[k] / passes for k in PASS},
                device_ms=cs.device_split(
                    lambda a=args, k=kw, vlib=vlib: k10.call(
                        vlib, *a, **k, stream=_build.stream_ptr("cuda"))))
        out["narrow"][label] = dict(
            shapes=dict(genes=problems // data.S.shape[0],
                        nrho=data.S.shape[0], R=data.S.shape[1],
                        p=data.Xt.shape[2], n_grid=n_grid, n_iters=n_iters),
            variants=rows)
        print(json.dumps({label: out["narrow"][label]}), flush=True)

    args, kw = ab.k10_wide_call()
    data, n, restricted, lo, hi, n_grid, n_iters = args
    out["shapes"] = dict(nrho=data.S.shape[0], R=data.S.shape[1],
                         p=data.Xt.shape[2], n_grid=n_grid, n_iters=n_iters)
    wide = ("wide factorization", "wide partial sums")
    cyc, _ = sections(lib, args, kw)
    out["cycles_a_step"] = {k: cyc[k] / (n_iters + 3) for k in wide}
    total = sum(out["cycles_a_step"].values())
    out["share"] = {k: c / total for k, c in out["cycles_a_step"].items()}
    out["variants"] = {}
    for src in opt.source:
        cyc, _ = sections(libs[str(src)], args, kw)
        out["variants"][str(src)] = {k: cyc[k] / (n_iters + 3) for k in wide}

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
