"""Where a kernel wrapper's host time goes, on the card: K8 (``fast_scan``)
on the headline's Ls batch (512 variants at the null's best rho and delta)
and its ``assoc_multigene_16`` tile, and the converge (``reml_converge``)
on K7's zero-step fit at the grid's low end, each on the f64 scanner.

For each call: the wrapper's host milliseconds (``calls`` calls enqueued
back to back after a synchronise, the device never the bound: the
zero-step and K8 calls take 0.01-0.03 ms of device time), then the same
for each of its parts alone: the operand checks, the current stream's
handle (as the wrappers take it, and by ``torch._C._cuda_getCurrentRawStream``),
one ``torch.empty`` on the card, the scratch query through ``ctypes``,
and the C entry point with its outputs and scratch allocated once (its
argument conversion and launches).  Prints one JSON line.

    python3 scripts/profile_wrapper_host.py [--calls 200] [--out FILE]
"""
import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(1, str(Path(__file__).resolve().parent.parent))
import chip_smoke as cs  # noqa: E402
import cellregmap_tpu_torch as crp  # noqa: E402
from cellregmap_tpu_torch import engine  # noqa: E402
from cellregmap_tpu_torch.kernels import _build  # noqa: E402
from cellregmap_tpu_torch.kernels import delta_grid as k2  # noqa: E402
from cellregmap_tpu_torch.kernels import fast_scan as k8  # noqa: E402
from cellregmap_tpu_torch.kernels import reml_newton as k3  # noqa: E402


def host_ms(fn, calls):
    """Mean host milliseconds of ``fn`` over ``calls`` calls."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / calls
    torch.cuda.synchronize()
    return ms


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--calls", type=int, default=200)
    ap.add_argument("--out", type=Path)
    opt = ap.parse_args()
    d = cs.make_dataset(**cs.HEADLINE)
    n = len(d["y"])
    Ls = crp.get_L_values(d["hK"], d["E"])
    G = torch.as_tensor(d["G"][:, :cs.BATCH], device="cuda").contiguous()
    ctx = engine.build_null_context(d["y"], d["W"], d["E"], Ls=Ls,
                                    device="cuda")
    fits, k = engine.null_association_fit(ctx, n,
                                          delta_cfg=cs.ASSOC_DELTA_CFG)
    k = int(k)
    (fs_args, fs_kw), = cs.capture_kernel_inputs(
        lambda: engine.fast_scan_batch(ctx, G, k, float(fits.delta[k]), n),
        ["fast_scan"])["fast_scan"]
    ctx_g = cs._gene_ctx(ctx, cs._multigene_genes(d))
    gfits, kg = engine.null_association_multigene_fit(
        ctx_g, n, delta_cfg=cs.ASSOC_DELTA_CFG)
    delta = gfits.delta[torch.arange(kg.shape[0], device="cuda"),
                        kg].contiguous()
    kg = kg.cpu().numpy()
    (gs_args, gs_kw), = cs.capture_kernel_inputs(
        lambda: engine.fast_scan_multigene_batch(ctx_g, G, kg, delta, n),
        ["fast_scan"])["fast_scan"]
    conv = cs.capture_kernel_inputs(
        lambda: engine.association_refit_batch(
            ctx, G, k, n, delta_cfg=cs.ASSOC_DELTA_CFG),
        ["reml_converge"])["reml_converge"]
    cv_args, cv_kw = conv[1]  # a zero-step fit
    dev = G.device
    lib8 = _build.load("fast_scan", k8._bind)
    lib3 = _build.load("reml_newton", k3._bind)
    stream = _build.stream_ptr(dev)
    S, Wt, yt, CWW, cWy, cyy, Gt, CWG, cGy, cGG = fs_args[1:11]
    R, p = Wt.shape
    nS = Gt.shape[1]
    specs = ((S, "S", (R,)), (Wt, "Wt", (R, p)), (yt, "yt", (R,)),
             (CWW, "CWW", (p, p)), (cWy, "cWy", (p,)), (cyy, "cyy", ()),
             (Gt, "Gt", (R, nS)), (CWG, "CWG", (p, nS)),
             (cGy, "cGy", (nS,)), (cGG, "cGG", (nS,)))
    out8 = [torch.empty(sh, dtype=torch.float64, device=dev)
            for sh in ((nS,), (nS,), (nS, p), (nS,))]
    work8 = torch.empty(lib8.crm_fast_scan_workspace(R, p, nS, 1, 1, 1, 0),
                        dtype=torch.uint8, device=dev)
    ptrs8 = [_build.ptr(t) for t in (*fs_args[1:11], *out8, work8)]
    idx = dev.index
    c = opt.calls
    parts = {
        "fast_scan, the wrapper": host_ms(
            lambda: k8.fast_scan(*fs_args, **fs_kw), c),
        "fast_scan (16 genes), the wrapper": host_ms(
            lambda: k8.fast_scan(*gs_args, **gs_kw), c),
        "reml_converge (K7's zero-step fit), the wrapper": host_ms(
            lambda: k3.reml_converge(*cv_args, **cv_kw), c),
        "fast_scan's checks (require_all)": host_ms(
            lambda: _build.require_all("fast_scan", torch.float64, specs),
            c),
        "reml_converge's checks (check_operands)": host_ms(
            lambda: k2.check_operands("reml_converge", *cv_args[:5],
                                      False), c),
        "stream_ptr": host_ms(lambda: _build.stream_ptr(dev), c),
        "torch._C._cuda_getCurrentRawStream": host_ms(
            lambda: torch._C._cuda_getCurrentRawStream(idx), c),
        "torch.empty on the card": host_ms(
            lambda: torch.empty((nS,), dtype=torch.float64, device=dev), c),
        "crm_fast_scan_workspace (ctypes)": host_ms(
            lambda: lib8.crm_fast_scan_workspace(R, p, nS, 1, 1, 1, 0), c),
        "crm_fast_scan (ctypes call, two launches)": host_ms(
            lambda: lib8.crm_fast_scan(*ptrs8, float(fs_args[0]), n, R, p,
                                       nS, stream), c),
        "crm_reml_converge_workspace (ctypes)": host_ms(
            lambda: lib3.crm_reml_converge_workspace(1, 512, 1), c),
    }
    out = {"card": cs.card_line(), "calls": c, "host_ms": parts,
           "slot_index_cached": bool(k8._INDEX),
           "genes": int(np.asarray(gs_kw["slot"]).size)}
    line = json.dumps(out)
    print(line, flush=True)
    if opt.out:
        opt.out.parent.mkdir(parents=True, exist_ok=True)
        opt.out.write_text(line + "\n")


if __name__ == "__main__":
    main()
