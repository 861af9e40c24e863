"""K2, the delta grid (``csrc/delta_grid.cu``), timed on the card on the
operands its paths give it at the headline size (2000 cells, 10 contexts,
100 donors, batch 512, the bench's synthetic dataset):

* ``reml_f32`` / ``reml_f64``: the interaction batch's grid, hybrid
  localization on and off (K = 64, 11 rho);
* ``ml_k7``: the association refit's ML grid (K = 256, one rho);
* ``genes16``: the gene axis of 16 genes (Y = y + 0.1 N(0, 1), rng 9);
* ``slot16``: the gene-batched refit's grid, the 16 genes on two slots.

Prints one JSON line of CUDA-event medians (ms, 20 runs) and each call's
first-call seconds.  With ``--profile`` it also holds each call against
its plain version (``chip_smoke.check_delta_grid``, the bracket-shortfall
criterion), adds the call at p = 24 with 21 rho (W = [1, 23 columns of
N(0, 1), rng 24]), and prints each kernel's device time a call from
``torch.profiler``, and the time of K3's localize on that call's
operands.

It imports ``chip_smoke`` and ``cellregmap_tpu_torch`` from the path, so
that another checkout's K2 can be timed on the same card in the same call:

    python3 scripts/profile_delta_grid.py [--profile] [--tag NAME]
    (cd <other checkout> && PYTHONPATH=. python3 <this file> --tag other)
"""
import argparse
import json
import sys
import time

import numpy as np
import torch

sys.path.insert(1, ".")
import chip_smoke as cs  # noqa: E402
import cellregmap_tpu_torch as crp  # noqa: E402
from cellregmap_tpu_torch import engine  # noqa: E402
from cellregmap_tpu_torch.kernels import delta_grid as k2  # noqa: E402
from cellregmap_tpu_torch.kernels import reml_newton as k3  # noqa: E402


def captured(run, name="delta_grid"):
    return cs.capture_kernel_inputs(run, [name])[name][0]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--tag", default="this checkout")
    opt = ap.parse_args()

    d = cs.make_dataset(**cs.HEADLINE)
    n = len(d["y"])
    Ls = crp.get_L_values(d["hK"], d["E"])
    ctx = engine.build_null_context(d["y"], d["W"], d["E"], Ls=Ls,
                                    device="cuda")
    G = torch.as_tensor(d["G"][:, :cs.BATCH], device="cuda").contiguous()
    rng = np.random.default_rng(9)
    Yt = torch.as_tensor(d["y"][None] + 0.1 * rng.normal(size=(16, n)),
                         device="cuda")
    ctx_g = ctx._replace(y=Yt, Zy=Yt @ ctx.Z, Wy=Yt @ ctx.W,
                         yy=(Yt * Yt).sum(dim=1))
    calls = {
        "reml_f32": captured(lambda: engine.interaction_batch(
            ctx, G, G, n, delta_cfg=cs.DELTA_CFG)),
        "reml_f64": captured(lambda: engine.interaction_batch(
            ctx, G, G, n, delta_cfg=cs.DELTA_CFG, localize_f32=False)),
        "ml_k7": captured(lambda: engine.association_refit_batch(
            ctx, G, 5, n, delta_cfg=cs.ASSOC_DELTA_CFG)),
        "genes16": captured(lambda: engine.interaction_multigene_batch(
            ctx_g, G, G, n, delta_cfg=cs.DELTA_CFG)),
        "slot16": captured(lambda: engine.association_refit_multigene_batch(
            ctx_g, G, np.array([5] * 8 + [6] * 8), n,
            delta_cfg=cs.ASSOC_DELTA_CFG)),
    }
    out = {"tag": opt.tag, "card": cs.card_line()}
    for name, (args, kw) in calls.items():
        t0 = time.perf_counter()
        k2.delta_grid(*args, **kw)
        torch.cuda.synchronize()
        out[name + "_first_s"] = time.perf_counter() - t0
        out[name] = cs.cuda_ms(lambda: k2.delta_grid(*args, **kw), reps=20)
    print(json.dumps(out), flush=True)
    if opt.profile:
        profile(calls, d, n, Ls, G)


def profile(calls, d, n, Ls, G):
    from torch.profiler import ProfilerActivity, profile as tprofile

    rng = np.random.default_rng(24)
    W = np.concatenate([np.ones((n, 1)), rng.normal(size=(n, 23))], axis=1)
    ctx = engine.build_null_context(d["y"], W, d["E"], Ls=Ls,
                                    rho_grid=np.linspace(0, 1, 21),
                                    device="cuda")
    run = lambda: engine.interaction_batch(  # noqa: E731
        ctx, G, G, n, delta_cfg=cs.DELTA_CFG)
    calls = dict(calls, p24=captured(run))
    for name in ("slot16", "reml_f64"):
        calls.pop(name)
    for name, (args, kw) in calls.items():
        row = cs.check_delta_grid((args, kw), library=name == "reml_f32")
        print(f"{name}: shortfall {row['bracket_shortfall']} ms "
              f"{row['ms']:.4f} library {row['library_ms']} bound "
              f"{row['bound_ms']:.4f}", flush=True)
        fn = lambda: k2.delta_grid(*args, **kw)  # noqa: E731
        fn()
        torch.cuda.synchronize()
        with tprofile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                fn()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            dt = getattr(e, "device_time_total", None)
            if dt is None:
                dt = getattr(e, "cuda_time_total", 0)
            if dt and e.count:
                print(f"  {e.key[:70]:70s} n {e.count:4d} device_us/call "
                      f"{dt / e.count:9.2f}", flush=True)
    args, kw = captured(run, "reml_localize")
    ms = cs.cuda_ms(lambda: k3.reml_localize(*args, **kw), reps=3)
    print(f"localize p24: ms {ms:.3f}", flush=True)


if __name__ == "__main__":
    main()
