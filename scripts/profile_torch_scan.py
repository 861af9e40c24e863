"""Where a scan batch's time goes on the card (PyTorch port).

Runs the port's ``scan_interaction`` at the bench's headline size (2000
cells, 10 contexts, 100 donors, 2048 variants, batch 512) once to warm up,
then once under ``torch.profiler`` with CPU and CUDA activities, and prints:

* the card (nvidia-smi name and power limit);
* device time by kernel (``key_averages``), the hand-written kernels (K1,
  K2, K3, K4, K5) apart from the rest, and the device kernels per batch;
* the device's busy time against the profiled wall time (its idle share);
* the scan's seconds with ``hybrid_localization`` on and off, five
  alternating pairs on the same card, and the p-value gap between them;
* five end-to-end ``run_interaction`` runs (setup included).

With ``--table PATH`` it also writes torch's full ``key_averages`` table
there.

    python3 scripts/profile_torch_scan.py [--table PATH]
"""
import argparse
import dataclasses
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke  # noqa: E402
import cellregmap_tpu_torch as crp  # noqa: E402

OURS = ("kr_contract_kernel", "delta_grid_kernel", "localize_kernel",
        "converge_kernel", "rotate_", "score_core_kernel")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--table", help="write the key_averages table here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_scan: no CUDA device", file=sys.stderr)
        return 1
    card = chip_smoke.card_line()
    d = chip_smoke.make_dataset(**chip_smoke.HEADLINE)
    cfg = crp.ScanConfig(snp_batch=chip_smoke.BATCH)
    crm = crp.CellRegMap(y=d["y"], E=d["E"], W=d["W"],
                         Ls=crp.get_L_values(d["hK"], d["E"]), config=cfg,
                         device="cuda")
    crm.scan_interaction(d["G"][:, : cfg.snp_batch])   # warm-up + setup
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        crm.scan_interaction(d["G"])
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0

    # kernel-level rows: device events only (no CPU-op double counting)
    rows = {}
    n_launch = {}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            us = float(evt.time_range.elapsed_us())
            rows[evt.name] = rows.get(evt.name, 0.0) + us
            n_launch[evt.name] = n_launch.get(evt.name, 0) + 1
    busy_us = sum(rows.values())
    ours_us = {k: sum(v for n, v in rows.items() if k in n) for k in OURS}
    top = sorted(rows.items(), key=lambda kv: -kv[1])[:25]

    if args.table:
        os.makedirs(os.path.dirname(args.table) or ".", exist_ok=True)
        with open(args.table, "w") as f:
            f.write(card + "\n")
            f.write(prof.key_averages().table(
                sort_by="self_device_time_total", row_limit=60))
    summary = {
        "card": card, "n_snps": d["G"].shape[1], "batch": cfg.snp_batch,
        "wall_s": wall_s, "device_busy_s": busy_us / 1e6,
        "device_idle_share": 1.0 - busy_us / 1e6 / wall_s,
        "n_device_kernels": int(sum(n_launch.values())),
        "device_kernels_per_batch": sum(n_launch.values())
        / -(-d["G"].shape[1] // cfg.snp_batch),
        "ours_s": {k: v / 1e6 for k, v in ours_us.items()},
        "top_kernels": [{"name": n[:90], "s": us / 1e6,
                         "launches": n_launch[n]} for n, us in top],
        "hybrid_vs_f64": hybrid_vs_f64(d, crm, cfg),
        "run_interaction_s": end_to_end(d, cfg),
    }
    print(json.dumps(summary, indent=1))
    return 0


def end_to_end(d, cfg, runs=5):
    """Seconds of ``run_interaction`` (setup + scan of all variants) over
    ``runs`` repeats: every sample, the median and the extremes."""
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        crp.run_interaction(y=d["y"], E=d["E"], G=d["G"], W=d["W"],
                            hK=d["hK"], config=cfg, device="cuda")
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return {"samples": times, "median": statistics.median(times),
            "min": min(times), "max": max(times)}


def hybrid_vs_f64(d, crm_hybrid, cfg_hybrid, pairs=5):
    """Scan seconds with ``hybrid_localization`` on and off, in turns
    (on, off, off, on, ...) on one card, plus their p-value gap."""
    cfg = dataclasses.replace(cfg_hybrid, hybrid_localization=False)
    crm_f64 = crp.CellRegMap(y=d["y"], E=d["E"], W=d["W"],
                             Ls=crp.get_L_values(d["hK"], d["E"]),
                             config=cfg, device="cuda")
    crm_f64.scan_interaction(d["G"][:, : cfg.snp_batch])   # setup + warm-up
    times = {"hybrid": [], "f64": []}
    pvs = {}

    def one(label, crm):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pvs[label], _ = crm.scan_interaction(d["G"])
        times[label].append(time.perf_counter() - t0)

    for i in range(pairs):
        order = [("hybrid", crm_hybrid), ("f64", crm_f64)]
        for label, crm in (order if i % 2 == 0 else order[::-1]):
            one(label, crm)
    return {"scan_s": times,
            "median_s": {k: statistics.median(v) for k, v in times.items()},
            "max_abs_pv_diff": float(np.max(np.abs(pvs["hybrid"]
                                                   - pvs["f64"])))}


if __name__ == "__main__":
    sys.exit(main())
