"""The float32 screen's accuracy and throughput on the card, for the
PyTorch port: the method of ``SCREEN_CALIB.json`` (the JAX package's
``scripts/measure_screen.py``) run on ``cellregmap_tpu_torch``.

Two configurations, as there: the bench headline (2000 cells, 10
contexts, 100 donors, 2048 variants, seed 0) and a C = 20 case (2048
cells, 20 contexts, 125 donors, 1024 variants, seed 5), each on one
scanner (``ScanConfig(snp_batch=512)``, the Ls background):

1. the float64 scan under davies (the comparator of throughput), a first
   call (setup) and a timed one;
2. the float64 scan under saddlepoint (the same tail approximation as the
   screen, so that the comparison isolates the float32 error);
3. the float32 screen with significance 1e-300 (nothing confirmed: the
   screen pass alone), a first call and a timed one;
4. the screen at significance 5e-8, end to end (screen and confirm);
5. the distribution of |log10(screen_pv) - log10(pv64 saddlepoint)| (max,
   q99, median), and at the float64 Davies hits (pv < 5e-8) the largest
   ratio screen_pv / pv64: the margin the screen needed.

Prints one JSON line (and the card's name and power limit before it);
``--out PATH`` also writes it to PATH, which must not exist.  Needs one
CUDA card; imports neither jax nor the JAX package.

    python3 scripts/measure_screen_torch.py [--out PATH]
"""
import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(1, str(Path(__file__).resolve().parent.parent))
import chip_smoke as cs  # noqa: E402
import cellregmap_tpu_torch as crp  # noqa: E402

CONFIGS = {"c10_2k": dict(n_cells=2000, n_contexts=10, n_donors=100,
                          n_snps=2048, seed=0),
           "c20_2k": dict(n_cells=2048, n_contexts=20, n_donors=125,
                          n_snps=1024, seed=5)}


def _timed(fn):
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def run_config(spec):
    d = cs.make_dataset(**spec)
    G, n_snps = d["G"], spec["n_snps"]
    cfg = crp.ScanConfig(snp_batch=512)
    crm = crp.CellRegMap(y=d["y"], E=d["E"], W=d["W"],
                         Ls=crp.get_L_values(d["hK"], d["E"]), config=cfg,
                         device="cuda")
    crm_sp = crm._with_config(dataclasses.replace(
        cfg, pvalue_method="saddlepoint"))
    t_first64, _ = _timed(lambda: crm.scan_interaction(G))
    t64, (pv64, _) = _timed(lambda: crm.scan_interaction(G))
    pv64_sp, _ = crm_sp.scan_interaction(G)
    t_first32, _ = _timed(lambda: crm.scan_interaction_screen(
        G, significance=1e-300))
    t32, (_, info) = _timed(lambda: crm.scan_interaction_screen(
        G, significance=1e-300))
    t_e2e, (_, info_e2e) = _timed(lambda: crm.scan_interaction_screen(
        G, significance=5e-8))
    pv32 = info["screen_pv"]
    ok = (np.isfinite(pv32) & np.isfinite(pv64_sp) & (pv64_sp > 1e-300)
          & (pv32 > 1e-300))
    dlog = np.abs(np.log10(pv32[ok]) - np.log10(pv64_sp[ok]))
    sig = pv64 < 5e-8
    return dict(
        n_cells=spec["n_cells"], n_contexts=spec["n_contexts"],
        n_snps=n_snps, dlog10_max=float(dlog.max()),
        dlog10_q99=float(np.quantile(dlog, 0.99)),
        dlog10_median=float(np.median(dlog)), n_compared=int(ok.sum()),
        n_true_hits=int(sig.sum()),
        screen_over_exact_ratio_at_hits=(float((pv32[sig] / pv64[sig]).max())
                                         if sig.any() else None),
        exact_tests_per_sec=n_snps / t64, screen_tests_per_sec=n_snps / t32,
        e2e_screen_tests_per_sec=n_snps / t_e2e,
        n_confirmed_e2e=int(info_e2e["n_confirmed"]),
        speedup_screen_vs_exact=t64 / t32, first_exact_s=t_first64,
        first_screen_s=t_first32)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", type=Path)
    opt = ap.parse_args()
    if not torch.cuda.is_available():
        print("measure_screen_torch: no CUDA device", file=sys.stderr)
        return 1
    if opt.out is not None and opt.out.exists():
        print(f"measure_screen_torch: {opt.out} exists", file=sys.stderr)
        return 1
    card = cs.card_line()
    print(card, flush=True)
    out = {"card": card, "device": torch.cuda.get_device_name(0)}
    for name, spec in CONFIGS.items():
        out[name] = run_config(spec)
        print(json.dumps({name: out[name]}), flush=True)
    line = json.dumps(out)
    if opt.out is not None:
        opt.out.write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
