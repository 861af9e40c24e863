#!/usr/bin/env python3
"""Smoke run of the PyTorch port (cellregmap_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. the card, as nvidia-smi reports its name and power limit;
2. build the CUDA kernels (one nvcc per source, in parallel) and the Davies
   library, from the sources in this checkout;
3. each kernel (K1 kr_contract, K4 best_rho_rotate, K5 score_core) on the
   inputs the main path gives it at the headline size, held against its
   plain torch version, and timed with CUDA events beside its plain
   version, the library call where one exists, and its bound;
4. the main path, ``run_interaction(..., device="cuda")``, at the bench's
   headline size (2000 cells, 10 contexts, 100 donors, 2048 variants,
   batch 512): throughput, setup/scan split, the traced phase split, the
   launch counts of every kernel, the planted GxC variant, and the first
   64 variants against the port on the CPU;
5. a second size users run (10k cells, 20 contexts, 125 donors, 512
   variants);
6. one JSON line of the kernels, then the result line.

It imports neither jax nor the JAX package.  Without a CUDA device it
exits non-zero before printing any result.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np

# Published peaks of one H100 SXM (NVIDIA data sheet, dense): FP64 tensor
# core rate and HBM3 bandwidth.  The bounds below are against these.
PEAK_F64_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
F64 = 8

HEADLINE = dict(n_cells=2000, n_contexts=10, n_donors=100, n_snps=2048,
                seed=0)
SECOND = dict(n_cells=10_000, n_contexts=20, n_donors=125, n_snps=512,
              seed=1)
BATCH = 512
GXE_SNP = 7


def make_dataset(n_cells, n_contexts, n_donors, n_snps, seed=0,
                 gxe_snp=GXE_SNP):
    """The bench's synthetic dataset (cellregmap_tpu's bench.py
    make_dataset): donor-expanded genotypes, block kinship, one planted
    GxC variant."""
    rng = np.random.default_rng(seed)
    E = rng.normal(size=(n_cells, n_contexts)) / np.sqrt(n_contexts)
    W = np.ones((n_cells, 1))
    donor_of = np.repeat(np.arange(n_donors),
                         -(-n_cells // n_donors))[:n_cells]
    hK = np.zeros((n_cells, n_donors))
    hK[np.arange(n_cells), donor_of] = 1.0
    maf = rng.uniform(0.1, 0.45, size=n_snps)
    G = rng.binomial(2, maf[None, :].repeat(n_donors, 0))[donor_of, :]
    G = np.asarray(G, float)
    G = (G - G.mean(0)) / np.maximum(G.std(0), 1e-9)
    y = (rng.normal(size=n_cells)
         + 0.5 * E @ rng.normal(size=n_contexts)
         + 0.4 * hK @ rng.normal(size=n_donors)
         + 0.2 * G[:, gxe_snp] * E[:, 0] * np.sqrt(n_contexts))
    return dict(y=y, W=W, E=E, hK=hK, G=G)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps=10, warmup=2):
    """Median milliseconds of ``fn`` over ``reps`` runs, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound(flops, nbytes):
    t_ops = flops / PEAK_F64_FLOPS * 1e3
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    return (max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def capture_kernel_inputs(ctx, G, n):
    """One headline batch through the engine, recording each kernel
    wrapper's inputs (and outputs) as the main path gives them."""
    from cellregmap_tpu_torch import engine

    calls = {"kr_contract": [], "best_rho_rotate": [], "score_core": []}
    saved = {k: getattr(engine, k) for k in calls}

    def recorder(name):
        def f(*args):
            calls[name].append(args)
            return saved[name](*args)
        return f

    for k in calls:
        setattr(engine, k, recorder(k))
    try:
        engine.interaction_batch(ctx, G, G, n)
    finally:
        for k, f in saved.items():
            setattr(engine, k, f)
    return calls


def check_kernels(ctx, G, n):
    import torch

    from cellregmap_tpu_torch.kernels import best_rho_rotate as k4
    from cellregmap_tpu_torch.kernels import kr_contract as k1
    from cellregmap_tpu_torch.kernels import score_core as k5

    calls = capture_kernel_inputs(ctx, G, n)
    rows = []

    # K1: the three contractions of one batch
    err = 0.0
    for U, V, Gm in calls["kr_contract"]:
        out, ref = k1.kr_contract(U, V, Gm), k1.kr_contract_plain(U, V, Gm)
        torch.cuda.synchronize()
        e = float((out - ref).abs().max())
        rel = e / float(ref.abs().max())
        assert rel <= 1e-12, f"kr_contract {tuple(out.shape)}: rel {rel}"
        err = max(err, e)
    k1_args = calls["kr_contract"]
    flops = sum(2 * U.shape[0] * U.shape[1] * V.shape[1] * Gm.shape[1]
                for U, V, Gm in k1_args)
    nbytes = F64 * sum(U.numel() + V.numel() + Gm.numel()
                       + U.shape[1] * V.shape[1] * Gm.shape[1]
                       for U, V, Gm in k1_args)

    def k1_library():
        for U, V, Gm in k1_args:
            nn = U.shape[0]
            torch.matmul(U.T, (V[:, :, None] * Gm[:, None, :]).reshape(nn, -1))

    b_ms, b_by = bound(flops, nbytes)
    rows.append(dict(
        name="kr_contract", route="cuda",
        source="cellregmap_tpu_torch/csrc/kr_contract.cu",
        replaces="cellregmap_tpu/engine.py:184", max_abs_err=err,
        ms=cuda_ms(lambda: [k1.kr_contract(*a) for a in k1_args]),
        plain_ms=cuda_ms(lambda: [k1.kr_contract_plain(*a)
                                  for a in k1_args]),
        bound_ms=b_ms, bound_by=b_by, library_ms=cuda_ms(k1_library),
        tolerance="max|err| <= 1e-12 * max|plain|, per call"))

    # K4
    (V, T, kb), = calls["best_rho_rotate"]
    out, ref = k4.best_rho_rotate(V, T, kb), k4.best_rho_rotate_plain(V, T, kb)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    rel = err / float(ref.abs().max())
    assert rel <= 1e-12, f"best_rho_rotate: rel {rel}"
    R, C, S = T.shape
    n_k = int(torch.unique(kb).numel())
    b_ms, b_by = bound(2 * R * R * C * S,
                       F64 * (n_k * R * R + 2 * R * C * S + S))

    def k4_library(chunk=64):
        for s0 in range(0, S, chunk):
            sl = slice(s0, s0 + chunk)
            torch.bmm(V[kb[sl]].transpose(1, 2), T[:, :, sl].permute(2, 0, 1))

    rows.append(dict(
        name="best_rho_rotate", route="cuda",
        source="cellregmap_tpu_torch/csrc/best_rho_rotate.cu",
        replaces="cellregmap_tpu/engine.py:672", max_abs_err=err,
        ms=cuda_ms(lambda: k4.best_rho_rotate(V, T, kb)),
        plain_ms=cuda_ms(lambda: k4.best_rho_rotate_plain(V, T, kb)),
        bound_ms=b_ms, bound_by=b_by, library_ms=cuda_ms(k4_library),
        tolerance="max|err| <= 1e-12 * max|plain|", distinct_rho=n_k))

    # K5
    (args,) = calls["score_core"]
    (Q, Wm), (Qr, Wr) = k5.score_core(*args), k5.score_core_plain(*args)
    torch.cuda.synchronize()
    err = max(float((Q - Qr).abs().max()), float((Wm - Wr).abs().max()))
    rel = max(float((Q - Qr).abs().max() / Qr.abs().max()),
              float((Wm - Wr).abs().max() / Wr.abs().max()))
    assert rel <= 1e-10, f"score_core: rel {rel}"
    Sv, WGt, yt, At, WW = args[:5]
    kb5 = args[13]
    S, R, C = At.shape
    p = WW.shape[0]
    m = C + p + 2
    n_k = int(torch.unique(kb5).numel())
    flops = S * R * (3 * m * (m + 1) // 2 + 3)
    nbytes = F64 * (S * R * C + S * R + n_k * R * (p + 2)
                    + S * (C * C + C * (p + 1) + C + p + 4)
                    + S * (C * C + 1))
    b_ms, b_by = bound(flops, nbytes)
    rows.append(dict(
        name="score_core", route="cuda",
        source="cellregmap_tpu_torch/csrc/score_core.cu",
        replaces="cellregmap_tpu/engine.py:234", max_abs_err=err,
        ms=cuda_ms(lambda: k5.score_core(*args)),
        plain_ms=cuda_ms(lambda: k5.score_core_plain(*args)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        tolerance="max|err| <= 1e-10 * max|plain|, Q and Wmat"))
    for r in rows:
        print(f"kernel {r['name']}: max_abs_err {r['max_abs_err']:.3e} "
              f"({r['tolerance']}); ms {r['ms']:.4f}  plain_ms "
              f"{r['plain_ms']:.4f}  library_ms {r['library_ms']}  "
              f"bound_ms {r['bound_ms']:.4f} ({r['bound_by']})"
              + (f"; distinct rho {r['distinct_rho']}"
                 if "distinct_rho" in r else ""), flush=True)
    return rows


def scan_size(label, spec, cfg, warmup=True, cpu_check=0):
    """The main path at one size, run as a user runs it; returns
    (summary dict, launch counts of the untraced run)."""
    import dataclasses

    import torch

    import cellregmap_tpu_torch as crp
    from cellregmap_tpu_torch import kernels

    d = make_dataset(**spec)
    n_snps = spec["n_snps"]
    batches = -(-n_snps // cfg.snp_batch)
    run = lambda c, G: crp.run_interaction(  # noqa: E731
        y=d["y"], E=d["E"], G=G, W=d["W"], hK=d["hK"], config=c,
        device="cuda")

    if warmup:  # one batch: CUDA context, cuBLAS handles, kernel modules
        run(cfg, d["G"][:, :cfg.snp_batch])
        torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    pv, info = run(cfg, d["G"])
    torch.cuda.synchronize()
    e2e_s = time.perf_counter() - t0
    counts = kernels.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    assert pv.shape == (n_snps,) and np.all((pv > 0) & (pv <= 1)), \
        f"{label}: p-values outside (0, 1]"
    assert np.isfinite(info["Q"]).all()
    want = {"kr_contract": 3 * batches, "best_rho_rotate": batches,
            "score_core": batches}
    assert counts == want, f"{label}: launches {counts} != {want}"

    # setup apart from scan: a scanner's first scan builds the null
    # factorization, its second reuses it
    crm = crp.CellRegMap(y=d["y"], E=d["E"], W=d["W"],
                         Ls=crp.get_L_values(d["hK"], d["E"]), config=cfg,
                         device="cuda")
    t0 = time.perf_counter()
    crm.scan_interaction(d["G"])
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pv_s, _ = crm.scan_interaction(d["G"])
    scan_s = time.perf_counter() - t0
    assert np.array_equal(pv_s, pv), f"{label}: rerun differs"

    # traced rerun: every phase synchronises, so it gives the split, while
    # the untraced runs above give the throughput
    pv_t, info_t = run(dataclasses.replace(cfg, trace=True), d["G"])
    assert np.array_equal(pv_t, pv), f"{label}: traced rerun differs"
    phases = {k.rsplit("/", 1)[-1]: v for k, v in info_t["timers"].items()}

    out = dict(label=label, n_cells=spec["n_cells"],
               n_contexts=spec["n_contexts"], n_donors=spec["n_donors"],
               n_snps=n_snps, batch=cfg.snp_batch, e2e_s=e2e_s,
               e2e_tests_per_s=n_snps / e2e_s, setup_s=first_s - scan_s,
               scan_s=scan_s, scan_tests_per_s=n_snps / scan_s,
               traced_phase_s=phases, launches=counts,
               pv_planted=float(pv[GXE_SNP]), peak_mem_gb=peak_gb)
    if cpu_check:
        pv_c, info_c = crp.run_interaction(
            y=d["y"], E=d["E"], G=d["G"][:, :cpu_check], W=d["W"],
            hK=d["hK"], config=cfg, device="cpu")
        gap = float(np.max(np.abs(pv[:cpu_check] - pv_c)))
        assert gap <= 1e-8, f"{label}: |pv_gpu - pv_cpu| = {gap}"
        assert np.array_equal(info["rho1"][:cpu_check], info_c["rho1"]), \
            f"{label}: rho1 differs between the card and the CPU"
        out["cpu_check"] = dict(n=cpu_check, max_abs_pv_diff=gap,
                                rho1_identical=True)
    print(f"scan {label}: " + json.dumps(out), flush=True)
    return out, counts


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    import cellregmap_tpu_torch as crp
    from cellregmap_tpu_torch import engine
    from cellregmap_tpu_torch.kernels import _build
    from cellregmap_tpu_torch.utils.native import build_qfc

    t_start = time.perf_counter()
    card = card_line()
    print(card, flush=True)
    assert not torch.backends.cuda.matmul.allow_tf32, "TF32 matmul is on"

    # --- build ---
    t0 = time.perf_counter()
    built = _build.build_all(verbose=True)
    assert build_qfc() is not None, "qfc.cc did not build"
    print(f"build: {time.perf_counter() - t0:.2f} s", flush=True)
    for name in _build.SOURCES:
        log = built.get(f"{name}.ptxas", "")
        report = [ln.strip() for ln in log.splitlines()
                  if "registers" in ln or "spill" in ln]
        print(f"ptxas {name}: " + " | ".join(report), flush=True)

    # --- kernels against their plain versions, at the headline shapes ---
    cfg = crp.ScanConfig(snp_batch=BATCH)
    d = make_dataset(**HEADLINE)
    ctx = engine.build_null_context(
        d["y"], d["W"], d["E"], Ls=crp.get_L_values(d["hK"], d["E"]),
        device="cuda")
    Gb = torch.as_tensor(d["G"][:, :BATCH], device="cuda").contiguous()
    rows = check_kernels(ctx, Gb, len(d["y"]))

    # --- the main path at the headline size, then a second size ---
    head, counts = scan_size("headline", HEADLINE, cfg, cpu_check=64)
    assert head["pv_planted"] < 1e-6, \
        f"planted GxC variant {GXE_SNP}: pv {head['pv_planted']}"
    scan_size("cells10k", SECOND, cfg, warmup=False)

    for r in rows:
        r["launches"] = counts[r["name"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(f"total: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(card)
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
