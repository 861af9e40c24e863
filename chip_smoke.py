#!/usr/bin/env python3
"""Smoke run of the PyTorch port (cellregmap_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. the card, as nvidia-smi reports its name and power limit;
2. build the CUDA kernels (one nvcc per source, in parallel) and the Davies
   library, from the sources in this checkout;
3. each kernel on the inputs the main paths give it at the headline size
   (K1 kr_contract, K2 delta_grid, K3 reml_newton, K4 best_rho_rotate, K5
   score_core, K6a sym_eigvalsh and K6b mixture_tails on an interaction
   batch; K7, the ML delta grid and Newton, on an association refit batch;
   K10 null_fit on the association's null fit), held against its plain
   torch version, and timed with CUDA events beside its plain version, the
   library call where one exists, and its bound (K1 a row a call: T, A^T A
   and A^T W);
4. the interaction path, ``run_interaction(..., device="cuda")``, at the
   bench's headline size (2000 cells, 10 contexts, 100 donors, 2048
   variants, batch 512): throughput, setup/scan split, the traced phase
   split, the launch counts of every kernel, the planted GxC variant, and
   the first 64 variants against the port on the CPU; then the same under
   ``pvalue_method="auto"`` (the device tails, K6a and K6b), its refined
   pairs against the davies run;
5. the float32 context's instantiations (K1 T, A^T A and A^T W, K2, K3's
   localize and converge, K4, K5 on f32 operands, K6a in f32) and K6b on
   the operands of one screen batch (1024 variants of the headline
   dataset, cast to f32 on the card), each against its plain version
   (n-term sums within sqrt(n) eps(f32) of the terms' magnitudes; the
   tolerances of ``check_f32_kernels``), timed beside it, its bound and
   its library call (K4-f32 also beside one f32 ``matmul`` of the same
   flops);
6. ``screen_2k``: ``scan_interaction_screen`` on the headline dataset, all
   2048 variants, significance 5e-8: every f64 Davies hit of phase 4
   confirmed with its value, the screen within 0.5 decades of the f64
   saddlepoint, the first 64 variants against the CPU screen, tests/s
   beside the f64 scan under davies and auto (the spread of 3 runs), the
   f32 instantiations' launch counts; then ``screen_multigene_16`` (16
   genes, 2048 variants, gene_batch 16): pairs/s, launch counts with the
   gene axis, gene 0 against its single-gene screen, K4-f32 and K6b on
   its first batch (16 genes x 84 variants);
7. a second interaction size users run (10k cells, 20 contexts, 125
   donors, 512 variants), and K1 on the three contractions of its batch,
   captured from that run;
8. the gene-batched scan, ``run_interaction_multigene(..., device="cuda")``
   at the JAX bench's ``multigene_16`` shape (the headline dataset, 16
   genes, 512 variants, one tile): first and steady pairs/s, launch counts,
   the per-gene loop on the same scanner, the first 2 genes x 64 variants
   against the CPU, K2-K5 with the gene axis against their plain versions
   (timed, with their bounds), and one call under "auto";
9. the association paths at the headline size: ``run_association(...,
   hK=hK, device="cuda")`` (R = 110) and ``scan_association`` on the
   headline's Ls scanner (R = 1010), each with its launch counts and the
   first 64 variants against the port on the CPU;
10. K8 fast_scan on a headline batch of the Ls scanner and K9
   woodbury_family on every call of a 512-variant effect-size batch (f32
   zoom rounds, f64 rounds, the f64 fit with coefficients), each against
   its plain version and timed as in 3, and K1 on that batch's three
   contractions (K = Rk, V = E0 or B);
11. the fast association paths, ``run_association_fast(..., hK=hK,
   device="cuda")`` and ``scan_association_fast`` on the Ls scanner, at
   2000 cells x 2048 variants, with launch counts and the first 64
   variants against the CPU;
12. the effect sizes, ``estimate_betas(..., hK=hK)`` at 2000 cells x 512
    variants (a first and a steady call, the traced phase split, launch
    counts, the first 32 variants' fits against the CPU), and
    ``estimate_aggregate_environment`` of the planted variant against the
    CPU (on the headline's scanner, and with an E1 outside E, whose REML
    mean fit, K10's narrow instantiation at p = 12, is held against its
    plain version and timed);
13. 50 contexts (2000 cells, 100 donors, an E1 outside E): the aggregate
    environment through K10's wide instantiation (p = 52) against the CPU
    and the kernel against its plain version, and K6a on one interaction
    batch's 50 x 50 weight matrices and on 512 seeded PSD 64 x 64 ones
    (the card's widest C); then the same dataset with W widened
    to 32 columns (rank[W, E] = 82): the aggregate environment at 83 mean
    columns and one 64-variant ``estimate_betas`` batch at K9's q = 134,
    each against the CPU and each kernel call against its plain version;
14. the gene-batched association scans on the headline's Ls scanner
    (R = 1010), at the JAX bench's ``assoc_multigene_16`` row (16 genes,
    Y = y + 0.1 N(0, 1)): ``scan_association_fast_multigene`` at 2048
    variants (first and steady pairs/s, launch counts, the per-gene loop,
    the first 2 genes x 64 variants against the CPU) and
    ``scan_association_multigene`` at 512 variants (steady pairs/s, the
    per-gene loop, 2 genes x 64 against the CPU), with K10, K8 and K7 with
    the gene axis against their plain versions (timed, with their
    bounds);
15. checkpointed scans on the card: a gene-batched fast association scan
    stopped after its first gene tile and an interaction scan stopped
    after its first variant batch, each resumed and held equal to a clean
    run;
16. ``covariates_24``: the headline dataset with p = 24 columns of W and
    21 rho points, 512 variants through ``run_interaction`` (davies),
    ``run_association_fast`` and ``run_association`` (hK), each with its
    launch counts (K2, K3, K5 and K8 in their wide instantiations) and its
    first 64 variants against the CPU at the headline budgets; K2, K3, K5,
    K7 and K8 at that width against their plain versions (K3's localize
    split by kernel from torch.profiler); and a p = 33
    scanner on the card, refused before any setup (the refusal timed);
17. ``ScanConfig(n_rho=80)`` (past the 64 rho points the localize took
    before) through ``run_interaction`` at 1000 cells, 10 contexts, 50
    donors and 512 variants: launch counts, the first 64 variants against
    the CPU, and K3 at 80 rho points against its plain version;
18. ``plink``: a seeded donor-level cohort written as a PLINK fileset
    (2000 cells, C = 10, 100 donors, 8192 variants; missing calls, a
    monomorphic variant, three planted GxC variants) through the PLINK
    drivers on the card: ``scan_interaction_plink`` in blocks of 2048
    (decode / expand-and-standardize / scan seconds; stopped after two
    blocks and resumed equal to one run; its head against a direct scan
    and the CPU port), the screen on one block, the fast association on
    the cohort, the effect sizes on a block of 512, the gene-batched cis
    scan (16 genes, one tile), the CLI in subprocesses, each driver's
    kernels' launch counts, the native .bed decoder built; then the
    low-rank shims on the headline's hK against the CPU port;
19. one JSON line of the kernels (every row's times a wrapper call, as
    its launches count them; a row timed over a batch's several calls
    keeps the batch's times beside), then the result line.

It imports neither jax nor the JAX package.  Without a CUDA device it
exits non-zero before printing any result.
"""
from __future__ import annotations

import faulthandler
import json
import logging
import math
import statistics
import subprocess
import sys
import time

import numpy as np

# Published peaks of one H100 SXM (NVIDIA data sheet, dense): the FP64
# tensor-core rate (the FP32 rate outside the tensor cores is the same 67
# TFLOP/s), the TF32 tensor-core rate and HBM3 bandwidth.  The bounds
# below are against these.
PEAK_F64_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_HBM_BYTES = 3.35e12
# the FP64 rate of the CUDA cores (the same data sheet): K6b's divisions,
# transcendentals and scalar steps do not run on the tensor cores
PEAK_F64_CUDA_FLOPS = 34e12
F64 = 8
DELTA_CFG = (-18.0, 18.0, 64, 60)          # the interaction's grid
ASSOC_DELTA_CFG = (-18.0, 18.0, 256, 60)   # the association's grid

HEADLINE = dict(n_cells=2000, n_contexts=10, n_donors=100, n_snps=2048,
                seed=0)
BETAS_SNPS = 512       # the JAX bench's betas_2k size (bench.py:462-477)
SECOND = dict(n_cells=10_000, n_contexts=20, n_donors=125, n_snps=512,
              seed=1)
WIDE = dict(n_cells=2000, n_contexts=50, n_donors=100, n_snps=512, seed=2)
MULTIGENE = dict(genes=16, n_snps=512, seed=9)    # bench.py:479-506
# bench.py:559-573; the refit phase on the same genes at 512 variants
ASSOC_MULTIGENE = dict(genes=16, n_snps=2048, refit_snps=512, seed=11)
# covariates_24: the headline dataset with p = 24 columns of W, 21 rho
COVARIATES = dict(p=24, n_rho=21, n_snps=512, seed=24)
WIDE_COVARIATES = dict(p=32, seed=32)   # W's columns on WIDE's dataset
WIDE_BETAS_CPU = 16     # of its 64-variant q = 134 betas batch, on the CPU
# 80 rho points, past the 64 the localize took before; the dataset cut to
# 1000 cells and 50 donors (R = 510) so that the host setup's 80
# eigendecompositions, on the card's scanner and the CPU's, stay short
RHO80 = dict(n_cells=1000, n_contexts=10, n_donors=50, n_snps=512, seed=80)
N_RHO80 = 80
BATCH = 512
GXE_SNP = 7
CARD = "cuda"          # the device of the main paths


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
    return dict(y=y, W=W, E=E, hK=hK, G=G, maf=maf)


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


def bound(flops, nbytes, split_tf32=False):
    """(ms, "operations" or "bytes"): the least time for ``flops`` and
    ``nbytes``; ``split_tf32``: a split-TF32 route's (three TF32 products
    a term, on the tensor cores), else the FP64 / FP32 rate's."""
    t_ops = (3 * flops / PEAK_TF32_FLOPS if split_tf32
             else flops / PEAK_F64_FLOPS) * 1e3
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    return (max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def expected_launches(**counts):
    """Every kernel's launch count: 0 unless given."""
    from cellregmap_tpu_torch import kernels

    want = dict.fromkeys(kernels.MODULES, 0)
    want.update(counts)
    return want


def capture_kernel_inputs(run, names):
    """Run ``run()`` through the engine, recording the positional and
    keyword arguments of each kernel wrapper in ``names`` as the main path
    gives them: name -> [(args, kwargs)]."""
    from cellregmap_tpu_torch import engine

    calls = {k: [] for k in names}
    saved = {k: getattr(engine, k) for k in names}

    def recorder(name):
        def f(*args, **kw):
            calls[name].append((args, kw))
            return saved[name](*args, **kw)
        return f

    for k in names:
        setattr(engine, k, recorder(k))
    try:
        run()
    finally:
        for k, f in saved.items():
            setattr(engine, k, f)
    return calls


def check_kernels(ctx, G, n):
    from cellregmap_tpu_torch import engine
    from cellregmap_tpu_torch.kernels import best_rho_rotate as k4

    calls = capture_kernel_inputs(
        lambda: engine.interaction_batch(ctx, G, G, n, delta_cfg=DELTA_CFG,
                                         device_pvalues=True),
        ["kr_contract", "delta_grid", "reml_localize", "reml_converge",
         "best_rho_rotate", "score_core", "sym_eigvalsh", "mixture_tails"])
    tails = (calls.pop("sym_eigvalsh")[0][0],
             calls.pop("mixture_tails")[0][0])
    calls = {k: [a for a, _ in v] if k in ("kr_contract", "best_rho_rotate",
                                           "score_core") else v
             for k, v in calls.items()}
    rows = []

    # K1: the three contractions of one batch, a row each
    rows += check_kr_contract(calls["kr_contract"], K1_CALLS)

    # K4
    (V, T, kb), = calls["best_rho_rotate"]
    err = check_best_rho_rotate(V, T, kb, "best_rho_rotate")
    b_ms, b_by, n_k, _ = k4_bound(V, T, kb)
    rows.append(dict(
        name="best_rho_rotate", route="cuda",
        source="cellregmap_tpu_torch/csrc/best_rho_rotate.cu",
        replaces="cellregmap_tpu/engine.py:672", max_abs_err=err,
        ms=cuda_ms(lambda: k4.best_rho_rotate(V, T, kb)),
        plain_ms=cuda_ms(lambda: k4.best_rho_rotate_plain(V, T, kb)),
        bound_ms=b_ms, bound_by=b_by, library_ms=k4_library_ms(V, T, kb),
        tolerance="slots equal; the gathered factors' max|err| <= 1e-12 * "
                  "max|plain|", distinct_rho=n_k))

    # K5
    (args,) = calls["score_core"]
    rows.append(check_score_core(args))
    rows[len(K1_CALLS):len(K1_CALLS)] = [
        check_delta_grid(calls["delta_grid"][0]),
        *check_reml_newton(calls["reml_localize"][0],
                           calls["reml_converge"][0])]
    rows += [check_sym_eigvalsh(*tails[0]), check_mixture_tails(*tails[1])]
    rows += check_association_kernels(ctx, G, n)
    for r in rows:
        print(f"kernel {r['name']}: max_abs_err {r['max_abs_err']:.3e} "
              f"({r['tolerance']}); ms {r['ms']:.4f}  plain_ms "
              f"{r['plain_ms']:.4f}  library_ms {r['library_ms']}  "
              f"bound_ms {r['bound_ms']:.4f} ({r['bound_by']})"
              + (f"; distinct rho {r['distinct_rho']}"
                 if "distinct_rho" in r else "")
              + ("; " + json.dumps({k: r[k] for k in (
                  "device", "pairs", "operations", "gammaincc_iterations",
                  "near_mean", "rel_near", "rel_far")})
                 if r["name"] == "mixture_tails" else ""), flush=True)
    return rows


K5_NOTE = ("the genotype columns of the distinct (slot, variant) "
           "pairs gathered once a call; a block a variant takes its used "
           "slots in turn, up to 16 genes a pass sharing the staged rows; "
           "the Gram on mma.sync m16n8k8 (FP64 tensor cores), the algebra "
           "a warp a gene")
CONVERGE_NOTE = ("the problems listed a rho on the card; a block a "
                 "(rho, tile of 4 problems) stages the rows they share (the "
                 "genotype read along the variants), resident up to 110 KB "
                 "or in chunks, read in place with no Newton steps; two "
                 "warps a problem at p + 1 <= 2; wide: 4 x 4 blocks of sums "
                 "a lane")


FAST_SCAN_NOTE = ("two launches: the sums a block a (variant tile, split "
                  "of the rows, slot, chunk of genes), the splits filling "
                  "two blocks an SM, beside a block a gene computing its "
                  "shared terms and A's factor once; then an epilogue a "
                  "block a (32 variants, gene) adding the splits in a "
                  "fixed order")


def device_ms(fn):
    """Profiler milliseconds a call of ``fn`` by kernel, or None where the
    profiler saw no device time."""
    try:
        return device_split(fn)
    except AssertionError:
        return None


def check_score_core(args, tag=None, plain_reps=10):
    """K5 on one call's operands (a single phenotype) against its plain
    version, Q and Wmat within 1e-10 of max|plain|, timed beside it; the
    bound counts the factor, the rows of each best rho and the Grams read
    once, Q and Wmat written once.  One row, ``score_core[ (<tag>)]``."""
    import torch

    from cellregmap_tpu_torch.kernels import score_core as k5

    name = "score_core" + (f" ({tag})" if tag else "")
    (Q, Wm), (Qr, Wr) = k5.score_core(*args), k5.score_core_plain(*args)
    torch.cuda.synchronize()
    rel = max(float((Q - Qr).abs().max() / Qr.abs().max()),
              float((Wm - Wr).abs().max() / Wr.abs().max()))
    assert rel <= 1e-10, f"{name}: rel {rel}"
    At, WW = args[3], args[4]
    _, S, R, C = At.shape
    p = WW.shape[0]
    m = C + p + 2
    n_k = int(torch.unique(args[13]).numel())
    # the operands in their own type (f32 in the float32 context); v0, v1,
    # Q and Wmat f64
    es = At.element_size()
    b_ms, b_by = bound(S * R * (3 * m * (m + 1) // 2 + 3),
                       es * (S * (R * C + R) + n_k * R * (p + 2)
                             + S * (C * C + C * (p + 1)) + S * (C + p + 2))
                       + F64 * (2 * S + S * (C * C + 1)))
    return dict(
        name=name, route="cuda",
        source="cellregmap_tpu_torch/csrc/score_core.cu",
        replaces="cellregmap_tpu/engine.py:234",
        max_abs_err=max(float((Q - Qr).abs().max()),
                        float((Wm - Wr).abs().max())),
        ms=cuda_ms(lambda: k5.score_core(*args)),
        plain_ms=cuda_ms(lambda: k5.score_core_plain(*args), reps=plain_reps,
                         warmup=min(2, plain_reps)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        tolerance="Q, Wmat: max|err| <= 1e-10 * max|plain|", note=K5_NOTE)


K1_CALLS = ("T", "AtA", "AtW")    # the interaction batch's K1 calls


def check_kr_contract(calls, names, tag=None):
    """K1 on each captured call (U, V, G): within 1e-12 of max|plain| of
    the plain version, timed beside it and beside one ``matmul`` of U^T
    against the materialized V o G.  One row a call named ``kr_contract
    (<name>)``, or with ``tag`` ``kr_contract (<name>, <tag>)``."""
    import torch

    from cellregmap_tpu_torch.kernels import kr_contract as k1

    rows = []
    for (U, V, Gm), name in zip(calls, names):
        out, ref = k1.kr_contract(U, V, Gm), k1.kr_contract_plain(U, V, Gm)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        rel = err / float(ref.abs().max())
        assert rel <= 1e-12, f"kr_contract {name} {tuple(out.shape)}: rel {rel}"
        del out, ref
        nn, K = U.shape
        p, S = V.shape[1], Gm.shape[1]
        b_ms, b_by = bound(2 * nn * K * p * S,
                           F64 * (U.numel() + V.numel() + Gm.numel()
                                  + K * p * S))

        def library():
            torch.matmul(U.T, (V[:, :, None] * Gm[:, None, :]).reshape(nn, -1))

        rows.append(dict(
            name=f"kr_contract ({name}{', ' + tag if tag else ''})",
            route="cuda",
            source="cellregmap_tpu_torch/csrc/kr_contract.cu",
            replaces="cellregmap_tpu/engine.py:184", max_abs_err=err,
            ms=cuda_ms(lambda: k1.kr_contract(U, V, Gm)),
            plain_ms=cuda_ms(lambda: k1.kr_contract_plain(U, V, Gm)),
            bound_ms=b_ms, bound_by=b_by, library_ms=cuda_ms(library),
            shape=dict(n=nn, K=K, p=p, S=S), rel=rel,
            tolerance="max|err| <= 1e-12 * max|plain|"))
    return rows


def check_sym_eigvalsh(A, tol=1e-12, tag=None):
    """K6a on one batch's weight matrices A (S, C, C): ascending, clamped
    eigenvalues within 1e-12 of each row's largest |lambda| of the plain
    version (the shifted ``torch.linalg.eigvalsh``), timed beside it and
    beside one ``torch.linalg.eigvalsh`` call (cuSOLVER).  The operation
    bound counts what the function needs, whatever the route takes (not
    the kernel's Jacobi sweeps or bisection steps): a matrix's reduction
    to tridiagonal form, 4 C^3 / 3 flop, and the tridiagonal's
    eigenvalues, O(C^2), counted at 2 C flop an eigenvalue (a floor: one
    pass over the tridiagonal each).  ``tol`` (1e-12; 1e-5 for the float32
    context's f32 matrices) and ``tag`` name the row."""
    import torch

    from cellregmap_tpu_torch.kernels import sym_eigvalsh as k6a

    lam, sweeps = k6a.sym_eigvalsh(A, return_sweeps=True)
    want = k6a.sym_eigvalsh_plain(A)
    # the f64 eigenvalues of A as it is (an f32 A widened), clamped
    exact = torch.linalg.eigvalsh(
        0.5 * (A + A.transpose(1, 2)).double()).clamp(min=0.0)
    torch.cuda.synchronize()
    scale = want.abs().amax(dim=1, keepdim=True).clamp(min=1e-300)
    rel = float(((lam - want).abs() / scale).max())
    rel_exact = float(((lam.double() - exact).abs() / scale).max())
    name = "sym_eigvalsh" if tag is None else f"sym_eigvalsh ({tag})"
    assert rel <= tol, f"{name}: rel {rel}"
    assert bool((lam[:, 1:] >= lam[:, :-1]).all()), f"{name}: order"
    S, C = A.shape[0], A.shape[-1]
    n_sw = int(sweeps.sum())
    b_ms, b_by = bound(S * (4 * C ** 3 // 3 + 2 * C * C),
                       A.element_size() * (S * C * C + S * C))
    return dict(
        name=name, route="cuda",
        source="cellregmap_tpu_torch/csrc/sym_eigvalsh.cu",
        replaces="cellregmap_tpu/ops/linalg.py:238",
        max_abs_err=float((lam - want).abs().max()),
        ms=cuda_ms(lambda: k6a.sym_eigvalsh(A)),
        plain_ms=cuda_ms(lambda: k6a.sym_eigvalsh_plain(A)),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=cuda_ms(lambda: torch.linalg.eigvalsh(A)),
        shapes=dict(S=S, C=C), rel_to_f64=rel_exact,
        sweeps_max=int(sweeps.max()),
        sweeps_mean=n_sw / S,
        tolerance=f"|err| <= {tol} * max|lambda| of each matrix")


def k6a_c64_matrices(S=BATCH, C=64, seed=64):
    """S seeded PSD (C x C) matrices B B^T / 96, B of N(0, 1) entries (C x
    96): weight matrices at the card's widest C, which no bench dataset
    reaches (a 64-context scanner's setup alone would take ~20 s)."""
    import torch

    B = np.random.default_rng(seed).normal(size=(S, C, 96))
    return torch.as_tensor(B @ np.swapaxes(B, 1, 2) / 96.0, device=CARD)


GAMMAINCC_MAX_IT = 2000       # csrc/mixture_tails.cu's MAX_IT


def gammaincc_iterations(a, x):
    """The iterations ``csrc/mixture_tails.cu``'s gammaincc runs for each
    (a, x) (NumPy arrays of one shape), its loops rendered in NumPy: the
    series of P(a, x) where x < a + 1, else Lentz's continued fraction,
    each to its break; 0 for the early returns.  Returns (series
    iterations, continued-fraction iterations), arrays like a."""
    a = np.asarray(a, float)
    x = np.broadcast_to(np.asarray(x, float), a.shape).copy()
    special = (np.isnan(a) | np.isnan(x) | (a <= 0) | (x <= 0)
               | np.isinf(x))
    ser = ~special & (x < a + 1.0)
    cf = ~special & ~ser
    n_ser = np.zeros(a.shape, dtype=np.int64)
    n_cf = np.zeros(a.shape, dtype=np.int64)
    eps = np.finfo(float).eps
    with np.errstate(all="ignore"):
        ap, term = a[ser].copy(), 1.0 / a[ser]
        total, xs = term.copy(), x[ser]
        live = np.ones(ap.shape, bool)
        cnt = np.zeros(ap.shape, dtype=np.int64)
        for _ in range(GAMMAINCC_MAX_IT):
            if not live.any():
                break
            ap = np.where(live, ap + 1.0, ap)
            term = np.where(live, term * xs / ap, term)
            total = np.where(live, total + term, total)
            cnt += live
            live &= ~(np.abs(term) < np.abs(total) * eps)
        n_ser[ser] = cnt
        tiny = 1e-300
        ac, xc = a[cf], x[cf]
        b = xc + 1.0 - ac
        c = np.full(ac.shape, 1.0 / tiny)
        d = 1.0 / b
        live = np.ones(ac.shape, bool)
        cnt = np.zeros(ac.shape, dtype=np.int64)
        for i in range(1, GAMMAINCC_MAX_IT + 1):
            if not live.any():
                break
            an = -i * (i - ac)
            b = np.where(live, b + 2.0, b)
            dn = an * d + b
            dn = np.where(np.abs(dn) < tiny, tiny, dn)
            cn = b + an / c
            cn = np.where(np.abs(cn) < tiny, tiny, cn)
            dn = 1.0 / dn
            d, c = np.where(live, dn, d), np.where(live, cn, c)
            cnt += live
            live &= ~(np.abs(d * c - 1.0) < eps)
        n_cf[cf] = cnt
    return n_ser, n_cf


def k6b_operations(Q, lam, n_bisect):
    """The FP64 operations K6b's pairs need, counted from the loops these
    inputs run (``csrc/mixture_tails.cu`` rendered in NumPy): a division,
    a transcendental (log, exp, lgamma, log1p, erf, sqrt) and an add or a
    multiply one operation each, an FMA two.  Per pair: the moments (7 a
    weight) and the Liu match (~40); each gammaincc it runs (one for the
    central tail, 64 where the match is noncentral) 10 for its prefactor
    and Poisson weight, 4 a series iteration (an add, a division, a
    multiply, an add) and 10 a continued-fraction iteration (two
    divisions, an FMA, six adds or multiplies); n_bisect bisection steps
    of 4 a weight (an FMA, a division, an add) and 2; K and K'' at the
    saddlepoint 10 a weight, and ~30 for the Lugannani-Rice tail.
    Returns (operations, gammaincc calls, their iterations)."""
    lam = np.asarray(lam, float)
    q = np.asarray(Q, float)
    P, C = lam.shape
    with np.errstate(all="ignore"):
        l2 = lam * lam
        c1, c2 = lam.sum(1), l2.sum(1)
        c3, c4 = (l2 * lam).sum(1), (l2 * l2).sum(1)
        r2 = np.sqrt(c2)
        s1 = c3 / (r2 * r2 * r2)
        s2 = c4 / (c2 * c2)
        has_ncp = s1 * s1 > s2
        a = 1.0 / (s1 - np.sqrt(np.maximum(s1 * s1 - s2, 0.0)))
        ncp_1 = s1 * (a * a * a) - a * a
        ncp = np.where(has_ncp, ncp_1, 0.0)
        dof = np.where(has_ncp, a * a - 2.0 * ncp_1, 1.0 / s2)
        sigma_x = np.sqrt(2.0 * (dof + 2.0 * ncp))
        xh = np.maximum((q - c1) / np.sqrt(2.0 * c2) * sigma_x + dof + ncp,
                        0.0) / 2.0
    series = ncp > 0
    k = np.arange(64.0)
    a_all = np.concatenate([dof[~series] / 2.0,
                            ((dof[series, None] + 2.0 * k) / 2.0).ravel()])
    x_all = np.concatenate([xh[~series],
                            np.repeat(xh[series], 64)])
    n_ser, n_cf = gammaincc_iterations(a_all, x_all)
    calls = a_all.size
    ops = (P * (7 * C + 40 + n_bisect * (4 * C + 2) + 10 * C + 30)
           + 10 * calls + 4 * int(n_ser.sum()) + 10 * int(n_cf.sum()))
    return ops, calls, int(n_ser.sum() + n_cf.sum())


# K6b's saddlepoint near the mean.  At Q a relative distance d from its
# mean the Lugannani-Rice tail takes w from t Q - K(t), two nearly equal
# terms, and adds log(v / w) / w, so float64 rounding alone moves it by
# ~1e-16 / d^2 relative (tests/test_torch_emulated_k4f32_k6b.py, against
# 50 digits), and two float64 evaluations whose sums run in other orders
# part by that much.  A pair within SADDLE_NEAR_D of its mean is held, not
# to the plain version, but to the same formula in extended precision
# (saddlepoint_extended), within 1e-9 + min(SADDLE_NEAR_MEAN / d^2,
# SADDLE_CAP) relative: that rounding with a tenfold margin, never more
# than 1e-6.  Every other pair, and the Liu tail of every pair, is held to
# the plain version within 1e-9.
SADDLE_NEAR_MEAN = 1e-15
SADDLE_NEAR_D = 1e-3     # where SADDLE_NEAR_MEAN / d^2 reaches 1e-9
SADDLE_CAP = 1e-6


def saddlepoint_extended(Q, lam, n_iters=40):
    """The plain saddlepoint's formula (``models.pvalues.
    saddlepoint_sf_torch``: its bracket, its ``n_iters + 60`` bisection
    steps, K, K'' and the Lugannani-Rice z) in NumPy's long double, of Q
    (P,) against lam (P, C) (float64 arrays); 1 - ndtr(z) in float64 from
    z (well conditioned there).  Returns (tail, v) as float64; the tail is
    NaN where the formula gives way to Liu's value (|v| < 1e-8 or lmax <=
    0)."""
    import math

    ld = np.longdouble
    assert np.finfo(ld).eps < 1e-18, "long double is no wider than float64"
    L, q = np.asarray(lam, ld), np.asarray(Q, ld)
    lmax, mean = L.max(-1), L.sum(-1)
    with np.errstate(all="ignore"):
        hi = 1.0 / (2.0 * lmax)
        span = np.maximum(mean, 1.0) / np.maximum(q, np.finfo(float).tiny)
        a = -np.abs(hi) * 1e3 - span * 1e3 - 1e3
        b = hi * (1.0 - 1e-12)
        for _ in range(n_iters + 60):
            mid = 0.5 * (a + b)
            below = (L / (1.0 - 2.0 * mid[:, None] * L)).sum(-1) < q
            a, b = np.where(below, mid, a), np.where(below, b, mid)
        t = 0.5 * (a + b)
        K = -0.5 * np.log1p(-2.0 * t[:, None] * L).sum(-1)
        w = np.sign(t) * np.sqrt(np.maximum(2.0 * (t * q - K), 0.0))
        kpp = (2.0 * L ** 2 / (1.0 - 2.0 * t[:, None] * L) ** 2).sum(-1)
        v = t * np.sqrt(kpp)
        z = (w + np.log(v / w) / w).astype(float)
    tail = np.array([0.5 * math.erfc(x / math.sqrt(2.0)) for x in z])
    tail[(np.abs(v) < 1e-8) | (lmax <= 0)] = np.nan
    return tail, v.astype(float)


def tails_gaps(got, want, Q, lam, n_iters=40, rtol=1e-9):
    """K6b's rule measured: ``got`` and ``want`` (the plain version) are
    (pv_liu, pv_saddlepoint) of Q (P,) against lam (P, C), tensors or
    arrays.  Each tail is held to ``want`` within ``rtol`` relative (floor
    1e-300), but the saddlepoint of a pair within SADDLE_NEAR_D of its mean
    whose formula is taken: that is held to ``saddlepoint_extended``
    within rtol + min(SADDLE_NEAR_MEAN / d^2, SADDLE_CAP).  Returns a dict:
    ``nan_equal`` (NaN exactly where ``want`` is NaN), ``excess`` (the
    largest |err| - tolerance |reference|; <= 1e-300 passes), ``rel_liu``
    and ``rel_far`` (the largest relative errors against ``want``: Liu,
    the saddlepoint off the near pairs), ``near_mean`` (how many near
    pairs), ``near_d_min``, ``rel_near`` (their largest relative error
    against the extended evaluation), ``rel_near_plain`` (the plain
    version's own there) and ``rel_near_vs_plain``."""
    def arr(t):
        return np.asarray(t.cpu() if hasattr(t, "cpu") else t, float)

    g_liu, g_sp, w_liu, w_sp, q, L = map(arr, (*got, *want, Q, lam))
    with np.errstate(all="ignore"):
        mean = L.sum(-1)
        d = np.abs(q - mean) / np.abs(mean)
    cand = np.flatnonzero(d < SADDLE_NEAR_D)
    ref, tol = w_sp.copy(), np.full(q.shape, rtol)
    near = np.zeros(q.shape, bool)
    if cand.size:
        ext, _ = saddlepoint_extended(q[cand], L[cand], n_iters)
        take = ~np.isnan(ext)
        idx = cand[take]
        near[idx], ref[idx] = True, ext[take]
        tol[idx] = rtol + np.minimum(SADDLE_NEAR_MEAN / d[idx] ** 2,
                                     SADDLE_CAP)

    def rel(a, b, sel):
        sel = sel & ~np.isnan(b)
        if not sel.any():
            return 0.0
        return float((np.abs(a - b) / np.maximum(np.abs(b), 1e-300))[sel]
                     .max())

    out = dict(nan_equal=bool(np.array_equal(np.isnan(g_liu),
                                             np.isnan(w_liu))
                              and np.array_equal(np.isnan(g_sp),
                                                 np.isnan(w_sp))),
               excess=-np.inf)
    for g, r, tl in ((g_liu, w_liu, rtol), (g_sp, ref, tol)):
        fin = ~np.isnan(r)
        if fin.any():
            gap = np.where(np.isnan(g), np.inf,
                           np.abs(g - r) - tl * np.abs(r))
            out["excess"] = max(out["excess"], float(gap[fin].max()))
    every = np.ones(q.shape, bool)
    out.update(rel_liu=rel(g_liu, w_liu, every),
               rel_far=rel(g_sp, w_sp, ~near),
               near_mean=int(near.sum()),
               near_d_min=float(d[near].min()) if near.any() else None,
               rel_near=rel(g_sp, ref, near),
               rel_near_plain=rel(w_sp, ref, near),
               rel_near_vs_plain=rel(g_sp, w_sp, near))
    return out


def check_tails(got, want, Q, lam, label, n_iters=40):
    """Assert K6b's rule (``tails_gaps``) on ``got``; returns the gaps."""
    gaps = tails_gaps(got, want, Q, lam, n_iters)
    assert gaps["nan_equal"], f"{label}: NaN where the plain is not"
    assert gaps["excess"] <= 1e-300, f"{label}: {gaps}"
    return gaps


def check_mixture_tails(Q, lam, n_iters=40, tag=None):
    """K6b on one batch's (Q, lambda) by ``check_tails``'s rule (1e-9
    relative of the plain version, floor 1e-300, NaN where it is NaN; the
    saddlepoint of the pairs near their mean against its formula in
    extended precision), and a second launch bit-equal to the first; the
    row keeps the rule's gaps (``tails_gaps``).  Its operation bound
    counts what these pairs run (``k6b_operations``: the gammaincc
    iterations of each pair's Liu tail, rendered in NumPy, and the n_iters
    + 60 bisection steps), at the FP64 CUDA-core rate.  One row,
    ``mixture_tails[ (<tag>)]``."""
    import torch

    from cellregmap_tpu_torch.kernels import mixture_tails as k6b

    got = k6b.mixture_tails(Q, lam, n_iters)
    want = k6b.mixture_tails_plain(Q, lam, n_iters)
    again = k6b.mixture_tails(Q, lam, n_iters)
    torch.cuda.synchronize()
    name = tagged("mixture_tails", tag) if tag else "mixture_tails"
    gaps = check_tails(got, want, Q, lam, name, n_iters)
    for g, a, which in zip(got, again, ("pv_liu", "pv_saddlepoint")):
        assert torch.equal(a.view(torch.int64), g.view(torch.int64)), \
            f"{name} {which}: a second launch differs"
    err = max(float((g - w)[~torch.isnan(w)].abs().max())
              for g, w in zip(got, want))
    P, C = lam.shape
    ops, calls, its = k6b_operations(Q.cpu().numpy(), lam.cpu().numpy(),
                                     n_iters + 60)
    t_ops = ops / PEAK_F64_CUDA_FLOPS * 1e3
    t_bytes = F64 * (P * C + P + 2 * P) / PEAK_HBM_BYTES * 1e3
    return dict(
        name=name, route="cuda",
        source="cellregmap_tpu_torch/csrc/mixture_tails.cu",
        replaces="cellregmap_tpu/models/pvalues.py:31", max_abs_err=err,
        ms=cuda_ms(lambda: k6b.mixture_tails(Q, lam, n_iters)),
        plain_ms=cuda_ms(lambda: k6b.mixture_tails_plain(Q, lam, n_iters)),
        bound_ms=max(t_ops, t_bytes),
        bound_by="operations" if t_ops >= t_bytes else "bytes",
        library_ms=None, device=device_ms(
            lambda: k6b.mixture_tails(Q, lam, n_iters)),
        pairs=P, contexts=C, operations=ops, gammaincc_calls=calls,
        gammaincc_iterations=its,
        **{k: gaps[k] for k in ("near_mean", "near_d_min", "rel_near",
                                "rel_near_plain", "rel_far", "rel_liu")},
        min_pv=[float(t[~torch.isnan(t)].min()) for t in got],
        tolerance="|err| <= 1e-9 |plain| + 1e-300, NaN where plain is NaN; "
                  "the saddlepoint within 1e-3 of the mean against its "
                  "formula in long double, 1e-9 + min(1e-15 / d^2, 1e-6)")


def _rel(a, b):
    """max |a - b| / |b| over the finite entries of b (equal infinities
    count as agreement)."""
    import torch

    fin = torch.isfinite(b)
    assert torch.equal(fin, torch.isfinite(a)), "non-finite entries differ"
    if not bool(fin.any()):
        return 0.0
    return float(((a - b).abs() / b.abs().clamp(min=1e-300))[fin].max())


def k4_bound(V, T, kb, per_gene=False):
    """K4's bound on one call (V, T and the factors in their own type: f32
    in the float32 context): 2 R^2 C flop for each distinct (rho,
    variant) pair of k_best ([genes,] S), since genes whose best rho
    agrees share the product V[k]^T T[:, :, s]; V's used slices and T read
    once, each distinct pair's factor written once (K4's slots), k_best
    read and the slots written once.  ``per_gene``: the bound of the
    contract before the slots, a factor written for every (gene,
    variant).  Returns (ms, by, distinct rho points, distinct pairs)."""
    import torch

    R, C, S = T.shape
    es = T.element_size()
    keys = kb.reshape(-1, S) * S + torch.arange(S, device=kb.device)
    n_pairs = int(torch.unique(keys).numel())
    n_k = int(torch.unique(kb).numel())
    if per_gene:
        nbytes = (es * (n_k * R * R + R * C * S + kb.numel() * R * C)
                  + F64 * kb.numel())
    else:
        nbytes = (es * (n_k * R * R + R * C * S + n_pairs * R * C)
                  + F64 * 2 * kb.numel())
    b_ms, b_by = bound(2 * R * R * C * n_pairs, nbytes)
    return b_ms, b_by, n_k, n_pairs


def k4_library_ms(V, T, kb, chunk=64):
    """K4's yardstick on one call: ``bmm`` of V gathered at each variant's
    best rho against T, ``chunk`` variants at a time."""
    import torch

    def library():
        for s0 in range(0, T.shape[2], chunk):
            sl = slice(s0, s0 + chunk)
            torch.bmm(V[kb[sl]].transpose(1, 2), T[:, :, sl].permute(2, 0, 1))

    return cuda_ms(library)


def k4_matmul_ms(V, T, n_pairs):
    """cuBLAS's rate at K4's shapes: one ``matmul`` of V[0]^T (R x R)
    against T as (R, C S), its columns repeated to C n_pairs (the distinct
    pairs' work), in T's type (TF32 off for f32)."""
    import torch

    R, C, S = T.shape
    X = T.reshape(R, C * S)
    X = X.repeat(1, -(-n_pairs // S))[:, :C * n_pairs].contiguous()
    Vt = V[0].T.contiguous()
    return cuda_ms(lambda: torch.matmul(Vt, X))


def check_best_rho_rotate(V, T, kb, what):
    """K4 against its plain version on one call: the slots equal, the
    factors gathered through them within 1e-12 of max|plain|.  Returns the
    max abs error of the gathered factors."""
    import torch

    from cellregmap_tpu_torch.kernels import best_rho_rotate as k4

    (At, slot), (At_p, slot_p) = (k4.best_rho_rotate(V, T, kb),
                                  k4.best_rho_rotate_plain(V, T, kb))
    torch.cuda.synchronize()
    assert At.shape == At_p.shape, f"{what}: {At.shape} != {At_p.shape}"
    assert torch.equal(slot, slot_p), f"{what}: the slots differ"
    got, ref = k4.gather(At, slot), k4.gather(At_p, slot_p)
    err = float((got - ref).abs().max())
    rel = err / float(ref.abs().max())
    assert rel <= 1e-12, f"{what}: rel {rel}"
    return err


def _fit_flops(p1, R, problems, deriv_steps):
    """Flops of the Newton kernel's reductions: per eigen row, the
    normal-equation products (ne) with three weight families (2 flop
    each) and the weights for a derivative step, one family for a value."""
    ne = p1 * (p1 + 1) // 2 + p1 + 1
    return problems * R * (deriv_steps * (7 * ne + 12) + (3 * ne + 4))


def check_delta_grid(call, library=True, plain_reps=10, tag=None):
    """K2 (or K7's grid): the kernel against its plain version on one
    call's operands; a bracket may sit on a near-tie neighbour of the
    plain argmax (plain lml within 1e-5 relative of the maximum in
    float32, 1e-12 in float64).  In the float32 context (f32 operands) the
    REML brackets are the f32-rounded grid logits (the ML ones the f64
    logits), and its operands count 4 bytes each in the bound."""
    import torch

    from cellregmap_tpu_torch.kernels import delta_grid as k2

    args, kw = call
    S, WGt, yt, comp, ld_xx, lo, hi, K, n, fast = args[:10]
    restricted = kw.get("restricted", True)
    br_lo, br_hi = k2.delta_grid(*args, **kw)
    plo, phi, lml = k2.delta_grid_plain(*args, **kw, return_lml=True)
    torch.cuda.synchronize()
    # the brackets' logits: the context's dtype (REML), f64 (ML)
    gap = k2.bracket_shortfall(br_lo, br_hi, lml, lo, hi,
                               S.dtype if restricted else torch.float64)
    tol = 1e-5 if fast == torch.float32 else 1e-12
    assert gap <= tol, f"delta_grid: bracket shortfall {gap} > {tol}"
    err = max(float((br_lo - plo).abs().max()),
              float((br_hi - phi).abs().max()))
    nrho, R = S.shape
    p = comp.CWW.shape[0]
    nS = WGt.shape[2] - p
    genes = math.prod(yt.shape[:-2])      # 1, or the gene-batched scan's
    # weighted sums per (rho, grid point, eigen row), 2 flop each: those
    # that no phenotype enters (g W_j and g^2 per variant, W_i W_j and the
    # log-determinant) counted once, the phenotype's (g y per variant,
    # W_j y, y^2) once per gene
    shared = nS * (p + 1) + p * (p + 1) // 2 + 1
    flops = 2 * nrho * K * R * (shared + genes * (nS + p + 1))
    es = S.element_size()
    nbytes = (es * (WGt.numel() + (1 + genes) * S.numel()
                    + genes * nS * (p + 4))
              + F64 * genes * 2 * nS * nrho)
    # the float32 context's sums are split-TF32 products (the FP32 FMA
    # figure beside them)
    tf32 = S.dtype == torch.float32
    b_ms, b_by = bound(flops, nbytes, split_tf32=tf32)
    lib_ms = None
    if library:
        # the JAX form: the (nrho, K, R) weights, materialized, against
        # the rotated products as one batched GEMM
        dl = torch.sigmoid(k2.logit_grid(lo, hi, K, S.device)).to(fast)
        Wd = 1.0 / ((1 - dl)[None, :, None] * S.to(fast)[:, None, :]
                    + dl[None, :, None])
        Gt, Wt = WGt[:, :, p:], WGt[:, :, :p]
        fam = torch.cat([Gt * Wt[:, :, j:j + 1] for j in range(p)]
                        + [Gt * Gt, Gt * yt[:, :, None]], dim=2).to(fast)
        lib_ms = cuda_ms(lambda: torch.bmm(Wd, fam))
    name = "delta_grid" if restricted else "delta_grid (ML)"
    if tag:
        name = tagged(name, tag)
    return dict(
        name=name, route="cuda",
        source="cellregmap_tpu_torch/csrc/delta_grid.cu",
        replaces="cellregmap_tpu/engine.py:460", max_abs_err=err,
        ms=cuda_ms(lambda: k2.delta_grid(*args, **kw)),
        plain_ms=cuda_ms(lambda: k2.delta_grid_plain(*args, **kw),
                         reps=plain_reps, warmup=min(2, plain_reps)),
        bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms, flops=flops,
        nbytes=nbytes, bracket_shortfall=gap,
        bound_fp32_ms=bound(flops, nbytes)[0] if tf32 else None,
        tolerance=f"plain lml at the kernel's grid point within {tol} "
                  "relative of the plain maximum")


def _check_converge(call, plain_reps=10):
    """The converge kernel against its plain version; rel errors <= 1e-9.
    Returns (max abs err, ms, plain ms)."""
    import torch

    from cellregmap_tpu_torch.kernels import reml_newton as k3

    args, kw = call
    got = k3.reml_converge(*args, **kw)
    want = k3.reml_converge_plain(*args, **kw)
    torch.cuda.synchronize()
    for g, w, name in zip(got, want, ("delta", "lml", "scale", "beta")):
        rel = _rel(g, w)
        assert rel <= 1e-9, f"reml_converge {name}: rel {rel}"
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    return (err, cuda_ms(lambda: k3.reml_converge(*args, **kw)),
            cuda_ms(lambda: k3.reml_converge_plain(*args, **kw),
                    reps=plain_reps, warmup=min(2, plain_reps)))


def _check_refit_converge(calls, plain_reps=10, genes=1):
    """K7's converge launches of one refit batch (the Newton steps, then
    the f64 fit at each end of the grid) against their plain versions:
    (max abs err, ms, plain ms, flops, bytes) summed over the launches,
    each launch's S, W G and y read once and its outputs written once."""
    err = ms = plain = flops = nbytes = 0.0
    for call in calls:
        e, m, pl = _check_converge(call, plain_reps)
        err, ms, plain = max(err, e), ms + m, plain + pl
        args = call[0]
        p = args[3].CWW.shape[0]
        nS = args[1].shape[2] - p
        flops += _fit_flops(p + 1, args[0].shape[1], genes * nS, args[10])
        nbytes += args[0].element_size() * (
            args[0].numel() + args[1].numel() + args[2].numel()
            + genes * nS * (p + 4))
    return err, ms, plain, flops, nbytes


def check_reml_newton(loc_call, conv_call, plain_reps=10, tag=None):
    """K3: localize (k_best equal, x at rel 1e-9, lml at 1e-10) and
    converge (rel 1e-9) against their plain versions.  Two rows, a
    wrapper call each: ``reml_newton (localize[, <tag>])`` and
    ``reml_newton (converge[, <tag>])``."""
    import torch

    from cellregmap_tpu_torch.kernels import reml_newton as k3

    args, kw = loc_call
    x, lml_all, kb = k3.reml_localize(*args, **kw)
    xp, lml_p, kb_p = k3.reml_localize_plain(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(kb, kb_p), "reml_localize: k_best differs"
    assert _rel(x, xp) <= 1e-9, f"reml_localize x: rel {_rel(x, xp)}"
    assert _rel(lml_all, lml_p) <= 1e-10, \
        f"reml_localize lml: rel {_rel(lml_all, lml_p)}"
    fin = torch.isfinite(lml_p)
    err = max(float((x - xp).abs().max()),
              float((lml_all - lml_p)[fin].abs().max()))
    loc_ms = cuda_ms(lambda: k3.reml_localize(*args, **kw))
    loc_plain = cuda_ms(lambda: k3.reml_localize_plain(*args, **kw),
                        reps=plain_reps, warmup=min(2, plain_reps))
    c_err, c_ms, c_plain = _check_converge(conv_call, plain_reps)

    S, WGt, yt, comp = args[:4]
    steps, steps3 = args[8], conv_call[0][10]
    nrho, R = S.shape
    p = comp.CWW.shape[0]
    nS = WGt.shape[2] - p
    genes = math.prod(yt.shape[:-2])      # 1, or the gene-batched scan's
    n_k = int(torch.unique(kb).numel())
    # the localize: every rho's rows, the complements and the brackets
    # read, x, lml and k_best written; the converge: the best rho points'
    # rows and the brackets read, delta, lml, scale and beta written
    loc_bound = bound(
        _fit_flops(p + 1, R, genes * nS * nrho, steps),
        F64 * (WGt.numel() + (1 + genes) * S.numel()
               + genes * (nS * (p + 4) + 4 * nS * nrho + nS)))
    conv_bound = bound(_fit_flops(p + 1, R, genes * nS, steps3),
                       F64 * (n_k * R * (p + 2) + genes * nS * (p + 4)))
    suffix = f", {tag})" if tag else ")"
    common = dict(route="cuda",
                  source="cellregmap_tpu_torch/csrc/reml_newton.cu",
                  replaces="cellregmap_tpu/engine.py:538", library_ms=None)
    return [
        dict(common, name="reml_newton (localize" + suffix, max_abs_err=err,
             ms=loc_ms, plain_ms=loc_plain, bound_ms=loc_bound[0],
             bound_by=loc_bound[1],
             tolerance="k_best equal, x rel <= 1e-9, lml rel <= 1e-10"),
        dict(common, name="reml_newton (converge" + suffix,
             max_abs_err=c_err, ms=c_ms, plain_ms=c_plain,
             bound_ms=conv_bound[0], bound_by=conv_bound[1],
             tolerance="delta, lml, scale, beta rel <= 1e-9",
             note=CONVERGE_NOTE)]


def refit_rows(grid, conv_calls, replaces, tag, plain_reps=10, genes=1):
    """K7's two rows from its grid's row and its converge launches of one
    batch: ``association_refit (grid[, <tag>])``, one wrapper call, and
    ``association_refit (converge[, <tag>])``, timed over the batch's
    converge calls (the same kernel each)."""
    c_err, c_ms, c_plain, c_flops, c_bytes = _check_refit_converge(
        conv_calls, plain_reps, genes=genes)
    suffix = f", {tag})" if tag else ")"
    common = dict(route="cuda", replaces="cellregmap_tpu/" + replaces,
                  library_ms=None)
    b_ms, b_by = bound(c_flops, c_bytes)
    return [
        dict(grid, **common, name="association_refit (grid" + suffix,
             source="cellregmap_tpu_torch/csrc/delta_grid.cu"),
        dict(common, name="association_refit (converge" + suffix,
             source="cellregmap_tpu_torch/csrc/reml_newton.cu",
             max_abs_err=c_err, ms=c_ms, plain_ms=c_plain, bound_ms=b_ms,
             bound_by=b_by, calls=len(conv_calls),
             tolerance="delta, lml, scale, beta rel <= 1e-9",
             note=CONVERGE_NOTE)]


def check_association_kernels(ctx, G, n, plain_reps=10):
    """K7 (the ML delta grid and the ML converge of one refit batch) and
    K10 (the null fit over the rho grid) on the headline's Ls context."""
    from cellregmap_tpu_torch import engine

    k_rho = int(engine.null_association_fit(ctx, n,
                                            delta_cfg=ASSOC_DELTA_CFG)[1])
    calls = capture_kernel_inputs(
        lambda: engine.association_refit_batch(ctx, G, k_rho, n,
                                               delta_cfg=ASSOC_DELTA_CFG),
        ["delta_grid", "reml_converge"])
    grid = check_delta_grid(calls["delta_grid"][0], library=False,
                            plain_reps=plain_reps)
    k7 = refit_rows(grid, calls["reml_converge"], "engine.py:875", None,
                    plain_reps)

    calls = capture_kernel_inputs(
        lambda: engine.null_association_fit(ctx, n,
                                            delta_cfg=ASSOC_DELTA_CFG),
        ["null_fit"])
    (args, kw), = calls["null_fit"]
    return k7 + [check_null_fit_narrow(args, kw, "null_fit",
                                       "cellregmap_tpu/engine.py:268")]


def null_fits_agree(fits, plain, data, n, restricted, name):
    """K10's fits against the plain ones; returns the gaps.  float64:
    ``null_fit.fit_gaps`` at 1e-10.  float32 (two f32 golden sections stop
    at different points of an lml flat to f32 resolution), gene by gene:
    the lml within 1e-5 (relative), the f64 objective at the kernel's delta
    no lower than at the plain one's by more than 1e-6 of it, beta and the
    scale within 1e-3 of the f64 values at the kernel's delta (of their
    largest entry)."""
    import torch

    from cellregmap_tpu_torch.kernels import null_fit as k10
    from cellregmap_tpu_torch.models.lmm import lml_at_delta_eig

    if data.S.dtype == torch.float64:
        gaps = k10.fit_gaps(fits, plain, data, n, restricted)
        assert max(gaps.values()) <= 1e-10, f"{name}: {gaps}"
        return gaps
    genes = data.yt.shape[0] if data.yt.ndim == 3 else 0
    gaps = dict(lml=0.0, lml_at_delta=0.0, beta=0.0, scale=0.0)
    for g in range(max(genes, 1)):
        pick = (lambda t: t[g]) if genes else (lambda t: t)  # noqa: E731
        f, pl = type(fits)(*map(pick, fits)), type(plain)(*map(pick, plain))
        dg = k10.gene_data(data, g) if genes else data
        d64 = type(dg)(*(t.double() for t in dg))
        at_k = lml_at_delta_eig(f.delta.double()[:, None], d64, n,
                                restricted)
        at_p = lml_at_delta_eig(pl.delta.double()[:, None], d64, n,
                                restricted)
        lk, lp = at_k[0][:, 0], at_p[0][:, 0]
        gaps["lml"] = max(gaps["lml"], _rel(f.lml, pl.lml))
        gaps["lml_at_delta"] = max(gaps["lml_at_delta"],
                                   float(((lp - lk) / lp.abs()).max()))
        for k, got, want in (("beta", f.beta, at_k[1][:, 0]),
                             ("scale", f.scale, at_k[2][:, 0])):
            gaps[k] = max(gaps[k], float((got.double() - want).abs().max()
                                         / want.abs().max()))
    assert gaps["lml"] <= 1e-5 and gaps["lml_at_delta"] <= 1e-6 \
        and gaps["beta"] <= 1e-3 and gaps["scale"] <= 1e-3, f"{name}: {gaps}"
    return gaps


def check_null_fit_narrow(args, kw, name, replaces, plain_reps=3):
    """K10's narrow instantiation on one call's operands: its fits through
    ``null_fit.fit_gaps`` at 1e-10, timed beside its plain version.  The
    bound counts each evaluation's pass over the rows (the weights, a log
    and the packed triangle's sums) at every grid point, golden-section
    step and final fit, and logdet(X^T X) once a rho point where REML."""
    import torch

    from cellregmap_tpu_torch.kernels import null_fit as k10

    data, n, restricted, lo, hi, n_grid, n_iters = args
    fits = k10.null_fit(*args, **kw)
    plain = k10.null_fit_plain(*args, **kw)
    torch.cuda.synchronize()
    gaps = null_fits_agree(fits, plain, data, n, restricted, name)
    nrho, R = data.S.shape
    p = data.Xt.shape[2]
    evals = nrho * (n_grid + n_iters + 3 + int(restricted))
    flops = evals * R * (3 * (p * (p + 1) // 2 + p + 1) + 8)
    nbytes = data.S.element_size() * (nrho * R * (p + 2)
                                      + nrho * (p * p + p + 1)
                                      + nrho * (p + 6))
    b_ms, b_by = bound(flops, nbytes)
    return dict(
        name=name, route="cuda",
        source="cellregmap_tpu_torch/csrc/null_fit.cu", replaces=replaces,
        max_abs_err=float((fits.lml - plain.lml).abs().max()),
        ms=cuda_ms(lambda: k10.null_fit(*args, **kw)),
        plain_ms=cuda_ms(lambda: k10.null_fit_plain(*args, **kw),
                         reps=plain_reps),
        bound_ms=b_ms, bound_by=b_by, library_ms=None, gaps=gaps,
        shapes=dict(nrho=nrho, R=R, p=p, n_grid=n_grid, n_iters=n_iters),
        tolerance=NULL_FIT_TOLERANCE[str(data.S.dtype)])


NULL_FIT_TOLERANCE = {
    "torch.float64": "lml, plain lml at the kernel's delta, beta and scale "
                     "at that delta: rel <= 1e-10",
    "torch.float32": "lml rel <= 1e-5; the f64 objective at the kernel's "
                     "delta >= at the plain one's - 1e-6 rel; beta, scale "
                     "within 1e-3 of the f64 values there"}


def device_split(fn, reps=3):
    """Device milliseconds a call of ``fn`` spends in each CUDA kernel, by
    the kernel's name (its template arguments kept), from
    ``torch.profiler`` over ``reps`` calls after one warm-up.  The
    profiler now and then drops a call's kernels (or every event): a
    trace whose kernel counts are not whole multiples of ``reps`` is
    taken again, up to four times, and each kernel's time a call is its
    mean time a launch times its launches a call."""
    import re

    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    out = {}
    for _ in range(4):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        seen = {}
        for e in prof.key_averages():
            us = getattr(e, "device_time_total", None)
            if us is None:
                us = getattr(e, "cuda_time_total", 0)
            if us > 0:  # a kernel (its launch on the host has none)
                name = re.sub(r"\(.*", "", e.key.replace(
                    "(anonymous namespace)::", "").replace("void ", ""))
                t, c = seen.get(name, (0.0, 0))
                seen[name] = (t + us / 1e3, c + e.count)
        out = {name: t / c * max(1, round(c / reps))
               for name, (t, c) in seen.items()}
        if seen and all(c % reps == 0 for _, c in seen.values()):
            break
    assert out, "the profiler saw no device time"
    return out


def tagged(name, tag):
    """A kernel row's name with ``tag`` added: ``base (part, tag)`` or
    ``base (tag)``."""
    if name.endswith(")"):
        return f"{name[:-1]}, {tag})"
    return f"{name} ({tag})"


def check_wide_kernels(ctx, ctx_assoc, G, n):
    """K2, K3, K5, K7 and K8 in their wide instantiations (the contexts'
    p columns of W, nrho rho points) on one batch's operands, each
    against its plain version with the headline's tolerances: K2, K3 and
    K5 on the interaction's context ``ctx``, K7 and K8 on the association's
    ``ctx_assoc``.  Returns their kernel rows, named with the width."""
    from cellregmap_tpu_torch import engine
    from cellregmap_tpu_torch.kernels import reml_newton as k3

    p = ctx.W.shape[1]
    tag = f"p = {p}"
    calls = capture_kernel_inputs(
        lambda: engine.interaction_batch(ctx, G, G, n, delta_cfg=DELTA_CFG),
        ["delta_grid", "reml_localize", "reml_converge", "score_core"])
    # the plain versions at this width take seconds a call: timed once
    k2_row = check_delta_grid(calls["delta_grid"][0], library=False,
                              plain_reps=1)
    k3_rows = check_reml_newton(calls["reml_localize"][0],
                                calls["reml_converge"][0], plain_reps=1)
    k3_rows[0]["split_ms"] = device_split(
        lambda: k3.reml_localize(*calls["reml_localize"][0][0],
                                 **calls["reml_localize"][0][1]))
    (args, _), = calls["score_core"]
    k5_row = check_score_core(args, plain_reps=3)
    k7_rows = check_association_kernels(ctx_assoc, G, n, plain_reps=1)[:2]
    k8_row = check_fast_scan(ctx_assoc, G, n, plain_reps=1)
    rows = [k2_row, *k3_rows, k5_row, *k7_rows, k8_row]
    for r in rows:
        r["name"] = tagged(r["name"], tag)
        print(f"kernel {r['name']}: max_abs_err {r['max_abs_err']:.3e} "
              f"({r['tolerance']}); ms {r['ms']:.4f}  plain_ms "
              f"{r['plain_ms']:.4f}  bound_ms {r['bound_ms']:.4f} "
              f"({r['bound_by']})" + (f"; split {json.dumps(r['split_ms'])}"
                                      if "split_ms" in r else ""),
              flush=True)
    return rows


def association_path(label, d, cfg, Ls=None, cpu_check=64):
    """One association main path as a user runs it: ``run_association``
    with hK, or ``scan_association`` on an Ls scanner; launch counts of
    the run, p-values in (0, 1], and the first ``cpu_check`` variants and
    the null's best rho against the port on the CPU."""
    import torch

    import cellregmap_tpu_torch as crp
    from cellregmap_tpu_torch import kernels

    n_snps = d["G"].shape[1]
    batches = -(-n_snps // cfg.snp_batch)

    def run(G, device):
        if Ls is None:
            return crp.run_association(d["y"], d["W"], d["E"], G,
                                       hK=d["hK"], config=cfg, device=device)
        return crp.CellRegMap(y=d["y"], E=d["E"], W=d["W"], Ls=Ls,
                              config=cfg, device=device).scan_association(G)

    run(d["G"][:, :cfg.snp_batch], "cuda")      # warm-up
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    pv, info = run(d["G"], "cuda")
    torch.cuda.synchronize()
    e2e_s = time.perf_counter() - t0
    counts = kernels.launch_counts()
    assert pv.shape == (n_snps,) and np.all((pv > 0) & (pv <= 1)), \
        f"{label}: p-values outside (0, 1]"
    # K3's converge three times a batch: the Newton steps, then the f64
    # fit at each end of the grid (engine._best_of_grid_ends)
    want = expected_launches(delta_grid=batches, reml_newton=3 * batches,
                             null_fit=1)
    assert counts == want, f"{label}: launches {counts} != {want}"
    pv_c, info_c = run(d["G"][:, :cpu_check], "cpu")
    gap = float(np.max(np.abs(pv[:cpu_check] - pv_c)))
    assert gap <= 1e-9, f"{label}: |pv_gpu - pv_cpu| = {gap}"
    assert np.array_equal(info["rho1"], info_c["rho1"]), \
        f"{label}: the null's best rho differs between the card and the CPU"
    out = dict(label=label, n_cells=len(d["y"]), n_snps=n_snps,
               batch=cfg.snp_batch, e2e_s=e2e_s,
               e2e_tests_per_s=n_snps / e2e_s, launches=counts,
               rho1=float(info["rho1"][0]), min_pv=float(pv.min()),
               cpu_check=dict(n=cpu_check, max_abs_pv_diff=gap,
                              rho1_identical=True))
    print(f"association {label}: " + json.dumps(out), flush=True)
    return out, counts


class _EventLog(logging.Handler):
    """The package's structured log lines (``trace.log_event``) of a
    ``with`` block, as dicts."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.records = []
        self._logger = logging.getLogger("cellregmap_tpu_torch")

    def emit(self, record):
        self.records.append(json.loads(record.getMessage()))

    def __enter__(self):
        self._level = self._logger.level
        self._logger.setLevel(logging.INFO)
        self._logger.addHandler(self)
        return self

    def __exit__(self, *exc):
        self._logger.removeHandler(self)
        self._logger.setLevel(self._level)


FAST_SCAN_TOLERANCE = {
    "torch.float64": dict(lml=1e-10, effsizes_g=1e-10, effsizes_W=1e-10,
                          scale=1e-10, text="lml, beta_g, beta_W, scale: "
                          "max|err| <= 1e-10 * max|plain|"),
    # f32 sums over R, an f32 Cholesky and the rank-1 update
    "torch.float32": dict(lml=1e-6, effsizes_g=1e-4, effsizes_W=1e-4,
                          scale=1e-4, text="lml: max|err| <= 1e-6 * "
                          "max|plain|; beta_g, beta_W, scale: 1e-4")}


def check_fast_scan(ctx, G, n, plain_reps=10):
    """K8 on one headline batch of the Ls scanner, at the null's best rho
    and delta: every output within 1e-10 of max|plain|."""
    import torch

    from cellregmap_tpu_torch import engine
    from cellregmap_tpu_torch.kernels import fast_scan as k8

    fits, k = engine.null_association_fit(ctx, n, delta_cfg=ASSOC_DELTA_CFG)
    k = int(k)
    delta = float(fits.delta[k])
    calls = capture_kernel_inputs(
        lambda: engine.fast_scan_batch(ctx, G, k, delta, n), ["fast_scan"])
    (args, kw), = calls["fast_scan"]
    got, want = k8.fast_scan(*args, **kw), k8.fast_scan_plain(*args, **kw)
    torch.cuda.synchronize()
    tols = FAST_SCAN_TOLERANCE[str(args[1].dtype)]
    err = 0.0
    for g, w, name in zip(got, want, want._fields):
        e = float((g - w).abs().max())
        rel = e / float(w.abs().max())
        assert rel <= tols[name], f"fast_scan {name}: rel {rel}"
        err = max(err, e)
    R, p = args[2].shape
    nS = args[7].shape[1]
    flops = R * nS * (2 * p + 6) + R * (p * (p + 1) + 2 * p + 6)
    nbytes = args[1].element_size() * (R * nS + R * (p + 2) + p * p + p + 1
                                       + nS * (p + 2) + nS * (p + 3))
    b_ms, b_by = bound(flops, nbytes)

    def library():
        # one cuBLAS GEMM of the weighted rotated [W, y] against Gt: the
        # reductions U and cgy alone
        Sb, Wt, yt, Gt = args[1], args[2], args[3], args[7]
        w = 1.0 / ((1 - delta) * Sb + delta)
        torch.matmul((torch.cat([Wt, yt[:, None]], dim=1) * w[:, None]).T, Gt)

    return dict(
        name="fast_scan" + (" (f32)" if args[1].dtype == torch.float32
                            else ""), route="cuda",
        source="cellregmap_tpu_torch/csrc/fast_scan.cu",
        replaces="cellregmap_tpu/engine.py:1132", max_abs_err=err,
        ms=cuda_ms(lambda: k8.fast_scan(*args, **kw)),
        plain_ms=cuda_ms(lambda: k8.fast_scan_plain(*args, **kw),
                         reps=plain_reps, warmup=min(2, plain_reps)),
        bound_ms=b_ms, bound_by=b_by, library_ms=cuda_ms(library),
        shapes=dict(R=R, p=p, S=nS), tolerance=tols["text"],
        split_ms=device_ms(lambda: k8.fast_scan(*args, **kw)),
        note=FAST_SCAN_NOTE)


def check_woodbury_family(bctx, G, norm, n, tag=None, with_library=True,
                          reps=5):
    """K9 on every call of one effect-size batch (five f32 zoom rounds over
    all rho, three f64 rounds on the top-2 rho, the f64 fit with
    coefficients): f64 lml within 1e-10 of max(|lml|, 1) with the same
    non-finite points, beta and rss within 1e-9 of their largest entry;
    f32 held to the f64 lml at no more than twice the plain f32 version's
    distance from it (``woodbury_family.f32_gaps``).  ``with_library``: time
    the Gram alone as one ``bmm`` a call (its materialized pair products
    take S Rk q (q + 1) / 2 doubles: the headline's widths only); ``reps``
    the timed runs of the kernel (the plain version's: reps - 2, at least
    1)."""
    import torch

    from cellregmap_tpu_torch import engine
    from cellregmap_tpu_torch.kernels import kr_contract as k1
    from cellregmap_tpu_torch.kernels import woodbury_family as k9

    captured = capture_kernel_inputs(
        lambda: engine.predict_interaction_batch(bctx, G, norm, n,
                                                 localize_f32=True),
        ["family_eval", "kr_contract"])
    calls = captured["family_eval"]
    # K1 at the effect sizes' widths (K = Rk, and V = B): 1e-12 as in 3
    k1_rel = 0.0
    for args, kw in captured["kr_contract"]:
        out, ref = k1.kr_contract(*args), k1.kr_contract_plain(*args)
        torch.cuda.synchronize()
        k1_rel = max(k1_rel, float((out - ref).abs().max()
                                   / ref.abs().max()))
    assert k1_rel <= 1e-12, f"kr_contract on the betas path: rel {k1_rel}"
    err, gaps32, gaps64 = 0.0, [], []
    flops = nbytes = 0
    pts = {"float32": 0, "float64": 0}
    for args, kw in calls:
        got, want = k9.family_eval(*args, **kw), k9.family_eval_plain(*args,
                                                                     **kw)
        torch.cuda.synchronize()
        logits, cols, compS = args[0], args[2], args[3]
        S, L = logits.shape
        Rk, C, _ = cols.Ua.shape
        q = compS.shape[1]
        sz = logits.element_size()
        flops += 2 * S * L * Rk * (q * (q + 1) // 2) + S * L * Rk * 6
        nbytes += sz * (S * Rk * (C + 1) + Rk * (q - C) + S * q * q
                        + 3 * S * L + S + Rk
                        + (S * L * (q - C) if kw.get("want_beta") else 0))
        pts[str(logits.dtype).split(".")[-1]] += L
        if logits.dtype == torch.float32:
            g = k9.f32_gaps(got, args, kw)
            assert g["mask"] == 0 and g["excess"] <= 1e-5, f"K9 f32: {g}"
            gaps32.append(g)
            fin = torch.isfinite(got) & torch.isfinite(want)
            err = max(err, float((got - want)[fin].abs().max()))
            continue
        if not kw.get("want_beta"):
            got, want = (got,), (want,)
        g = k9.lml_gaps(got[0], want[0])
        assert g["mask"] == 0 and g["rel"] <= 1e-10, f"K9 f64: {g}"
        gaps64.append(g)
        fin = torch.isfinite(want[0])
        err = max(err, float((got[0] - want[0])[fin].abs().max()))
        for a, b in zip(got[1:], want[1:]):
            rel = float((a - b).abs().max() / b.abs().max())
            assert rel <= 1e-9, f"K9 beta/rss: rel {rel}"
    b_ms, b_by = bound(flops, nbytes)

    def library():
        # the Gram alone, as one cuBLAS bmm per call: the points' weights
        # (S, L, Rk) against the materialized pair products (S, Rk, q(q+1)/2)
        for (args, _), (W, P) in zip(calls, lib_operands):
            torch.bmm(W, P)

    lib_operands = []
    for args, _ in (calls if with_library else ()):
        logits, rho, cols, _, Lam = args[:5]
        dl = torch.sigmoid(logits)
        W = 1.0 / ((1 - dl)[..., None] * ((1 - rho)[..., None] * Lam)
                   + dl[..., None])
        X = torch.cat([cols.Ua.permute(2, 0, 1),
                       cols.UB.expand(logits.shape[0], -1, -1),
                       cols.ug.T[:, :, None],
                       cols.uy.expand(logits.shape[0], -1)[:, :, None]], 2)
        iu = torch.triu_indices(X.shape[2], X.shape[2], device=X.device)
        lib_operands.append((W, X[:, :, iu[0]] * X[:, :, iu[1]]))
        del X
    lib_ms = cuda_ms(library, reps=5) if with_library else None
    del lib_operands
    by_kind = {}
    for args, kw in calls:
        kind = ("f32" if args[0].dtype == torch.float32
                else "f64 beta" if kw.get("want_beta") else "f64")
        by_kind[kind] = by_kind.get(kind, 0.0) + cuda_ms(
            lambda a=args, k=kw: k9.family_eval(*a, **k), reps=reps)
    return dict(
        name="woodbury_family" + (f" ({tag})" if tag else ""), route="cuda",
        source="cellregmap_tpu_torch/csrc/woodbury_family.cu",
        replaces="cellregmap_tpu/models/lmm.py:435", max_abs_err=err,
        ms=cuda_ms(lambda: [k9.family_eval(*a, **kw) for a, kw in calls],
                   reps=reps),
        plain_ms=cuda_ms(lambda: [k9.family_eval_plain(*a, **kw)
                                  for a, kw in calls], reps=max(1, reps - 2),
                         warmup=1),
        bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms, calls=len(calls),
        points_per_variant=pts, flops=flops, nbytes=nbytes,
        f32_excess=max(g["excess"] for g in gaps32),
        f64_rel=max(g["rel"] for g in gaps64), k1_betas_rel=k1_rel,
        split_ms=by_kind, shapes=dict(S=G.shape[1], Rk=bctx.Zk.shape[1],
                                      q=calls[0][0][3].shape[1]),
        tolerance="f64: lml rel <= 1e-10 of max(|lml|, 1), same non-finite "
                  "points, beta/rss <= 1e-9 of max; f32: |kernel - f64| <= "
                  "2 |plain - f64| + 1e-5 max(|f64|, 1), masks equal where "
                  "f32 resolves the lml to 1e-3")


def fast_association_path(label, d, cfg, Ls=None, cpu_check=64):
    """One fast association main path as a user runs it:
    ``run_association_fast`` with hK, or ``scan_association_fast`` on an Ls
    scanner; launch counts, p-values in (0, 1], and the first
    ``cpu_check`` variants against the port on the CPU within the JAX
    suite's fast-scan budget (rtol 1e-5, atol 1e-12: the null's golden
    section stops ~1e-8 apart in delta on the two devices, and the
    alternative lml at a fixed delta moves with it)."""
    import torch

    import cellregmap_tpu_torch as crp
    from cellregmap_tpu_torch import kernels

    n_snps = d["G"].shape[1]
    batches = -(-n_snps // cfg.snp_batch)

    def run(G, device):
        if Ls is None:
            return crp.run_association_fast(d["y"], d["W"], d["E"], G,
                                            hK=d["hK"], config=cfg,
                                            device=device)
        return crp.CellRegMap(y=d["y"], E=d["E"], W=d["W"], Ls=Ls,
                              config=cfg, device=device
                              ).scan_association_fast(G)

    run(d["G"][:, :cfg.snp_batch], CARD)      # warm-up
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    pv, info = run(d["G"], CARD)
    torch.cuda.synchronize()
    e2e_s = time.perf_counter() - t0
    counts = kernels.launch_counts()
    assert pv.shape == (n_snps,) and np.all((pv > 0) & (pv <= 1)), \
        f"{label}: p-values outside (0, 1]"
    want = expected_launches(fast_scan=batches, null_fit=1)
    assert counts == want, f"{label}: launches {counts} != {want}"
    pv_c, info_c = run(d["G"][:, :cpu_check], "cpu")
    gap = float(np.max(np.abs(pv[:cpu_check] - pv_c)))
    excess = float(np.max(np.abs(pv[:cpu_check] - pv_c)
                          - (1e-5 * np.abs(pv_c) + 1e-12)))
    assert excess <= 0, f"{label}: |pv_gpu - pv_cpu| = {gap}"
    assert np.array_equal(info["rho1"], info_c["rho1"]), \
        f"{label}: the null's best rho differs between the card and the CPU"
    out = dict(label=label, n_cells=len(d["y"]), n_snps=n_snps,
               batch=cfg.snp_batch, e2e_s=e2e_s,
               e2e_tests_per_s=n_snps / e2e_s, launches=counts,
               rho1=float(info["rho1"][0]), min_pv=float(pv.min()),
               cpu_check=dict(n=cpu_check, max_abs_pv_diff=gap,
                              rho1_identical=True))
    print(f"association_fast {label}: " + json.dumps(out), flush=True)
    return out, counts


def betas_path(d, cfg, cpu_check=32):
    """The effect sizes as a user runs them, ``estimate_betas(...,
    hK=hK)`` at 2000 cells x 512 variants: a first call (kernel modules,
    the background factorization), a steady call, a traced call for the
    phase split; launch counts; finite outputs; then the first
    ``cpu_check`` variants' fits on the card against the CPU under the JAX
    suite's hybrid rule (tests/test_hybrid.py:62-79: a rho flip only where
    the lml gap is below 1e-4, beta_G within 1e-7 where rho agrees)."""
    import dataclasses

    import torch

    import cellregmap_tpu_torch as crp
    from cellregmap_tpu_torch import engine, kernels

    G, maf = d["G"][:, :BETAS_SNPS], d["maf"][:BETAS_SNPS]
    batches = -(-BETAS_SNPS // cfg.snp_batch)

    def run(c):
        return crp.estimate_betas(d["y"], d["W"], d["E"], G, maf=maf,
                                  hK=d["hK"], config=c, device=CARD)

    t0 = time.perf_counter()
    bg, bgxe = run(cfg)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    kernels.reset_launches()
    t0 = time.perf_counter()
    bg2, bgxe2 = run(cfg)
    torch.cuda.synchronize()
    steady_s = time.perf_counter() - t0
    counts = kernels.launch_counts()
    want = expected_launches(kr_contract=3 * batches,
                             woodbury_family=9 * batches)
    assert counts == want, f"betas: launches {counts} != {want}"
    assert bg.shape == (BETAS_SNPS,) and bgxe.shape == (len(d["y"]),
                                                        BETAS_SNPS)
    assert np.isfinite(bg).all() and np.isfinite(bgxe).all(), \
        "betas: non-finite effect sizes"
    assert np.array_equal(bg, bg2) and np.array_equal(bgxe, bgxe2), \
        "betas: rerun differs"
    # traced call: the phase split, from the package's structured log
    events = _EventLog()
    with events:
        t0 = time.perf_counter()
        run(dataclasses.replace(cfg, trace=True))
        traced_s = time.perf_counter() - t0
    phases = {k: v for ev in events.records
              if ev["event"] == "predict_interaction"
              for k, v in ev.items() if k.startswith("s_")}

    # the first variants' fits, card against CPU, with rho1 and lml
    Ls = crp.get_L_values(d["hK"], d["E"])
    norm = 1.0 / np.sqrt(2 * maf[:cpu_check] * (1 - maf[:cpu_check]))
    res = {}
    for dev in (CARD, "cpu"):
        bctx = engine.build_betas_context(d["y"], d["W"], d["E"], Ls,
                                          rho_grid=np.linspace(0, 1, 11),
                                          device=dev)
        bg_d, _, info = engine.predict_interaction_batch(
            bctx, torch.as_tensor(G[:, :cpu_check], device=dev),
            torch.as_tensor(norm, device=dev), len(d["y"]),
            localize_f32=cfg.hybrid_localization)
        res[dev] = (bg_d.cpu().numpy(), info["rho1"].cpu().numpy(),
                    info["lml"].cpu().numpy())
    (bg_g, rho_g, lml_g), (bg_c, rho_c, lml_c) = res[CARD], res["cpu"]
    flipped = rho_g != rho_c
    lml_gap = np.abs(lml_g - lml_c)
    assert np.all(lml_gap[flipped] < 1e-4), \
        f"betas: rho flips at lml gaps {lml_gap[flipped]}"
    bg_gap = float(np.max(np.abs(bg_g - bg_c)[~flipped]))
    assert bg_gap <= 1e-7, f"betas: |beta_g gpu - cpu| = {bg_gap}"
    assert np.allclose(bg[:cpu_check][~flipped], bg_g[~flipped], rtol=0,
                       atol=1e-12), "betas: the API and the engine differ"
    out = dict(n_cells=len(d["y"]), n_snps=BETAS_SNPS, batch=cfg.snp_batch,
               first_s=first_s, steady_s=steady_s,
               steady_tests_per_s=BETAS_SNPS / steady_s, traced_s=traced_s,
               traced_phase_s=phases, launches=counts,
               beta_g_planted=float(bg[GXE_SNP]),
               cpu_check=dict(n=cpu_check, rho_flips=int(flipped.sum()),
                              max_abs_beta_g_diff=bg_gap,
                              max_lml_gap=float(lml_gap.max())))
    print("betas: " + json.dumps(out), flush=True)
    return out, counts


def _aggregate_cases(d):
    """The aggregate environment's two scanners on the headline dataset:
    (label, y, E1): E1 = E, and a seeded (n, C) E1 outside E's span."""
    rng = np.random.default_rng(GXE_SNP)
    E1 = rng.normal(size=d["E"].shape) / np.sqrt(d["E"].shape[1])
    y1 = d["y"] + E1 @ rng.normal(size=E1.shape[1])
    return (("E1=E", d["y"], None), ("E1 outside E", y1, E1))


def _aggregate_M(d, g):
    """The aggregate environment's mean matrix [B, g], B the reduced design
    basis of [W, E] (rank 11 at 10 contexts: p = 12)."""
    from cellregmap_tpu_torch import engine

    return np.concatenate([engine.reduced_design_basis(d["W"], d["E"]),
                           g[:, None]], axis=1)


def aggregate_fit_call(d, cfg, crm=None):
    """K10's (args, kw) of the aggregate environment's REML mean fit on the
    scanner with an E1 outside E (``crm``, else made here on the card)."""
    import torch

    import cellregmap_tpu_torch as crp
    from cellregmap_tpu_torch import engine

    if crm is None:
        _, y, e1 = _aggregate_cases(d)[1]
        crm = crp.CellRegMap(y=y, E=d["E"], E1=e1, W=d["W"],
                             Ls=crp.get_L_values(d["hK"], d["E"]),
                             config=cfg, device=CARD)
    M = torch.as_tensor(_aggregate_M(d, d["G"][:, GXE_SNP]), device=CARD)
    (args, kw), = capture_kernel_inputs(
        lambda: engine.mean_fit(crm._ctx, M, len(d["y"]), True,
                                (cfg.delta_logit_lo, cfg.delta_logit_hi,
                                 cfg.n_delta_grid, cfg.n_golden_iters)),
        ["null_fit"])["null_fit"]
    return args, kw


def aggregate_environment_phase(d, cfg):
    """``estimate_aggregate_environment`` of the planted variant on the
    headline's Ls scanner: K10 (REML, M = [B, g], p = 12) launched once,
    the result finite and within 1e-5 (tests/test_api.py:180) of the CPU's.
    With E1 = E the null family's E E^T part lies in the span of [B, g], so
    the REML best rho is 0 and the aggregate exactly 0; the same call on a
    scanner whose E1 background (a seeded (n, C) draw) lies outside that
    span gives a non-zero aggregate, held in the same way; that call's K10
    operands give the p = 12 row (against the plain version, timed)."""
    import torch

    import cellregmap_tpu_torch as crp
    from cellregmap_tpu_torch import engine, kernels

    Ls = crp.get_L_values(d["hK"], d["E"])
    g = d["G"][:, GXE_SNP]
    n = len(d["y"])
    out, counts = {}, None
    for label, y, e1 in _aggregate_cases(d):
        crm = crp.CellRegMap(y=y, E=d["E"], E1=e1, W=d["W"], Ls=Ls,
                             config=cfg, device=CARD)
        kernels.reset_launches()
        t0 = time.perf_counter()
        agg = crm.estimate_aggregate_environment(g)
        torch.cuda.synchronize()
        e2e_s = time.perf_counter() - t0
        c = kernels.launch_counts()
        assert c == expected_launches(null_fit=1), \
            f"aggregate environment: launches {c}"
        counts = counts or c
        agg_c = crp.CellRegMap(y=y, E=d["E"], E1=e1, W=d["W"], Ls=Ls,
                               config=cfg, device="cpu"
                               ).estimate_aggregate_environment(g)
        assert agg.shape == (n,) and np.isfinite(agg).all()
        gap = float(np.max(np.abs(agg - agg_c)))
        assert gap <= 1e-5, f"aggregate environment: |gpu - cpu| = {gap}"
        # the REML fits' best rho
        M = torch.as_tensor(_aggregate_M(d, g), device=CARD)
        fits = engine.mean_fit(crm._ctx, M, n, True,
                               (cfg.delta_logit_lo, cfg.delta_logit_hi,
                                cfg.n_delta_grid, cfg.n_golden_iters))
        out[label] = dict(e2e_s=e2e_s, launches=c, max_abs_diff_cpu=gap,
                          max_abs=float(np.abs(agg).max()),
                          rho1=float(crm._rho_grid[int(fits.lml.argmax())]))
    assert out["E1 outside E"]["max_abs"] > 1e-3, \
        "aggregate environment: zero where E1 lies outside E"
    print("aggregate_environment: " + json.dumps(out), flush=True)
    args, kw = aggregate_fit_call(d, cfg, crm)
    row = check_null_fit_narrow(args, kw, "null_fit (p = 12)",
                                "cellregmap_tpu/engine.py:849")
    row["launches"] = counts["null_fit"]
    return out, counts, row


def scan_size(label, spec, cfg, warmup=True, cpu_check=0):
    """The main path at one size, run as a user runs it; returns
    (summary dict, launch counts of the untraced run, p-values, info)."""
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
    tails = 0 if cfg.pvalue_method == "davies" else batches
    want = expected_launches(kr_contract=3 * batches, delta_grid=batches,
                             reml_newton=2 * batches,
                             best_rho_rotate=batches, score_core=batches,
                             sym_eigvalsh=tails, mixture_tails=tails)
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
    return out, counts, pv, info


def covariates_phase(d, cpu_check=64):
    """``covariates_24``: the headline dataset (2000 cells, 10 contexts, 100
    donors) with W = [1, 23 columns of N(0, 1) (rng 24)], p = 24, and
    ``ScanConfig(n_rho=21)``, 512 variants through ``run_interaction``
    (davies), ``run_association_fast`` and ``run_association`` (hK), each
    with its launch counts (K2, K3, K5 and K8 in their wide
    instantiations: p + 1 > 16) and its first ``cpu_check`` variants
    against the port on the CPU at the headline budgets; then K2, K3, K5,
    K7 and K8 against their plain versions on the phase's operands; then a
    p = 33 scanner on the card, refused before any setup."""
    import torch

    import cellregmap_tpu_torch as crp
    from cellregmap_tpu_torch import engine, kernels

    n = len(d["y"])
    rng = np.random.default_rng(COVARIATES["seed"])
    W = np.concatenate([np.ones((n, 1)),
                        rng.normal(size=(n, COVARIATES["p"] - 1))], axis=1)
    G = d["G"][:, :COVARIATES["n_snps"]]
    cfg = crp.ScanConfig(snp_batch=BATCH, n_rho=COVARIATES["n_rho"])
    args = dict(y=d["y"], E=d["E"], W=W, hK=d["hK"], config=cfg)
    runs = (
        ("run_interaction", lambda g, dev: crp.run_interaction(
            G=g, device=dev, **args)),
        ("run_association_fast", lambda g, dev: crp.run_association_fast(
            d["y"], W, d["E"], g, hK=d["hK"], config=cfg, device=dev)),
        ("run_association", lambda g, dev: crp.run_association(
            d["y"], W, d["E"], g, hK=d["hK"], config=cfg, device=dev)),
    )
    want_wide = {"run_interaction": ("delta_grid", "reml_newton",
                                     "score_core"),
                 "run_association_fast": ("fast_scan",),
                 "run_association": ("delta_grid", "reml_newton")}
    out, counts = dict(p=W.shape[1], n_rho=cfg.n_rho, n_snps=G.shape[1]), {}
    for name, run in runs:
        kernels.reset_launches()
        t0 = time.perf_counter()
        pv, info = run(G, CARD)
        torch.cuda.synchronize()
        e2e_s = time.perf_counter() - t0
        c = kernels.launch_counts()
        counts[name] = c
        for k in want_wide[name]:
            assert c[k] > 0, f"covariates_24 {name}: {k} not launched"
        assert pv.shape == (G.shape[1],) and np.all((pv > 0) & (pv <= 1)), \
            f"covariates_24 {name}: p-values outside (0, 1]"
        t0 = time.perf_counter()
        pv_c, info_c = run(G[:, :cpu_check], "cpu")
        cpu_s = time.perf_counter() - t0
        gap = float(np.max(np.abs(pv[:cpu_check] - pv_c)))
        if name == "run_association_fast":
            rel = np.abs(pv[:cpu_check] - pv_c) - 1e-5 * np.abs(pv_c)
            assert float(rel.max()) <= 1e-12, \
                f"covariates_24 {name}: |gpu - cpu| = {gap}"
        else:
            tol = 1e-8 if name == "run_interaction" else 1e-9
            assert gap <= tol, f"covariates_24 {name}: |gpu - cpu| = {gap}"
        rho1 = np.asarray(info["rho1"])
        rho1 = rho1[:cpu_check] if rho1.shape else rho1
        assert np.array_equal(rho1, np.asarray(info_c["rho1"])), \
            f"covariates_24 {name}: rho1 differs between the card and CPU"
        out[name] = dict(e2e_s=e2e_s, tests_per_s=G.shape[1] / e2e_s,
                         launches={k: v for k, v in c.items() if v},
                         cpu_check=dict(n=cpu_check, max_abs_pv_diff=gap,
                                        cpu_s=cpu_s))
    print("covariates_24: " + json.dumps(out), flush=True)

    # the paths' own contexts: run_interaction takes hK as the K (.) E E^T
    # background (R = 1010), the association tests as K (R = 110)
    rho = np.linspace(0.0, 1.0, cfg.n_rho)
    ctx = engine.build_null_context(
        d["y"], W, d["E"], Ls=crp.get_L_values(d["hK"], d["E"]),
        rho_grid=rho, device=CARD)
    ctx_assoc = engine.build_null_context(d["y"], W, d["E"], hK=d["hK"],
                                          rho_grid=rho, device=CARD)
    Gb = torch.as_tensor(G[:, :BATCH], device=CARD).contiguous()
    rows = check_wide_kernels(ctx, ctx_assoc, Gb, n)

    # a scanner past the card's envelope is refused before any setup
    W33 = np.concatenate([W, rng.normal(size=(n, 9))], axis=1)
    t0 = time.perf_counter()
    try:
        crp.CellRegMap(y=d["y"], E=d["E"], W=W33, hK=d["hK"], device=CARD)
    except ValueError as e:
        refuse_s = time.perf_counter() - t0
        msg = str(e)
    else:
        raise AssertionError("covariates_24: a p = 33 scanner was accepted "
                             "on the card")
    assert "32" in msg and "33" in msg, msg
    assert refuse_s < 0.1, f"covariates_24: the refusal took {refuse_s} s"
    print(f"covariates_24 refusal (p = 33): {refuse_s * 1e3:.3f} ms: {msg}",
          flush=True)
    return out, counts, rows


def rho80_phase(cfg, cpu_check=64):
    """``ScanConfig(n_rho=80)`` through ``run_interaction`` on the card
    (``RHO80``: 1000 cells, 10 contexts, 50 donors, 512 variants): the
    launch counts, p-values in (0, 1], the first ``cpu_check`` variants
    against the CPU port (1e-8, rho1 identical), and K3's localize at 80
    rho points on one batch's operands against its plain version (k_best
    equal, x rel <= 1e-9, lml rel <= 1e-10), its converge and K5 beside
    it.  Returns (summary, launch counts, K3's two and K5's kernel rows)."""
    import dataclasses

    import torch

    import cellregmap_tpu_torch as crp
    from cellregmap_tpu_torch import engine, kernels

    d = make_dataset(**RHO80)
    n_snps = RHO80["n_snps"]
    cfg80 = dataclasses.replace(cfg, n_rho=N_RHO80)
    batches = -(-n_snps // cfg80.snp_batch)
    run = lambda G, device: crp.run_interaction(  # noqa: E731
        y=d["y"], E=d["E"], G=G, W=d["W"], hK=d["hK"], config=cfg80,
        device=device)
    kernels.reset_launches()
    t0 = time.perf_counter()
    pv, info = run(d["G"], CARD)
    torch.cuda.synchronize()
    e2e_s = time.perf_counter() - t0
    counts = kernels.launch_counts()
    want = expected_launches(kr_contract=3 * batches, delta_grid=batches,
                             reml_newton=2 * batches,
                             best_rho_rotate=batches, score_core=batches)
    assert counts == want, f"n_rho = 80: launches {counts} != {want}"
    assert np.all((pv > 0) & (pv <= 1)), "n_rho = 80: p-values outside (0, 1]"
    t0 = time.perf_counter()
    pv_c, info_c = run(d["G"][:, :cpu_check], "cpu")
    cpu_s = time.perf_counter() - t0
    gap = float(np.max(np.abs(pv[:cpu_check] - pv_c)))
    assert gap <= 1e-8, f"n_rho = 80: |pv_gpu - pv_cpu| = {gap}"
    assert np.array_equal(info["rho1"][:cpu_check], info_c["rho1"]), \
        "n_rho = 80: rho1 differs between the card and the CPU"

    # the localize at 80 rho points against its plain version
    n = len(d["y"])
    ctx = engine.build_null_context(
        d["y"], d["W"], d["E"], Ls=crp.get_L_values(d["hK"], d["E"]),
        rho_grid=np.linspace(0, 1, N_RHO80), device=CARD)
    Gb = torch.as_tensor(d["G"][:, :cfg80.snp_batch], device=CARD)
    calls = capture_kernel_inputs(
        lambda: engine.interaction_batch(ctx, Gb, Gb, n, delta_cfg=DELTA_CFG),
        ["reml_localize", "reml_converge", "score_core"])
    k3_rows = check_reml_newton(calls["reml_localize"][0],
                                calls["reml_converge"][0], plain_reps=3,
                                tag=f"n_rho = {N_RHO80}")
    k3_rows.append(check_score_core(calls["score_core"][0][0],
                                    tag=f"n_rho = {N_RHO80}", plain_reps=3))
    out = dict(n_cells=RHO80["n_cells"], n_donors=RHO80["n_donors"],
               n_rho=N_RHO80, n_snps=n_snps, e2e_s=e2e_s,
               e2e_tests_per_s=n_snps / e2e_s, launches=counts,
               cpu_check=dict(n=cpu_check, max_abs_pv_diff=gap,
                              rho1_identical=True, cpu_s=cpu_s),
               kernels={r["name"]: {k: r[k] for k in (
                   "max_abs_err", "ms", "bound_ms")} for r in k3_rows})
    print("n_rho = 80: " + json.dumps(out), flush=True)
    return out, counts, k3_rows


def auto_vs_davies(pv_auto, info_auto, pv_dav, cfg):
    """The auto method against the davies run of the same data: the pairs
    it refined (saddlepoint below davies_threshold) within 1e-8 of davies,
    the others equal to the device saddlepoint."""
    refined = info_auto["pv_saddlepoint"] < cfg.davies_threshold
    gap = float(np.max(np.abs(pv_auto - pv_dav)[refined], initial=0.0))
    assert gap <= 1e-8, f"auto: refined pairs {gap} from davies"
    assert np.array_equal(pv_auto[~refined],
                          info_auto["pv_saddlepoint"][~refined]), \
        "auto: unrefined pairs are not the device saddlepoint"
    sp_gap = np.abs(info_auto["pv_saddlepoint"] - pv_dav)
    return dict(refined=int(refined.sum()), n=int(pv_auto.size),
                max_abs_refined_vs_davies=gap,
                max_abs_saddlepoint_vs_davies=float(sp_gap.max()),
                max_abs_liu_vs_davies=float(np.max(
                    np.abs(info_auto["pv_liu"] - pv_dav))))


def check_gene_axis(ctx, Y, G, n):
    """K2-K5 with the gene axis, on the operands of one gene-batched batch
    at the multigene shape (the headline's context, Y's genes, G's
    variants), each against its plain version (one gene at a time) with
    the single-phenotype tolerances, timed beside it (plain: median of 3),
    and its bound counted for all the genes: the genotype's operands read
    once, and work that no phenotype enters (K2's genotype and W sums, K4's
    product for a (rho, variant) pair that several genes pick) done once."""
    import torch

    from cellregmap_tpu_torch import engine
    from cellregmap_tpu_torch.kernels import best_rho_rotate as k4
    from cellregmap_tpu_torch.kernels import score_core as k5

    Yg = torch.as_tensor(np.ascontiguousarray(Y.T), device=CARD)
    ctx_g = ctx._replace(y=Yg, Zy=Yg @ ctx.Z, Wy=Yg @ ctx.W,
                         yy=(Yg * Yg).sum(dim=1))
    Gb = torch.as_tensor(G, device=CARD).contiguous()
    calls = capture_kernel_inputs(
        lambda: engine.interaction_multigene_batch(
            ctx_g, Gb, Gb, n, delta_cfg=DELTA_CFG, device_pvalues=False),
        ["delta_grid", "reml_localize", "reml_converge", "best_rho_rotate",
         "score_core"])
    genes, nS = Y.shape[1], G.shape[1]
    loc, conv = check_reml_newton(calls["reml_localize"][0],
                                  calls["reml_converge"][0])
    rows = {"delta_grid": check_delta_grid(calls["delta_grid"][0],
                                           library=False),
            "reml_localize": loc, "reml_converge": conv}
    (V, T, kb), _ = calls["best_rho_rotate"][0]
    err = check_best_rho_rotate(V, T, kb, "best_rho_rotate (gene axis)")
    R, C, _ = T.shape
    b_ms, b_by, n_k, n_pairs = k4_bound(V, T, kb)
    rows["best_rho_rotate"] = dict(
        max_abs_err=err,
        ms=cuda_ms(lambda: k4.best_rho_rotate(V, T, kb)),
        plain_ms=cuda_ms(lambda: k4.best_rho_rotate_plain(V, T, kb), reps=3,
                         warmup=1), bound_ms=b_ms, bound_by=b_by,
        bound_ms_per_gene_store=k4_bound(V, T, kb, per_gene=True)[0],
        distinct_rho=n_k, distinct_rho_variant_pairs=n_pairs)
    (args, _), = calls["score_core"]
    (Q, Wm), (Qr, Wr) = k5.score_core(*args), k5.score_core_plain(*args)
    torch.cuda.synchronize()
    rel = max(float((Q - Qr).abs().max() / Qr.abs().max()),
              float((Wm - Wr).abs().max() / Wr.abs().max()))
    assert rel <= 1e-10, f"score_core (gene axis): rel {rel}"
    p = args[4].shape[0]
    m = C + p + 2
    n_k = int(torch.unique(args[13]).numel())
    # each distinct pair's factor read once (K4's slots)
    b_ms, b_by = bound(
        genes * nS * R * (3 * m * (m + 1) // 2 + 3),
        F64 * (n_pairs * R * C + genes * nS * R + n_k * R * (p + 2)
               + nS * (C * C + C * (p + 1)) + genes * nS * (C + p + 5)
               + genes * nS * (C * C + 1)))
    rows["score_core"] = dict(
        max_abs_err=max(float((Q - Qr).abs().max()),
                        float((Wm - Wr).abs().max())),
        ms=cuda_ms(lambda: k5.score_core(*args)),
        plain_ms=cuda_ms(lambda: k5.score_core_plain(*args), reps=3,
                         warmup=1), bound_ms=b_ms, bound_by=b_by)
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "bound_ms_per_gene_store", "split_ms", "distinct_rho",
            "distinct_rho_variant_pairs")
    out = dict(genes=genes, n_snps=nS,
               kernels={k: {kk: r[kk] for kk in keys if kk in r}
                        for k, r in rows.items()})
    print("gene axis: " + json.dumps(out), flush=True)
    return out


def multigene_phase(d, cfg):
    """``run_interaction_multigene`` at the JAX bench's ``multigene_16``
    shape (bench.py:479-506): Y = y + 0.1 N(0, 1) (rng 9) over 16 genes,
    512 variants, gene_batch = 16.  A first call (the scanner's setup,
    through ``run_interaction_multigene``) and a steady call on one
    scanner, with launch counts (one per kernel per gene tile and variant
    batch, K1 three times: shared by the genes); the per-gene loop
    (``with_phenotype(...).scan_interaction``) on the same scanner; the
    first 2 genes x 64 variants against the CPU (1e-8, rho1 identical);
    K2-K5 with the gene axis against their plain versions
    (:func:`check_gene_axis`); one steady call under "auto", its refined
    pairs against davies."""
    import dataclasses

    import torch

    import cellregmap_tpu_torch as crp
    from cellregmap_tpu_torch import kernels

    genes, n_snps = MULTIGENE["genes"], MULTIGENE["n_snps"]
    rng = np.random.default_rng(MULTIGENE["seed"])
    n = len(d["y"])
    Y = d["y"][:, None] + 0.1 * rng.normal(size=(n, genes))
    G = d["G"][:, :n_snps]
    Ls = crp.get_L_values(d["hK"], d["E"])
    pairs = genes * n_snps
    batches = -(-n_snps // cfg.snp_batch)

    t0 = time.perf_counter()
    pv0, _ = crp.run_interaction_multigene(Y, d["E"], G, W=d["W"], Ls=Ls,
                                           gene_batch=genes, config=cfg,
                                           device=CARD)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    crm = crp.CellRegMap(y=Y[:, 0], E=d["E"], W=d["W"], Ls=Ls, config=cfg,
                         device=CARD)
    crm.scan_interaction_multigene(Y[:, :2], G[:, :cfg.snp_batch])  # setup
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    pv, info = crm.scan_interaction_multigene(Y, G, gene_batch=genes)
    torch.cuda.synchronize()
    steady_s = time.perf_counter() - t0
    counts = kernels.launch_counts()
    want = expected_launches(kr_contract=3 * batches, delta_grid=batches,
                             reml_newton=2 * batches,
                             best_rho_rotate=batches, score_core=batches)
    assert counts == want, f"multigene: launches {counts} != {want}"
    assert pv.shape == (genes, n_snps) and np.all((pv > 0) & (pv <= 1))
    assert np.array_equal(pv, pv0), "multigene: the first call differs"

    # the per-gene loop on the same scanner
    t0 = time.perf_counter()
    loop = [crm.with_phenotype(Y[:, j]).scan_interaction(G)
            for j in range(genes)]
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    loop_gap = max(float(np.max(np.abs(pv[j] - pv_j)))
                   for j, (pv_j, _) in enumerate(loop))
    assert loop_gap <= 1e-8, f"multigene vs the per-gene loop: {loop_gap}"
    assert all(np.array_equal(info["rho1"][j], info_j["rho1"])
               for j, (_, info_j) in enumerate(loop)), \
        "multigene: rho1 differs from the per-gene loop"

    # card against CPU on the first genes and variants
    pv_c, info_c = crp.CellRegMap(
        y=Y[:, 0], E=d["E"], W=d["W"], Ls=Ls, config=cfg, device="cpu"
    ).scan_interaction_multigene(Y[:, :2], G[:, :64])
    cpu_gap = float(np.max(np.abs(pv[:2, :64] - pv_c)))
    assert cpu_gap <= 1e-8, f"multigene: |pv_gpu - pv_cpu| = {cpu_gap}"
    assert np.array_equal(info["rho1"][:2, :64], info_c["rho1"]), \
        "multigene: rho1 differs between the card and the CPU"

    # the gene axis of K2-K5 against the plain versions at this shape
    gene_axis = check_gene_axis(crm._ctx, Y, G[:, :cfg.snp_batch], n)

    # one call under auto, on a scanner sharing the factorization
    cfg_auto = dataclasses.replace(cfg, pvalue_method="auto")
    crm_auto = crp.CellRegMap(y=Y[:, 0], E=d["E"], W=d["W"], Ls=Ls,
                              config=cfg_auto, device=CARD)
    crm_auto._ctx_cache = crm._ctx
    kernels.reset_launches()
    t0 = time.perf_counter()
    pv_a, info_a = crm_auto.scan_interaction_multigene(Y, G,
                                                       gene_batch=genes)
    torch.cuda.synchronize()
    auto_s = time.perf_counter() - t0
    c_auto = kernels.launch_counts()
    assert c_auto["sym_eigvalsh"] == c_auto["mixture_tails"] == batches, \
        f"multigene auto: launches {c_auto}"
    auto = auto_vs_davies(pv_a.ravel(), {k: v.ravel() for k, v in
                                         info_a.items()
                                         if k in ("pv_liu",
                                                  "pv_saddlepoint")},
                          pv.ravel(), cfg_auto)
    out = dict(genes=genes, n_snps=n_snps, gene_batch=genes,
               batch=cfg.snp_batch, first_s=first_s, steady_s=steady_s,
               first_pairs_per_s=pairs / first_s,
               steady_pairs_per_s=pairs / steady_s, launches=counts,
               per_gene_loop_s=loop_s,
               per_gene_loop_pairs_per_s=pairs / loop_s,
               speedup_vs_per_gene_loop=loop_s / steady_s,
               max_abs_vs_loop=loop_gap,
               cpu_check=dict(genes=2, n=64, max_abs_pv_diff=cpu_gap,
                              rho1_identical=True),
               auto=dict(s=auto_s, pairs_per_s=pairs / auto_s,
                         launches=c_auto, **auto),
               gene_axis_ms={k: v["ms"] for k, v in
                             gene_axis["kernels"].items()})
    print("multigene: " + json.dumps(out), flush=True)
    return out, counts


def wide_phase(cfg):
    """50 contexts (2000 cells, 100 donors; an E1 of 10 seeded contexts
    outside span(E), so that the aggregate is not 0): a card scanner
    factorizing the null family (on the host) and uploading it, and a CPU
    scanner on a copy of that factorization.
    ``estimate_aggregate_environment`` of a planted variant on the card
    (K10 with p = rank[W, E] + 1 = 52: the wide instantiation, one launch)
    within 1e-5 of the CPU; K10 against its plain version on that call's
    operands (``null_fit.fit_gaps`` at 1e-10) and timed; K6a on one
    512-variant interaction batch's 50 x 50 weight matrices."""
    import torch

    import cellregmap_tpu_torch as crp
    from cellregmap_tpu_torch import engine, kernels
    from cellregmap_tpu_torch.kernels import null_fit as k10

    d = make_dataset(**WIDE)
    n, C = d["E"].shape
    rng = np.random.default_rng(WIDE["seed"])
    E1 = rng.normal(size=(n, 10)) / np.sqrt(10)
    y = d["y"] + E1 @ rng.normal(size=10)
    Ls = crp.get_L_values(d["hK"], d["E"])
    t0 = time.perf_counter()
    crm = crp.CellRegMap(y=y, E=d["E"], E1=E1, W=d["W"], Ls=Ls, config=cfg,
                         device=CARD)
    crm._ctx                          # the host factorization, uploaded
    torch.cuda.synchronize()
    card_setup_s = time.perf_counter() - t0
    # the CPU scanner takes the same host factorization (made by the same
    # NumPy code either way), copied back rather than made again
    crm_c = crp.CellRegMap(y=y, E=d["E"], E1=E1, W=d["W"], Ls=Ls,
                           config=cfg, device="cpu")
    crm_c._ctx_cache = engine.NullContext(*(t.cpu() for t in crm._ctx))
    g = d["G"][:, GXE_SNP]

    kernels.reset_launches()
    t0 = time.perf_counter()
    agg = crm.estimate_aggregate_environment(g)
    torch.cuda.synchronize()
    agg_s = time.perf_counter() - t0
    counts = kernels.launch_counts()
    assert counts == expected_launches(null_fit=1), \
        f"wide aggregate environment: launches {counts}"
    agg_c = crm_c.estimate_aggregate_environment(g)
    assert agg.shape == (n,) and np.isfinite(agg).all()
    gap = float(np.max(np.abs(agg - agg_c)))
    assert gap <= 1e-5, f"wide aggregate environment: |gpu - cpu| = {gap}"
    assert float(np.abs(agg_c).max()) > 1e-3, \
        "wide aggregate environment: zero where E1 lies outside E"

    # K10's wide instantiation against its plain version
    M = np.concatenate([engine.reduced_design_basis(d["W"], d["E"]),
                        g[:, None]], axis=1)
    delta_cfg = (cfg.delta_logit_lo, cfg.delta_logit_hi, cfg.n_delta_grid,
                 cfg.n_golden_iters)
    calls = capture_kernel_inputs(
        lambda: engine.mean_fit(crm._ctx, torch.as_tensor(M, device=CARD), n,
                                True, delta_cfg), ["null_fit"])
    (args, kw), = calls["null_fit"]
    data, _, restricted, lo, hi, n_grid, n_iters = args
    fits = k10.null_fit(*args, **kw)
    plain = k10.null_fit_plain(*args, **kw)
    torch.cuda.synchronize()
    gaps = k10.fit_gaps(fits, plain, data, n, restricted)
    assert max(gaps.values()) <= 1e-10, f"null_fit (wide): {gaps}"
    nrho, R = data.S.shape
    p = data.Xt.shape[2]
    evals = nrho * (n_grid + n_iters + 3 + 1)   # + logdet(X^T X)
    flops = evals * R * 2 * (p * (p + 1) // 2 + p + 2)
    nbytes = F64 * (nrho * R * (p + 2) + nrho * (p * p + p + 1)
                    + nrho * (p + 6))
    b_ms, b_by = bound(flops, nbytes)
    k10_row = dict(
        name="null_fit (wide)", route="cuda",
        source="cellregmap_tpu_torch/csrc/null_fit.cu",
        replaces="cellregmap_tpu/engine.py:849",
        max_abs_err=float((fits.lml - plain.lml).abs().max()),
        ms=cuda_ms(lambda: k10.null_fit(*args, **kw), reps=5),
        plain_ms=cuda_ms(lambda: k10.null_fit_plain(*args, **kw), reps=3,
                         warmup=1),
        bound_ms=b_ms, bound_by=b_by, library_ms=None, gaps=gaps,
        shapes=dict(nrho=nrho, R=R, p=p), launches=counts["null_fit"],
        tolerance="lml, plain lml at the kernel's delta, beta and scale "
                  "at that delta: rel <= 1e-10")

    # K6a at C = 50 on one interaction batch's weight matrices
    Gb = torch.as_tensor(d["G"][:, :BATCH], device=CARD).contiguous()
    calls = capture_kernel_inputs(
        lambda: engine.interaction_batch(crm._ctx, Gb, Gb, n,
                                         delta_cfg=DELTA_CFG,
                                         device_pvalues=True),
        ["sym_eigvalsh"])
    k6a_c50 = check_sym_eigvalsh(calls["sym_eigvalsh"][0][0][0])
    k6a_c64 = check_sym_eigvalsh(k6a_c64_matrices())
    out = dict(n_cells=n, n_contexts=C, n_donors=WIDE["n_donors"],
               R=R, p=p, card_setup_s=card_setup_s, aggregate_s=agg_s,
               max_abs_diff_cpu=gap, max_abs=float(np.abs(agg).max()),
               launches=counts, null_fit_gaps=gaps,
               **{key: {k: r[k] for k in
                        ("max_abs_err", "ms", "plain_ms", "library_ms",
                         "bound_ms", "bound_by", "sweeps_max",
                         "sweeps_mean", "shapes")}
                  for key, r in (("k6a_c50", k6a_c50),
                                 ("k6a_c64", k6a_c64))})
    print("wide (C = 50): " + json.dumps(out), flush=True)
    print(f"kernel {k10_row['name']}: max_abs_err "
          f"{k10_row['max_abs_err']:.3e} ({k10_row['tolerance']}); ms "
          f"{k10_row['ms']:.4f}  plain_ms {k10_row['plain_ms']:.4f}  "
          f"bound_ms {k10_row['bound_ms']:.4f} ({k10_row['bound_by']})",
          flush=True)
    return out, k10_row


def wide_covariates_phase(cfg, cpu_check=64):
    """The card's envelope on the effect-size paths: ``WIDE``'s dataset (50
    contexts, 2000 cells, 100 donors, the same E1 of 10 seeded contexts)
    with W = [1, 31 columns of N(0, 1) (rng ``WIDE_COVARIATES["seed"]``, as
    ``covariates_phase`` makes them)], so rank[W, E] = 82:
    ``estimate_aggregate_environment`` of the planted variant (K10 at 83
    mean columns, one launch) within 1e-5 of the CPU, the K10 call against
    its plain version (``fit_gaps`` at 1e-10); one ``estimate_betas`` batch
    of ``cpu_check`` variants (K9 at q = 50 + 82 + 2 = 134, nine launches;
    K1 three), finite and its first ``WIDE_BETAS_CPU`` fits against the
    CPU's under the hybrid rule of ``betas_path``; every K9 call of that
    batch against its plain version as ``check_woodbury_family`` holds it.
    The CPU scanners take copies of the card scanners' host
    factorizations.  Returns the phase's record and the K10 and K9 rows."""
    import torch

    import cellregmap_tpu_torch as crp
    from cellregmap_tpu_torch import engine, kernels
    from cellregmap_tpu_torch.kernels import null_fit as k10

    d = make_dataset(**WIDE)
    n, C = d["E"].shape
    rng = np.random.default_rng(WIDE["seed"])
    E1 = rng.normal(size=(n, 10)) / np.sqrt(10)
    y = d["y"] + E1 @ rng.normal(size=10)
    rng = np.random.default_rng(WIDE_COVARIATES["seed"])
    W = np.concatenate([np.ones((n, 1)),
                        rng.normal(size=(n, WIDE_COVARIATES["p"] - 1))],
                       axis=1)
    Ls = crp.get_L_values(d["hK"], d["E"])
    B = engine.reduced_design_basis(W, d["E"])
    assert B.shape[1] == WIDE_COVARIATES["p"] + C, B.shape
    g = d["G"][:, GXE_SNP]

    # the aggregate environment at rank[W, E] + 1 = 83 mean columns
    crm = crp.CellRegMap(y=y, E=d["E"], E1=E1, W=W, Ls=Ls, config=cfg,
                         device=CARD)
    crm._ctx
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    agg = crm.estimate_aggregate_environment(g)
    torch.cuda.synchronize()
    agg_s = time.perf_counter() - t0
    counts = kernels.launch_counts()
    assert counts == expected_launches(null_fit=1), \
        f"wide covariates aggregate environment: launches {counts}"
    # the CPU scanner on a copy of the card scanner's host factorization
    crm_c = crp.CellRegMap(y=y, E=d["E"], E1=E1, W=W, Ls=Ls, config=cfg,
                           device="cpu")
    crm_c._ctx_cache = engine.NullContext(*(t.cpu() for t in crm._ctx))
    agg_c = crm_c.estimate_aggregate_environment(g)
    del crm_c
    assert agg.shape == (n,) and np.isfinite(agg).all()
    gap = float(np.max(np.abs(agg - agg_c)))
    assert gap <= 1e-5, f"wide covariates aggregate: |gpu - cpu| = {gap}"
    M = np.concatenate([B, g[:, None]], axis=1)
    delta_cfg = (cfg.delta_logit_lo, cfg.delta_logit_hi, cfg.n_delta_grid,
                 cfg.n_golden_iters)
    (args, kw), = capture_kernel_inputs(
        lambda: engine.mean_fit(crm._ctx, torch.as_tensor(M, device=CARD), n,
                                True, delta_cfg), ["null_fit"])["null_fit"]
    data, _, restricted, lo, hi, n_grid, n_iters = args
    fits = k10.null_fit(*args, **kw)
    plain = k10.null_fit_plain(*args, **kw)
    torch.cuda.synchronize()
    gaps = k10.fit_gaps(fits, plain, data, n, restricted)
    assert max(gaps.values()) <= 1e-10, f"null_fit (83 columns): {gaps}"
    nrho, R = data.S.shape
    p = data.Xt.shape[2]
    evals = nrho * (n_grid + n_iters + 3 + 1)
    b_ms, b_by = bound(evals * R * 2 * (p * (p + 1) // 2 + p + 2),
                       F64 * (nrho * R * (p + 2) + nrho * (p * p + p + 1)
                              + nrho * (p + 6)))
    k10_row = dict(
        name=f"null_fit (wide, p = {p})", route="cuda",
        source="cellregmap_tpu_torch/csrc/null_fit.cu",
        replaces="cellregmap_tpu/engine.py:849",
        max_abs_err=float((fits.lml - plain.lml).abs().max()),
        ms=cuda_ms(lambda: k10.null_fit(*args, **kw), reps=5),
        plain_ms=cuda_ms(lambda: k10.null_fit_plain(*args, **kw), reps=3,
                         warmup=1),
        bound_ms=b_ms, bound_by=b_by, library_ms=None, gaps=gaps,
        shapes=dict(nrho=nrho, R=R, p=p), launches=counts["null_fit"],
        tolerance="lml, plain lml at the kernel's delta, beta and scale "
                  "at that delta: rel <= 1e-10")
    del crm, args, kw, data, fits, plain

    # one batch of effect sizes at q = C + rank[W, E] + 2 = 134
    G = d["G"][:, :cpu_check]
    maf = d["maf"][:cpu_check]
    kernels.reset_launches()
    t0 = time.perf_counter()
    bg, bgxe = crp.estimate_betas(d["y"], W, d["E"], G, maf=maf, hK=d["hK"],
                                  config=cfg, device=CARD)
    torch.cuda.synchronize()
    betas_s = time.perf_counter() - t0
    c_betas = kernels.launch_counts()
    assert c_betas == expected_launches(kr_contract=3, woodbury_family=9), \
        f"wide covariates betas: launches {c_betas}"
    assert np.isfinite(bg).all() and np.isfinite(bgxe).all(), \
        "wide covariates betas: non-finite effect sizes"
    Lh = crp.get_L_values(d["hK"], d["E"])
    norm = 1.0 / np.sqrt(2 * maf * (1 - maf))
    bctx_card = engine.build_betas_context(d["y"], W, d["E"], Lh,
                                           rho_grid=np.linspace(0, 1, 11),
                                           device=CARD)
    # the CPU fits the first ``WIDE_BETAS_CPU`` variants on a copy of the
    # card's background factorization (the same host NumPy either way)
    res = {}
    for dev, bctx, m in ((CARD, bctx_card, cpu_check),
                         ("cpu", engine.BetasContext(
                             *(t.cpu() for t in bctx_card)),
                          WIDE_BETAS_CPU)):
        bg_d, _, info = engine.predict_interaction_batch(
            bctx, torch.as_tensor(G[:, :m], device=dev),
            torch.as_tensor(norm[:m], device=dev), n,
            localize_f32=cfg.hybrid_localization)
        res[dev] = (bg_d.cpu().numpy()[:WIDE_BETAS_CPU],
                    info["rho1"].cpu().numpy()[:WIDE_BETAS_CPU],
                    info["lml"].cpu().numpy()[:WIDE_BETAS_CPU])
    (bg_g, rho_g, lml_g), (bg_c, rho_c, lml_c) = res[CARD], res["cpu"]
    flipped = rho_g != rho_c
    lml_gap = np.abs(lml_g - lml_c)
    assert np.all(lml_gap[flipped] < 1e-4), \
        f"wide covariates betas: rho flips at lml gaps {lml_gap[flipped]}"
    bg_gap = float(np.max(np.abs(bg_g - bg_c)[~flipped]))
    assert bg_gap <= 1e-7, f"wide covariates betas: |beta_g gpu - cpu| = " \
        f"{bg_gap}"
    Gt = torch.as_tensor(G, device=CARD).contiguous()
    k9_row = check_woodbury_family(bctx_card, Gt,
                                   torch.as_tensor(norm, device=CARD), n,
                                   tag="q = 134", with_library=False,
                                   reps=2)
    k9_row["launches"] = c_betas["woodbury_family"]
    out = dict(n_cells=n, n_contexts=C, p=WIDE_COVARIATES["p"],
               mean_columns=M.shape[1], q=k9_row["shapes"]["q"],
               aggregate_s=agg_s, aggregate_max_abs_diff_cpu=gap,
               null_fit_gaps=gaps, betas_s=betas_s, launches=c_betas,
               betas_cpu_check=dict(n=WIDE_BETAS_CPU,
                                    rho_flips=int(flipped.sum()),
                                    max_abs_beta_g_diff=bg_gap,
                                    max_lml_gap=float(lml_gap.max())))
    del bctx_card, Gt
    # hand the phase's cached blocks back: the later scans size their
    # batches by the card's free memory
    torch.cuda.empty_cache()
    print("wide covariates (C = 50, p = 32): " + json.dumps(out), flush=True)
    for r in (k10_row, k9_row):
        print(f"kernel {r['name']}: max_abs_err {r['max_abs_err']:.3e} "
              f"({r['tolerance']}); ms {r['ms']:.4f}  plain_ms "
              f"{r['plain_ms']:.4f}  bound_ms {r['bound_ms']:.4f} "
              f"({r['bound_by']}); "
              + json.dumps({k: r[k] for k in ("shapes", "split_ms", "gaps")
                            if k in r}), flush=True)
    return out, [k10_row, k9_row]


def _gene_ctx(ctx, Y):
    """``ctx`` with the phenotypes Y (n, genes) on a leading gene axis, on
    the card, in the context's dtype."""
    import torch

    Yg = torch.as_tensor(np.ascontiguousarray(Y.T), device=CARD,
                         dtype=ctx.y.dtype)
    return ctx._replace(y=Yg, Zy=Yg @ ctx.Z, Wy=Yg @ ctx.W,
                        yy=(Yg * Yg).sum(dim=1))


def check_null_fit_genes(ctx_g, n):
    """K10 with the gene axis on a gene tile's null fits (p = 1: the grid a
    block per tile of up to 16 genes): every gene's fits
    through ``null_fit.fit_gaps`` at 1e-10.  The bound counts the grid's
    sums that no phenotype enters (the covariates' Gram and log d at the
    shared grid points) once per (rho, grid point), the phenotype's
    (X^T y, y^2) once per gene, and the golden section's and the final
    fit's evaluations (each gene at its own delta) in full per gene."""
    import torch

    from cellregmap_tpu_torch import engine
    from cellregmap_tpu_torch.kernels import null_fit as k10

    calls = capture_kernel_inputs(
        lambda: engine.null_association_multigene_fit(
            ctx_g, n, delta_cfg=ASSOC_DELTA_CFG), ["null_fit"])
    (args, kw), = calls["null_fit"]
    data, _, restricted, lo, hi, n_grid, n_iters = args
    fits = k10.null_fit(*args, **kw)
    plain = k10.null_fit_plain(*args, **kw)
    torch.cuda.synchronize()
    f32 = data.S.dtype == torch.float32
    name = "null_fit (genes, f32)" if f32 else "null_fit (genes)"
    gaps = null_fits_agree(fits, plain, data, n, restricted, name)
    genes, nrho, R = data.yt.shape
    p = data.Xt.shape[2]
    ntri = p * (p + 1) // 2
    shared, per_gene = 2 * ntri + 8, 2 * (p + 1)
    flops = (nrho * n_grid * R * (shared + genes * per_gene)
             + genes * nrho * (n_iters + 3) * R * (shared + per_gene))
    nbytes = data.S.element_size() * (nrho * R * (p + 1) + nrho * p * p
                                      + genes * nrho * (R + p + 1)
                                      + genes * nrho * (p + 6))
    b_ms, b_by = bound(flops, nbytes)
    return dict(
        name=name, route="cuda",
        source="cellregmap_tpu_torch/csrc/null_fit.cu",
        replaces="cellregmap_tpu/engine.py:1154",
        max_abs_err=float((fits.lml - plain.lml).abs().max()),
        ms=cuda_ms(lambda: k10.null_fit(*args, **kw)),
        plain_ms=cuda_ms(lambda: k10.null_fit_plain(*args, **kw), reps=3,
                         warmup=1),
        bound_ms=b_ms, bound_by=b_by, library_ms=None, gaps=gaps,
        shapes=dict(genes=genes, nrho=nrho, R=R, p=p),
        tolerance="per gene: " + NULL_FIT_TOLERANCE[str(data.S.dtype)])


def check_fast_scan_genes(ctx_g, G, k, delta, n):
    """K8 with the gene axis on one batch of the gene tile, each gene at
    its null's best rho and delta: every output within 1e-10 of max|plain|.
    The bound reads the rotated candidates once per distinct best rho
    (slot); the per-gene work is the weighted rank-1 sums.  The library
    call is one batched GEMM of the genes' weighted [W, y] against each
    slot's Gt (the sums U and cgy alone)."""
    import torch

    from cellregmap_tpu_torch import engine
    from cellregmap_tpu_torch.kernels import fast_scan as k8

    calls = capture_kernel_inputs(
        lambda: engine.fast_scan_multigene_batch(ctx_g, G, k, delta, n),
        ["fast_scan"])
    (args, kw), = calls["fast_scan"]
    got = k8.fast_scan(*args, **kw)
    want = k8.fast_scan_genes_plain(*args, **kw)
    torch.cuda.synchronize()
    tols = FAST_SCAN_TOLERANCE[str(args[1].dtype)]
    err = 0.0
    for g, w, name in zip(got, want, want._fields):
        e = float((g - w).abs().max())
        assert e <= tols[name] * float(w.abs().max()), \
            f"fast_scan (genes) {name}: {e}"
        err = max(err, e)
    dl, Sd, Wt, yt = args[:4]
    Gt = args[7]
    slot = np.asarray(kw["slot"])
    m, R, p = Wt.shape
    genes, nS = yt.shape[0], Gt.shape[2]
    flops = genes * (R * nS * (2 * p + 6) + R * (p * (p + 1) + 2 * p + 6))
    nbytes = Gt.element_size() * (
        m * (R * nS + R * (p + 1) + p * p + p * nS + nS)
        + genes * (R + p + 2 + nS) + genes * nS * (p + 3))
    b_ms, b_by = bound(flops, nbytes)
    # per slot, its genes' weighted [W, y] side by side (zero padded)
    gmax = int(np.bincount(slot, minlength=m).max())
    lhs = torch.zeros((m, R, gmax * (p + 1)), dtype=Gt.dtype,
                      device=Gt.device)
    fill = [0] * m
    for g, sl in enumerate(slot):
        w = 1.0 / ((1 - dl[g]) * Sd[sl] + dl[g])
        c = fill[sl] * (p + 1)
        lhs[sl, :, c:c + p + 1] = torch.cat([Wt[sl], yt[g][:, None]],
                                             dim=1) * w[:, None]
        fill[sl] += 1
    lhsT = lhs.transpose(1, 2)
    return dict(
        name="fast_scan (genes" + (", f32)" if Gt.dtype == torch.float32
                                   else ")"), route="cuda",
        source="cellregmap_tpu_torch/csrc/fast_scan.cu",
        replaces="cellregmap_tpu/engine.py:1176", max_abs_err=err,
        ms=cuda_ms(lambda: k8.fast_scan(*args, **kw)),
        plain_ms=cuda_ms(lambda: k8.fast_scan_genes_plain(*args, **kw),
                         reps=3, warmup=1),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=cuda_ms(lambda: torch.bmm(lhsT, Gt)),
        shapes=dict(genes=genes, slots=m, R=R, p=p, S=nS),
        tolerance=tols["text"],
        split_ms=device_ms(lambda: k8.fast_scan(*args, **kw)),
        note=FAST_SCAN_NOTE)


def check_refit_genes(ctx_g, G, k, n, plain_reps=10):
    """K7 with a per-gene rho on one batch of the gene tile: the grid's
    brackets at each gene's slot (NaN elsewhere, as the plain version's)
    held as K7's, the converge at rel 1e-9.  The bound counts the grid's
    sums that no phenotype enters once per (slot, grid point), the
    phenotype's once per gene, and the Newton steps per (gene, variant).
    Returns K7's two rows (:func:`refit_rows`), tagged ``genes``."""
    import torch

    from cellregmap_tpu_torch import engine
    from cellregmap_tpu_torch.kernels import delta_grid as k2

    calls = capture_kernel_inputs(
        lambda: engine.association_refit_multigene_batch(
            ctx_g, G, k, n, delta_cfg=ASSOC_DELTA_CFG),
        ["delta_grid", "reml_converge"])
    (args, kw), = calls["delta_grid"]
    S, WGt, yt, comp = args[:4]
    lo, hi, K = args[5:8]
    fast = args[9]
    slot = kw["slot"]
    br_lo, br_hi = k2.delta_grid(*args, **kw)
    plo, phi, lml = k2.delta_grid_plain(*args, **kw, return_lml=True)
    torch.cuda.synchronize()
    assert torch.equal(torch.isnan(br_lo), torch.isnan(plo)), \
        "association_refit (genes): brackets outside the slots"
    tol = 1e-5 if fast == torch.float32 else 1e-12
    gap = max(k2.bracket_shortfall(br_lo[g, :, s:s + 1],
                                   br_hi[g, :, s:s + 1], lml[g], lo, hi)
              for g, s in enumerate(slot))
    assert gap <= tol, f"association_refit (genes): shortfall {gap}"
    fin = ~torch.isnan(plo)
    err = max(float((br_lo - plo)[fin].abs().max()),
              float((br_hi - phi)[fin].abs().max()))
    genes = yt.shape[0]
    m, R = S.shape
    p = comp.CWW.shape[0]
    nS = WGt.shape[2] - p
    shared = nS * (p + 1) + p * (p + 1) // 2 + 1
    flops = 2 * K * R * (m * shared + genes * (nS + p + 1))
    nbytes = (S.element_size() * (WGt.numel() + S.numel() + genes * R
                                  + genes * nS * (p + 4))
              + F64 * 2 * 2 * genes * nS)
    tf32 = S.dtype == torch.float32   # split-TF32 sums
    b_ms, b_by = bound(flops, nbytes, split_tf32=tf32)
    grid = dict(
        max_abs_err=err, ms=cuda_ms(lambda: k2.delta_grid(*args, **kw)),
        plain_ms=cuda_ms(lambda: k2.delta_grid_plain(*args, **kw),
                         reps=min(3, plain_reps), warmup=1),
        bound_ms=b_ms, bound_by=b_by,
        bound_fp32_ms=bound(flops, nbytes)[0] if tf32 else None,
        shapes=dict(genes=genes, slots=m, R=R, p=p, S=nS, K=K),
        tolerance=f"plain lml at the kernel's grid point within {tol} "
                  "relative of the plain maximum, at each gene's slot")
    return refit_rows(grid, calls["reml_converge"], "engine.py:1070",
                      "genes, f32" if S.dtype == torch.float32 else "genes",
                      plain_reps=plain_reps, genes=genes)


def _multigene_genes(d):
    """The JAX bench's gene set (bench.py:559-573): Y = y + 0.1 N(0, 1)
    (rng 11) over 16 genes."""
    rng = np.random.default_rng(ASSOC_MULTIGENE["seed"])
    n = len(d["y"])
    return d["y"][:, None] + 0.1 * rng.normal(
        size=(n, ASSOC_MULTIGENE["genes"]))


def assoc_multigene_phase(d, cfg, Ls):
    """``scan_association_fast_multigene`` at the JAX bench's
    ``assoc_multigene_16`` row (bench.py:559-573): the headline dataset on
    its Ls scanner, 16 genes x 2048 variants, gene_batch = 16.  A first
    call (the scanner's factorization included) and a steady call, with
    launch counts (one K10 launch for the tile, one K8 a variant batch);
    the per-gene loop of ``scan_association_fast`` on the same scanner
    (each gene's own null fit and scan); the first 2 genes x 64 variants
    against the CPU (rtol 1e-5, atol 1e-12, rho1 identical); K10 and K8
    with the gene axis against their plain versions on the tile's
    operands."""
    import torch

    import cellregmap_tpu_torch as crp
    from cellregmap_tpu_torch import engine, kernels

    Y = _multigene_genes(d)
    genes = Y.shape[1]
    G = d["G"][:, :ASSOC_MULTIGENE["n_snps"]]
    n_snps = G.shape[1]
    pairs = genes * n_snps
    batches = -(-n_snps // cfg.snp_batch)
    n = len(d["y"])

    t0 = time.perf_counter()
    crm = crp.CellRegMap(y=Y[:, 0], E=d["E"], W=d["W"], Ls=Ls, config=cfg,
                         device=CARD)
    pv0, _ = crm.scan_association_fast_multigene(Y, G, gene_batch=genes)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    kernels.reset_launches()
    t0 = time.perf_counter()
    pv, info = crm.scan_association_fast_multigene(Y, G, gene_batch=genes)
    torch.cuda.synchronize()
    steady_s = time.perf_counter() - t0
    counts = kernels.launch_counts()
    want = expected_launches(null_fit=1, fast_scan=batches)
    assert counts == want, f"assoc_multigene_16: launches {counts} != {want}"
    assert pv.shape == (genes, n_snps) and np.all((pv > 0) & (pv <= 1))
    assert np.array_equal(pv, pv0), "assoc_multigene_16: first call differs"

    t0 = time.perf_counter()
    loop = [crm.with_phenotype(Y[:, j]).scan_association_fast(G)
            for j in range(genes)]
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    loop_excess = max(float(np.max(np.abs(pv[j] - pv_j)
                                   - (1e-5 * np.abs(pv_j) + 1e-12)))
                      for j, (pv_j, _) in enumerate(loop))
    assert loop_excess <= 0, "assoc_multigene_16 vs the per-gene loop"
    assert all(info["rho1"][j] == info_j["rho1"][0]
               for j, (_, info_j) in enumerate(loop)), \
        "assoc_multigene_16: rho1 differs from the per-gene loop"

    pv_c, info_c = crp.CellRegMap(
        y=Y[:, 0], E=d["E"], W=d["W"], Ls=Ls, config=cfg, device="cpu"
    ).scan_association_fast_multigene(Y[:, :2], G[:, :64])
    cpu_gap = float(np.max(np.abs(pv[:2, :64] - pv_c)))
    excess = float(np.max(np.abs(pv[:2, :64] - pv_c)
                          - (1e-5 * np.abs(pv_c) + 1e-12)))
    assert excess <= 0, f"assoc_multigene_16: |pv_gpu - pv_cpu| = {cpu_gap}"
    assert np.array_equal(info["rho1"][:2], info_c["rho1"]), \
        "assoc_multigene_16: rho1 differs between the card and the CPU"

    # the kernels on the tile's operands
    ctx_g = _gene_ctx(crm._ctx, Y)
    fits, k = engine.null_association_multigene_fit(
        ctx_g, n, delta_cfg=ASSOC_DELTA_CFG)
    k = k.cpu().numpy()
    delta = fits.delta[torch.arange(genes, device=CARD),
                       torch.as_tensor(k, device=CARD)].contiguous()
    Gb = torch.as_tensor(G[:, :cfg.snp_batch], device=CARD).contiguous()
    rows = [check_null_fit_genes(ctx_g, n),
            check_fast_scan_genes(ctx_g, Gb, k, delta, n)]
    distinct = int(np.unique(k).size)
    out = dict(genes=genes, n_snps=n_snps, gene_batch=genes,
               batch=cfg.snp_batch, first_s=first_s, steady_s=steady_s,
               first_pairs_per_s=pairs / first_s,
               steady_pairs_per_s=pairs / steady_s, launches=counts,
               per_gene_loop_s=loop_s,
               per_gene_loop_pairs_per_s=pairs / loop_s,
               speedup_vs_per_gene_loop=loop_s / steady_s,
               distinct_best_rho=distinct, min_pv=float(pv.min()),
               cpu_check=dict(genes=2, n=64, max_abs_pv_diff=cpu_gap,
                              rho1_identical=True),
               kernel_ms={r["name"]: r["ms"] for r in rows})
    print("assoc_multigene_16: " + json.dumps(out), flush=True)
    return out, counts, rows, crm


def assoc_refit_multigene_phase(d, cfg, crm):
    """``scan_association_multigene`` (ML refits) on the same scanner and
    genes x 512 variants, gene_batch = 16: a steady call with launch counts
    (one K10 launch for the tile, one K7 grid + converge a variant batch),
    the per-gene loop of ``scan_association``, the first 2 genes x 64
    variants against the CPU (1e-9, rho1 identical) and K7 with a per-gene
    rho against its plain version on one batch's operands."""
    import torch
    from scipy.stats import chi2

    import cellregmap_tpu_torch as crp
    from cellregmap_tpu_torch import engine, kernels

    Y = _multigene_genes(d)
    genes = Y.shape[1]
    G = d["G"][:, :ASSOC_MULTIGENE["refit_snps"]]
    n_snps = G.shape[1]
    pairs = genes * n_snps
    batches = -(-n_snps // cfg.snp_batch)
    n = len(d["y"])
    crm.scan_association_multigene(Y[:, :2], G[:, :64])       # warm-up
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    pv, info = crm.scan_association_multigene(Y, G, gene_batch=genes)
    torch.cuda.synchronize()
    steady_s = time.perf_counter() - t0
    counts = kernels.launch_counts()
    want = expected_launches(null_fit=1, delta_grid=batches,
                             reml_newton=3 * batches)
    assert counts == want, \
        f"assoc_refit_multigene_16: launches {counts} != {want}"
    assert pv.shape == (genes, n_snps) and np.all((pv > 0) & (pv <= 1))

    t0 = time.perf_counter()
    loop = [crm.with_phenotype(Y[:, j]).scan_association(G)
            for j in range(genes)]
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    # held on the LRT statistic: near p = 1 the chi2(1) tail's slope grows
    # as 1 / sqrt(statistic), so the last bit of an lml of ~3000 (4.5e-13)
    # moves such a p-value by ~1e-9; 2e-8 is twice the JAX suite's 1e-8 on
    # an alternative lml
    loop_gap = max(float(np.max(np.abs(pv[j] - pv_j)))
                   for j, (pv_j, _) in enumerate(loop))
    stat_gap = max(float(np.max(np.abs(chi2.isf(pv[j], 1)
                                       - chi2.isf(pv_j, 1))))
                   for j, (pv_j, _) in enumerate(loop))
    assert stat_gap <= 2e-8, f"assoc_refit_multigene_16 vs loop: {stat_gap}"
    assert all(info["rho1"][j] == info_j["rho1"][0]
               for j, (_, info_j) in enumerate(loop)), \
        "assoc_refit_multigene_16: rho1 differs from the per-gene loop"

    pv_c, info_c = crp.CellRegMap(
        y=Y[:, 0], E=d["E"], W=d["W"], Ls=crm._Ls, config=cfg, device="cpu"
    ).scan_association_multigene(Y[:, :2], G[:, :64])
    cpu_gap = float(np.max(np.abs(pv[:2, :64] - pv_c)))
    assert cpu_gap <= 1e-9, f"assoc_refit_multigene_16: {cpu_gap}"
    assert np.array_equal(info["rho1"][:2], info_c["rho1"]), \
        "assoc_refit_multigene_16: rho1 differs between card and CPU"

    ctx_g = _gene_ctx(crm._ctx, Y)
    k = engine.null_association_multigene_fit(
        ctx_g, n, delta_cfg=ASSOC_DELTA_CFG)[1].cpu().numpy()
    Gb = torch.as_tensor(G[:, :cfg.snp_batch], device=CARD).contiguous()
    k7_rows = check_refit_genes(ctx_g, Gb, k, n, plain_reps=3)
    out = dict(genes=genes, n_snps=n_snps, gene_batch=genes,
               batch=cfg.snp_batch, steady_s=steady_s,
               steady_pairs_per_s=pairs / steady_s, launches=counts,
               per_gene_loop_s=loop_s,
               per_gene_loop_pairs_per_s=pairs / loop_s,
               speedup_vs_per_gene_loop=loop_s / steady_s,
               max_abs_vs_loop=loop_gap, max_abs_stat_vs_loop=stat_gap,
               distinct_best_rho=int(np.unique(k).size),
               cpu_check=dict(genes=2, n=64, max_abs_pv_diff=cpu_gap,
                              rho1_identical=True),
               kernel_ms={r["name"]: r["ms"] for r in k7_rows})
    print("assoc_refit_multigene_16: " + json.dumps(out), flush=True)
    return out, counts, k7_rows


# ---------------------------------------------------------------------------
# the float32 context on the association scans and the effect sizes
# ---------------------------------------------------------------------------
# card f32 against CPU f32: the LRT statistics 2 (alt - null) within
# 1e-5 of |null lml| (each lml of either f32 program is good to a few
# 1e-6 of its magnitude: f32 sums of n terms, a golden section stopping
# on an lml flat to f32 resolution)
F32_STAT_REL = 1e-5


def _decades(a, b):
    return float(np.max(np.abs(np.log10(a) - np.log10(b))))


def _stat_gap(pv, pv_c, null_lml):
    """The largest |LRT statistic card - CPU| over |null lml| of two
    p-value arrays (chi2(1) p-values of 2 (alt - null))."""
    from scipy.stats import chi2

    gap = np.abs(chi2.isf(pv, 1) - chi2.isf(pv_c, 1))
    return float(np.max(gap / np.abs(np.asarray(null_lml)).reshape(
        (-1,) + (1,) * (gap.ndim - 1))))


def _f32_gap(got, args, kw):
    """A float32 K9 call's lml against the plain f32 one through the f64
    value at the same points: (the kernel's largest distance from f64, the
    plain version's, both over max(|f64|, 1), where both are finite; the
    masks' disagreements where f32 resolves the lml, as
    ``woodbury_family.f32_gaps``)."""
    import torch

    from cellregmap_tpu_torch.kernels import woodbury_family as k9

    c = lambda a: a.double() if isinstance(a, torch.Tensor) else a  # noqa
    plain = k9.family_eval_plain(*args, **kw)
    exact = k9.family_eval_plain(*(type(a)(*map(c, a))
                                   if isinstance(a, tuple) else c(a)
                                   for a in args), **kw)
    if kw.get("want_beta"):
        got, plain, exact = got[0], plain[0], exact[0]
    ref = exact.abs().clamp(min=1.0)
    eg, ep = (got - exact).abs() / ref, (plain - exact).abs() / ref
    fin_g, fin_p = torch.isfinite(got), torch.isfinite(plain)
    both = fin_g & fin_p
    mask = int(((fin_g != fin_p)
                & (torch.where(fin_g, eg, ep) <= 1e-3)).sum())
    return float(eg[both].max()), float(ep[both].max()), mask


def check_woodbury_family_f32(bctx, G, norm, n, reps=5):
    """K9 on every call of one effect-size batch of the float32 context
    (five f32 zoom rounds over every rho, then the f32 fit with the
    coefficients): each call's largest lml distance from the f64 value at
    most twice the plain f32 version's plus 1e-5 (of max(|f64|, 1)), masks
    equal where f32 resolves the lml (a round over the whole delta range
    has points where both f32 versions lie ~1e-4 from f64, so the rule
    holds the largest distances, not each point's); the final fit's beta
    and rss within 1e-3 of the plain f32 ones' largest entry.  K1 on the
    batch's three f32 contractions (K = Rk, V = E0 or B) within sqrt(n)
    eps(f32) of the terms' magnitudes.  Times a wrapper call of the
    batch's 6, the Gram alone as one f32 ``bmm`` a call."""
    import torch

    from cellregmap_tpu_torch import engine
    from cellregmap_tpu_torch.kernels import kr_contract as k1
    from cellregmap_tpu_torch.kernels import woodbury_family as k9

    captured = capture_kernel_inputs(
        lambda: engine.predict_interaction_batch(bctx, G, norm, n),
        ["family_eval", "kr_contract"])
    calls = captured["family_eval"]
    assert [a[0].dtype for a, _ in calls] == [torch.float32] * 6, \
        "woodbury_family (f32): a call outside float32"
    k1_ulp = 0.0
    for args, _ in captured["kr_contract"]:
        U, V, Gm = args
        mags = k1.kr_contract_plain(U.double().abs(), V.double().abs(),
                                    Gm.double().abs())
        k1_ulp = max(k1_ulp, _f32_sums_check(
            k1.kr_contract(*args), k1.kr_contract_plain(*args), mags,
            U.shape[0], "kr_contract (betas, f32)")[1])
    err, worst, flops, nbytes = 0.0, [], 0, 0
    for args, kw in calls:
        got = k9.family_eval(*args, **kw)
        torch.cuda.synchronize()
        eg, ep, mask = _f32_gap(got, args, kw)
        assert mask == 0 and eg <= 2 * ep + 1e-5, \
            f"woodbury_family (f32): {eg} against plain {ep}, mask {mask}"
        worst.append((eg, ep))
        want = k9.family_eval_plain(*args, **kw)
        if kw.get("want_beta"):
            fin = torch.isfinite(got[0])
            for a, b in zip(got[1:], want[1:]):
                rel = float((a - b)[fin].abs().max() / b[fin].abs().max())
                assert rel <= 1e-3, f"K9 f32 beta/rss: rel {rel}"
            got, want = got[0], want[0]
        fin = torch.isfinite(got) & torch.isfinite(want)
        err = max(err, float((got - want)[fin].abs().max()))
        logits, cols, compS = args[0], args[2], args[3]
        S, L = logits.shape
        Rk, C, _ = cols.Ua.shape
        q = compS.shape[1]
        flops += 2 * S * L * Rk * (q * (q + 1) // 2) + S * L * Rk * 6
        nbytes += F32 * (S * Rk * (C + 1) + Rk * (q - C) + S * q * q
                         + 3 * S * L + S + Rk
                         + (S * L * (q - C) if kw.get("want_beta") else 0))
    b_ms, b_by = bound(flops, nbytes)
    lib_operands = []
    for args, _ in calls:
        logits, rho, cols, _, Lam = args[:5]
        dl = torch.sigmoid(logits)
        W = 1.0 / ((1 - dl)[..., None] * ((1 - rho)[..., None] * Lam)
                   + dl[..., None])
        X = torch.cat([cols.Ua.permute(2, 0, 1),
                       cols.UB.expand(logits.shape[0], -1, -1),
                       cols.ug.T[:, :, None],
                       cols.uy.expand(logits.shape[0], -1)[:, :, None]], 2)
        iu = torch.triu_indices(X.shape[2], X.shape[2], device=X.device)
        lib_operands.append((W, X[:, :, iu[0]] * X[:, :, iu[1]]))
        del X
    lib_ms = cuda_ms(lambda: [torch.bmm(W, P) for W, P in lib_operands],
                     reps=5)
    del lib_operands
    return dict(
        name="woodbury_family (f32)", route="cuda",
        source="cellregmap_tpu_torch/csrc/woodbury_family.cu",
        replaces="cellregmap_tpu/models/lmm.py:435", max_abs_err=err,
        ms=cuda_ms(lambda: [k9.family_eval(*a, **kw) for a, kw in calls],
                   reps=reps),
        plain_ms=cuda_ms(lambda: [k9.family_eval_plain(*a, **kw)
                                  for a, kw in calls], reps=max(1, reps - 2),
                         warmup=1),
        bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms, calls=len(calls),
        flops=flops, nbytes=nbytes, lml_f64_distance=worst,
        k1_betas_eps32=k1_ulp,
        shapes=dict(S=G.shape[1], Rk=bctx.Zk.shape[1],
                    q=calls[0][0][3].shape[1]),
        tolerance="a call's largest |kernel - f64| <= 2 x the plain f32 "
                  "version's + 1e-5 of max(|f64|, 1), masks equal; beta, "
                  "rss within 1e-3 of the plain ones' largest")


def f32_association_phase(d, cfg, Ls):
    """The float32 context (``ScanConfig(dtype="float32")``) through the
    association scans and the effect sizes as a user runs them, at the
    float64 phases' widths on the headline dataset: ``run_association``
    (hK, R = 110) and ``scan_association`` (Ls, R = 1010) at 2048
    variants, ``scan_association_fast`` at 2048 on the same Ls scanner,
    the gene-batched ``assoc_multigene_16`` (fast, 16 genes x 2048) and
    ``assoc_refit_multigene_16`` (16 x 512) on it too, and
    ``estimate_betas`` (hK) at 512 variants.  Each is timed, its launches
    counted (every launch a float32 one), its p-values in (0, 1] (finite
    effect sizes), and its first 64 variants (2 genes x 64) held to the
    port's float32 run on the CPU: the LRT statistics within
    ``F32_STAT_REL`` of |null lml| and the same rho1; 32 effect-size fits
    (through the engine, with their rho1 and lml): a rho flip only where
    the two lmls lie within 1e-5 of |lml| (f32 resolution), beta_G within
    1e-3 of the largest |beta_G| where rho agrees.  Then every kernel of
    the slice on the Ls scanner's operands (a 512-variant batch; the
    16-gene tile) against its plain f32 version: K10, K7's grid and
    converge, K8, each with the gene axis, and K9.  Returns (the phase's
    summary, its kernel rows, each with its launches on these paths)."""
    import dataclasses

    import torch

    import cellregmap_tpu_torch as crp
    from cellregmap_tpu_torch import engine, kernels

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    n = len(d["y"])
    G = d["G"]
    n_snps = G.shape[1]
    b = -(-n_snps // cfg.snp_batch)
    Y = _multigene_genes(d)
    genes = Y.shape[1]
    G_mg = G[:, :ASSOC_MULTIGENE["refit_snps"]]
    b_mg = -(-G_mg.shape[1] // cfg.snp_batch)
    G_b, maf_b = G[:, :BETAS_SNPS], d["maf"][:BETAS_SNPS]
    b_betas = -(-BETAS_SNPS // cfg.snp_batch)

    def ls(dev):
        return crp.CellRegMap(y=d["y"], E=d["E"], W=d["W"], Ls=Ls,
                              config=cfg32, device=dev)

    def hk(dev):
        return crp.CellRegMap(y=d["y"], E=d["E"], W=d["W"], hK=d["hK"],
                              config=cfg32, device=dev)

    # one Ls scanner a device (its null fit cached after the first scan:
    # the fast scan launches no null fit of its own)
    crm, crm_c, hk_c = ls(CARD), ls("cpu"), hk("cpu")
    paths = {
        "association_hK": (
            lambda: crp.run_association(d["y"], d["W"], d["E"], G,
                                        hK=d["hK"], config=cfg32,
                                        device=CARD),
            lambda: hk_c.scan_association(G[:, :64]),
            dict(null_fit=1, delta_grid=b, reml_newton=3 * b)),
        "association_Ls": (
            lambda: crm.scan_association(G),
            lambda: crm_c.scan_association(G[:, :64]),
            dict(null_fit=1, delta_grid=b, reml_newton=3 * b)),
        "association_fast_Ls": (
            lambda: crm.scan_association_fast(G),
            lambda: crm_c.scan_association_fast(G[:, :64]),
            dict(fast_scan=b)),
        "assoc_multigene_16": (
            lambda: crm.scan_association_fast_multigene(Y, G,
                                                        gene_batch=genes),
            lambda: crm_c.scan_association_fast_multigene(Y[:, :2],
                                                          G[:, :64]),
            dict(null_fit=1, fast_scan=b)),
        "assoc_refit_multigene_16": (
            lambda: crm.scan_association_multigene(Y, G_mg,
                                                   gene_batch=genes),
            lambda: crm_c.scan_association_multigene(Y[:, :2], G[:, :64]),
            dict(null_fit=1, delta_grid=b_mg, reml_newton=3 * b_mg)),
    }
    out, counts32 = {}, {}
    for label, (run, run_cpu, want) in paths.items():
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        pv, info = run()
        torch.cuda.synchronize()
        e2e_s = time.perf_counter() - t0
        counts, c32 = kernels.launch_counts(), kernels.launch_counts_f32()
        want = expected_launches(**want)
        assert counts == want, f"{label} (f32): launches {counts} != {want}"
        assert c32 == {k: want[k] for k in c32}, \
            f"{label} (f32): float32 launches {c32}"
        counts32[label] = c32
        assert np.all((pv > 0) & (pv <= 1)), f"{label} (f32): p-values"
        pv_c, info_c = run_cpu()
        if pv.ndim == 2:
            pv_g, rho_g = pv[:2, :64], info["rho1"][:2]
        else:
            pv_g, rho_g = pv[:64], info["rho1"]
        assert np.allclose(rho_g, info_c["rho1"], rtol=1e-6, atol=0), \
            f"{label} (f32): rho1 differs between the card and the CPU"
        scan = hk_c if label == "association_hK" else crm_c
        if pv.ndim == 2:
            null_lml = [float(f.lml[k]) for f, k in (
                crm_c.with_phenotype(Y[:, j])._fit_null_association()
                for j in range(2))]
        else:
            f, k = scan._fit_null_association()
            null_lml = [float(f.lml[k])]
        gap = _stat_gap(pv_g, pv_c, null_lml)
        assert gap <= F32_STAT_REL, f"{label} (f32): statistic gap {gap}"
        out[label] = dict(shape=list(pv.shape), e2e_s=e2e_s,
                          pairs_per_s=pv.size / e2e_s, launches_f32=c32,
                          min_pv=float(pv.min()),
                          cpu_check=dict(n=int(pv_g.size),
                                         stat_gap_over_lml=gap,
                                         max_log10_gap=_decades(pv_g, pv_c)))
        print(f"f32 {label}: " + json.dumps(out[label]), flush=True)

    # the effect sizes (hK): a first and a steady call, 32 fits on the CPU
    def betas():
        return crp.estimate_betas(d["y"], d["W"], d["E"], G_b, maf=maf_b,
                                  hK=d["hK"], config=cfg32, device=CARD)

    t0 = time.perf_counter()
    betas()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    kernels.reset_launches()
    t0 = time.perf_counter()
    bg, bgxe = betas()
    torch.cuda.synchronize()
    steady_s = time.perf_counter() - t0
    want = expected_launches(kr_contract=3 * b_betas,
                             woodbury_family=6 * b_betas)
    counts, c32 = kernels.launch_counts(), kernels.launch_counts_f32()
    assert counts == want, f"betas_2k (f32): launches {counts} != {want}"
    assert c32 == {k: want[k] for k in c32}, f"betas_2k (f32): {c32}"
    counts32["betas_2k"] = c32
    assert np.isfinite(bg).all() and np.isfinite(bgxe).all()
    norm = 1.0 / np.sqrt(2 * maf_b[:32] * (1 - maf_b[:32]))
    res = {}
    for dev in (CARD, "cpu"):
        bctx = engine.build_betas_context(
            d["y"], d["W"], d["E"], crp.get_L_values(d["hK"], d["E"]),
            rho_grid=np.linspace(0, 1, 11), device=dev, dtype=torch.float32)
        bg_d, _, info = engine.predict_interaction_batch(
            bctx, torch.as_tensor(G_b[:, :32], device=dev,
                                  dtype=torch.float32),
            torch.as_tensor(norm, device=dev, dtype=torch.float32), n)
        res[dev] = [t.cpu().double().numpy()
                    for t in (bg_d, info["rho1"], info["lml"])]
    (bg_g, rho_g, lml_g), (bg_c, rho_c, lml_c) = res[CARD], res["cpu"]
    flipped = np.abs(rho_g - rho_c) > 1e-6
    lml_gap = np.abs(lml_g - lml_c) / np.abs(lml_c)
    assert np.all(lml_gap[flipped] <= 1e-5), \
        f"betas_2k (f32): rho flips at lml gaps {lml_gap[flipped]}"
    bg_gap = float(np.max(np.abs(bg_g - bg_c)[~flipped])
                   / np.max(np.abs(bg_c)))
    assert bg_gap <= 1e-3, f"betas_2k (f32): beta_g gap {bg_gap}"
    out["betas_2k"] = dict(n_snps=BETAS_SNPS, first_s=first_s,
                           steady_s=steady_s,
                           steady_tests_per_s=BETAS_SNPS / steady_s,
                           launches_f32=c32,
                           cpu_check=dict(n=32, rho_flips=int(flipped.sum()),
                                          beta_g_rel=bg_gap,
                                          max_lml_rel_gap=float(
                                              lml_gap.max())))
    print("f32 betas_2k: " + json.dumps(out["betas_2k"]), flush=True)
    del crm_c, hk_c

    # the kernels against their plain f32 versions, on the Ls scanner's
    # operands
    f32 = torch.float32
    ctx32 = crm._ctx
    assert ctx32.y.dtype == f32
    G32 = torch.as_tensor(G[:, :cfg.snp_batch], device=CARD,
                          dtype=f32).contiguous()
    (args, kw), = capture_kernel_inputs(
        lambda: engine.null_association_fit(ctx32, n,
                                            delta_cfg=ASSOC_DELTA_CFG),
        ["null_fit"])["null_fit"]
    rows = [check_null_fit_narrow(args, kw, "null_fit (f32)",
                                  "cellregmap_tpu/engine.py:865")]
    k = int(engine.null_association_fit(ctx32, n,
                                        delta_cfg=ASSOC_DELTA_CFG)[1])
    calls = capture_kernel_inputs(
        lambda: engine.association_refit_batch(ctx32, G32, k, n,
                                               delta_cfg=ASSOC_DELTA_CFG),
        ["delta_grid", "reml_converge"])
    grid = check_delta_grid(calls["delta_grid"][0], library=False)
    rows += refit_rows(grid, calls["reml_converge"], "engine.py:875", "f32")
    rows.append(check_fast_scan(ctx32, G32, n))
    ctx_g = _gene_ctx(ctx32, Y)
    fits, kg = engine.null_association_multigene_fit(
        ctx_g, n, delta_cfg=ASSOC_DELTA_CFG)
    kg = kg.cpu().numpy()
    delta = fits.delta[torch.arange(genes, device=CARD),
                       torch.as_tensor(kg, device=CARD)].contiguous()
    rows.append(check_null_fit_genes(ctx_g, n))
    rows.append(check_fast_scan_genes(ctx_g, G32, kg, delta, n))
    rows += check_refit_genes(ctx_g, G32, kg, n, plain_reps=2)
    bctx = engine.build_betas_context(d["y"], d["W"], d["E"], Ls,
                                      rho_grid=np.linspace(0, 1, 11),
                                      device=CARD, dtype=f32)
    norm = torch.as_tensor(1.0 / np.sqrt(2 * maf_b * (1 - maf_b)),
                           device=CARD, dtype=f32)
    rows.append(check_woodbury_family_f32(
        bctx, torch.as_tensor(G_b, device=CARD, dtype=f32).contiguous(),
        norm, n))
    del bctx, ctx_g
    torch.cuda.empty_cache()

    # each row's launches: its f32 wrapper calls on the paths above
    def total(module, *labels):
        return sum(counts32[lb][module] for lb in labels)

    single = ("association_hK", "association_Ls")
    launches = {
        "null_fit (f32)": total("null_fit", *single, "association_fast_Ls"),
        "association_refit (grid, f32)": total("delta_grid", *single),
        "association_refit (converge, f32)": total("reml_newton", *single),
        "fast_scan (f32)": total("fast_scan", "association_fast_Ls"),
        "null_fit (genes, f32)": total("null_fit", "assoc_multigene_16",
                                       "assoc_refit_multigene_16"),
        "fast_scan (genes, f32)": total("fast_scan", "assoc_multigene_16"),
        "association_refit (grid, genes, f32)": total(
            "delta_grid", "assoc_refit_multigene_16"),
        "association_refit (converge, genes, f32)": total(
            "reml_newton", "assoc_refit_multigene_16"),
        "woodbury_family (f32)": total("woodbury_family", "betas_2k"),
    }
    for r in rows:
        r["launches"] = launches[r["name"]]
        assert r["launches"] > 0, f"{r['name']}: no launch on its path"
        print(f"kernel {r['name']}: max_abs_err {r['max_abs_err']:.3e} "
              f"({r['tolerance']}); ms {r['ms']:.4f}  plain_ms "
              f"{r['plain_ms']:.4f}  library_ms {r['library_ms']}  "
              f"bound_ms {r['bound_ms']:.4f} ({r['bound_by']})", flush=True)
    return out, rows


class _Stop(RuntimeError):
    """Raised by a wrapped engine function to stop a checkpointed scan."""


def _stopped_then_resumed(scan, fn_name, n_ok, ck):
    """Run ``scan(ck)`` with engine.``fn_name`` raising after ``n_ok``
    calls (the scan stops with a durable cursor), then again on the same
    checkpoint; returns (resumed result, cursor at the stop, calls made by
    the resumed run)."""
    from cellregmap_tpu_torch import engine
    from cellregmap_tpu_torch.parallel.checkpoint import ScanCheckpoint

    orig = getattr(engine, fn_name)
    calls = {"n": 0}

    def stopping(*a, **kw):
        if calls["n"] >= n_ok:
            raise _Stop(fn_name)
        calls["n"] += 1
        return orig(*a, **kw)

    setattr(engine, fn_name, stopping)
    try:
        scan(ck)
        raise AssertionError(f"checkpoint: {fn_name} did not stop the scan")
    except _Stop:
        pass
    finally:
        setattr(engine, fn_name, orig)
    state = ScanCheckpoint(ck).load()
    assert state is not None, f"checkpoint: nothing durable at {fn_name}"
    cursor = state["cursor"]
    resumed = {"n": 0}

    def counting(*a, **kw):
        resumed["n"] += 1
        return orig(*a, **kw)

    setattr(engine, fn_name, counting)
    try:
        out = scan(ck)
    finally:
        setattr(engine, fn_name, orig)
    assert ScanCheckpoint(ck).load() is None, "checkpoint: not cleared"
    return out, cursor, resumed["n"]


def checkpoint_phase(d, cfg, crm_assoc):
    """Checkpointed scans on the card, in a temporary directory: a
    ``scan_association_fast_multigene`` (16 genes in tiles of 8 x 1024
    variants) stopped after its first gene tile, and a ``scan_interaction``
    (2048 variants) stopped after its first variant batch, each by an
    exception from a wrapped engine function, then resumed; the resumed
    results equal a clean run's (rtol 1e-12) and the checkpoint is cleared
    at the end."""
    import tempfile

    import torch

    Y = _multigene_genes(d)
    G = d["G"][:, :1024]
    batches = -(-G.shape[1] // cfg.snp_batch)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        clean = crm_assoc.scan_association_fast_multigene(Y, G, gene_batch=8)
        t0 = time.perf_counter()
        got, cursor, n_calls = _stopped_then_resumed(
            lambda ck: crm_assoc.scan_association_fast_multigene(
                Y, G, gene_batch=8, checkpoint=ck),
            "fast_scan_multigene_batch", batches, f"{tmp}/assoc")
        torch.cuda.synchronize()
        for a, b in ((got[0], clean[0]),
                     *((got[1][k], clean[1][k]) for k in clean[1])):
            np.testing.assert_allclose(a, b, rtol=1e-12)
        assert cursor == 1 and n_calls == batches, (cursor, n_calls)
        out["assoc_fast_multigene"] = dict(
            tiles=2, cursor_at_stop=cursor, resumed_calls=n_calls,
            s=time.perf_counter() - t0)

        # the headline phenotype on the same factorization
        crm = crm_assoc.with_phenotype(d["y"])
        Gi = d["G"]
        clean = crm.scan_interaction(Gi)
        t0 = time.perf_counter()
        got, cursor, n_calls = _stopped_then_resumed(
            lambda ck: crm.scan_interaction(Gi, checkpoint=ck),
            "interaction_batch", 1, f"{tmp}/interaction")
        torch.cuda.synchronize()
        n_b = -(-Gi.shape[1] // cfg.snp_batch)
        np.testing.assert_allclose(got[0], clean[0], rtol=1e-12)
        for k in clean[1]:
            np.testing.assert_allclose(got[1][k], clean[1][k], rtol=1e-12)
        assert cursor == 1 and n_calls == n_b - 1, (cursor, n_calls)
        out["interaction"] = dict(batches=n_b, cursor_at_stop=cursor,
                                  resumed_calls=n_calls,
                                  s=time.perf_counter() - t0)
    print("checkpoint: " + json.dumps(out), flush=True)
    return out


# The float32 context's kernels against their plain f32 versions: a sum of
# n f32 terms within sqrt(n) units of f32 rounding of the sum of the terms'
# magnitudes (the kernel adds its terms one after another, the plain
# version in blocks: n roundings each, whose errors grow as sqrt(n) for
# rounding that behaves randomly; n eps is the worst case)
EPS32 = 2.0 ** -23
F32 = 4


def _f32_sums_check(got, want, mags, n_terms, what):
    """(max abs err, the largest error in eps(f32) of the magnitudes' sum)
    of an f32 kernel's sums of ``n_terms`` terms against the plain
    version's; raises past sqrt(n_terms)."""
    err = (got.double() - want.double()).abs()
    ulp = float((err / (mags + 1e-300)).max()) / EPS32
    assert ulp <= math.sqrt(n_terms), \
        f"{what}: {ulp} eps(f32) of the terms' sums, n = {n_terms}"
    return float(err.max()), ulp


def check_localize_f32(call, name):
    """The float32 localize (``crm_reml_localize_f32``) on one call's
    operands against its plain version: the f64 lml at the localized
    optimum within 1e-6 of max(|lml|, 1) with the same -inf entries, the
    argmax a tie within 1e-6 (the f32 steps part from the plain version's
    at f32 rounding); timed beside it, its bound the f32 rows read once
    (4 bytes each) and the steps' and evaluation's flops at 67 TFLOP/s.
    Returns (the row, the kernel's k_best)."""
    import torch

    from cellregmap_tpu_torch.kernels import reml_newton as k3

    args, kw = call
    x, lml_all, kb = k3.reml_localize(*args, **kw)
    xp, lml_p, kb_p = k3.reml_localize_plain(*args, **kw)
    torch.cuda.synchronize()
    fin = torch.isfinite(lml_p)
    assert torch.equal(torch.isfinite(lml_all), fin), f"{name}: inf"
    scale = lml_p.abs().clamp(min=1.0)
    lrel = float(((lml_all - lml_p).abs() / scale)[fin].max())
    assert lrel <= 1e-6, f"{name}: lml rel {lrel}"
    best = lml_p.amax(dim=-1)
    at_k = lml_p.gather(-1, kb[..., None])[..., 0]
    tie = float(((best - at_k) / best.abs().clamp(min=1.0)).max())
    assert tie <= 1e-6, f"{name}: argmax gap {tie}"
    err = max(float((x - xp).abs().max()),
              float((lml_all - lml_p)[fin].abs().max()))
    S_, WGt, _, comp = args[:4]
    steps = args[8]
    nrho, R = S_.shape
    p = comp.CWW.shape[0]
    nS = WGt.shape[2] - p
    b_ms, b_by = bound(_fit_flops(p + 1, R, nS * nrho, steps),
                       F32 * (WGt.numel() + 2 * S_.numel() + nS * (p + 4))
                       + F64 * (4 * nS * nrho + nS))
    return dict(
        name=name, route="cuda",
        source="cellregmap_tpu_torch/csrc/reml_newton.cu",
        replaces="cellregmap_tpu/engine.py:538", library_ms=None,
        max_abs_err=err, ms=cuda_ms(lambda: k3.reml_localize(*args, **kw)),
        plain_ms=cuda_ms(lambda: k3.reml_localize_plain(*args, **kw)),
        bound_ms=b_ms, bound_by=b_by, lml_rel=lrel,
        k_best_identical=float((kb == kb_p).double().mean()),
        shape=dict(nrho=nrho, R=R, p=p, S=nS, steps=steps),
        tolerance="f64 lml at the localized optimum within 1e-6 of "
                  "max(|lml|, 1); the argmax a tie within 1e-6"), kb


def check_localize_f32_p7(d):
    """The float32 localize at p = 7 (W = [1, 6 columns of N(0, 1), rng
    24]: the wide f32 localize, its sums split over warps) on a
    1024-variant screen batch of the headline dataset, through
    ``check_localize_f32``.  The screens run p = 1, so this instantiation
    is off their path and launches no time there: the row's launches are
    0."""
    import torch

    import cellregmap_tpu_torch as crp
    from cellregmap_tpu_torch import engine

    n = len(d["y"])
    rng = np.random.default_rng(COVARIATES["seed"])
    W = np.concatenate([np.ones((n, 1)), rng.normal(size=(n, 6))], axis=1)
    ctx = engine.build_null_context(d["y"], W, d["E"],
                                    Ls=crp.get_L_values(d["hK"], d["E"]),
                                    device=CARD)
    ctx32 = engine.NullContext(*(t.to(torch.float32) for t in ctx))
    G32 = torch.as_tensor(d["G"][:, :2 * BATCH], device=CARD,
                          dtype=torch.float32).contiguous()
    call, = capture_kernel_inputs(
        lambda: engine.interaction_batch(ctx32, G32, G32, n,
                                         delta_cfg=DELTA_CFG),
        ["reml_localize"])["reml_localize"]
    row, _ = check_localize_f32(call, "reml_newton (localize, p = 7, f32)")
    row["launches"] = 0
    row["off_main_path"] = ("the screens run p = 1: this instantiation "
                            "launches no time on the main path")
    print(f"kernel {row['name']}: max_abs_err {row['max_abs_err']:.3e} "
          f"({row['tolerance']}); ms {row['ms']:.4f}  plain_ms "
          f"{row['plain_ms']:.4f}  library_ms None  bound_ms "
          f"{row['bound_ms']:.4f} ({row['bound_by']})", flush=True)
    return row


def check_f32_kernels(ctx32, G32, n):
    """The float32 context's instantiations on the operands of one screen
    batch (``engine.interaction_batch`` on an f32 context, with the device
    tails), each against its plain f32 version and timed beside it, its
    bound (f32 operands at 4 bytes, the 67 TFLOP/s of FP32 and FP64; for
    the split-TF32 routes, K1 at K > 32 and K2, three TF32 products a term
    at 495 TFLOP/s, the FP32 figure beside it as ``bound_fp32_ms``) and
    the library call where one exists: K1 (T, A^T A, A^T W: sums within
    sqrt(n) eps(f32) of the terms' magnitudes; ``matmul`` on the
    materialized V o G), K2 (brackets on the plain argmax or a tie within
    1e-5; the f32 ``bmm``), K3's localize (the f64 lml at the localized
    optimum within 1e-6 of max(|lml|, 1), the argmax a tie within 1e-6)
    and converge (rtol 1e-9), K4 (as K1; the chunked f32 ``bmm``), K5 on
    f32 operands (1e-10 of max|plain|: f64 arithmetic) and K6a in f32
    (1e-5 of each matrix's largest |lambda|; ``eigvalsh`` in f32), then
    K6b on the batch's 1024 pairs (``check_mixture_tails``).  Rows named
    ``<kernel> (..., f32)`` and K6b's ``mixture_tails (screen batch)``."""
    import torch

    from cellregmap_tpu_torch import engine
    from cellregmap_tpu_torch.kernels import best_rho_rotate as k4
    from cellregmap_tpu_torch.kernels import kr_contract as k1

    calls = capture_kernel_inputs(
        lambda: engine.interaction_batch(ctx32, G32, G32, n,
                                         delta_cfg=DELTA_CFG,
                                         device_pvalues=True),
        ["kr_contract", "delta_grid", "reml_localize", "reml_converge",
         "best_rho_rotate", "score_core", "sym_eigvalsh", "mixture_tails"])
    rows = []
    for (args, _), name in zip(calls["kr_contract"], K1_CALLS):
        U, V, Gm = args
        assert U.dtype == torch.float32
        out, ref = k1.kr_contract(U, V, Gm), k1.kr_contract_plain(U, V, Gm)
        mags = k1.kr_contract_plain(U.double().abs(), V.double().abs(),
                                    Gm.double().abs())
        err, ulp = _f32_sums_check(out, ref, mags, U.shape[0],
                                   f"kr_contract ({name}, f32)")
        del out, ref, mags
        nn, K = U.shape
        p, S = V.shape[1], Gm.shape[1]
        # K > 32: split-TF32 products on the tensor cores (the FP32 FMA
        # figure beside them); K <= 32: FP32 FMA
        flops = 2 * nn * K * p * S
        nbytes = F32 * (U.numel() + V.numel() + Gm.numel() + K * p * S)
        b_ms, b_by = bound(flops, nbytes, split_tf32=K > 32)

        def library():
            torch.matmul(U.T, (V[:, :, None] * Gm[:, None, :]).reshape(nn, -1))

        rows.append(dict(
            name=f"kr_contract ({name}, f32)", route="cuda",
            source="cellregmap_tpu_torch/csrc/kr_contract.cu",
            replaces="cellregmap_tpu/engine.py:184", max_abs_err=err,
            ms=cuda_ms(lambda: k1.kr_contract(U, V, Gm)),
            plain_ms=cuda_ms(lambda: k1.kr_contract_plain(U, V, Gm)),
            bound_ms=b_ms, bound_by=b_by, library_ms=cuda_ms(library),
            bound_fp32_ms=bound(flops, nbytes)[0],
            route_kind="split TF32" if K > 32 else "FP32 FMA",
            shape=dict(n=nn, K=K, p=p, S=S), eps32_of_sums=ulp,
            tolerance="|err| <= sqrt(n) eps(f32) x sum |terms|"))
    rows.append(check_delta_grid(calls["delta_grid"][0], tag="f32"))

    # K3: the localize's f32 steps part from the plain version's at f32
    # rounding; the f64 evaluation there, and the converge, as stated
    loc_call = calls["reml_localize"][0]
    loc, kb = check_localize_f32(loc_call, "reml_newton (localize, f32)")
    c_err, c_ms, c_plain = _check_converge(calls["reml_converge"][0])
    S_, WGt = loc_call[0][:2]
    steps3 = calls["reml_converge"][0][0][10]
    nrho, R = S_.shape
    p = loc_call[0][3].CWW.shape[0]
    nS = WGt.shape[2] - p
    n_k = int(torch.unique(kb).numel())
    conv_bound = bound(_fit_flops(p + 1, R, nS, steps3),
                       F32 * (n_k * R * (p + 2) + nS * (p + 4))
                       + F64 * nS * (p + 8))
    rows += [
        loc,
        dict(name="reml_newton (converge, f32)", route="cuda",
             source="cellregmap_tpu_torch/csrc/reml_newton.cu",
             replaces="cellregmap_tpu/engine.py:538", library_ms=None,
             max_abs_err=c_err, ms=c_ms, plain_ms=c_plain,
             bound_ms=conv_bound[0], bound_by=conv_bound[1],
             tolerance="delta, lml, scale, beta rel <= 1e-9")]

    (args, _), = calls["best_rho_rotate"]
    rows.append(check_best_rho_rotate_f32(*args, "best_rho_rotate (f32)"))
    (args, _), = calls["score_core"]
    rows.append(check_score_core(args, tag="f32"))
    (A,), _ = calls["sym_eigvalsh"][0]
    assert A.dtype == torch.float32
    rows.append(check_sym_eigvalsh(A, tol=1e-5, tag="f32"))
    (tails, _), = calls["mixture_tails"]
    rows.append(check_mixture_tails(*tails, tag="screen batch"))
    del calls, args, tails
    torch.cuda.empty_cache()
    for r in rows:
        fp32 = r.get("bound_fp32_ms")
        extra = {k: r[k] for k in ("matmul_ms", "device", "distinct_pairs",
                                   "pairs", "contexts", "operations",
                                   "gammaincc_calls", "gammaincc_iterations",
                                   "near_mean", "near_d_min", "rel_near",
                                   "rel_near_plain", "rel_far") if k in r}
        print(f"kernel {r['name']}: max_abs_err {r['max_abs_err']:.3e} "
              f"({r['tolerance']}); ms {r['ms']:.4f}  plain_ms "
              f"{r['plain_ms']:.4f}  library_ms {r['library_ms']}  "
              f"bound_ms {r['bound_ms']:.4f} ({r['bound_by']})"
              + (f"  bound_fp32_ms {fp32:.4f}" if fp32 else "")
              + (f"; {json.dumps(extra)}" if extra else ""), flush=True)
    return rows


def check_best_rho_rotate_f32(V, T, kbest, name):
    """K4-f32 on one call against its plain version: the slots equal, the
    factors gathered through them within sqrt(R) eps(f32) of the terms'
    magnitudes, a second launch bit-equal; timed beside its plain version,
    the chunked f32 ``bmm`` (``library_ms``; a single phenotype's k_best
    only, as the gene-axis rows of f64 K4) and one f32 ``matmul`` of the
    same flops (``matmul_ms``: cuBLAS's FP32 rate at these shapes).
    Its bound: ``k4_bound`` at the 67 TFLOP/s of the FP32 pipes."""
    import torch

    from cellregmap_tpu_torch.kernels import best_rho_rotate as k4

    (At, slot), (At_p, slot_p) = (k4.best_rho_rotate(V, T, kbest),
                                  k4.best_rho_rotate_plain(V, T, kbest))
    assert torch.equal(slot, slot_p), f"{name}: the slots"
    got = k4.gather(At, slot)
    del At
    want = k4.gather(At_p, slot_p)
    del At_p
    mags = k4.gather(k4.best_rho_rotate_plain(V.double().abs(),
                                              T.double().abs(), kbest)[0],
                     slot_p)
    err, ulp = _f32_sums_check(got, want, mags, V.shape[1], name)
    del want, mags
    assert torch.equal(k4.gather(*k4.best_rho_rotate(V, T, kbest)), got), \
        f"{name}: a second launch differs"
    del got
    torch.cuda.empty_cache()
    b_ms, b_by, n_k, n_pairs = k4_bound(V, T, kbest)
    return dict(
        name=name, route="cuda",
        source="cellregmap_tpu_torch/csrc/best_rho_rotate.cu",
        replaces="cellregmap_tpu/engine.py:672", max_abs_err=err,
        ms=cuda_ms(lambda: k4.best_rho_rotate(V, T, kbest)),
        plain_ms=cuda_ms(lambda: k4.best_rho_rotate_plain(V, T, kbest),
                         reps=3, warmup=1),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=k4_library_ms(V, T, kbest) if kbest.ndim == 1 else None,
        matmul_ms=k4_matmul_ms(V, T, n_pairs),
        device=device_ms(lambda: k4.best_rho_rotate(V, T, kbest)),
        eps32_of_sums=ulp, distinct_rho=n_k, distinct_pairs=n_pairs,
        tolerance="slots equal; |err| <= sqrt(R) eps(f32) x sum |terms|")


# the float32 context's kernel modules on the interaction path
INTERACTION_F32 = ("kr_contract", "delta_grid", "reml_newton",
                   "best_rho_rotate", "score_core", "sym_eigvalsh")
SCREEN_SIGNIFICANCE = 5e-8     # bench.py:525-539
SCREEN_MULTIGENE = dict(genes=16, seed=13)   # bench.py:541-557


def davies_tolerance(pv):
    """How far two Davies p-values of one pair, from inputs equal to
    rounding (the same fits in batches of other widths), may part: the
    ladder's accuracy on each side, 1e-8 absolute, and below 1e-4 the
    refinement's 1e-3 of the value (models/pvalues.py ``davies_pvalue``)."""
    pv = np.asarray(pv, float)
    return np.where(pv < 1e-4, 2e-3 * pv, 2e-8)


def _timed(fn, reps):
    """(host seconds of each of ``reps`` calls, synchronised; the last
    call's result)."""
    import torch

    times, out = [], None
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return times, out


def screen_phase(d, cfg, pv_dav, info_auto, cpu_check=64, reps=3):
    """``screen_2k`` (bench.py:525-539): the headline dataset, all 2048
    variants, ``scan_interaction_screen`` at significance 5e-8 on the
    card.  Every variant whose f64 Davies p-value on the card (the
    headline davies run, ``pv_dav``) is below 5e-8 is confirmed and
    reported with that value, within the Davies ladder's accuracy
    (``davies_tolerance``: the confirm reruns Davies on another batch's
    f64 fits, equal to rounding); the screen p-values within
    0.5 decades of the f64 saddlepoint (the headline auto run's device
    tails), the JAX test's bound; the first ``cpu_check`` variants'
    screen against the port's CPU screen (the same discovery set and
    confirmed values to 1e-8, screen_pv to rtol 0.05 where rho1 agrees:
    two f32 programs); the screen's tests/s beside the f64 scan's under
    davies and auto on the same scanner, ``reps`` runs each in turns
    (setup excluded; the spread is max - min); the f32 instantiations'
    launch counts on one screen.  Returns (summary, f32 launch counts,
    screen batches)."""
    import dataclasses

    import torch

    import cellregmap_tpu_torch as crp
    from cellregmap_tpu_torch import kernels

    G = d["G"]
    n_snps = G.shape[1]
    Ls = crp.get_L_values(d["hK"], d["E"])
    crm = crp.CellRegMap(y=d["y"], E=d["E"], W=d["W"], Ls=Ls, config=cfg,
                         device="cuda")
    crm_auto = crm._with_config(dataclasses.replace(cfg,
                                                    pvalue_method="auto"))
    screen = lambda: crm.scan_interaction_screen(  # noqa: E731
        G, significance=SCREEN_SIGNIFICANCE)
    screen()          # the f32 context's setup, the kernels' first calls
    torch.cuda.synchronize()
    kernels.reset_launches()
    pv, info = screen()
    torch.cuda.synchronize()
    counts, counts32 = kernels.launch_counts(), kernels.launch_counts_f32()
    batch = min(cfg.snp_batch * 2, n_snps)
    n_batches = -(-n_snps // batch)
    hits = int(info["n_confirmed"])
    assert counts32 == dict(kr_contract=3 * n_batches, delta_grid=n_batches,
                            reml_newton=2 * n_batches,
                            best_rho_rotate=n_batches, score_core=n_batches,
                            sym_eigvalsh=n_batches, null_fit=0, fast_scan=0,
                            woodbury_family=0), counts32
    assert counts["mixture_tails"] == n_batches, counts
    # the discoveries: every f64 Davies hit confirmed with its value
    below = pv_dav < SCREEN_SIGNIFICANCE
    assert below.any(), "screen_2k: no f64 hit; the check is vacuous"
    assert np.all(info["confirmed"][below]), "screen_2k: a screen miss"
    conf_rel = float(np.max(np.abs(pv[below] - pv_dav[below])
                            / pv_dav[below]))
    assert np.all(np.abs(pv[below] - pv_dav[below])
                  <= davies_tolerance(pv_dav[below])), \
        f"screen_2k: confirmed pv rel {conf_rel}"
    assert np.array_equal(pv < SCREEN_SIGNIFICANCE, below), \
        "screen_2k: the discovery set differs from the f64 davies scan's"
    far = ~info["confirmed"]
    assert np.all(pv[far] == info["screen_pv"][far])
    pv32, sp64 = info["screen_pv"], np.asarray(info_auto["pv_saddlepoint"])
    ok = (np.isfinite(pv32) & (pv32 > 0) & np.isfinite(sp64)
          & (sp64 > 1e-30))
    assert ok.sum() >= 0.9 * n_snps
    dlog = np.abs(np.log10(pv32[ok]) - np.log10(sp64[ok]))
    q99 = float(np.quantile(dlog, 0.99))
    assert dlog.max() < 0.5, f"screen_2k: max |log10 ratio| {dlog.max()}"
    # throughput: screen, f64 davies and f64 auto in turns
    t_scr, t_dav, t_auto = [], [], []
    crm.scan_interaction(G)
    crm_auto.scan_interaction(G)
    for _ in range(reps):
        t_scr += _timed(screen, 1)[0]
        t_dav += _timed(lambda: crm.scan_interaction(G), 1)[0]
        t_auto += _timed(lambda: crm_auto.scan_interaction(G), 1)[0]
    # the traced split (every phase synchronises): setup, the batches'
    # device and copy-back phases, the confirm pass
    crm_t = crm._with_config(dataclasses.replace(cfg, trace=True))
    _, info_t = crm_t.scan_interaction_screen(
        G, significance=SCREEN_SIGNIFICANCE)
    phases = {k.split("/", 1)[-1]: v for k, v in info_t["timers"].items()}
    out = dict(
        label="screen_2k", n_cells=len(d["y"]), n_snps=n_snps,
        significance=SCREEN_SIGNIFICANCE, screen_batch=batch,
        screen_batches=n_batches, n_confirmed=hits,
        n_f64_hits=int(below.sum()), confirmed_pv_rel_max=conf_rel,
        log10_ratio_vs_f64_saddlepoint=dict(max=float(dlog.max()), q99=q99,
                                            n=int(ok.sum())),
        screen_s=t_scr, davies_s=t_dav, auto_s=t_auto,
        tests_per_s={k: n_snps / statistics.median(v) for k, v in
                     (("screen", t_scr), ("davies", t_dav),
                      ("auto", t_auto))},
        spread_s={k: max(v) - min(v) for k, v in
                  (("screen", t_scr), ("davies", t_dav), ("auto", t_auto))},
        traced_phase_s=phases, launches=counts, launches_f32=counts32)
    if cpu_check:
        Gc = G[:, :cpu_check]
        pv_g, info_g = crm.scan_interaction_screen(
            Gc, significance=SCREEN_SIGNIFICANCE)
        crm_c = crp.CellRegMap(y=d["y"], E=d["E"], W=d["W"], Ls=Ls,
                               config=cfg, device="cpu")
        pv_c, info_c = crm_c.scan_interaction_screen(
            Gc, significance=SCREEN_SIGNIFICANCE)
        assert np.array_equal(info_g["confirmed"], info_c["confirmed"])
        conf = info_c["confirmed"]
        gap = float(np.max(np.abs(pv_g[conf] - pv_c[conf]), initial=0.0))
        assert gap <= 1e-8, f"screen_2k: confirmed |pv_gpu - pv_cpu| {gap}"
        same = info_g["rho1"] == info_c["rho1"]
        assert same.mean() >= 0.9, f"screen_2k: rho1 agrees {same.mean()}"
        sp_rel = float(np.max(np.abs(info_g["screen_pv"][same]
                                     - info_c["screen_pv"][same])
                              / info_c["screen_pv"][same]))
        assert sp_rel <= 0.05, f"screen_2k: screen_pv rel {sp_rel}"
        out["cpu_check"] = dict(n=cpu_check, confirmed=int(conf.sum()),
                                confirmed_max_abs_pv_diff=gap,
                                rho1_identical=float(same.mean()),
                                screen_pv_rel_max=sp_rel)
    print("scan screen_2k: " + json.dumps(out), flush=True)
    return out, counts32


def screen_multigene_phase(d, cfg):
    """``screen_multigene_16`` (bench.py:541-557): 16 genes, Y = y + 0.1
    N(0, 1) (rng 13), 2048 variants, gene_batch = 16, significance 5e-8,
    through ``scan_interaction_multigene_screen`` on the card: a first and
    a steady call (pairs/s), the f32 instantiations' launch counts with
    the gene axis, every gene's screen p-value finite, the planted
    variant confirmed in every gene, and gene 0 against its single-gene
    screen on the card (screen p-values within rtol 0.05, the JAX suite's
    tolerance across two f32 programs; confirmed values within the Davies
    ladder's accuracy, ``davies_tolerance``); then K4-f32 and K6b on the
    first batch the screen gives them (16 genes x 84 variants: its memory
    rule), held to their plain versions and timed, their launches this
    run's.  Returns (summary, f32 launch counts, those two kernel
    rows)."""
    import torch

    import cellregmap_tpu_torch as crp
    from cellregmap_tpu_torch import kernels

    genes = SCREEN_MULTIGENE["genes"]
    rng = np.random.default_rng(SCREEN_MULTIGENE["seed"])
    Y = d["y"][:, None] + 0.1 * rng.normal(size=(len(d["y"]), genes))
    G = d["G"]
    Ls = crp.get_L_values(d["hK"], d["E"])
    crm = crp.CellRegMap(y=Y[:, 0], E=d["E"], W=d["W"], Ls=Ls, config=cfg,
                         device="cuda")
    run = lambda: crm.scan_interaction_multigene_screen(  # noqa: E731
        Y, G, gene_batch=genes, significance=SCREEN_SIGNIFICANCE)
    first_s, _ = _timed(run, 1)
    kernels.reset_launches()
    steady_s, (pv, info) = _timed(run, 1)
    counts, counts32 = kernels.launch_counts(), kernels.launch_counts_f32()
    assert pv.shape == (genes, G.shape[1])
    assert np.isfinite(info["screen_pv"]).all()
    assert np.all(info["confirmed"][:, GXE_SNP]), "the planted variant"
    assert all(counts32[k] > 0 for k in INTERACTION_F32), counts32
    pv0, info0 = crm.scan_interaction_screen(
        G, significance=SCREEN_SIGNIFICANCE)
    same = info0["rho1"] == info["rho1"][0]
    rel = float(np.max(np.abs(pv[0][same] - pv0[same]) / pv0[same]))
    assert rel <= 0.05, f"screen_multigene_16: gene 0 rel {rel}"
    both = info["confirmed"][0] & info0["confirmed"]
    conf_rel = float(np.max(np.abs(pv[0][both] - pv0[both]) / pv0[both],
                            initial=0.0))
    assert np.all(np.abs(pv[0][both] - pv0[both])
                  <= davies_tolerance(pv0[both])), \
        f"screen_multigene_16: confirmed rel {conf_rel}"
    # the path's own batch (the first of a gene tile): K4-f32 and K6b
    # held and timed, their launches this run's
    calls = capture_kernel_inputs(run, ["best_rho_rotate", "mixture_tails"])
    (args, _) = calls["best_rho_rotate"][0]
    (tails, _) = calls["mixture_tails"][0]
    del calls
    rows = [check_best_rho_rotate_f32(
                *args, f"best_rho_rotate ({genes} genes, f32)"),
            check_mixture_tails(*tails, tag=f"{genes} genes, screen")]
    rows[0]["launches"] = counts32["best_rho_rotate"]
    rows[1]["launches"] = counts["mixture_tails"]
    rows[0]["batch"] = int(args[1].shape[2])
    del args, tails
    torch.cuda.empty_cache()
    pairs = genes * G.shape[1]
    out = dict(label="screen_multigene_16", genes=genes,
               n_snps=G.shape[1], first_s=first_s[0], steady_s=steady_s[0],
               steady_pairs_per_s=pairs / steady_s[0],
               n_confirmed=int(info["n_confirmed"]),
               gene0_vs_single=dict(rho1_identical=float(same.mean()),
                                    screen_pv_rel_max=rel,
                                    confirmed_rel_max=conf_rel),
               launches=counts, launches_f32=counts32)
    print("scan screen_multigene_16: " + json.dumps(out), flush=True)
    for r in rows:
        print(f"kernel {r['name']}: max_abs_err {r['max_abs_err']:.3e} "
              f"({r['tolerance']}); ms {r['ms']:.4f}  plain_ms "
              f"{r['plain_ms']:.4f}  library_ms {r['library_ms']}  "
              f"bound_ms {r['bound_ms']:.4f} ({r['bound_by']}); "
              + json.dumps({k: r[k] for k in (
                  "matmul_ms", "device", "distinct_pairs", "batch", "pairs",
                  "operations", "gammaincc_iterations", "near_mean",
                  "rel_near", "rel_far") if k in r}), flush=True)
    return out, counts32, rows


# plink: a donor-level cohort written as a PLINK fileset at the headline's
# width (2000 cells, C = 10, 100 donors, 11 rho, snp_batch 512), 8192
# variants read in blocks of 2048; GxC planted on four variants (two in
# block 0, one in blocks 1 and 2), a monomorphic variant and a few missing
# calls
PLINK = dict(n_cells=2000, n_contexts=10, n_donors=100, n_variants=8192,
             block=2048, planted=(7, 1500, 2100, 5000), monomorphic=17,
             seed=18)
PLINK_GENES = dict(genes=16, window=512, stride=256)
PLINK_CLI_GENES = 4


def plink_cohort(prefix, n_cells, n_contexts, n_donors, n_variants, planted,
                 monomorphic, seed, **_):
    """Write the cohort's fileset at ``prefix``; returns the cell-level
    data (y, E, hK, d2c, the donor genotypes Gd)."""
    from cellregmap_tpu_torch.utils import plink

    rng = np.random.default_rng(seed)
    maf = rng.uniform(0.05, 0.45, size=n_variants)
    Gd = rng.binomial(2, maf, size=(n_donors, n_variants)).astype(float)
    Gd[:, monomorphic] = 0.0
    Gd[0, :16] = np.nan
    Gd[rng.integers(0, n_donors, 48), rng.integers(0, n_variants, 48)] = \
        np.nan
    d2c = np.repeat(np.arange(n_donors), -(-n_cells // n_donors))[:n_cells]
    E = rng.normal(size=(n_cells, n_contexts)) / np.sqrt(n_contexts)
    hK = np.zeros((n_cells, n_donors))
    hK[np.arange(n_cells), d2c] = 1.0
    Gp = Gd[:, list(planted)]
    Gp = np.where(np.isnan(Gp), np.nanmean(Gp, 0), Gp)[d2c]
    Gp = (Gp - Gp.mean(0)) / Gp.std(0)
    y = (rng.normal(size=n_cells) + 0.5 * E @ rng.normal(size=n_contexts)
         + 0.4 * hK @ rng.normal(size=n_donors)
         + 0.3 * np.sqrt(n_contexts) * (Gp * E[:, :1]).sum(1))
    plink.write_bed(prefix, Gd)
    return dict(y=y, E=E, hK=hK, d2c=d2c, Gd=Gd)


def _grew(before, names, what):
    """Assert that every kernel in ``names`` launched since ``before``."""
    from cellregmap_tpu_torch import kernels

    now = kernels.launch_counts()
    grew = {k: now[k] - before[k] for k in names}
    assert all(v > 0 for v in grew.values()), f"{what}: {grew}"
    return grew


def shims_check(d, device=CARD, tol=1e-10):
    """The low-rank shims (``ops.lowrank``) on the card against the CPU
    port, on the headline's hK (2000 x 100): ``economic_qs_linear``'s
    reconstruction, ``QSCov.solve`` and ``logdet``, ``ScoreStatistic``'s
    statistic and weights, each within ``tol`` of the CPU's largest
    entry; on the card, also host arrays given no device, which go
    there."""
    import torch

    from cellregmap_tpu_torch.ops import lowrank as lr

    rng = np.random.default_rng(100)
    rhs = rng.normal(size=(d["hK"].shape[0], 3))
    out = {}
    for dev in (device, "cpu"):
        hK = torch.as_tensor(d["hK"], device=dev)
        Q0, S0 = lr.economic_qs_linear(hK)
        cov = lr.QSCov(Q0, S0, 0.5, 0.7)
        ss = lr.ScoreStatistic(lr.PMat(cov, d["W"]), cov, d["E"])
        out[dev] = dict(
            K=(Q0 * S0) @ Q0.T, solve=cov.solve(rhs), logdet=cov.logdet(),
            Q=ss.statistic(d["y"]),
            weights=torch.sort(ss.distr_weights()).values)
        assert all(t.device.type == torch.device(dev).type
                   for t in out[dev].values()), dev
    if torch.device(device).type == "cuda":
        # host arrays, given no device, go to the card
        Q0, S0 = lr.economic_qs_linear(d["hK"])
        cov = lr.QSCov(Q0.cpu().numpy(), S0.cpu().numpy(), 0.5, 0.7)
        out["host"] = dict(K=(Q0 * S0) @ Q0.T, solve=cov.solve(rhs))
        assert all(t.device.type == "cuda" for t in out["host"].values())
    errs = {}
    for src in [device] + ["host"] * ("host" in out):
        for k, got in out[src].items():
            got, want = got.cpu(), out["cpu"][k]
            assert got.shape == want.shape, (k, got.shape, want.shape)
            key = k if src == device else f"host_{k}"
            errs[key] = float((got - want).abs().max())
            assert errs[key] <= tol * max(1.0, float(want.abs().max())), (
                key, errs)
    return errs


def plink_phase(d, cfg, device=CARD, spec=PLINK, genes=PLINK_GENES):
    """The PLINK drivers and their CLI on the card, over a fileset that
    the phase writes (``PLINK``): ``scan_interaction_plink`` (its time
    split: decode, expand-and-standardize, scan), checkpointed, stopped
    after two blocks and resumed equal to one uninterrupted run (rtol
    1e-12); its first block's first 64 variants against a direct
    ``scan_interaction`` of the same columns (1e-12) and the CPU port
    (1e-8, identical rho1); ``scan_interaction_screen_plink`` on one
    block (every f64 Davies hit confirmed with its value);
    ``scan_association_plink(fast=True)`` on the cohort;
    ``estimate_betas_plink`` on one block of 512;
    ``scan_interaction_multigene_plink`` (16 genes, 512-variant windows
    at a stride of 256, one tile); the CLI in a subprocess, once in
    interaction mode and once with Y + windows; each driver's kernels'
    launch counts grown; the native decoder built and loaded.  Then the
    low-rank shims (:func:`shims_check`)."""
    import os
    import tempfile

    import torch

    import cellregmap_tpu_torch as crp
    from cellregmap_tpu_torch import kernels
    from cellregmap_tpu_torch import plink_scan as ps
    from cellregmap_tpu_torch.parallel.checkpoint import ScanCheckpoint
    from cellregmap_tpu_torch.utils import plink
    from cellregmap_tpu_torch.utils.native import build_bed

    def sync():
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()

    assert build_bed() is not None, "bedreader.cc did not build"
    assert plink._get_bed_lib() is not None, "the .bed decoder did not load"
    block, m = spec["block"], spec["n_variants"]
    k15 = ("kr_contract", "delta_grid", "reml_newton", "best_rho_rotate",
           "score_core")
    out = dict(spec={k: v for k, v in spec.items() if k != "planted"})
    with tempfile.TemporaryDirectory() as tmp:
        prefix = os.path.join(tmp, "cohort")
        t0 = time.perf_counter()
        c = plink_cohort(prefix, **spec)
        out["write_s"] = time.perf_counter() - t0
        d2c = c["d2c"]
        Ls = crp.get_L_values(c["hK"], c["E"])
        t0 = time.perf_counter()
        crm = crp.CellRegMap(y=c["y"], E=c["E"], Ls=Ls, config=cfg,
                             device=device)
        crm._ctx
        sync()
        out["setup_s"] = time.perf_counter() - t0

        # the time split, block by block through the driver's own steps
        reader = plink.PlinkReader(prefix)
        split = dict(decode=0.0, expand_standardize=0.0, scan=0.0)
        cols = []
        for v0 in range(0, m, block):
            t0 = time.perf_counter()
            Gd = reader.read(v0, min(v0 + block, m))
            t1 = time.perf_counter()
            Gc, _, _ = ps._prepare_block(Gd, d2c, 0.0, True)
            t2 = time.perf_counter()
            crm.scan_interaction(Gc)
            sync()
            t3 = time.perf_counter()
            split["decode"] += t1 - t0
            split["expand_standardize"] += t2 - t1
            split["scan"] += t3 - t2
            cols.append(Gc)
        out["interaction_split_s"] = split

        # the driver, uninterrupted, then a direct scan of its columns
        before = kernels.launch_counts()
        t0 = time.perf_counter()
        pv, info, vidx = ps.scan_interaction_plink(crm, prefix,
                                                   donor_to_cell=d2c,
                                                   block_size=block)
        sync()
        out["interaction_driver_s"] = time.perf_counter() - t0
        out["interaction_launches"] = _grew(before, k15, "plink scan")
        Gall = np.concatenate(cols, axis=1)
        assert spec["monomorphic"] not in vidx
        assert pv.shape == vidx.shape == (Gall.shape[1],)
        assert np.all((pv > 0) & (pv <= 1)), "plink: p-value outside (0, 1]"
        t0 = time.perf_counter()
        pv_d, info_d = crm.scan_interaction(Gall)
        sync()
        out["interaction_direct_s"] = time.perf_counter() - t0
        head = cols[0][:, :64]
        pv_h, info_h = crm.scan_interaction(head)
        np.testing.assert_allclose(pv[:64], pv_h, rtol=0, atol=1e-12)
        out["direct_max_abs_gap"] = float(np.abs(pv - pv_d).max())
        planted = pv[np.searchsorted(vidx, spec["planted"])]
        assert np.all(planted < 1e-6), f"plink: planted pv {planted}"
        cpu = crp.CellRegMap(y=c["y"], E=c["E"], Ls=Ls, config=cfg,
                             device="cpu")
        pv_c, info_c = cpu.scan_interaction(head)
        out["cpu_max_abs_gap"] = float(np.abs(pv[:64] - pv_c).max())
        assert out["cpu_max_abs_gap"] <= 1e-8, out["cpu_max_abs_gap"]
        assert np.array_equal(info["rho1"][:64], info_c["rho1"])
        del cpu, cols

        # checkpointed, stopped after two blocks, resumed
        ck = os.path.join(tmp, "ck")
        real, calls = crm.scan_interaction, []

        def stopping(G, **kw):
            if len(calls) == 2:
                raise _Stop("scan_interaction")
            calls.append(G.shape[1])
            return real(G, **kw)

        crm.scan_interaction = stopping
        try:
            ps.scan_interaction_plink(crm, prefix, donor_to_cell=d2c,
                                      block_size=block, checkpoint=ck)
            raise AssertionError("plink: the stop did not stop the scan")
        except _Stop:
            pass
        finally:
            del crm.scan_interaction
        cursor = ScanCheckpoint(ck).load()["cursor"]
        assert cursor == 2, cursor
        t0 = time.perf_counter()
        pv_r, info_r, vidx_r = ps.scan_interaction_plink(
            crm, prefix, donor_to_cell=d2c, block_size=block, checkpoint=ck)
        out["resume_s"] = time.perf_counter() - t0
        assert np.array_equal(vidx_r, vidx)
        np.testing.assert_allclose(pv_r, pv, rtol=1e-12)
        for k in ("rho1", "e2", "g2", "eps2", "Q", "maf"):
            np.testing.assert_allclose(info_r[k], info[k], rtol=1e-12,
                                       err_msg=k)
        assert ScanCheckpoint(ck).load() is None, "plink: checkpoint kept"

        # the screen on one block: a fileset of the cohort's first block
        first = os.path.join(tmp, "first_block")
        plink.write_bed(first, c["Gd"][:, :block])
        before32 = kernels.launch_counts_f32()
        t0 = time.perf_counter()
        spv, sinfo, svidx = ps.scan_interaction_screen_plink(
            crm, first, donor_to_cell=d2c, block_size=block,
            significance=SCREEN_SIGNIFICANCE)
        out["screen_s"] = time.perf_counter() - t0
        now32 = kernels.launch_counts_f32()
        assert all(now32[k] > before32[k] for k in k15), now32
        in1 = vidx < block
        assert np.array_equal(svidx, vidx[in1])
        below = pv[in1] < SCREEN_SIGNIFICANCE
        assert below.any(), "plink screen: no f64 hit; the check is vacuous"
        assert np.all(sinfo["confirmed"][below]), "plink screen: a miss"
        assert np.all(np.abs(spv[below] - pv[in1][below])
                      <= davies_tolerance(pv[in1][below]))
        assert np.array_equal(spv < SCREEN_SIGNIFICANCE, below)
        out["screen_hits"] = int(below.sum())

        # the fast association on the cohort (a fresh null fit)
        crm_a = crm.with_phenotype(c["y"])
        before = kernels.launch_counts()
        t0 = time.perf_counter()
        apv, ainfo, avidx = ps.scan_association_plink(
            crm_a, prefix, donor_to_cell=d2c, block_size=block, fast=True)
        sync()
        out["association_fast_s"] = time.perf_counter() - t0
        out["association_fast_launches"] = _grew(
            before, ("null_fit", "fast_scan"), "plink association")
        assert np.array_equal(avidx, vidx)
        assert np.all((apv > 0) & (apv <= 1))
        np.testing.assert_allclose(
            apv[:64], crm_a.scan_association_fast(head)[0], rtol=0,
            atol=1e-12)
        t0 = time.perf_counter()
        crm_a.scan_association_fast(Gall)
        sync()
        out["association_fast_direct_s"] = time.perf_counter() - t0
        del Gall

        # the effect sizes on one block of 512 (raw genotypes)
        b512 = os.path.join(tmp, "block512")
        plink.write_bed(b512, c["Gd"][:, :512])
        crm_b = crp.CellRegMap(y=c["y"], E=c["E"], Ls=Ls, config=cfg,
                               device=device)
        before = kernels.launch_counts()
        t0 = time.perf_counter()
        bg, bgxe, bmaf, bvidx = ps.estimate_betas_plink(
            crm_b, b512, donor_to_cell=d2c, block_size=512)
        sync()
        out["betas_s"] = time.perf_counter() - t0
        out["betas_launches"] = _grew(before, ("woodbury_family",),
                                      "plink betas")
        assert bg.shape == bvidx.shape and bgxe.shape == (len(d2c), bg.size)
        assert np.isfinite(bg).all() and np.isfinite(bgxe).all()
        # a direct call on the block's columns (the same batch: a batch of
        # another width sums K9's terms in another order, ~1e-11 apart)
        raw, bmaf_d, _ = ps._prepare_block(reader.read(0, 512), d2c, 0.0,
                                           False)
        t0 = time.perf_counter()
        bg_d, bgxe_d = crm_b.predict_interaction(raw, bmaf_d)
        out["betas_direct_s"] = time.perf_counter() - t0
        assert np.array_equal(bmaf, bmaf_d)
        np.testing.assert_allclose(bg, bg_d, rtol=0, atol=1e-12)
        np.testing.assert_allclose(bgxe, bgxe_d, rtol=0, atol=1e-12)
        del crm_b, bgxe, bgxe_d

        # the gene-batched cis scan: one tile of 16 genes
        rng = np.random.default_rng(spec["seed"] + 1)
        G_n = genes["genes"]
        Y = c["y"][:, None] + 0.1 * rng.normal(size=(len(d2c), G_n))
        starts = genes["stride"] * np.arange(G_n)
        windows = np.stack([starts, starts + genes["window"]], axis=1)
        before = kernels.launch_counts()
        t0 = time.perf_counter()
        res = ps.scan_interaction_multigene_plink(
            crm, prefix, Y, windows, donor_to_cell=d2c, gene_batch=G_n)
        sync()
        out["multigene_s"] = time.perf_counter() - t0
        out["multigene_launches"] = _grew(before, k15[1:],
                                          "plink multigene")
        out["multigene_pairs"] = int(res["pvalues"].size)
        assert np.all((res["pvalues"] > 0) & (res["pvalues"] <= 1))
        for g in range(G_n):
            vi = res["variant_index"][res["gene"] == g]
            assert np.array_equal(vi, vidx[(vidx >= windows[g, 0])
                                           & (vidx < windows[g, 1])]), g
        g = 3
        sel = res["gene"] == g
        Gw, _, _ = ps._prepare_block(
            reader.read(int(windows[g, 0]), int(windows[g, 1])), d2c, 0.0,
            True)
        assert Gw.shape[1] == int(sel.sum())
        pv_g, _ = crm.with_phenotype(Y[:, g]).scan_interaction(Gw)
        np.testing.assert_allclose(res["pvalues"][sel], pv_g, rtol=0,
                                   atol=1e-9)

        # the CLI, in subprocesses: interaction mode, then Y + windows
        root = os.path.dirname(os.path.abspath(__file__))
        env = dict(os.environ, PYTHONPATH=root)
        dev_args = [] if device == CARD else ["--device", str(device)]
        data = os.path.join(tmp, "data.npz")
        np.savez(data, y=c["y"], E=c["E"], hK=c["hK"], donor_to_cell=d2c)
        cli = {}
        for mode, data_path, outp in (
                ("interaction", data, os.path.join(tmp, "cli.npz")),
                ("multigene", os.path.join(tmp, "data_mg.npz"),
                 os.path.join(tmp, "cli_mg.npz"))):
            if mode == "multigene":
                np.savez(data_path, Y=Y[:, :PLINK_CLI_GENES],
                         windows=windows[:PLINK_CLI_GENES], E=c["E"],
                         hK=c["hK"], donor_to_cell=d2c)
            t0 = time.perf_counter()
            r = subprocess.run(
                [sys.executable, "-m", "cellregmap_tpu_torch.plink_scan",
                 "--bed", first, "--data", data_path, "--out", outp,
                 "--snp-batch", str(cfg.snp_batch), *dev_args],
                cwd=root, env=env, capture_output=True, text=True,
                timeout=600)
            assert r.returncode == 0, f"CLI {mode}:\n{r.stderr[-4000:]}"
            line = json.loads(r.stdout.strip().splitlines()[-1])
            dev_type = torch.device(device).type
            assert line["device"].startswith(dev_type), line
            cli[mode] = dict(line, s=time.perf_counter() - t0)
            with np.load(outp) as z:
                # another process's host setup: equal to rounding
                if mode == "interaction":
                    assert np.array_equal(z["variant_index"], vidx[in1])
                    assert np.array_equal(z["rho1"], info["rho1"][in1])
                    np.testing.assert_allclose(z["pvalues"], pv[in1],
                                               rtol=1e-9, atol=1e-12)
                else:
                    for g in range(PLINK_CLI_GENES):
                        sel = res["gene"] == g
                        zs = z["gene"] == g
                        assert np.array_equal(z["variant_index"][zs],
                                              res["variant_index"][sel])
                        np.testing.assert_allclose(
                            z["pvalues"][zs], res["pvalues"][sel], rtol=0,
                            atol=1e-9)
        out["cli"] = cli
    out["shims_max_abs_err"] = shims_check(d, device)
    print("plink: " + json.dumps(out), flush=True)
    return out


def ptxas_report(log):
    """Each kernel of an ``nvcc -Xptxas -v`` log with its registers, stack
    and spills: ["name: Used N registers, ...; S bytes stack frame, ...",
    ...], the names demangled where c++filt is at hand."""
    import re
    import shutil

    out, name = [], None
    for ln in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\w+)", ln)
        if m:
            name = m.group(1)
        elif name and ("registers" in ln or "spill" in ln):
            out.append((name, ln.split(":", 1)[-1].strip()))
    if shutil.which("c++filt"):
        names = sorted({n for n, _ in out})
        demangled = subprocess.run(["c++filt", *names], capture_output=True,
                                   text=True, timeout=60).stdout.split("\n")
        short = {n: re.sub(r"\(.*", "", d.replace(
                     "(anonymous namespace)::", "").replace("void ", ""))
                 for n, d in zip(names, demangled)}
        out = [(short.get(n, n), r) for n, r in out]
    merged = {}
    for n, r in out:
        merged.setdefault(n, []).append(r)
    return [f"{n}: " + "; ".join(rs) for n, rs in merged.items()]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    import cellregmap_tpu_torch as crp
    from cellregmap_tpu_torch import engine
    from cellregmap_tpu_torch.kernels import _build
    from cellregmap_tpu_torch.kernels import best_rho_rotate as k4
    from cellregmap_tpu_torch.utils.native import build_qfc

    faulthandler.enable()         # a crash in native code prints its stack
    t_start = time.perf_counter()

    def mark(label):
        # the phases' end times, for sizing the script's whole time
        print(f"phase {label}: ends at {time.perf_counter() - t_start:.1f} s",
              flush=True)

    card = card_line()
    print(card, flush=True)
    assert not torch.backends.cuda.matmul.allow_tf32, "TF32 matmul is on"

    # --- build ---
    t0 = time.perf_counter()
    built = _build.build_all(verbose=True)
    assert build_qfc() is not None, "qfc.cc did not build"
    print(f"build: {time.perf_counter() - t0:.2f} s", flush=True)
    for name in _build.SOURCES:
        print(f"ptxas {name}: " + " | ".join(
            ptxas_report(built.get(f"{name}.ptxas", ""))), flush=True)

    # --- kernels against their plain versions, at the headline shapes ---
    cfg = crp.ScanConfig(snp_batch=BATCH)
    d = make_dataset(**HEADLINE)
    ctx = engine.build_null_context(
        d["y"], d["W"], d["E"], Ls=crp.get_L_values(d["hK"], d["E"]),
        device="cuda")
    Gb = torch.as_tensor(d["G"][:, :BATCH], device="cuda").contiguous()
    rows = check_kernels(ctx, Gb, len(d["y"]))
    mark("kernels")

    # --- the interaction path at the headline size (davies, then auto),
    # then a second size ---
    head, counts, pv_dav, _ = scan_size("headline", HEADLINE, cfg,
                                        cpu_check=64)
    assert head["pv_planted"] < 1e-6, \
        f"planted GxC variant {GXE_SNP}: pv {head['pv_planted']}"
    cfg_auto = crp.ScanConfig(snp_batch=BATCH, pvalue_method="auto")
    head_auto, c_auto, pv_auto, info_auto = scan_size(
        "headline_auto", HEADLINE, cfg_auto, warmup=False, cpu_check=64)
    assert head_auto["pv_planted"] < 1e-6, \
        f"auto: planted GxC variant {GXE_SNP}: pv {head_auto['pv_planted']}"
    auto = auto_vs_davies(pv_auto, info_auto, pv_dav, cfg_auto)
    print("auto vs davies (headline): " + json.dumps(dict(
        auto, scan_s={"davies": head["scan_s"], "auto": head_auto["scan_s"]},
        pvalue_ladder_s={
            "davies": head["traced_phase_s"]["pvalue_ladder"],
            "auto": head_auto["traced_phase_s"]["pvalue_ladder"]})),
        flush=True)
    # the float32 context's kernels on one screen batch, then the screens
    ctx32 = engine.NullContext(*(t.to(torch.float32) for t in ctx))
    G32 = torch.as_tensor(d["G"][:, :2 * BATCH], device="cuda",
                          dtype=torch.float32).contiguous()
    rows32 = check_f32_kernels(ctx32, G32, len(d["y"]))
    del ctx32, G32
    rows32.append(check_localize_f32_p7(d))
    torch.cuda.empty_cache()
    mark("headline scans, f32 kernels")
    scr, c_screen = screen_phase(d, cfg, pv_dav, info_auto)
    _, _, rows_smg = screen_multigene_phase(d, cfg)
    mark("screens")
    # each f32 row's launches: its instantiation's on one screen_2k run,
    # K6b's (f64) from that run's counts (the p = 7 localize is off the
    # path and keeps its 0; the multigene screen's rows come counted)
    for r in rows32:
        if "off_main_path" in r:
            continue
        base = r["name"].split(" (")[0]
        c = scr["launches"] if base == "mixture_tails" else c_screen
        per = {"kr_contract": len(K1_CALLS), "reml_newton": 2}.get(base, 1)
        assert c[base] % per == 0 and c[base] > 0, r["name"]
        r["launches"] = c[base] // per
    assert all(r["launches"] > 0 for r in rows_smg), rows_smg
    rows += rows32 + rows_smg

    # cells10k (R = 2500, C = 20: the localize stages its rows in chunks),
    # its first batch's K1, K3 and K4 operands captured from the run
    held = {}
    cap = capture_kernel_inputs(
        lambda: held.update(counts=scan_size("cells10k", SECOND, cfg,
                                             warmup=False)[1]),
        ["kr_contract", "reml_localize", "reml_converge", "best_rho_rotate",
         "score_core"])
    c_10k = held["counts"]
    rows_10k = check_kr_contract([a for a, _ in cap["kr_contract"][:3]],
                                 K1_CALLS, tag="cells10k")
    rows_10k += check_reml_newton(cap["reml_localize"][0],
                                  cap["reml_converge"][0], plain_reps=3,
                                  tag="cells10k")
    rows_10k.append(check_score_core(cap["score_core"][0][0],
                                     tag="cells10k", plain_reps=3))
    (V, T, kb), _ = cap["best_rho_rotate"][0]
    del cap
    b_ms, b_by, _, _ = k4_bound(V, T, kb)
    rows_10k.append(dict(
        name="best_rho_rotate (cells10k)", route="cuda",
        source="cellregmap_tpu_torch/csrc/best_rho_rotate.cu",
        replaces="cellregmap_tpu/engine.py:672",
        max_abs_err=check_best_rho_rotate(V, T, kb,
                                          "best_rho_rotate (cells10k)"),
        ms=cuda_ms(lambda: k4.best_rho_rotate(V, T, kb)),
        plain_ms=cuda_ms(lambda: k4.best_rho_rotate_plain(V, T, kb),
                         reps=3, warmup=1),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=k4_library_ms(V, T, kb, chunk=16),
        tolerance="slots equal; the gathered factors' max|err| <= 1e-12 * "
                  "max|plain|"))
    del V, T, kb
    # hand the rows' cached blocks back: the scans size their batches by
    # the card's free memory
    torch.cuda.empty_cache()
    for r in rows_10k:
        print(f"kernel {r['name']}: max_abs_err {r['max_abs_err']:.3e} "
              f"({r['tolerance']}); ms {r['ms']:.4f}  plain_ms "
              f"{r['plain_ms']:.4f}  library_ms {r['library_ms']}  "
              f"bound_ms {r['bound_ms']:.4f} ({r['bound_by']})", flush=True)
    rows += rows_10k
    mark("cells10k")

    # --- the gene-batched scan ---
    multigene_phase(d, cfg)
    mark("multigene_16")

    # --- the association paths at the headline size ---
    Ls = crp.get_L_values(d["hK"], d["E"])
    _, c_hk = association_path("run_association_hK", d, cfg)
    _, c_ls = association_path("scan_association_Ls", d, cfg, Ls=Ls)

    # --- K8 and K9 against their plain versions, at the headline shapes ---
    n = len(d["y"])
    rows.append(check_fast_scan(ctx, Gb, n))
    bctx = engine.build_betas_context(d["y"], d["W"], d["E"], Ls,
                                      rho_grid=np.linspace(0, 1, 11),
                                      device="cuda")
    maf = d["maf"][:BATCH]
    norm = torch.as_tensor(1.0 / np.sqrt(2 * maf * (1 - maf)),
                           device="cuda")
    rows.append(check_woodbury_family(bctx, Gb, norm, n))
    del bctx
    for r in rows[-2:]:
        print(f"kernel {r['name']}: max_abs_err {r['max_abs_err']:.3e} "
              f"({r['tolerance']}); ms {r['ms']:.4f}  plain_ms "
              f"{r['plain_ms']:.4f}  library_ms {r['library_ms']:.4f}  "
              f"bound_ms {r['bound_ms']:.4f} ({r['bound_by']}); "
              + json.dumps({k: r[k] for k in ("shapes", "calls",
                                              "points_per_variant", "flops",
                                              "nbytes", "f32_excess",
                                              "f64_rel", "k1_betas_rel",
                                              "split_ms")
                             if k in r}),
              flush=True)

    # --- fast association, effect sizes, aggregate environment ---
    _, c_fhk = fast_association_path("run_association_fast_hK", d, cfg)
    _, c_fls = fast_association_path("scan_association_fast_Ls", d, cfg,
                                     Ls=Ls)
    _, c_betas = betas_path(d, cfg)
    mark("association, fast association, K8, K9, betas")
    _, c_agg, k10_p12 = aggregate_environment_phase(d, cfg)
    rows.append(k10_p12)
    _, k10_wide = wide_phase(cfg)
    rows.append(k10_wide)
    _, wide_cov_rows = wide_covariates_phase(cfg)
    rows += wide_cov_rows
    mark("aggregate environment, C = 50")

    # --- the gene-batched association scans, then checkpointed scans ---
    _, c_amg, amg_rows, crm_assoc = assoc_multigene_phase(d, cfg, Ls)
    _, c_arm, arm_rows = assoc_refit_multigene_phase(d, cfg, crm_assoc)
    rows += amg_rows + arm_rows
    for r in rows[-4:]:
        print(f"kernel {r['name']}: max_abs_err {r['max_abs_err']:.3e} "
              f"({r['tolerance']}); ms {r['ms']:.4f}  plain_ms "
              f"{r['plain_ms']:.4f}  library_ms {r['library_ms']}  "
              f"bound_ms {r['bound_ms']:.4f} ({r['bound_by']}); "
              + json.dumps({k: r[k] for k in ("shapes", "split_ms")
                            if k in r}), flush=True)
    checkpoint_phase(d, cfg, crm_assoc)
    del crm_assoc
    torch.cuda.empty_cache()

    # --- the float32 context on the association scans and the effect
    # sizes: the paths, then their kernels (rows with their launches) ---
    mark("assoc_multigene_16, assoc_refit_multigene_16, checkpoint")
    _, f32_rows = f32_association_phase(d, cfg, Ls)
    rows += f32_rows
    mark("float32 association and effect sizes")

    # --- the card's covariate envelope: p = 24, 21 rho; 80 rho ---
    _, c_cov, cov_rows = covariates_phase(d)
    rows += cov_rows
    _, c_rho80, rho80_rows = rho80_phase(cfg)
    rows += rho80_rows
    mark("covariates_24, n_rho = 80")

    # --- the PLINK drivers and their CLI; the low-rank shims ---
    plink_phase(d, cfg)
    mark("plink")

    # each row's launches: its wrapper's count on the run its operands
    # came from (tagged rows: their phase's run), divided by the wrapper's
    # calls a batch there when the row is one of them (K1's three calls,
    # K3's localize and converge)
    def total(*cs):
        return {k: sum(c[k] for c in cs) for k in counts}

    runs = {None: counts, "cells10k": c_10k, f"n_rho = {N_RHO80}": c_rho80,
            "p = 24": c_cov["run_interaction"], "genes": c_arm}
    for r in rows:
        if "launches" in r:       # counted by its phase
            continue
        base, _, inner = r["name"].partition(" (")
        parts = inner.rstrip(")").split(", ") if inner else []
        tag = next((s for s in parts if s in runs), None)
        c, module, per_batch = runs[tag], base, 1
        if base == "kr_contract":
            per_batch = len(K1_CALLS)
        elif base == "reml_newton":
            per_batch = 2
        elif base == "association_refit":
            module = "delta_grid" if "grid" in parts else "reml_newton"
            c = {None: total(c_hk, c_ls), "genes": c_arm,
                 "p = 24": c_cov["run_association"]}[tag]
        elif base in ("sym_eigvalsh", "mixture_tails"):
            c = c_auto
        elif base == "null_fit":
            c = (total(c_amg, c_arm) if tag == "genes"
                 else total(c_hk, c_ls, c_fhk, c_fls, c_agg))
        elif base == "fast_scan":
            c = {None: total(c_fhk, c_fls), "genes": c_amg,
                 "p = 24": c_cov["run_association_fast"]}[tag]
        elif base == "woodbury_family":
            c = c_betas
        assert c[module] % per_batch == 0, f"{r['name']}: {c[module]}"
        r["launches"] = c[module] // per_batch
        assert r["launches"] > 0, f"{r['name']}: no launch on its path"
    # one unit for every row: launches count wrapper calls, so a row
    # timed over a batch's `calls` calls of its wrapper (K7's converge,
    # K9) gives its times a call (the batch's beside them)
    for r in rows:
        if r.get("calls", 1) > 1:
            r["batch_ms"] = {k: r[k] for k in ("ms", "plain_ms", "bound_ms",
                                               "library_ms")}
            for k in ("ms", "plain_ms", "bound_ms", "library_ms"):
                if r[k] is not None:
                    r[k] /= r["calls"]
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
