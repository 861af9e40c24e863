"""K1 (``csrc/kr_contract.cu``), the wide K3 localize
(``csrc/reml_newton.cu``), the wide K10 (``csrc/null_fit.cu``) and K9
(``csrc/woodbury_family.cu``) of this checkout against another checkout's,
on the same operands, on one card in one process:

* K1 on the three contractions of a headline interaction batch (2000
  cells, 10 contexts, 100 donors, 512 variants: T = Z^T (E0 o G), A^T A,
  A^T W), each call apart;
* K3's localize at ``covariates_24`` (the headline dataset with W = [1, 23
  columns of N(0, 1), rng 24], 21 rho points) and at p = 8 (the first 8
  columns of that W), both from the batch's own K2 brackets;
* K10 (``k10``) on the headline's association null fit (the Ls
  scanner: p = 1, R = 1000, 11 rho, the association's 256-point grid and
  60 golden-section steps, ML), on the aggregate environment's mean fit
  on that scanner with an E1 outside E (``chip_smoke``'s phase: p = 12,
  REML) and, wide, at 50 contexts (``chip_smoke.WIDE``: 2000 cells, 100
  donors, an E1 of 10 seeded contexts; p = rank[W, E] + 1 = 52 mean
  columns, R = 2000, 11 rho); K10 with the gene axis (``k10mg``) on the
  ``assoc_multigene_16`` tile's null fit (16 genes, Y = y + 0.1 N(0, 1),
  rng 11, p = 1);
* K6a (``k6a``, ``csrc/sym_eigvalsh.cu``) on a headline interaction
  batch's 512 weight matrices (C = 10), on a 512-variant batch at 50
  contexts (``chip_smoke.WIDE``) and on 512 seeded PSD matrices at C =
  64 (``chip_smoke.k6a_c64_matrices``), eigenvalues within 1e-12 of each
  row's largest |lambda| of this checkout's plain version;
* the headline scan (``scan``): ``scan_interaction`` of the headline's
  2048 variants on a scanner already set up (2000 cells, the Ls
  background), under davies and under auto, each side's scanner built
  once and timed by host clock over ``--scan-reps`` scans a turn, in the
  order other, this, this, other (every scan's seconds kept: their spread
  is the run-to-run spread of one card and process);
* K9 on each of the 9 calls of one headline effect-size batch (512
  variants, Rk = 1000, q = 23: five f32 zoom rounds, three f64 rounds, the
  f64 fit with coefficients), each call apart and their sums by precision;
* the float32 context's K1 (``k1f32``) on the three contractions of one
  screen batch (the headline's context cast to f32 on the card, 1024
  variants), each sum within sqrt(n) eps(f32) of the terms' magnitudes
  of this checkout's plain version, and its K2 (``k2f32``) on that
  batch's REML grid, on its 16-gene tile (Y = y + 0.1 N(0, 1), rng 13)
  and on K7-f32's ML grid (the float32 Ls scanner, 512 variants), each
  bracket on the plain grid's argmax or a tie within 1e-5; each call's
  profile splits its time by launch (K2-f32: the weights, the sums and
  the epilogue, or the sums and the epilogue);
* K2 (``k2``, ``csrc/delta_grid.cu``) on the same three batches as K4
  below, each bracket on the plain grid's argmax or a tie within 1e-5
  (the float32 grid of hybrid localization);
* K4 (``csrc/best_rho_rotate.cu``) and K3's register localize (p = 1) on
  a headline interaction batch, on a ``multigene_16`` batch (the
  headline dataset, Y = y + 0.1 N(0, 1) over 16 genes, rng 9) and on a
  ``cells10k`` batch (R = 2500, C = 20: the localize's rows staged in
  chunks), from the batch's own k_best and K2 brackets.  K4's contract
  changed (each distinct (rho, variant) pair once, through slots), so
  each side's factors are compared per (gene, variant): this checkout's
  gathered through its slots;
* K5 (``csrc/score_core.cu``) and K3's converge (``csrc/reml_newton.cu``)
  on the batches ``chip_smoke.py`` holds them on: a headline interaction
  batch, a ``multigene_16`` batch, a ``cells10k`` batch, a
  ``covariates_24`` batch (p = 24, 21 rho: K5 at m = 36 and the wide
  converge) and an ``n_rho = 80`` batch (``chip_smoke.RHO80``: 1000
  cells, R = 510); the converge also on each call of K7's association
  refit batch (the headline's Ls scanner, 512 variants at the null's best
  rho: the Newton steps, then the two zero-step fits at the grid's ends),
  of K7 with the gene axis (``assoc_refit_multigene_16``: 16 genes, Y = y
  + 0.1 N(0, 1), rng 11, each at its own null's best rho) and of the wide
  K7 (``covariates_24``'s hK scanner, R = 110).  K5 within 1e-10 of
  max|plain|, the converge's delta, lml, scale and beta within rel 1e-9.

The operands come from this checkout's engine; the other checkout's
package is loaded under another name, builds its own kernels into its own
``build/``, and is called through its own wrappers (whose signatures are
the same).  Each call is held to this checkout's plain version (K1 within
1e-12 of max|plain|; the localize with k_best equal, x within rel 1e-9 and
lml within rel 1e-10; K10 through ``null_fit.fit_gaps`` at 1e-10; K9 f64
lml within 1e-10 of max(|lml|, 1) with the same non-finite points, beta
and rss within 1e-9 of their largest entry, f32 through
``woodbury_family.f32_gaps``), then timed by CUDA events (the median of 20
runs, 10 for the localize and K9, 5 for K10) in the order other, this,
this, other, and profiled with ``torch.profiler`` (device milliseconds a
call in each kernel; None where the profiler saw no kernel); ``host_ms``
is each side's host time a call (50 calls enqueued back to back).  Prints
one JSON line per call and one of the whole;
``--out`` also writes that line to a file; ``--kernels`` picks some of
k1, k1f32, k2, k2f32, k3, k10, k10mg, k6a, k9, k4, k3reg, k5, k3conv,
k3conv32, k8, scan, assoc (``assoc_ab``: the fast association scans
end to end, f64 and f32, host clock), k3loc32, k10f32, e2e32, k4f32, k6b,
e2e_tails.  K8 (``csrc/fast_scan.cu``): the
headline's Ls
fast-scan batch (512 variants at the null's best rho and delta) and the
``assoc_multigene_16`` tile's batch (16 genes, each at its own), on the
scanner built in f64 and in f32, and the wide instantiation at
``covariates_24`` (the hK scanner, p = 24), each output within
``chip_smoke.FAST_SCAN_TOLERANCE`` of max|plain|, timed over 20 runs,
each call's profile split by launch.  The float32 converge
(``k3conv32``): stage 3 of one screen batch (1024 variants of the
headline's context cast to f32), K7's three calls of one refit batch and
K7 with the gene axis, each on the float32 scanner, and the same calls
in f64 as the yardstick, within rel 1e-9 of the plain version.  The
float32 localize (``k3loc32``): stages 1b and 2 of one screen batch (1024
variants of the headline's context cast to f32) at p = 1, at p = 7 (W =
[1, 6 columns of N(0, 1), rng 24]) and on ``screen_multigene_16``'s 16
genes, held by ``chip_smoke.check_localize_f32``'s rule (the f64 lml at
the localized optimum within 1e-6 of max(|lml|, 1), the same -inf
entries, the argmax a tie within 1e-6).  K10-f32 (``k10f32``): the
float32 Ls scanner's null fit and the ``assoc_multigene_16`` tile's,
within ``chip_smoke.null_fits_agree``'s f32 budget.  ``e2e32``: the
scans those two feed, end to end on both checkouts (host clock, every
scan kept): ``screen_2k`` (``scan_interaction_screen`` of the headline's
2048 variants at 5e-8, the discoveries equal on both sides),
``screen_multigene_16`` (16 genes, Y = y + 0.1 N(0, 1), rng 13), the
float32 ``scan_association`` on the Ls scanner (its null fit, K10, made
again each scan, as a scanner's first scan makes it) and the float32
``assoc_multigene_16`` (``scan_association_fast_multigene``), each
side's scanner set up once, then ``--scan-reps`` rounds of one timed scan
a side, the side that runs first alternating (10 rounds or more to tell
a change from the spread), and each side's device milliseconds a scan.
K4's float32 product (``k4f32``) on one screen batch's rotation (the
headline's context cast to f32, 1024 variants, one gene) and on
``screen_multigene_16``'s 16-gene tile of it, the factors per (gene,
variant) within sqrt(R) eps(f32) of the terms' magnitudes; K6b (``k6b``,
``csrc/mixture_tails.cu``) on the (Q, lambda) pairs of the headline's f64
auto batch (512), of that screen batch (1024) and of the 16-gene tile (16
x 1024); both also on the first batch ``scan_interaction_multigene_screen``
gives them (16 genes x 84 variants: its memory rule); K6b's tails by
``chip_smoke.check_tails`` against this checkout's plain version, each
side's gaps to that rule in the row (``gaps``).
``e2e_tails``: the scans those two feed, as ``e2e32`` runs its own:
``screen_2k``, ``screen_multigene_16`` and the headline scan under auto
(``scan_interaction`` of 2048 variants).

    python3 scripts/profile_kernel_ab.py --other <checkout> [--out FILE]
        [--kernels k10,k10mg,k6a,scan] [--scan-reps 5]
"""
import argparse
import importlib.util
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
from cellregmap_tpu_torch.kernels import best_rho_rotate as k4  # noqa: E402
from cellregmap_tpu_torch.kernels import delta_grid as k2  # noqa: E402
from cellregmap_tpu_torch.kernels import kr_contract as k1  # noqa: E402
from cellregmap_tpu_torch.kernels import mixture_tails as k6b  # noqa: E402
from cellregmap_tpu_torch.kernels import null_fit as k10  # noqa: E402
from cellregmap_tpu_torch.kernels import reml_newton as k3  # noqa: E402
from cellregmap_tpu_torch.kernels import score_core as k5  # noqa: E402
from cellregmap_tpu_torch.kernels import sym_eigvalsh as k6a  # noqa: E402
from cellregmap_tpu_torch.kernels import woodbury_family as k9  # noqa: E402

KERNELS = {"k1": "kr_contract", "k2": "delta_grid", "k3": "reml_newton",
           "k1f32": "kr_contract", "k2f32": "delta_grid",
           "k10": "null_fit",
           "k10mg": "null_fit", "k6a": "sym_eigvalsh",
           "k9": "woodbury_family", "k4": "best_rho_rotate",
           "k3reg": "reml_newton", "k5": "score_core", "k3conv": "reml_newton",
           "k3conv32": "reml_newton", "k8": "fast_scan", "scan": None,
           "assoc": None, "k3loc32": "reml_newton", "k10f32": "null_fit",
           "e2e32": None, "k4f32": "best_rho_rotate",
           "k6b": "mixture_tails", "e2e_tails": None}
# the end-to-end rows of each end-to-end selection
E2E_ROWS = {"e2e32": ("screen_2k", "screen_multigene_16",
                      "scan_association f32", "assoc_multigene_16 f32"),
            "e2e_tails": ("screen_2k", "screen_multigene_16",
                          "headline auto")}


def load_other(root: Path, name="other_crp"):
    """The package of the checkout at ``root``, imported as ``name``."""
    pkg = root / "cellregmap_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        name, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    for kernel in set(KERNELS.values()) - {None}:
        importlib.import_module(f"{name}.kernels.{kernel}")
    return mod


def timed(fns, reps):
    """CUDA-event medians of each (label, fn) in the order given."""
    out = {}
    for label, fn in fns:
        out.setdefault(label, []).append(cs.cuda_ms(fn, reps=reps, warmup=2))
    return out


def host_ms(this_fn, other_fn, calls=50):
    """Host milliseconds a call of each side spends before it returns (its
    checks, allocations and launches), over ``calls`` calls enqueued back
    to back after a synchronise, in the order other, this, this, other."""
    out = {}
    for label, fn in (("other", other_fn), ("this", this_fn),
                      ("this", this_fn), ("other", other_fn)):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        out.setdefault(label, []).append((time.perf_counter() - t0) * 1e3
                                         / calls)
        torch.cuda.synchronize()
    return out


def compare(name, this_fn, other_fn, check, reps):
    for label, fn in (("this", this_fn), ("other", other_fn)):
        check(label, fn())
        torch.cuda.synchronize()
    ms = timed([("other", other_fn), ("this", this_fn), ("this", this_fn),
                ("other", other_fn)], reps)
    row = dict(call=name, ms=ms, host_ms=host_ms(this_fn, other_fn),
               profile={})
    for label, fn in (("this", this_fn), ("other", other_fn)):
        try:
            row["profile"][label] = cs.device_split(fn)
        except AssertionError:  # the profiler saw no kernel, twice
            row["profile"][label] = None
    print(json.dumps(row), flush=True)
    return row


def k10_wide_call():
    """The wide K10's operands on the aggregate environment's mean fit at
    50 contexts (``chip_smoke.wide_phase``'s dataset and scanner)."""
    d = cs.make_dataset(**cs.WIDE)
    n = len(d["y"])
    rng = np.random.default_rng(cs.WIDE["seed"])
    E1 = rng.normal(size=(n, 10)) / np.sqrt(10)
    y = d["y"] + E1 @ rng.normal(size=10)
    crm = crp.CellRegMap(y=y, E=d["E"], E1=E1, W=d["W"],
                         Ls=crp.get_L_values(d["hK"], d["E"]),
                         config=crp.ScanConfig(), device="cuda")
    cfg = crm._cfg
    M = np.concatenate([engine.reduced_design_basis(d["W"], d["E"]),
                        d["G"][:, cs.GXE_SNP][:, None]], axis=1)
    (args, kw), = cs.capture_kernel_inputs(
        lambda: engine.mean_fit(crm._ctx, torch.as_tensor(M, device="cuda"),
                                n, True, (cfg.delta_logit_lo,
                                          cfg.delta_logit_hi,
                                          cfg.n_delta_grid,
                                          cfg.n_golden_iters)),
        ["null_fit"])["null_fit"]
    return args, kw


def k10_calls(d, n, Ls, picked):
    """(label, K10's (args, kw)) of the calls the module doc lists: with
    ``k10`` the headline's association null fit, the aggregate
    environment's p = 12 mean fit and the wide fit at 50 contexts; with
    ``k10mg`` the ``assoc_multigene_16`` tile's null fit."""
    ctx = engine.build_null_context(d["y"], d["W"], d["E"], Ls=Ls,
                                    device="cuda")
    out = []
    if "k10" in picked:
        out += [("headline Ls, p = 1", cs.capture_kernel_inputs(
                    lambda: engine.null_association_fit(
                        ctx, n, delta_cfg=cs.ASSOC_DELTA_CFG),
                    ["null_fit"])["null_fit"][0]),
                ("aggregate environment, p = 12",
                 cs.aggregate_fit_call(d, crp.ScanConfig())),
                ("wide, p = 52", k10_wide_call())]
    if "k10mg" in picked:
        ctx_g = cs._gene_ctx(ctx, cs._multigene_genes(d))
        out.append(("genes", cs.capture_kernel_inputs(
            lambda: engine.null_association_multigene_fit(
                ctx_g, n, delta_cfg=cs.ASSOC_DELTA_CFG),
            ["null_fit"])["null_fit"][0]))
    return out


def k6a_calls(d, n, G, Ls):
    """(label, K6a's A (S, C, C)) of a headline interaction batch, of a
    512-variant batch at 50 contexts and of 512 seeded PSD matrices at C =
    64."""
    ctx = engine.build_null_context(d["y"], d["W"], d["E"], Ls=Ls,
                                    device="cuda")
    head = cs.capture_kernel_inputs(
        lambda: engine.interaction_batch(ctx, G, G, n,
                                         delta_cfg=cs.DELTA_CFG,
                                         device_pvalues=True),
        ["sym_eigvalsh"])["sym_eigvalsh"][0][0][0]
    dw = cs.make_dataset(**cs.WIDE)
    nw = len(dw["y"])
    ctx_w = engine.build_null_context(
        dw["y"], dw["W"], dw["E"], Ls=crp.get_L_values(dw["hK"], dw["E"]),
        device="cuda")
    Gw = torch.as_tensor(dw["G"][:, :cs.BATCH], device="cuda").contiguous()
    c50 = cs.capture_kernel_inputs(
        lambda: engine.interaction_batch(ctx_w, Gw, Gw, nw,
                                         delta_cfg=cs.DELTA_CFG,
                                         device_pvalues=True),
        ["sym_eigvalsh"])["sym_eigvalsh"][0][0][0]
    return [("headline, C = 10", head), ("C = 50", c50),
            ("C = 64", cs.k6a_c64_matrices())]


def scan_ab(d, Ls, other, reps):
    """The headline scan of both checkouts under davies and auto: each
    side's scanner set up and scanned once, then ``reps`` timed scans a
    turn in the order other, this, this, other, held equal to the first
    scan of this checkout within 1e-8 (absolute)."""
    out = {}
    for method in ("davies", "auto"):
        crms = {}
        for side, pkg in (("this", crp), ("other", other)):
            crms[side] = pkg.CellRegMap(
                y=d["y"], E=d["E"], W=d["W"], Ls=Ls, device="cuda",
                config=pkg.ScanConfig(snp_batch=cs.BATCH,
                                      pvalue_method=method))
            pv, _ = crms[side].scan_interaction(d["G"])
            if side == "this":
                ref = pv
            assert np.max(np.abs(pv - ref)) <= 1e-8, f"scan {method} ({side})"
        times = {"this": [], "other": []}
        for side in ("other", "this", "this", "other"):
            for _ in range(reps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                crms[side].scan_interaction(d["G"])
                torch.cuda.synchronize()
                times[side].append(time.perf_counter() - t0)
        out[method] = {side: dict(median_s=float(np.median(t)),
                                  min_s=min(t), max_s=max(t), s=t)
                       for side, t in times.items()}
        print(json.dumps({"scan": method, **out[method]}), flush=True)
        del crms
    return out


def assoc_ab(d, Ls, other, reps):
    """The fast association scans of both checkouts in f64 and f32
    (``ScanConfig(dtype=...)``): ``scan_association_fast`` of the
    headline's 2048 variants and ``scan_association_fast_multigene`` of
    the ``assoc_multigene_16`` genes, each side's scanner set up and
    scanned once, then ``reps`` timed scans a turn in the order other,
    this, this, other (host clock).  The other checkout's first scan is
    held to this one's by ``chip_smoke``'s rule for the float32 scans: the
    LRT statistics within ``tol`` of |null lml| (f64 1e-8, f32
    ``chip_smoke.F32_STAT_REL``: K8's sums run in another order)."""
    Y = cs._multigene_genes(d)
    out = {}
    for dt, tag, tol in (("float64", "f64", 1e-8),
                         ("float32", "f32", cs.F32_STAT_REL)):
        crms, runs = {}, {}
        for side, pkg in (("this", crp), ("other", other)):
            crm = pkg.CellRegMap(
                y=Y[:, 0], E=d["E"], W=d["W"], Ls=Ls, device="cuda",
                config=pkg.ScanConfig(snp_batch=cs.BATCH, dtype=dt))
            crms[side] = crm
            runs[side] = {
                "fast": lambda crm=crm: crm.scan_association_fast(d["G"]),
                "fast_multigene": lambda crm=crm: (
                    crm.scan_association_fast_multigene(Y, d["G"],
                                                        gene_batch=16))}
        crm = crms["this"]
        null_lml = {
            "fast": [float(f.lml[k]) for f, k in
                     [crm._fit_null_association()]],
            "fast_multigene": [
                float(f.lml[k]) for f, k in (
                    crm.with_phenotype(Y[:, j])._fit_null_association()
                    for j in range(Y.shape[1]))]}
        for kind in ("fast", "fast_multigene"):
            ref = runs["this"][kind]()[0]
            got = runs["other"][kind]()[0]
            gap = cs._stat_gap(got, ref, null_lml[kind])
            assert gap <= tol, f"assoc {kind} ({tag}): statistic gap {gap}"
            times = {"this": [], "other": []}
            for side in ("other", "this", "this", "other"):
                for _ in range(reps):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    runs[side][kind]()
                    torch.cuda.synchronize()
                    times[side].append(time.perf_counter() - t0)
            key = f"{kind} {tag}"
            out[key] = {side: dict(median_s=float(np.median(t)),
                                   min_s=min(t), max_s=max(t), s=t)
                        for side, t in times.items()}
            out[key]["stat_gap_over_null_lml"] = gap
            print(json.dumps({"assoc": key, **out[key]}), flush=True)
        del crms, runs
    return out


def e2e_ab(d, Ls, other, reps, rows):
    """The scans ``rows`` (of the module doc's ``e2e32`` and ``e2e_tails``
    entries), ``reps`` rounds of one timed run a side, the side that runs
    first alternating from round to round (other first in the even
    rounds); then each side's device milliseconds a scan, summed over its
    kernels (``cs.device_split``)."""
    G = d["G"]
    rng = np.random.default_rng(cs.SCREEN_MULTIGENE["seed"])
    Y13 = d["y"][:, None] + 0.1 * rng.normal(
        size=(len(d["y"]), cs.SCREEN_MULTIGENE["genes"]))
    Y11 = cs._multigene_genes(d)
    def fresh(crm):
        # the null fit (K10) is cached on the scanner: drop it, so that
        # each scan fits it again, as a scanner's first scan does
        crm._null_assoc = None
        return crm

    runs = {}
    for side, pkg in (("this", crp), ("other", other)):
        crm = pkg.CellRegMap(y=d["y"], E=d["E"], W=d["W"], Ls=Ls,
                             device="cuda",
                             config=pkg.ScanConfig(snp_batch=cs.BATCH))
        crm32 = pkg.CellRegMap(y=Y11[:, 0], E=d["E"], W=d["W"], Ls=Ls,
                               device="cuda",
                               config=pkg.ScanConfig(snp_batch=cs.BATCH,
                                                     dtype="float32"))
        crm_auto = pkg.CellRegMap(
            y=d["y"], E=d["E"], W=d["W"], Ls=Ls, device="cuda",
            config=pkg.ScanConfig(snp_batch=cs.BATCH, pvalue_method="auto"))
        runs[side] = {
            "screen_2k": (lambda c=crm: c.scan_interaction_screen(
                G, significance=cs.SCREEN_SIGNIFICANCE)),
            "screen_multigene_16": (
                lambda c=crm: c.scan_interaction_multigene_screen(
                    Y13, G, gene_batch=cs.SCREEN_MULTIGENE["genes"],
                    significance=cs.SCREEN_SIGNIFICANCE)),
            "scan_association f32": (
                lambda c=crm32: fresh(c).scan_association(G)),
            "assoc_multigene_16 f32": (
                lambda c=crm32: c.scan_association_fast_multigene(
                    Y11, G, gene_batch=16)),
            "headline auto": lambda c=crm_auto: c.scan_interaction(G)}
    out = {}
    for kind in rows:
        got = {side: runs[side][kind]() for side in ("this", "other")}
        pv = {side: np.asarray(g[0]) for side, g in got.items()}
        assert all(np.isfinite(v).all() for v in pv.values()), kind
        if "screen" in kind:
            assert np.array_equal(got["this"][1]["confirmed"],
                                  got["other"][1]["confirmed"]), kind
        times = {"this": [], "other": []}
        for r in range(reps):
            for side in ("other", "this") if r % 2 == 0 else ("this",
                                                              "other"):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                runs[side][kind]()
                torch.cuda.synchronize()
                times[side].append(time.perf_counter() - t0)
        out[kind] = {side: dict(median_s=float(np.median(t)), min_s=min(t),
                                max_s=max(t), s=t,
                                device_ms=sum(cs.device_split(
                                    runs[side][kind], reps=1).values()))
                     for side, t in times.items()}
        print(json.dumps({"e2e": kind, **out[kind]}), flush=True)
    return out


def k9_calls(d):
    """K9's 9 calls of one headline effect-size batch."""
    n = len(d["y"])
    bctx = engine.build_betas_context(
        d["y"], d["W"], d["E"], crp.get_L_values(d["hK"], d["E"]),
        rho_grid=np.linspace(0, 1, 11), device="cuda")
    G = torch.as_tensor(d["G"][:, :cs.BATCH], device="cuda").contiguous()
    maf = d["maf"][:cs.BATCH]
    norm = torch.as_tensor(1.0 / np.sqrt(2 * maf * (1 - maf)), device="cuda")
    return cs.capture_kernel_inputs(
        lambda: engine.predict_interaction_batch(bctx, G, norm, n,
                                                 localize_f32=True),
        ["family_eval"])["family_eval"]


def check_k9(args, kw):
    """K9 against this checkout's plain version, as chip_smoke holds it."""
    if args[0].dtype == torch.float32:
        def check(label, got):
            g = k9.f32_gaps(got, args, kw)
            assert g["mask"] == 0 and g["excess"] <= 1e-5, f"K9 ({label}): {g}"
        return check
    want = k9.family_eval_plain(*args, **kw)
    want = want if kw.get("want_beta") else (want,)

    def check(label, got):
        got = got if kw.get("want_beta") else (got,)
        g = k9.lml_gaps(got[0], want[0])
        assert g["mask"] == 0 and g["rel"] <= 1e-10, f"K9 ({label}): {g}"
        for a, b in zip(got[1:], want[1:]):
            rel = float((a - b).abs().max() / b.abs().max())
            assert rel <= 1e-9, f"K9 beta/rss ({label}): rel {rel}"
    return check


def rotate_localize_calls(d, n, G, Ls):
    """(label, K4's (V, T, k_best), K3's localize (args, kw), K2's (args,
    kw)) of a headline interaction batch, of a ``multigene_16`` batch and
    of a ``cells10k`` batch (``chip_smoke.SECOND``: 10 000 cells, 20
    contexts, 125 donors, R = 2500; its first 512 variants)."""
    ctx = engine.build_null_context(d["y"], d["W"], d["E"], Ls=Ls,
                                    device="cuda")
    d10 = cs.make_dataset(**cs.SECOND)
    n10 = len(d10["y"])
    ctx10 = engine.build_null_context(
        d10["y"], d10["W"], d10["E"],
        Ls=crp.get_L_values(d10["hK"], d10["E"]), device="cuda")
    G10 = torch.as_tensor(d10["G"][:, :cs.BATCH], device="cuda").contiguous()
    rng = np.random.default_rng(cs.MULTIGENE["seed"])
    Y = d["y"][:, None] + 0.1 * rng.normal(size=(n, cs.MULTIGENE["genes"]))
    Yg = torch.as_tensor(np.ascontiguousarray(Y.T), device="cuda")
    ctx_g = ctx._replace(y=Yg, Zy=Yg @ ctx.Z, Wy=Yg @ ctx.W,
                         yy=(Yg * Yg).sum(dim=1))
    out = []
    for label, run in (
            ("headline", lambda: engine.interaction_batch(
                ctx, G, G, n, delta_cfg=cs.DELTA_CFG)),
            ("multigene_16", lambda: engine.interaction_multigene_batch(
                ctx_g, G, G, n, delta_cfg=cs.DELTA_CFG)),
            ("cells10k", lambda: engine.interaction_batch(
                ctx10, G10, G10, n10, delta_cfg=cs.DELTA_CFG))):
        calls = cs.capture_kernel_inputs(run, ["best_rho_rotate",
                                               "reml_localize",
                                               "delta_grid"])
        out.append((label, calls["best_rho_rotate"][0][0],
                    calls["reml_localize"][0], calls["delta_grid"][0]))
    return out


def score_converge_calls(d, n, G, Ls):
    """(label, K5's args or None, [K3's converge (args, kw)]) of the
    batches the module doc lists."""
    ctx = engine.build_null_context(d["y"], d["W"], d["E"], Ls=Ls,
                                    device="cuda")
    rng = np.random.default_rng(cs.MULTIGENE["seed"])
    Y = d["y"][:, None] + 0.1 * rng.normal(size=(n, cs.MULTIGENE["genes"]))
    ctx_g = cs._gene_ctx(ctx, Y)
    d10 = cs.make_dataset(**cs.SECOND)
    ctx10 = engine.build_null_context(
        d10["y"], d10["W"], d10["E"],
        Ls=crp.get_L_values(d10["hK"], d10["E"]), device="cuda")
    G10 = torch.as_tensor(d10["G"][:, :cs.BATCH], device="cuda").contiguous()
    rng = np.random.default_rng(cs.COVARIATES["seed"])
    W24 = np.concatenate([np.ones((n, 1)),
                          rng.normal(size=(n, cs.COVARIATES["p"] - 1))],
                         axis=1)
    rho21 = np.linspace(0.0, 1.0, cs.COVARIATES["n_rho"])
    ctx24 = engine.build_null_context(d["y"], W24, d["E"], Ls=Ls,
                                      rho_grid=rho21, device="cuda")
    ctx24a = engine.build_null_context(d["y"], W24, d["E"], hK=d["hK"],
                                       rho_grid=rho21, device="cuda")
    d80 = cs.make_dataset(**cs.RHO80)
    ctx80 = engine.build_null_context(
        d80["y"], d80["W"], d80["E"],
        Ls=crp.get_L_values(d80["hK"], d80["E"]),
        rho_grid=np.linspace(0.0, 1.0, cs.N_RHO80), device="cuda")
    G80 = torch.as_tensor(d80["G"][:, :cs.BATCH], device="cuda").contiguous()
    ctx_ag = cs._gene_ctx(ctx, cs._multigene_genes(d))
    k_ag = engine.null_association_multigene_fit(
        ctx_ag, n, delta_cfg=cs.ASSOC_DELTA_CFG)[1].cpu().numpy()

    def refit(c):
        k_rho = int(engine.null_association_fit(
            c, n, delta_cfg=cs.ASSOC_DELTA_CFG)[1])
        return lambda: engine.association_refit_batch(
            c, G, k_rho, n, delta_cfg=cs.ASSOC_DELTA_CFG)

    out = []
    for label, run in (
            ("headline", lambda: engine.interaction_batch(
                ctx, G, G, n, delta_cfg=cs.DELTA_CFG)),
            ("multigene_16", lambda: engine.interaction_multigene_batch(
                ctx_g, G, G, n, delta_cfg=cs.DELTA_CFG)),
            ("cells10k", lambda: engine.interaction_batch(
                ctx10, G10, G10, len(d10["y"]), delta_cfg=cs.DELTA_CFG)),
            ("covariates_24", lambda: engine.interaction_batch(
                ctx24, G, G, n, delta_cfg=cs.DELTA_CFG)),
            ("rho80", lambda: engine.interaction_batch(
                ctx80, G80, G80, len(d80["y"]), delta_cfg=cs.DELTA_CFG)),
            ("K7", refit(ctx)),
            ("K7-MG", lambda: engine.association_refit_multigene_batch(
                ctx_ag, G, k_ag, n, delta_cfg=cs.ASSOC_DELTA_CFG)),
            ("wide K7", refit(ctx24a))):
        calls = cs.capture_kernel_inputs(run, ["score_core",
                                               "reml_converge"])
        sc = calls["score_core"][0][0] if calls["score_core"] else None
        out.append((label, sc, calls["reml_converge"]))
    return out


def k8_calls(d, n, G, Ls):
    """(label, K8's (args, kw)) on the headline's Ls scanner, built in f64
    and in f32: a 512-variant fast-scan batch at the null's best rho and
    delta, and the same batch through the ``assoc_multigene_16`` tile
    (each gene at its own); then the wide instantiation at
    ``covariates_24`` (its hK scanner: p = 24, 21 rho, R = 110)."""
    out = []
    for dt, tag in ((torch.float64, ""), (torch.float32, ", f32")):
        ctx = engine.build_null_context(d["y"], d["W"], d["E"], Ls=Ls,
                                        device="cuda", dtype=dt)
        Gd = G.to(dt)
        fits, k = engine.null_association_fit(ctx, n,
                                              delta_cfg=cs.ASSOC_DELTA_CFG)
        k = int(k)
        out.append((f"headline Ls{tag}", cs.capture_kernel_inputs(
            lambda: engine.fast_scan_batch(ctx, Gd, k, float(fits.delta[k]),
                                           n), ["fast_scan"])["fast_scan"][0]))
        ctx_g = cs._gene_ctx(ctx, cs._multigene_genes(d))
        fits, kg = engine.null_association_multigene_fit(
            ctx_g, n, delta_cfg=cs.ASSOC_DELTA_CFG)
        delta = fits.delta[torch.arange(kg.shape[0], device="cuda"),
                           kg].contiguous()
        kg = kg.cpu().numpy()
        out.append((f"genes{tag}", cs.capture_kernel_inputs(
            lambda: engine.fast_scan_multigene_batch(ctx_g, Gd, kg, delta, n),
            ["fast_scan"])["fast_scan"][0]))
    rng = np.random.default_rng(cs.COVARIATES["seed"])
    W24 = np.concatenate([np.ones((n, 1)),
                          rng.normal(size=(n, cs.COVARIATES["p"] - 1))],
                         axis=1)
    ctx24 = engine.build_null_context(
        d["y"], W24, d["E"], hK=d["hK"],
        rho_grid=np.linspace(0.0, 1.0, cs.COVARIATES["n_rho"]),
        device="cuda")
    fits, k = engine.null_association_fit(ctx24, n,
                                          delta_cfg=cs.ASSOC_DELTA_CFG)
    k = int(k)
    out.append(("covariates_24", cs.capture_kernel_inputs(
        lambda: engine.fast_scan_batch(ctx24, G, k, float(fits.delta[k]), n),
        ["fast_scan"])["fast_scan"][0]))
    return out


def f32_converge_calls(d, n, G, Ls):
    """(label, [K3's converge (args, kw)]) at the float32 context's three
    converge shapes, in f32 and, as the yardstick, in f64: stage 3 of one
    screen batch (the headline's context, cast to f32 on the card, and
    1024 variants), K7's refit batch on the Ls scanner built in that
    dtype (512 variants at the null's best rho: the Newton call, then the
    two zero-step fits at the grid's ends) and K7 with the gene axis
    (``assoc_refit_multigene_16``: 16 genes, each at its own null's best
    rho)."""
    out = []
    ctx64 = engine.build_null_context(d["y"], d["W"], d["E"], Ls=Ls,
                                      device="cuda")
    G2 = torch.as_tensor(d["G"][:, :2 * cs.BATCH], device="cuda").contiguous()
    for dt, tag in ((torch.float32, "f32"), (torch.float64, "f64")):
        c = engine.NullContext(*(t.to(dt) for t in ctx64))
        Gs = G2.to(dt)
        out.append((f"stage 3, S = 1024, {tag}", cs.capture_kernel_inputs(
            lambda: engine.interaction_batch(c, Gs, Gs, n,
                                             delta_cfg=cs.DELTA_CFG),
            ["reml_converge"])["reml_converge"]))
        ca = engine.build_null_context(d["y"], d["W"], d["E"], Ls=Ls,
                                       device="cuda", dtype=dt)
        Gd = G.to(dt)
        k = int(engine.null_association_fit(
            ca, n, delta_cfg=cs.ASSOC_DELTA_CFG)[1])
        out.append((f"K7, {tag}", cs.capture_kernel_inputs(
            lambda: engine.association_refit_batch(
                ca, Gd, k, n, delta_cfg=cs.ASSOC_DELTA_CFG),
            ["reml_converge"])["reml_converge"]))
        ctx_g = cs._gene_ctx(ca, cs._multigene_genes(d))
        kg = engine.null_association_multigene_fit(
            ctx_g, n, delta_cfg=cs.ASSOC_DELTA_CFG)[1].cpu().numpy()
        out.append((f"K7-MG, {tag}", cs.capture_kernel_inputs(
            lambda: engine.association_refit_multigene_batch(
                ctx_g, Gd, kg, n, delta_cfg=cs.ASSOC_DELTA_CFG),
            ["reml_converge"])["reml_converge"]))
    return out


def f32_calls(d, n, Ls):
    """The float32 context's K1 and K2 calls: K1's three (T, A^T A, A^T W)
    and K2's REML grid of one screen batch (the headline's f64 context
    cast to f32 on the card, 1024 variants, as ``chip_smoke`` holds them),
    K2 on that batch's 16-gene tile (``screen_multigene_16``'s genes: Y =
    y + 0.1 N(0, 1), rng 13) and K7-f32's ML grid (the float32 Ls
    scanner's context, 512 variants at the null's best rho).  Returns
    (K1's [(args, kw)], [(label, K2's (args, kw))])."""
    f32 = torch.float32
    ctx = engine.build_null_context(d["y"], d["W"], d["E"], Ls=Ls,
                                    device="cuda")
    ctx32 = engine.NullContext(*(t.to(f32) for t in ctx))
    G32 = torch.as_tensor(d["G"][:, :2 * cs.BATCH], device="cuda",
                          dtype=f32).contiguous()
    screen = cs.capture_kernel_inputs(
        lambda: engine.interaction_batch(ctx32, G32, G32, n,
                                         delta_cfg=cs.DELTA_CFG),
        ["kr_contract", "delta_grid"])
    rng = np.random.default_rng(cs.SCREEN_MULTIGENE["seed"])
    Y = d["y"][:, None] + 0.1 * rng.normal(
        size=(n, cs.SCREEN_MULTIGENE["genes"]))
    ctx_g = cs._gene_ctx(ctx32, Y)
    genes = cs.capture_kernel_inputs(
        lambda: engine.interaction_multigene_batch(ctx_g, G32, G32, n,
                                                   delta_cfg=cs.DELTA_CFG),
        ["delta_grid"])
    c32 = engine.build_null_context(d["y"], d["W"], d["E"], Ls=Ls,
                                    device="cuda", dtype=f32)
    k = int(engine.null_association_fit(c32, n,
                                        delta_cfg=cs.ASSOC_DELTA_CFG)[1])
    G_ml = G32[:, :cs.BATCH].contiguous()
    ml = cs.capture_kernel_inputs(
        lambda: engine.association_refit_batch(c32, G_ml, k, n,
                                               delta_cfg=cs.ASSOC_DELTA_CFG),
        ["delta_grid"])
    return screen["kr_contract"], [
        ("screen batch, S = 1024", screen["delta_grid"][0]),
        ("16 genes x 1024", genes["delta_grid"][0]),
        ("K7 ML, S = 512", ml["delta_grid"][0])]


def f32_localize_calls(d, n, Ls):
    """(label, the float32 localize's (args, kw)) of the ``k3loc32`` calls
    the module doc lists."""
    f32 = torch.float32
    rng = np.random.default_rng(cs.COVARIATES["seed"])
    W = np.concatenate([np.ones((n, 1)), rng.normal(size=(n, 6))], axis=1)
    G32 = torch.as_tensor(d["G"][:, :2 * cs.BATCH], device="cuda",
                          dtype=f32).contiguous()
    out = []
    for label, Wp, genes in (("screen batch, p = 1", d["W"], False),
                             ("screen batch, p = 7", W, False),
                             ("16 genes x 1024, p = 1", d["W"], True)):
        ctx = engine.build_null_context(d["y"], Wp, d["E"], Ls=Ls,
                                        device="cuda")
        ctx = engine.NullContext(*(t.to(f32) for t in ctx))
        if genes:
            rng = np.random.default_rng(cs.SCREEN_MULTIGENE["seed"])
            ctx = cs._gene_ctx(ctx, d["y"][:, None] + 0.1 * rng.normal(
                size=(n, cs.SCREEN_MULTIGENE["genes"])))
            run = (lambda c=ctx: engine.interaction_multigene_batch(
                c, G32, G32, n, delta_cfg=cs.DELTA_CFG))
        else:
            run = (lambda c=ctx: engine.interaction_batch(
                c, G32, G32, n, delta_cfg=cs.DELTA_CFG))
        out.append((label, cs.capture_kernel_inputs(
            run, ["reml_localize"])["reml_localize"][0]))
    return out


def f32_null_fit_calls(d, n, Ls):
    """(label, K10-f32's (args, kw)): the float32 Ls scanner's null fit and
    the ``assoc_multigene_16`` tile's."""
    c32 = engine.build_null_context(d["y"], d["W"], d["E"], Ls=Ls,
                                    device="cuda", dtype=torch.float32)
    ctx_g = cs._gene_ctx(c32, cs._multigene_genes(d))
    return [("Ls, p = 1, f32", cs.capture_kernel_inputs(
                lambda: engine.null_association_fit(
                    c32, n, delta_cfg=cs.ASSOC_DELTA_CFG),
                ["null_fit"])["null_fit"][0]),
            ("16 genes, f32", cs.capture_kernel_inputs(
                lambda: engine.null_association_multigene_fit(
                    ctx_g, n, delta_cfg=cs.ASSOC_DELTA_CFG),
                ["null_fit"])["null_fit"][0])]


def k4f32_k6b_calls(d, n, Ls):
    """([(label, K4-f32's args)], [(label, K6b's args)]): K4-f32 on one
    screen batch (the headline's context cast to f32 on the card, 1024
    variants) and on ``screen_multigene_16``'s 16-gene tile of it (Y = y +
    0.1 N(0, 1), rng 13); K6b on the headline's f64 auto batch (512
    pairs), the screen batch's 1024 and the tile's 16 x 1024, each batch
    run with its device tails."""
    f32 = torch.float32
    ctx = engine.build_null_context(d["y"], d["W"], d["E"], Ls=Ls,
                                    device="cuda")
    G = torch.as_tensor(d["G"][:, :cs.BATCH], device="cuda").contiguous()
    head = cs.capture_kernel_inputs(
        lambda: engine.interaction_batch(ctx, G, G, n,
                                         delta_cfg=cs.DELTA_CFG,
                                         device_pvalues=True),
        ["mixture_tails"])
    ctx32 = engine.NullContext(*(t.to(f32) for t in ctx))
    G32 = torch.as_tensor(d["G"][:, :2 * cs.BATCH], device="cuda",
                          dtype=f32).contiguous()
    names = ["best_rho_rotate", "mixture_tails"]
    one = cs.capture_kernel_inputs(
        lambda: engine.interaction_batch(ctx32, G32, G32, n,
                                         delta_cfg=cs.DELTA_CFG,
                                         device_pvalues=True), names)
    rng = np.random.default_rng(cs.SCREEN_MULTIGENE["seed"])
    Y = d["y"][:, None] + 0.1 * rng.normal(
        size=(n, cs.SCREEN_MULTIGENE["genes"]))
    ctx_g = cs._gene_ctx(ctx32, Y)
    genes = cs.capture_kernel_inputs(
        lambda: engine.interaction_multigene_batch(
            ctx_g, G32, G32, n, delta_cfg=cs.DELTA_CFG,
            device_pvalues=True), names)
    # the multigene screen's own first batch (its memory rule: 84
    # variants a 16-gene tile)
    crm = crp.CellRegMap(y=d["y"], E=d["E"], W=d["W"], Ls=Ls,
                         config=crp.ScanConfig(snp_batch=cs.BATCH),
                         device="cuda")
    path = cs.capture_kernel_inputs(
        lambda: crm.scan_interaction_multigene_screen(
            Y, d["G"], gene_batch=cs.SCREEN_MULTIGENE["genes"],
            significance=cs.SCREEN_SIGNIFICANCE), names)
    path = {k: v[0][0] for k, v in path.items()}
    S = path["best_rho_rotate"][1].shape[2]
    return ([("screen batch, S = 1024", one["best_rho_rotate"][0][0]),
             ("16 genes x 1024", genes["best_rho_rotate"][0][0]),
             (f"screen_multigene_16's batch, 16 genes x {S}",
              path["best_rho_rotate"])],
            [("headline auto batch, P = 512", head["mixture_tails"][0][0]),
             ("screen batch, P = 1024", one["mixture_tails"][0][0]),
             ("16 genes x 1024, P = 16384",
              genes["mixture_tails"][0][0]),
             (f"screen_multigene_16's batch, "
              f"P = {cs.SCREEN_MULTIGENE['genes'] * S}",
              path["mixture_tails"])])


def tails_check(want, Q, lam, label, gaps):
    """K6b's rule (``chip_smoke.check_tails``) on this checkout's tails;
    each side's gaps to the rule (``chip_smoke.tails_gaps``: the other
    checkout's held to it too) into ``gaps``."""
    def check(side, got):
        gaps[side] = cs.tails_gaps(got, want, Q, lam)
        if side == "this":
            cs.check_tails(got, want, Q, lam, f"K6b {label}")
    return check


def factors(got):
    """K4's factors per (gene, variant): this checkout's (At_slots, slot)
    gathered, an older checkout's At as it is."""
    return k4.gather(*got) if isinstance(got, tuple) else got


def converge_rows(label, conv, other_k3, out, sums):
    """K3's converge calls of one batch, this checkout's and the other's,
    each held to the plain version (rel 1e-9), timed and profiled; their
    CUDA-event medians summed by side into ``sums``."""
    for i, (args, kw) in enumerate(conv):
        want = k3.reml_converge_plain(*args, **kw)

        def check(side, got, want=want):
            for g, w, name in zip(got, want, ("delta", "lml", "scale",
                                              "beta")):
                assert cs._rel(g, w) <= 1e-9, f"converge {name} ({side})"

        row = compare(
            f"reml_converge ({label}, call {i}, steps {args[10]})",
            lambda a=args, k=kw: k3.reml_converge(*a, **k),
            lambda a=args, k=kw: other_k3.reml_converge(*a, **k),
            check, reps=10)
        out["calls"].append(row)
        for side, ms in row["ms"].items():
            key = f"reml_converge ({label}) {side}"
            sums[key] = [a + b for a, b in zip(
                sums.get(key, [0.0] * len(ms)), ms)]
        del want


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", required=True, type=Path)
    ap.add_argument("--out", type=Path)
    ap.add_argument("--kernels", default="k1,k3,k10,k9,k4,k3reg")
    ap.add_argument("--scan-reps", type=int, default=5)
    opt = ap.parse_args()
    picked = opt.kernels.split(",")
    assert set(picked) <= set(KERNELS), f"--kernels: some of {list(KERNELS)}"
    sources = tuple(sorted({KERNELS[k] for k in picked} - {None}))
    if {"scan", "assoc", "e2e32", "e2e_tails"} & set(picked):
        sources = _build.SOURCES

    other = load_other(opt.other.resolve())
    ok = {k: getattr(other.kernels, KERNELS[k]) for k in picked
          if KERNELS[k]}
    out = {"card": cs.card_line(), "other": str(opt.other), "calls": [],
           "ptxas": {}}
    # every source built (with -Xptxas -v) before anything runs; the
    # picked kernels' registers, stack and spills on each side
    for side, build in (("this", _build), ("other", other.kernels._build)):
        logs = build.build_all(sources, verbose=True)
        out["ptxas"][side] = {
            name: cs.ptxas_report(logs.get(f"{name}.ptxas", ""))
            for name in sorted({KERNELS[k] for k in picked} - {None})}
    print(json.dumps({"ptxas": out["ptxas"]}), flush=True)

    d = cs.make_dataset(**cs.HEADLINE)
    n = len(d["y"])
    Ls = crp.get_L_values(d["hK"], d["E"])
    G = torch.as_tensor(d["G"][:, :cs.BATCH], device="cuda").contiguous()
    if "k1" in picked:
        ctx = engine.build_null_context(d["y"], d["W"], d["E"], Ls=Ls,
                                        device="cuda")
        calls = cs.capture_kernel_inputs(
            lambda: engine.interaction_batch(ctx, G, G, n,
                                             delta_cfg=cs.DELTA_CFG),
            ["kr_contract"])["kr_contract"]
        for (args, _), name in zip(calls, cs.K1_CALLS):
            ref = k1.kr_contract_plain(*args)

            def check(label, got, ref=ref, name=name):
                rel = float((got - ref).abs().max() / ref.abs().max())
                assert rel <= 1e-12, f"K1 {name} ({label}): rel {rel}"

            out["calls"].append(compare(
                f"kr_contract ({name})", lambda a=args: k1.kr_contract(*a),
                lambda a=args: ok["k1"].kr_contract(*a), check, reps=20))
            del ref
        del ctx, calls

    if "k1f32" in picked or "k2f32" in picked:
        k1_calls, k2_calls = f32_calls(d, n, Ls)
        for (args, _), name in zip(k1_calls if "k1f32" in picked else [],
                                   cs.K1_CALLS):
            U = args[0]
            ref = k1.kr_contract_plain(*args)
            mags = k1.kr_contract_plain(*(a.double().abs() for a in args))

            def check(label, got, ref=ref, mags=mags, name=name,
                      nt=U.shape[0]):
                cs._f32_sums_check(got, ref, mags, nt,
                                   f"K1-f32 {name} ({label})")

            out["calls"].append(compare(
                f"kr_contract ({name}, f32)",
                lambda a=args: k1.kr_contract(*a),
                lambda a=args: ok["k1f32"].kr_contract(*a), check, reps=20))
            del ref, mags
        for label, (g_args, g_kw) in (k2_calls if "k2f32" in picked
                                      else []):
            lml = k2.delta_grid_plain(*g_args, **g_kw, return_lml=True)[2]
            # the brackets' logits: f32 (REML), f64 (ML)
            dt = (torch.float32 if g_kw.get("restricted", True)
                  else torch.float64)

            def check(side, got, lml=lml, a=g_args, label=label, dt=dt):
                for g in np.ndindex(*got[0].shape[:-2]):
                    gap = k2.bracket_shortfall(got[0][g], got[1][g],
                                               lml[g], a[5], a[6], dt)
                    assert gap <= 1e-5, f"K2-f32 {label} ({side}): {gap}"

            out["calls"].append(compare(
                f"delta_grid ({label}, f32)",
                lambda a=g_args, k=g_kw: k2.delta_grid(*a, **k),
                lambda a=g_args, k=g_kw: ok["k2f32"].delta_grid(*a, **k),
                check, reps=20))
            del lml
        del k1_calls, k2_calls
        torch.cuda.empty_cache()

    if "k3" in picked:
        rng = np.random.default_rng(cs.COVARIATES["seed"])
        W = np.concatenate([np.ones((n, 1)),
                            rng.normal(size=(n, cs.COVARIATES["p"] - 1))],
                           axis=1)
        rho = np.linspace(0.0, 1.0, cs.COVARIATES["n_rho"])
        for p in (cs.COVARIATES["p"], 8):
            ctx_w = engine.build_null_context(d["y"], W[:, :p], d["E"],
                                              Ls=Ls, rho_grid=rho,
                                              device="cuda")
            (args, kw), = cs.capture_kernel_inputs(
                lambda: engine.interaction_batch(ctx_w, G, G, n,
                                                 delta_cfg=cs.DELTA_CFG),
                ["reml_localize"])["reml_localize"]
            want = k3.reml_localize_plain(*args, **kw)

            def check(label, got, want=want, p=p):
                assert torch.equal(got[2], want[2]), \
                    f"K3 p={p} ({label}): k_best"
                assert cs._rel(got[0], want[0]) <= 1e-9, \
                    f"K3 p={p} ({label}): x"
                assert cs._rel(got[1], want[1]) <= 1e-10, \
                    f"K3 p={p} ({label}): lml"

            out["calls"].append(compare(
                f"reml_localize (p = {p})",
                lambda a=args, k=kw: k3.reml_localize(*a, **k),
                lambda a=args, k=kw: ok["k3"].reml_localize(*a, **k), check,
                reps=10))
            del want, ctx_w

    if "k4" in picked or "k3reg" in picked or "k2" in picked:
        for label, rot, (args, kw), grid in rotate_localize_calls(d, n, G,
                                                                  Ls):
            if "k2" in picked:
                g_args, g_kw = grid
                lml = k2.delta_grid_plain(*g_args, **g_kw,
                                          return_lml=True)[2]

                def check(side, got, lml=lml, a=g_args, label=label):
                    for g in np.ndindex(*got[0].shape[:-2]):
                        gap = k2.bracket_shortfall(got[0][g], got[1][g],
                                                   lml[g], a[5], a[6])
                        assert gap <= 1e-5, f"K2 {label} ({side}): {gap}"

                out["calls"].append(compare(
                    f"delta_grid ({label})",
                    lambda a=g_args, k=g_kw: k2.delta_grid(*a, **k),
                    lambda a=g_args, k=g_kw: ok["k2"].delta_grid(*a, **k),
                    check, reps=20))
                del lml
            if "k4" in picked:
                ref = factors(k4.best_rho_rotate_plain(*rot))

                def check(label, got, ref=ref):
                    rel = float((factors(got) - ref).abs().max()
                                / ref.abs().max())
                    assert rel <= 1e-12, f"K4 ({label}): rel {rel}"

                out["calls"].append(compare(
                    f"best_rho_rotate ({label})",
                    lambda a=rot: k4.best_rho_rotate(*a),
                    lambda a=rot: ok["k4"].best_rho_rotate(*a), check,
                    reps=10))
                del ref
            if "k3reg" in picked:
                want = k3.reml_localize_plain(*args, **kw)

                def check(label, got, want=want):
                    assert torch.equal(got[2], want[2]), f"K3 ({label}): k_best"
                    assert cs._rel(got[0], want[0]) <= 1e-9, f"K3 ({label}): x"
                    assert cs._rel(got[1], want[1]) <= 1e-10, \
                        f"K3 ({label}): lml"

                out["calls"].append(compare(
                    f"reml_localize (p = 1, {label})",
                    lambda a=args, k=kw: k3.reml_localize(*a, **k),
                    lambda a=args, k=kw: ok["k3reg"].reml_localize(*a, **k),
                    check, reps=10))
                del want

    if "k5" in picked or "k3conv" in picked:
        sums = {}
        for label, sc, conv in score_converge_calls(d, n, G, Ls):
            if "k5" in picked and sc is not None:
                Qr, Wr = k5.score_core_plain(*sc)

                def check(label, got, Qr=Qr, Wr=Wr):
                    for g, w in zip(got, (Qr, Wr)):
                        rel = float((g - w).abs().max() / w.abs().max())
                        assert rel <= 1e-10, f"K5 ({label}): rel {rel}"

                out["calls"].append(compare(
                    f"score_core ({label})",
                    lambda a=sc: k5.score_core(*a),
                    lambda a=sc: ok["k5"].score_core(*a), check, reps=10))
                del Qr, Wr
            if "k3conv" in picked:
                converge_rows(label, conv, ok["k3conv"], out, sums)
        if sums:
            out["reml_converge_sums_ms"] = sums
            print(json.dumps(sums), flush=True)

    if "k3conv32" in picked:
        sums = {}
        for label, conv in f32_converge_calls(d, n, G, Ls):
            converge_rows(label, conv, ok["k3conv32"], out, sums)
        out["reml_converge_f32_sums_ms"] = sums
        print(json.dumps(sums), flush=True)

    if "k3loc32" in picked:
        for label, (args, kw) in f32_localize_calls(d, n, Ls):
            want = k3.reml_localize_plain(*args, **kw)

            def check(side, got, want=want, label=label):
                x, lml, kb = got
                fin = torch.isfinite(want[1])
                assert torch.equal(torch.isfinite(lml), fin), \
                    f"K3-f32 {label} ({side}): inf"
                scale = want[1].abs().clamp(min=1.0)
                rel = float(((lml - want[1]).abs() / scale)[fin].max())
                assert rel <= 1e-6, f"K3-f32 {label} ({side}): lml {rel}"
                best = want[1].amax(dim=-1)
                at_k = want[1].gather(-1, kb[..., None])[..., 0]
                tie = float(((best - at_k) / best.abs().clamp(min=1.0))
                            .max())
                assert tie <= 1e-6, f"K3-f32 {label} ({side}): tie {tie}"

            out["calls"].append(compare(
                f"reml_localize ({label})",
                lambda a=args, k=kw: k3.reml_localize(*a, **k),
                lambda a=args, k=kw: ok["k3loc32"].reml_localize(*a, **k),
                check, reps=10))
            del want

    if "k10f32" in picked:
        for label, (args, kw) in f32_null_fit_calls(d, n, Ls):
            plain = k10.null_fit_plain(*args, **kw)

            def check(side, got, plain=plain, a=args, label=label):
                cs.null_fits_agree(got, plain, a[0], a[1], a[2],
                                   f"K10-f32 {label} ({side})")

            out["calls"].append(compare(
                f"null_fit ({label})",
                lambda a=args, k=kw: k10.null_fit(*a, **k),
                lambda a=args, k=kw: ok["k10f32"].null_fit(*a, **k),
                check, reps=10))
            del plain

    if "k4f32" in picked or "k6b" in picked:
        rot, tails = k4f32_k6b_calls(d, n, Ls)
        for label, (V, T, kb) in rot if "k4f32" in picked else []:
            ref = factors(k4.best_rho_rotate_plain(V, T, kb))
            mags = factors(k4.best_rho_rotate_plain(V.double().abs(),
                                                    T.double().abs(), kb))

            def check(side, got, ref=ref, mags=mags, R=V.shape[1],
                      label=label):
                cs._f32_sums_check(factors(got), ref, mags, R,
                                   f"K4-f32 {label} ({side})")

            out["calls"].append(compare(
                f"best_rho_rotate ({label}, f32)",
                lambda a=(V, T, kb): k4.best_rho_rotate(*a),
                lambda a=(V, T, kb): ok["k4f32"].best_rho_rotate(*a),
                check, reps=20))
            del ref, mags
            torch.cuda.empty_cache()
        for label, (Q, lam) in tails if "k6b" in picked else []:
            gaps = {}
            out["calls"].append(compare(
                f"mixture_tails ({label})",
                lambda a=(Q, lam): k6b.mixture_tails(*a),
                lambda a=(Q, lam): ok["k6b"].mixture_tails(*a),
                tails_check(k6b.mixture_tails_plain(Q, lam), Q, lam, label,
                            gaps),
                reps=20))
            out["calls"][-1]["gaps"] = gaps
            print(json.dumps({"gaps": label, **gaps}), flush=True)
        del rot, tails

    if "k10" in picked or "k10mg" in picked:
        for label, (args, kw) in k10_calls(d, n, Ls, picked):
            data, n_c, restricted = args[:3]
            plain = k10.null_fit_plain(*args, **kw)

            def check(side, got, plain=plain, data=data, n_c=n_c,
                      restricted=restricted, label=label):
                gaps = k10.fit_gaps(got, plain, data, n_c, restricted)
                assert max(gaps.values()) <= 1e-10, \
                    f"K10 {label} ({side}): {gaps}"

            key = "k10mg" if label == "genes" else "k10"
            out["calls"].append(compare(
                f"null_fit ({label})",
                lambda a=args, k=kw: k10.null_fit(*a, **k),
                lambda a=args, k=kw, key=key: ok[key].null_fit(*a, **k),
                check, reps=5))
            del args, kw, data, plain

    if "k8" in picked:
        from cellregmap_tpu_torch.kernels import fast_scan as k8

        for label, (args, kw) in k8_calls(d, n, G, Ls):
            plain = (k8.fast_scan_genes_plain(*args, **kw) if "slot" in kw
                     else k8.fast_scan_plain(*args, **kw))

            tols = cs.FAST_SCAN_TOLERANCE[str(args[1].dtype)]

            def check(side, got, plain=plain, label=label, tols=tols):
                for g, w, name in zip(got, plain, plain._fields):
                    rel = float((g - w).abs().max() / w.abs().max())
                    assert rel <= tols[name], \
                        f"K8 {label} {name} ({side}): rel {rel}"

            out["calls"].append(compare(
                f"fast_scan ({label})",
                lambda a=args, k=kw: k8.fast_scan(*a, **k),
                lambda a=args, k=kw: ok["k8"].fast_scan(*a, **k), check,
                reps=20))
            del args, kw, plain

    if "k6a" in picked:
        for label, A in k6a_calls(d, n, G, Ls):
            want = k6a.sym_eigvalsh_plain(A)
            scale = want.abs().amax(dim=1, keepdim=True).clamp(min=1e-300)

            def check(side, got, want=want, scale=scale, label=label):
                rel = float(((got - want).abs() / scale).max())
                assert rel <= 1e-12, f"K6a {label} ({side}): rel {rel}"
                assert bool((got[:, 1:] >= got[:, :-1]).all()), \
                    f"K6a {label} ({side}): order"

            out["calls"].append(compare(
                f"sym_eigvalsh ({label})",
                lambda A=A: k6a.sym_eigvalsh(A),
                lambda A=A: ok["k6a"].sym_eigvalsh(A), check, reps=20))
            del A, want

    if "scan" in picked:
        out["scans"] = scan_ab(d, Ls, other, opt.scan_reps)
    if "assoc" in picked:
        out["assoc"] = assoc_ab(d, Ls, other, opt.scan_reps)
    for key in E2E_ROWS:
        if key in picked:
            out[key] = e2e_ab(d, Ls, other, opt.scan_reps, E2E_ROWS[key])

    if "k9" in picked:
        rows = []
        for i, (args, kw) in enumerate(k9_calls(d)):
            kind = ("f32" if args[0].dtype == torch.float32
                    else "f64 beta" if kw.get("want_beta") else "f64")
            rows.append(compare(
                f"woodbury_family (call {i}: {kind}, "
                f"L = {args[0].shape[1]})",
                lambda a=args, k=kw: k9.family_eval(*a, **k),
                lambda a=args, k=kw: ok["k9"].family_eval(*a, **k),
                check_k9(args, kw), reps=10))
            rows[-1]["kind"] = kind
        out["calls"] += rows
        sums = {}
        for r in rows:
            for side, ms in r["ms"].items():
                key = (r["kind"].split()[0], side)
                sums.setdefault(key, [0.0] * len(ms))
                sums[key] = [a + b for a, b in zip(sums[key], ms)]
        out["woodbury_family_sums_ms"] = {
            f"{kind} {side}": ms for (kind, side), ms in sums.items()}
        print(json.dumps(out["woodbury_family_sums_ms"]), flush=True)
    line = json.dumps(out)
    print(line, flush=True)
    if opt.out:
        opt.out.parent.mkdir(parents=True, exist_ok=True)
        opt.out.write_text(line + "\n")


if __name__ == "__main__":
    main()
