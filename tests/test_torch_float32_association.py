"""The float32 context on the association scans and the effect sizes, on
the CPU: the port's ``ScanConfig(dtype="float32")`` against the JAX
package's, in float32 and in float64, on the same seeded inputs.

Two datasets (n = 240 cells, 3 contexts, 24 donors, 12 variants, 2 genes
for the gene-batched scans): p = 1 (an intercept) with the K (.) EE^T
background, and p = 4 columns of W with the plain-K background.  For
``scan_association``, ``scan_association_fast``, their gene-batched forms
and ``predict_interaction`` (through ``estimate_betas``):

1. the port's float32 result against the JAX package's float32 result:
   p-values within 5e-3 decades (max |log10 pv - log10 pv_jax32|) and the
   same rho1; effect sizes within 1e-2 of the largest |beta| (absolute,
   beta_G and beta_GxC each).  Two f32 programs: the null fits' golden
   sections stop at points of an lml flat to f32 resolution that differ
   between the packages, which moves every variant's alternative lml by
   ~1e-4 (measured up to 9e-4 decades on these data);
2. the port's float32 error against the JAX package's float64 result is
   no worse than twice the JAX package's own float32 error, plus 5e-4
   decades (p-values) or 1e-4 absolute (betas): the port is as accurate
   as the reference in float32.

The ``run_*`` wrappers equal their scanner methods exactly, and a
checkpointed float32 scan stopped after one batch resumes equal to the
clean scan (rtol 1e-12).
"""
import jax  # noqa: F401  (the JAX package, on the CPU)
import numpy as np
import pytest
from numpy.testing import assert_allclose

import cellregmap_tpu as crt
import cellregmap_tpu_torch as crp
from cellregmap_tpu_torch import engine

N, C, DONORS, S = 240, 3, 24, 12
PV_TOL = 5e-3        # decades, port f32 against JAX f32
PV_ATOL = 5e-4       # decades, on top of twice the JAX f32 error
BETA_TOL = 1e-2      # of the largest |beta|, port f32 against JAX f32
BETA_ATOL = 1e-4     # absolute, on top of twice the JAX f32 error
SCANS = ("association", "association_fast", "association_multigene",
         "association_fast_multigene")


def _dataset(seed, p):
    rng = np.random.default_rng(seed)
    E = rng.normal(size=(N, C)) / np.sqrt(C)
    W = np.concatenate([np.ones((N, 1)), rng.normal(size=(N, p - 1))], 1)
    donor = np.arange(N) % DONORS
    hK = np.zeros((N, DONORS))
    hK[np.arange(N), donor] = 1.0
    G = rng.binomial(2, rng.uniform(0.15, 0.45, size=S)[None],
                     size=(DONORS, S))[donor].astype(float)
    y = (rng.normal(size=N) + 0.5 * E @ rng.normal(size=C)
         + 0.4 * hK @ rng.normal(size=DONORS) + 0.3 * G[:, 2]
         + 0.5 * G[:, 5] * E[:, 0] + W[:, 1:] @ rng.normal(size=p - 1))
    Y = np.stack([y, y + 0.5 * rng.normal(size=N)], axis=1)
    return dict(y=y, Y=Y, W=W, E=E, hK=hK, G=G)


CASES = {"p1_Ls": (3, 1, "Ls"), "p4_hK": (5, 4, "hK")}


def _run(pkg, d, mode, dtype):
    """Every path of the slice on one package at one dtype."""
    kw = {"device": "cpu"} if pkg is crp else {}
    bg = ({"Ls": crp.get_L_values(d["hK"], d["E"])} if mode == "Ls"
          else {"hK": d["hK"]})
    crm = pkg.CellRegMap(y=d["y"], E=d["E"], W=d["W"],
                         config=pkg.ScanConfig(dtype=dtype), **bg, **kw)
    out = {}
    for name in SCANS:
        scan = getattr(crm, f"scan_{name}")
        args = (d["Y"], d["G"]) if "multigene" in name else (d["G"],)
        out[name] = scan(*args)
    maf = np.clip(d["G"].mean(0) / 2, 0.05, 0.95)
    bkw = {"hK": d["hK"]}
    out["betas"] = pkg.estimate_betas(d["y"], d["W"], d["E"], d["G"],
                                      maf=maf, config=pkg.ScanConfig(
                                          dtype=dtype), **bkw, **kw)
    return out


@pytest.fixture(scope="module", params=sorted(CASES))
def runs(request):
    seed, p, mode = CASES[request.param]
    d = _dataset(seed, p)
    return d, mode, {name: _run(pkg, d, mode, dt) for name, pkg, dt in (
        ("jax32", crt, "float32"), ("jax64", crt, "float64"),
        ("port32", crp, "float32"))}


def _decades(a, b):
    return float(np.max(np.abs(np.log10(a) - np.log10(b))))


@pytest.mark.parametrize("scan", SCANS)
def test_association_float32_matches_jax(runs, scan):
    """Rules 1 and 2 of the module doc, phenotype by phenotype.  Where the
    JAX package's float32 null fit takes a NaN rho (its p-values are all
    NaN: ROADMAP queue 3, "In the reference", item k) the port is held to
    the JAX float64 result at rule 1's tolerance instead."""
    _, _, r = runs
    pv, info = r["port32"][scan]
    pv32, info32 = r["jax32"][scan]
    pv64, info64 = r["jax64"][scan]
    assert pv.shape == pv32.shape and np.isfinite(pv).all()
    pv, pv32, pv64 = (np.atleast_2d(a) for a in (pv, pv32, pv64))
    faulty = ~np.isfinite(pv32).all(axis=1)        # per phenotype
    ref_pv = np.where(faulty[:, None], pv64, pv32)
    ref_rho = np.where(faulty, info64["rho1"], info32["rho1"])
    # the same grid point (the f32 and f64 grids differ by rounding)
    assert_allclose(info["rho1"], ref_rho, rtol=1e-6)
    assert _decades(pv, ref_pv) <= PV_TOL
    ok = ~faulty
    if ok.any():
        assert _decades(pv[ok], pv64[ok]) <= \
            2 * _decades(pv32[ok], pv64[ok]) + PV_ATOL


def test_reference_float32_null_fit_takes_a_nan_rho():
    """The p = 4 dataset's intercept lies in the span of the donors'
    one-hot background, so its complement Gram is cancellation noise in
    f32, and at small delta the f32 normal matrix is indefinite: the
    factorization fails (a NaN lml) at some grid points of some rho.  The
    JAX package's argmax takes the NaN grid point, that rho's fit is NaN,
    and its argmax over rho takes that rho.  The port's float32 null fit
    skips the failed points: finite at every rho, and the JAX float64 fit's
    best rho, lml within 1e-6 of it (relative)."""
    d = _dataset(*CASES["p4_hK"][:2])
    fits = {}
    for name, pkg, dt in (("jax32", crt, "float32"), ("jax64", crt, "float64"),
                          ("port32", crp, "float32")):
        kw = {"device": "cpu"} if pkg is crp else {}
        crm = pkg.CellRegMap(y=d["y"], E=d["E"], W=d["W"], hK=d["hK"],
                             config=pkg.ScanConfig(dtype=dt), **kw)
        fits[name] = crm._fit_null_association()
    (f32j, k32), (f64j, k64), (f32p, kp) = (fits[k] for k in (
        "jax32", "jax64", "port32"))
    lml32 = np.asarray(f32j.lml, float)
    assert np.isnan(lml32).any() and np.isnan(lml32[k32])
    assert np.isfinite(np.asarray(f32p.lml)).all() and kp == k64
    assert_allclose(np.asarray(f32p.lml, float), np.asarray(f64j.lml),
                    rtol=1e-6)


def test_betas_float32_matches_jax(runs):
    _, _, r = runs
    for i in range(2):   # beta_G, beta_GxC
        got, b32, b64 = (r[k]["betas"][i] for k in ("port32", "jax32",
                                                    "jax64"))
        assert got.shape == b64.shape and np.isfinite(got).all()
        assert np.max(np.abs(got - b32)) <= BETA_TOL * np.max(np.abs(b64))
        assert np.max(np.abs(got - b64)) <= \
            2 * np.max(np.abs(b32 - b64)) + BETA_ATOL


def test_run_wrappers_float32(runs):
    """The run_* wrappers on the float32 config equal the scanner methods
    (the same computation): the gene-batched ones on either background,
    the single-gene ones (which take the plain-K background alone) on the
    hK dataset."""
    d, mode, r = runs
    cfg = crp.ScanConfig(dtype="float32")
    bg = ({"Ls": crp.get_L_values(d["hK"], d["E"])} if mode == "Ls"
          else {"hK": d["hK"]})
    got = {
        "association_multigene": crp.run_association_multigene(
            d["Y"], d["E"], d["G"], W=d["W"], config=cfg, device="cpu",
            **bg),
        "association_fast_multigene": crp.run_association_fast_multigene(
            d["Y"], d["E"], d["G"], W=d["W"], config=cfg, device="cpu",
            **bg),
    }
    if mode == "hK":
        got["association"] = crp.run_association(
            d["y"], d["W"], d["E"], d["G"], hK=d["hK"], config=cfg,
            device="cpu")
        got["association_fast"] = crp.run_association_fast(
            d["y"], d["W"], d["E"], d["G"], hK=d["hK"], config=cfg,
            device="cpu")
    for name, (pv, _) in got.items():
        assert np.array_equal(pv, r["port32"][name][0]), name


class Boom(RuntimeError):
    pass


def test_float32_checkpoint_resumes(runs, tmp_path, monkeypatch):
    """A float32 association scan (3 batches of 4) stopped after its first
    batch resumes from the checkpoint equal to the clean scan."""
    d, mode, _ = runs
    bg = ({"Ls": crp.get_L_values(d["hK"], d["E"])} if mode == "Ls"
          else {"hK": d["hK"]})
    crm = crp.CellRegMap(y=d["y"], E=d["E"], W=d["W"], device="cpu",
                         config=crp.ScanConfig(dtype="float32", snp_batch=4),
                         **bg)
    clean, _ = crm.scan_association(d["G"])
    real, calls = engine.association_refit_batch, []

    def crash_after_one(*a, **kw):
        calls.append(1)
        if len(calls) > 1:
            raise Boom()
        return real(*a, **kw)

    ck = tmp_path / "ck"
    monkeypatch.setattr(engine, "association_refit_batch", crash_after_one)
    with pytest.raises(Boom):
        crm.scan_association(d["G"], checkpoint=ck)
    monkeypatch.setattr(engine, "association_refit_batch", real)
    resumed, _ = crm.scan_association(d["G"], checkpoint=ck)
    assert_allclose(resumed, clean, rtol=1e-12)
