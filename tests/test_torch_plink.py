"""The port's PLINK layer (``cellregmap_tpu_torch.utils.plink``,
``cellregmap_tpu_torch.plink_scan``) against the JAX package's, on the CPU.

It mirrors tests/test_plink.py's 14 tests on filesets that the tests write
themselves, with the JAX package's shapes (50 donors, 150 cells, C = 3)
and 2600 variants read in blocks of 1024 (two full blocks and a partial
one), missing calls and a monomorphic variant.  Each driver runs in both
packages on the same fileset and donor map: ``variant_index`` and ``maf``
identical, interaction p-values within 1e-8 with identical ``rho1``,
association within 1e-9, fast association rtol 1e-5 (atol 1e-12), effect
sizes within 1e-6, the screens' discovery sets identical.  The
interaction cases run ``pvalue_method="liu"`` as the JAX tests do, but
the item-f case (davies).  Three cases more: the variance filter on the
cell-level column (ROADMAP queue 3, reference item f), the checkpoint's
fingerprint (item l) and the CLI without a card.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import cellregmap_tpu as jcrt
import cellregmap_tpu_torch as crp
from _torch_inputs import jax_davies_library  # noqa: F401  (autouse)
from cellregmap_tpu import api as japi
from cellregmap_tpu import engine as jengine
from cellregmap_tpu import plink_scan as jps
from cellregmap_tpu.utils import plink as jplink
from cellregmap_tpu_torch import api as tapi
from cellregmap_tpu_torch import engine as tengine
from cellregmap_tpu_torch import plink_scan as tps
from cellregmap_tpu_torch.parallel.checkpoint import ScanCheckpoint
from cellregmap_tpu_torch.utils import plink

ROOT = Path(__file__).resolve().parent.parent
BLOCK = 1024


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU scans in one torch thread: their plain kernels run
    thousands of small ops, each an OpenMP region that, on a machine
    whose cores other test workers hold, waits for all its threads
    (a 4 s test took 150-310 s under six workers; 11 s in one thread)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def fileset(tmp_path):
    rng = np.random.default_rng(0)
    n, m = 37, 23  # deliberately not multiples of 4
    G = rng.choice([0.0, 1.0, 2.0], size=(n, m), p=[0.5, 0.3, 0.2])
    G[3, 5] = np.nan
    G[36, 22] = np.nan
    prefix = str(tmp_path / "toy")
    plink.write_bed(prefix, G)
    return prefix, G


def test_roundtrip_full(fileset, tmp_path):
    prefix, G = fileset
    rd = plink.PlinkReader(prefix)
    assert rd.n_samples == G.shape[0]
    assert rd.n_variants == G.shape[1]
    assert plink._get_bed_lib() is not None, "bedreader.cc did not build"
    got = rd.read()
    assert np.array_equal(got, G, equal_nan=True)
    # the plain NumPy decoder agrees with the native one, NaNs included
    py = plink._decode_python(prefix + ".bed", G.shape[0], 0, G.shape[1])
    assert np.array_equal(py, got, equal_nan=True)
    # the JAX package's writer makes the same bytes
    jplink.write_bed(str(tmp_path / "jax"), G)
    for ext in (".bed", ".bim", ".fam"):
        assert (Path(prefix + ext).read_bytes()
                == (tmp_path / ("jax" + ext)).read_bytes()), ext


def test_range_and_blocks(fileset):
    prefix, G = fileset
    rd = plink.PlinkReader(prefix)
    assert np.array_equal(rd.read(5, 11), G[:, 5:11], equal_nan=True)
    assert np.array_equal(
        plink._decode_python(prefix + ".bed", G.shape[0], 5, 11),
        G[:, 5:11], equal_nan=True)
    blocks = list(rd.iter_blocks(7))
    full = np.concatenate([b for b, _ in blocks], axis=1)
    assert np.array_equal(full, G, equal_nan=True)
    assert blocks[0][1] == slice(0, 7)
    with pytest.raises(ValueError, match="outside"):
        rd.read(20, 24)


def test_metadata(fileset):
    prefix, G = fileset
    rd = plink.PlinkReader(prefix)
    assert rd.variants[0].snp_id == "snp0"
    assert rd.samples[0][1] == "iid0"
    fp = rd.fingerprint()
    plink.write_bed(prefix, G, snp_ids=[f"rs{v}" for v in range(G.shape[1])])
    assert plink.PlinkReader(prefix).fingerprint() != fp


# ---------------------------------------------------------------------------
# The streaming drivers against the JAX package's
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    """Donor-level fileset (2600 variants) + cell-level model data."""
    rng = np.random.default_rng(11)
    n_donors, n_cells, C, m = 50, 150, 3, 2600
    maf = rng.uniform(0.05, 0.5, size=m)
    Gd = rng.binomial(2, maf[None, :].repeat(n_donors, 0)).astype(float)
    Gd[0, :8] = np.nan                      # some missing calls
    Gd[:, 17] = 0.0                         # a monomorphic variant
    prefix = str(tmp_path_factory.mktemp("plink") / "cohort")
    donor_ids = [f"donor{i}" for i in range(n_donors)]
    plink.write_bed(prefix, Gd, sample_ids=donor_ids)
    d2c = np.repeat(np.arange(n_donors), 3)
    E = rng.normal(size=(n_cells, C))
    hK = np.zeros((n_cells, n_donors))
    hK[np.arange(n_cells), d2c] = 1.0
    y = (rng.normal(size=n_cells) + 0.4 * E @ rng.normal(size=C)
         + 0.3 * hK @ rng.normal(size=n_donors))
    return dict(prefix=prefix, Gd=Gd, d2c=d2c, E=E, hK=hK, y=y,
                donor_ids=donor_ids, n_cells=n_cells,
                dids=np.asarray(donor_ids)[d2c])


def _crms(c, method="liu", **cfg):
    """(the port's scanner on the CPU, the JAX package's) on the cohort."""
    kw = dict(cfg, pvalue_method=method, snp_batch=256)
    port = crp.CellRegMap(y=c["y"], E=c["E"],
                          Ls=crp.get_L_values(c["hK"], c["E"]),
                          config=crp.ScanConfig(**kw), device="cpu")
    ref = jcrt.CellRegMap(y=c["y"], E=c["E"],
                          Ls=jcrt.get_L_values(c["hK"], c["E"]),
                          config=jcrt.ScanConfig(**kw))
    return port, ref


def _expected_filter(cohort, maf_min=0.01):
    Gd = cohort["Gd"]
    frq = np.nansum(Gd, axis=0) / (2 * np.sum(~np.isnan(Gd), axis=0))
    maf = np.minimum(frq, 1 - frq)
    mu = np.nanmean(Gd, axis=0)
    Gdi = np.where(np.isnan(Gd), mu[None, :], Gd)
    keep = (maf >= maf_min) & (Gdi.std(0) > 0) & np.isfinite(maf)
    return Gdi, keep


def _head(cohort, vidx, standardize=True, n=64):
    Gdi, _ = _expected_filter(cohort)
    head = vidx[vidx < n]
    Gc = Gdi[cohort["d2c"]][:, head]
    return (Gc - Gc.mean(0)) / Gc.std(0) if standardize else Gc


def _same_interaction(got, want, keys=("rho1", "maf")):
    (pv, info, vidx), (jpv, jinfo, jvidx) = got, want
    assert np.array_equal(vidx, jvidx)
    for k in keys:
        assert np.array_equal(info[k], jinfo[k]), k
    assert_allclose(pv, jpv, atol=1e-8)


def test_streaming_scan_matches_jax(cohort):
    crm, jcrm = _crms(cohort)
    kw = dict(donor_ids=cohort["dids"], block_size=BLOCK, maf_min=0.01)
    got = tps.scan_interaction_plink(crm, cohort["prefix"], **kw)
    _same_interaction(got, jps.scan_interaction_plink(
        jcrm, cohort["prefix"], **kw))
    pv, info, vidx = got
    _, keep = _expected_filter(cohort)
    assert 17 not in vidx
    assert np.array_equal(vidx, np.flatnonzero(keep))
    assert pv.shape == vidx.shape == info["Q"].shape
    # the direct in-memory scan of the first block's head agrees exactly
    pv_direct, _ = crm.scan_interaction(_head(cohort, vidx))
    assert_allclose(pv[: pv_direct.size], pv_direct, atol=1e-12)


def _genes(cohort, seed, n_genes):
    rng = np.random.default_rng(seed)
    return cohort["y"][:, None] + 0.3 * rng.normal(
        size=(cohort["n_cells"], n_genes))


def test_multigene_cis_scan_matches_jax(cohort):
    crm, jcrm = _crms(cohort)
    Y = _genes(cohort, 23, 5)
    starts = np.array([0, 10, 20, 30, 40])
    windows = np.stack([starts, starts + 24], axis=1)
    kw = dict(donor_ids=cohort["dids"], gene_batch=2, maf_min=0.01)
    res = tps.scan_interaction_multigene_plink(crm, cohort["prefix"], Y,
                                               windows, **kw)
    jres = jps.scan_interaction_multigene_plink(jcrm, cohort["prefix"], Y,
                                                windows, **kw)
    assert set(res) == set(jres)
    for k in ("gene", "variant_index", "maf", "rho1"):
        assert np.array_equal(res[k], jres[k]), k
    assert_allclose(res["pvalues"], jres["pvalues"], atol=1e-8)
    assert not np.any(res["variant_index"] == 17)
    for g in range(len(starts)):
        vi = res["variant_index"][res["gene"] == g]
        assert np.all((vi >= windows[g, 0]) & (vi < windows[g, 1]))
    # a direct scan of one gene's window agrees
    g = 2
    Gdi, keep = _expected_filter(cohort)
    win = np.flatnonzero(keep[windows[g, 0]:windows[g, 1]]) + windows[g, 0]
    Gc = Gdi[cohort["d2c"]][:, win]
    pv_direct, _ = crm.with_phenotype(Y[:, g]).scan_interaction(
        (Gc - Gc.mean(0)) / Gc.std(0))
    sel = res["gene"] == g
    assert np.array_equal(res["variant_index"][sel], win)
    assert_allclose(res["pvalues"][sel], pv_direct, atol=1e-9)


class Boom(RuntimeError):
    pass


def test_multigene_cis_scan_crash_resume(cohort, tmp_path, monkeypatch):
    crm, _ = _crms(cohort)
    Y = _genes(cohort, 29, 4)
    windows = np.array([[0, 16], [8, 24], [16, 32], [24, 40]])
    kw = dict(donor_ids=cohort["dids"], gene_batch=2)
    full = tps.scan_interaction_multigene_plink(crm, cohort["prefix"], Y,
                                                windows, **kw)
    ck = str(tmp_path / "ckmg")
    calls = {"n": 0}
    real = crp.CellRegMap.scan_interaction_multigene

    def crashing(self, *a, **k):
        if calls["n"] >= 1:  # the first tile completes and is durable
            raise Boom()
        calls["n"] += 1
        return real(self, *a, **k)

    monkeypatch.setattr(crp.CellRegMap, "scan_interaction_multigene",
                        crashing)
    with pytest.raises(Boom):
        tps.scan_interaction_multigene_plink(crm, cohort["prefix"], Y,
                                             windows, checkpoint=ck, **kw)
    monkeypatch.undo()
    state = ScanCheckpoint(ck).load()
    assert state is not None and state["cursor"] == 1
    resumed = tps.scan_interaction_multigene_plink(
        crm, cohort["prefix"], Y, windows, checkpoint=ck, **kw)
    assert set(resumed) == set(full)
    for k in full:
        assert_allclose(resumed[k], full[k], rtol=1e-12)
    assert ScanCheckpoint(ck).load() is None


def test_streaming_scan_crash_resume(cohort, tmp_path, monkeypatch):
    crm, _ = _crms(cohort)
    ck = str(tmp_path / "ck")
    calls = []
    real = crm.scan_interaction

    def wrapped(G, **kw):
        calls.append(G.shape[1])
        if len(calls) == 2:
            raise RuntimeError("simulated crash")
        return real(G, **kw)

    kw = dict(donor_to_cell=cohort["d2c"], block_size=BLOCK)
    monkeypatch.setattr(crm, "scan_interaction", wrapped)
    with pytest.raises(RuntimeError, match="simulated"):
        tps.scan_interaction_plink(crm, cohort["prefix"], checkpoint=ck,
                                   **kw)
    assert ScanCheckpoint(ck).load()["cursor"] == 1
    resumed = tps.scan_interaction_plink(crm, cohort["prefix"],
                                         checkpoint=ck, **kw)
    # block 2 crashed before its checkpoint: the rerun scans blocks 2 and 3
    assert len(calls) == 4
    monkeypatch.undo()
    pv_full, info_full, vidx_full = tps.scan_interaction_plink(
        crm, cohort["prefix"], **kw)
    assert_allclose(resumed[0], pv_full, rtol=1e-12)
    assert np.array_equal(resumed[2], vidx_full)
    for k in info_full:
        assert_allclose(resumed[1][k], info_full[k], rtol=1e-12)
    assert ScanCheckpoint(ck).load() is None


def test_streaming_association_matches_jax(cohort):
    crm, jcrm = _crms(cohort)
    kw = dict(donor_ids=cohort["dids"], block_size=BLOCK, maf_min=0.01)
    pv, info, vidx = tps.scan_association_plink(crm, cohort["prefix"],
                                                fast=True, **kw)
    jpv, jinfo, jvidx = jps.scan_association_plink(jcrm, cohort["prefix"],
                                                   fast=True, **kw)
    _, keep = _expected_filter(cohort)
    assert np.array_equal(vidx, np.flatnonzero(keep))
    assert np.array_equal(vidx, jvidx)
    assert np.array_equal(info["maf"], jinfo["maf"])
    assert_allclose(pv, jpv, rtol=1e-5, atol=1e-12)
    # the null fit's, at tests/test_torch_association.py's budgets
    assert np.array_equal(info["rho1"], jinfo["rho1"])
    for k in ("e2", "g2", "eps2"):
        assert_allclose(info[k], jinfo[k], rtol=1e-6, err_msg=k)
    Gc = _head(cohort, vidx)
    assert_allclose(pv[: Gc.shape[1]], crm.scan_association_fast(Gc)[0],
                    atol=1e-12)

    # the per-variant refits, on the first block
    kw["block_size"] = 64
    pv_s, _, vidx_s = tps.scan_association_plink(
        crm, cohort["prefix"], fast=False, **kw)
    jpv_s, _, jvidx_s = jps.scan_association_plink(
        jcrm, cohort["prefix"], fast=False, **kw)
    assert np.array_equal(vidx_s, jvidx_s)
    assert_allclose(pv_s, jpv_s, atol=1e-9)
    assert_allclose(pv_s[: Gc.shape[1]], crm.scan_association(Gc)[0],
                    atol=1e-12)


def test_streaming_association_crash_resume(cohort, tmp_path, monkeypatch):
    crm, _ = _crms(cohort)
    ck = str(tmp_path / "cka")
    kw = dict(donor_to_cell=cohort["d2c"], block_size=BLOCK)
    full = tps.scan_association_plink(crm, cohort["prefix"], **kw)
    calls = []
    real = crm.scan_association_fast

    def wrapped(G, **k):
        calls.append(G.shape[1])
        if len(calls) == 3:
            raise RuntimeError("simulated crash")
        return real(G, **k)

    monkeypatch.setattr(crm, "scan_association_fast", wrapped)
    with pytest.raises(RuntimeError, match="simulated"):
        tps.scan_association_plink(crm, cohort["prefix"], checkpoint=ck,
                                   **kw)
    monkeypatch.undo()
    state = ScanCheckpoint(ck).load()
    assert state is not None and state["cursor"] == 2
    pv, info, vidx = tps.scan_association_plink(crm, cohort["prefix"],
                                                checkpoint=ck, **kw)
    assert_allclose(pv, full[0], rtol=1e-12)
    assert np.array_equal(vidx, full[2])
    assert np.array_equal(info["maf"], full[1]["maf"])
    assert ScanCheckpoint(ck).load() is None


def test_streaming_betas_matches_jax(cohort, tmp_path, monkeypatch):
    """Full float64 fits on both sides (``hybrid_localization=False``):
    under the hybrid default a near tie may pick another rho in either
    package (the next test holds that case by its own rule)."""
    crm, jcrm = _crms(cohort, hybrid_localization=False)
    kw = dict(donor_ids=cohort["dids"], block_size=BLOCK, maf_min=0.45)
    prefix = cohort["prefix"]
    bg, bgxe, maf, vidx = tps.estimate_betas_plink(crm, prefix, **kw)
    jbg, jbgxe, jmaf, jvidx = jps.estimate_betas_plink(jcrm, prefix, **kw)
    Gdi, keep = _expected_filter(cohort, maf_min=0.45)
    assert np.array_equal(vidx, np.flatnonzero(keep))
    assert np.array_equal(vidx, jvidx) and np.array_equal(maf, jmaf)
    assert bg.shape == vidx.shape
    assert bgxe.shape == (cohort["n_cells"], vidx.shape[0])
    assert_allclose(bg, jbg, atol=1e-6)
    assert_allclose(bgxe, jbgxe, atol=1e-6)
    Gc = _head(cohort, vidx, standardize=False, n=256)   # raw genotypes
    bg_d, bgxe_d = crm.predict_interaction(Gc, maf[: Gc.shape[1]])
    assert_allclose(bg[: Gc.shape[1]], bg_d, atol=1e-12)
    assert_allclose(bgxe[:, : Gc.shape[1]], bgxe_d, atol=1e-12)

    # crash -> resume
    ck = str(tmp_path / "ckb")
    calls = []
    real = crm.predict_interaction

    def wrapped(G, m, **k):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("simulated crash")
        return real(G, m, **k)

    monkeypatch.setattr(crm, "predict_interaction", wrapped)
    with pytest.raises(RuntimeError, match="simulated"):
        tps.estimate_betas_plink(crm, prefix, checkpoint=ck, **kw)
    monkeypatch.undo()
    assert ScanCheckpoint(ck).load() is not None
    got = tps.estimate_betas_plink(crm, prefix, checkpoint=ck, **kw)
    for a, b in zip(got, (bg, bgxe, maf, vidx)):
        assert_allclose(a, b, rtol=1e-12)


def _betas_fits(crm, cohort, vidx, maf, port):
    """Each kept variant's ``(beta_g, rho1, lml)`` from its betas fit,
    redone in a betas driver's own batches: each block's kept raw columns,
    padded and batched as ``predict_interaction`` pads and batches them."""
    cfg = crm._cfg
    delta_cfg = (cfg.delta_logit_lo, cfg.delta_logit_hi,
                 min(16, cfg.n_delta_grid), cfg.n_golden_iters)
    Gdi, _ = _expected_filter(cohort)
    out = {"beta_g": [], "rho1": [], "lml": []}
    for b0 in range(0, Gdi.shape[1], BLOCK):
        sel = (vidx >= b0) & (vidx < b0 + BLOCK)
        if not sel.any():
            continue
        G = Gdi[cohort["d2c"]][:, vidx[sel]]
        norm = 1.0 / np.sqrt(2 * maf[sel] * (1 - maf[sel]))
        batch = min(cfg.snp_batch, crm._auto_batch_cap("betas"), G.shape[1])
        Gp, n = (tapi if port else japi)._pad_batch(G, batch)
        normp = np.concatenate([norm, np.repeat(norm[:1], Gp.shape[1] - n)])
        block = {k: [] for k in out}
        for s in range(0, Gp.shape[1], batch):
            g, nb = Gp[:, s : s + batch], normp[s : s + batch]
            if port:
                bg, _, info = tengine.predict_interaction_batch(
                    crm._betas_context(), crm._upload(g), crm._upload(nb),
                    crm._n, delta_cfg=delta_cfg,
                    localize_f32=cfg.hybrid_localization)
            else:
                bg, _, info = jengine.predict_interaction_kernel(
                    crm._betas_context(), jnp.asarray(g, crm._dtype),
                    jnp.asarray(nb, crm._dtype), crm._n,
                    delta_cfg=delta_cfg,
                    localize_f32=cfg.hybrid_localization)
            for k, v in (("beta_g", bg), ("rho1", info["rho1"]),
                         ("lml", info["lml"])):
                block[k].append(v.cpu().numpy() if port else np.asarray(v))
        for k, v in block.items():
            out[k].append(np.concatenate(v)[:n])
    return {k: np.concatenate(v) for k, v in out.items()}


def test_streaming_betas_default_matches_jax(cohort):
    """The default configuration (hybrid localization) against the JAX
    driver, by tests/test_torch_betas.py's rule for near ties: each
    variant's fit, redone in the drivers' own batches, gives its rho1 and
    lml; where both sides pick the same rho1 the effect sizes agree within
    1e-6, and where they do not the two lml are within 1e-4.  This
    cohort's y carries no GxC effect, so its rho profiles are flat: about
    two variants in five pick another rho1 at an lml gap near 1e-7."""
    crm, jcrm = _crms(cohort)
    assert crm._cfg.hybrid_localization and jcrm._cfg.hybrid_localization
    kw = dict(donor_ids=cohort["dids"], block_size=BLOCK, maf_min=0.45)
    prefix = cohort["prefix"]
    bg, bgxe, maf, vidx = tps.estimate_betas_plink(crm, prefix, **kw)
    jbg, jbgxe, jmaf, jvidx = jps.estimate_betas_plink(jcrm, prefix, **kw)
    assert np.array_equal(vidx, jvidx) and np.array_equal(maf, jmaf)
    fit = _betas_fits(crm, cohort, vidx, maf, port=True)
    jfit = _betas_fits(jcrm, cohort, vidx, maf, port=False)
    # the redone fits are the drivers' own
    assert_allclose(fit["beta_g"], bg, rtol=0, atol=1e-12)
    assert_allclose(jfit["beta_g"], jbg, rtol=0, atol=1e-12)
    flipped = fit["rho1"] != jfit["rho1"]
    gap = np.abs(fit["lml"] - jfit["lml"])
    assert np.all(gap[flipped] < 1e-4), gap[flipped]
    same = ~flipped
    assert same.any()
    assert_allclose(bg[same], jbg[same], atol=1e-6)
    assert_allclose(bgxe[:, same], jbgxe[:, same], atol=1e-6)


def test_streaming_screen_matches_jax(cohort):
    """The streaming screen -> confirm over .bed: the same discovery set
    as the JAX package's, confirmed pairs with f64 Davies p-values."""
    crm, jcrm = _crms(cohort)
    kw = dict(donor_ids=cohort["dids"], block_size=BLOCK, maf_min=0.01,
              significance=1e-3)
    pv, info, vidx = tps.scan_interaction_screen_plink(crm,
                                                       cohort["prefix"], **kw)
    jpv, jinfo, jvidx = jps.scan_interaction_screen_plink(
        jcrm, cohort["prefix"], **kw)
    assert np.array_equal(vidx, jvidx)
    assert pv.shape == vidx.shape == info["confirmed"].shape
    assert info["confirmed"].any()
    assert np.array_equal(info["confirmed"], jinfo["confirmed"])
    hits = pv < 1e-3
    assert np.array_equal(hits, jpv < 1e-3)
    assert np.array_equal(hits, info["confirmed"] & hits)
    conf = info["confirmed"]
    assert_allclose(pv[conf], jpv[conf], atol=1e-8)
    # the direct screen of the first block's head
    pv_d, info_d = crm.scan_interaction_screen(_head(cohort, vidx),
                                               significance=1e-3)
    both = info["confirmed"][: pv_d.size] & info_d["confirmed"]
    assert_allclose(pv[: pv_d.size][both], pv_d[both], rtol=1e-12)


def _data_npz(cohort, path, **extra):
    np.savez(path, E=cohort["E"], hK=cohort["hK"],
             donor_to_cell=cohort["d2c"], **extra)
    return str(path)


def test_plink_scan_cli_modes(cohort, tmp_path):
    """--mode association-fast and --mode betas against the drivers."""
    data = _data_npz(cohort, tmp_path / "data.npz", y=cohort["y"])
    out_a = str(tmp_path / "res_assoc.npz")
    rc = tps.main(["--bed", cohort["prefix"], "--data", data, "--out", out_a,
                   "--block-size", str(BLOCK), "--maf-min", "0.01",
                   "--mode", "association-fast", "--device", "cpu"])
    assert rc == 0
    crm = crp.CellRegMap(y=cohort["y"], E=cohort["E"],
                         Ls=crp.get_L_values(cohort["hK"], cohort["E"]),
                         device="cpu")
    pv, _, vidx = tps.scan_association_plink(
        crm, cohort["prefix"], donor_to_cell=cohort["d2c"],
        block_size=BLOCK, maf_min=0.01)
    with np.load(out_a) as z:
        assert np.array_equal(z["variant_index"], vidx)
        assert_allclose(z["pvalues"], pv, rtol=1e-12)
        assert np.all((z["pvalues"] > 0) & (z["pvalues"] <= 1))

    out_b = str(tmp_path / "res_betas.npz")
    rc = tps.main(["--bed", cohort["prefix"], "--data", data, "--out", out_b,
                   "--block-size", str(BLOCK), "--maf-min", "0.45",
                   "--mode", "betas", "--device", "cpu"])
    assert rc == 0
    with np.load(out_b) as z:
        assert z["beta_g"].shape == z["variant_index"].shape
        assert z["beta_gxe"].shape == (cohort["n_cells"],
                                       z["beta_g"].shape[0])
        assert np.isfinite(z["beta_g"]).all()


def test_plink_scan_cli(cohort, tmp_path):
    data = _data_npz(cohort, tmp_path / "data.npz", y=cohort["y"])
    out = str(tmp_path / "res.npz")
    rc = tps.main(["--bed", cohort["prefix"], "--data", data, "--out", out,
                   "--block-size", str(BLOCK), "--maf-min", "0.01",
                   "--pvalue-method", "liu", "--snp-batch", "256",
                   "--checkpoint", str(tmp_path / "ck2"), "--device", "cpu"])
    assert rc == 0
    crm, _ = _crms(cohort)
    pv, info, vidx = tps.scan_interaction_plink(
        crm, cohort["prefix"], donor_to_cell=cohort["d2c"],
        block_size=BLOCK, maf_min=0.01)
    with np.load(out) as z:
        assert np.array_equal(z["variant_index"], vidx)
        assert_allclose(z["pvalues"], pv, rtol=1e-12)
        assert np.array_equal(z["rho1"], info["rho1"])
        assert np.all((z["pvalues"] > 0) & (z["pvalues"] <= 1))


def test_plink_scan_cli_multigene(cohort, tmp_path):
    """--data with Y + windows dispatches the gene-batched cis driver."""
    Y = _genes(cohort, 31, 3)
    windows = np.array([[0, 12], [6, 18], [12, 24]])
    data = _data_npz(cohort, tmp_path / "datam.npz", Y=Y, windows=windows)
    out = str(tmp_path / "resm.npz")
    rc = tps.main(["--bed", cohort["prefix"], "--data", data, "--out", out,
                   "--maf-min", "0.01", "--pvalue-method", "liu",
                   "--gene-batch", "2", "--device", "cpu"])
    assert rc == 0
    with np.load(out) as z:
        assert z["pvalues"].shape == z["gene"].shape
        assert set(np.unique(z["gene"])) == {0, 1, 2}
        assert np.all((z["pvalues"] > 0) & (z["pvalues"] <= 1))


def test_plink_scan_cli_needs_a_card_or_device_cpu(cohort, tmp_path):
    """Without --device the CLI runs on the card: with none it exits
    non-zero, naming the CPU's flag."""
    data = _data_npz(cohort, tmp_path / "data.npz", y=cohort["y"])
    env = dict(os.environ, PYTHONPATH=str(ROOT), CUDA_VISIBLE_DEVICES="")
    r = subprocess.run(
        [sys.executable, "-m", "cellregmap_tpu_torch.plink_scan", "--bed",
         cohort["prefix"], "--data", data, "--out",
         str(tmp_path / "res.npz")], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert "device='cpu'" in r.stderr and "--device cpu" in r.stderr
    assert not (tmp_path / "res.npz").exists()


# ---------------------------------------------------------------------------
# Repairs of the JAX package's drivers
# ---------------------------------------------------------------------------
def test_variance_filter_is_cell_level(tmp_path):
    """Reference item f: variant 5 is constant on the 40 donors that have
    cells and varies over the .fam's 50.  The JAX driver filters on the
    donor-level column and keeps it: a NaN column (a NaN p-value, or a
    failed eigendecomposition under davies).  The port drops it, and every
    other row equals the JAX driver's on the fileset without it
    (davies)."""
    rng = np.random.default_rng(5)
    n_donors, m, j = 50, 300, 5
    Gd = rng.binomial(2, 0.3, size=(n_donors, m)).astype(float)
    Gd[:40, j] = 1.0
    Gd[40:, j] = rng.permutation(np.arange(10) % 3)
    d2c = np.repeat(np.arange(40), 3)
    n = d2c.size
    E = rng.normal(size=(n, 3))
    hK = np.zeros((n, 40))
    hK[np.arange(n), d2c] = 1.0
    y = rng.normal(size=n) + 0.4 * E @ rng.normal(size=3)
    full, cut = str(tmp_path / "full"), str(tmp_path / "cut")
    plink.write_bed(full, Gd)
    plink.write_bed(cut, np.delete(Gd, j, axis=1))
    cfg = dict(snp_batch=64)
    crm = crp.CellRegMap(y=y, E=E, Ls=crp.get_L_values(hK, E),
                         config=crp.ScanConfig(**cfg), device="cpu")
    jcrm = jcrt.CellRegMap(y=y, E=E, Ls=jcrt.get_L_values(hK, E),
                           config=jcrt.ScanConfig(**cfg))
    kw = dict(donor_to_cell=d2c, block_size=128)
    pv, info, vidx = tps.scan_interaction_plink(crm, full, **kw)
    assert j not in vidx and np.isfinite(pv).all()
    with np.errstate(invalid="ignore"):
        Gc, _, kept = jps._decode_block(jplink.PlinkReader(full), 0, m, d2c,
                                        0.0, True)
    assert j in kept and np.isnan(Gc[:, kept == j]).all()

    cpv, cinfo, cvidx = jps.scan_interaction_plink(jcrm, cut, **kw)
    _same_interaction((pv, info, vidx),
                      (cpv, cinfo, cvidx + (cvidx >= j)))


@pytest.mark.parametrize("change", ["phenotype", "bim"])
def test_checkpoint_resumes_only_on_the_same_inputs(cohort, tmp_path,
                                                    monkeypatch, change):
    """Reference item l: a checkpoint written under one phenotype (or
    another .bim of the same size) does not resume under another; the
    scan starts over and equals a fresh run."""
    crm, _ = _crms(cohort)
    prefix = str(tmp_path / "cohort")
    plink.write_bed(prefix, cohort["Gd"], sample_ids=cohort["donor_ids"])
    ck = str(tmp_path / "ck")
    kw = dict(donor_to_cell=cohort["d2c"], block_size=BLOCK)
    real = crp.CellRegMap.scan_interaction
    calls, crash = [], [True]

    def crashing(self, G, **k):
        calls.append(1)
        if crash[0] and len(calls) == 2:
            raise Boom()
        return real(self, G, **k)

    monkeypatch.setattr(crp.CellRegMap, "scan_interaction", crashing)
    with pytest.raises(Boom):
        tps.scan_interaction_plink(crm, prefix, checkpoint=ck, **kw)
    assert ScanCheckpoint(ck).load()["cursor"] == 1
    if change == "phenotype":
        crm = crm.with_phenotype(_genes(cohort, 37, 1)[:, 0])
    else:
        plink.write_bed(prefix, cohort["Gd"], sample_ids=cohort["donor_ids"],
                        snp_ids=[f"rs{v}" for v in range(2600)])
    calls.clear()
    crash[0] = False
    got = tps.scan_interaction_plink(crm, prefix, checkpoint=ck, **kw)
    assert len(calls) == 3            # every block scanned again
    monkeypatch.undo()
    want = tps.scan_interaction_plink(crm, prefix, **kw)
    assert_allclose(got[0], want[0], rtol=1e-12)
    assert np.array_equal(got[2], want[2])
