"""Crash -> resume of every scan of the port, on the CPU (the pattern of
tests/test_checkpoint_matrix.py).

Each scan runs once clean; then checkpointed, with its engine function
made to raise after N calls (a crash after at least one durable unit);
then again on the same checkpoint.  The resumed run makes fewer engine
calls than a clean one, equals the clean results at rtol 1e-12, and
leaves no checkpoint behind.  Single-gene scans checkpoint per variant
batch (4 batches of 3 over 12 variants), gene-batched scans per gene tile
(4 tiles of one gene x 4 variant batches = 16 engine calls).
"""
import numpy as np
import pytest
from numpy.testing import assert_allclose

import cellregmap_tpu_torch as crp
from cellregmap_tpu_torch import engine
from cellregmap_tpu_torch.parallel.checkpoint import ScanCheckpoint


def _dataset(seed=31, n=50, C=3, S=12):
    rng = np.random.default_rng(seed)
    E = rng.normal(size=(n, C))
    W = np.ones((n, 1))
    hK = rng.normal(size=(n, 6)) / np.sqrt(6)
    Ls = crp.get_L_values(hK, E)
    G = rng.choice([0.0, 1.0, 2.0], size=(n, S), p=[0.49, 0.42, 0.09])
    G = (G - G.mean(0)) / G.std(0)
    KE = sum(L @ L.T for L in Ls)
    y = (0.5 * rng.normal(size=n)
         + np.linalg.cholesky(KE + 1e-8 * np.eye(n)) @ rng.normal(size=n)
         + 0.4 * G[:, 2] * E[:, 0])
    return y, W, E, G, Ls


# name: (engine function to crash, scan, crash after N calls, calls of a
# clean scan, checkpoint units)
CASES = {
    "interaction": (
        "interaction_batch",
        lambda crm, Y, G, ck: crm.scan_interaction(G, checkpoint=ck),
        2, 4, 4),
    "interaction_multigene": (
        "interaction_multigene_batch",
        lambda crm, Y, G, ck: crm.scan_interaction_multigene(
            Y, G, gene_batch=1, checkpoint=ck),
        5, 16, 4),
    "association": (
        "association_refit_batch",
        lambda crm, Y, G, ck: crm.scan_association(G, checkpoint=ck),
        2, 4, 4),
    "association_fast": (
        "fast_scan_batch",
        lambda crm, Y, G, ck: crm.scan_association_fast(G, checkpoint=ck),
        2, 4, 4),
    "association_multigene": (
        "association_refit_multigene_batch",
        lambda crm, Y, G, ck: crm.scan_association_multigene(
            Y, G, gene_batch=1, checkpoint=ck),
        5, 16, 4),
    "association_fast_multigene": (
        "fast_scan_multigene_batch",
        lambda crm, Y, G, ck: crm.scan_association_fast_multigene(
            Y, G, gene_batch=1, checkpoint=ck),
        5, 16, 4),
    "betas": (
        "predict_interaction_batch",
        lambda crm, Y, G, ck: crm.predict_interaction(
            G, np.full(G.shape[1], 0.3), checkpoint=ck),
        2, 4, 4),
}


class Boom(RuntimeError):
    pass


def _assert_same(got, want):
    """Two scan results ((pvalues, info) or (beta_g, beta_gxe)) equal at
    rtol 1e-12, info entry by entry (timers aside)."""
    for g, w in zip(got, want):
        if isinstance(w, dict):
            assert set(g) == set(w)
            for k in w:
                if k != "timers":
                    assert_allclose(g[k], w[k], rtol=1e-12, err_msg=k)
        else:
            assert_allclose(g, w, rtol=1e-12)


def _crash_after(monkeypatch, name, n_ok):
    """Make engine.``name`` raise after ``n_ok`` calls."""
    orig = getattr(engine, name)
    calls = {"n": 0}

    def crashing(*a, **kw):
        if calls["n"] >= n_ok:
            raise Boom()
        calls["n"] += 1
        return orig(*a, **kw)

    monkeypatch.setattr(engine, name, crashing)
    return orig


def _counting(monkeypatch, name, orig):
    calls = {"n": 0}

    def counting(*a, **kw):
        calls["n"] += 1
        return orig(*a, **kw)

    monkeypatch.setattr(engine, name, counting)
    return calls


@pytest.mark.parametrize("name", sorted(CASES))
def test_checkpoint_crash_resume(name, tmp_path, monkeypatch):
    fn, scan, crash_after, total_calls, n_units = CASES[name]
    y, W, E, G, Ls = _dataset(seed=47)
    Y = y[:, None] + 0.3 * np.random.default_rng(5).normal(size=(len(y), 4))
    crm = crp.CellRegMap(y=y, E=E, W=W, Ls=Ls,
                         config=crp.ScanConfig(snp_batch=3), device="cpu")
    clean = scan(crm, Y, G, None)
    ck = str(tmp_path / "ckpt")

    orig = _crash_after(monkeypatch, fn, crash_after)
    with pytest.raises(Boom):
        scan(crm, Y, G, ck)
    state = ScanCheckpoint(ck).load()
    assert state is not None and 1 <= state["cursor"] < n_units

    calls = _counting(monkeypatch, fn, orig)
    resumed = scan(crm, Y, G, ck)
    assert calls["n"] < total_calls       # the durable units were skipped
    _assert_same(resumed, clean)
    assert ScanCheckpoint(ck).load() is None


@pytest.mark.parametrize("name", ["association_fast",
                                  "association_fast_multigene"])
def test_checkpoint_rejects_changed_inputs(name, tmp_path, monkeypatch):
    """A checkpoint of one (Y, G) is not spliced into a scan of other data
    with the same shapes: that scan starts over."""
    fn, scan, crash_after, total_calls, _ = CASES[name]
    y, W, E, G, Ls = _dataset(seed=53)
    Y = y[:, None] + 0.3 * np.random.default_rng(6).normal(size=(len(y), 4))
    crm = crp.CellRegMap(y=y, E=E, W=W, Ls=Ls,
                         config=crp.ScanConfig(snp_batch=3), device="cpu")
    ck = str(tmp_path / "ckpt")
    orig = _crash_after(monkeypatch, fn, crash_after)
    with pytest.raises(Boom):
        scan(crm, Y, G, ck)
    assert ScanCheckpoint(ck).load() is not None

    G2 = G[:, ::-1].copy()
    calls = _counting(monkeypatch, fn, orig)
    got = scan(crm, Y, G2, ck)
    assert calls["n"] == total_calls      # started over
    _assert_same(got, scan(crm, Y, G2, None))
