"""The port at the card's covariate envelope against the JAX package, on the
CPU, and the envelope's refusal at construction.

1. p = 24 columns of W (the intercept and 23 seeded normal columns) and
   ``ScanConfig(n_rho=21)``, through ``run_association`` and
   ``run_association_fast`` against the JAX package at the headline
   budgets (tests/test_torch_association.py,
   test_torch_fast_association.py): association within 1e-9 absolute,
   fast association at rtol 1e-5 / atol 1e-12, rho1 identical; through
   ``run_interaction`` against the package's dense oracle at p = 24 (the
   JAX engine's program does not compile in a test's time at that width)
   and against the JAX engine at p = 8 (within 1e-8, rho1 identical);
2. a scanner on the card whose shape lies past the card's kernels (p > 32
   columns of W, C > 64 contexts) raises ``ValueError`` naming the limit
   when it is made, before the null context is built; a rho grid of any
   length is accepted (65 and 128 points); inside the envelope, up to its
   corner (p = 32, C = 64), the effect sizes (K9, q = C + rank[W, E] + 2
   <= 162) and the aggregate environment (K10, rank[W, E] + 1 <= 97 mean
   columns) go on to their setup with no refusal.  Without a card, the device
   is made to read as CUDA (``api._resolve_device``) and the factorizations
   are replaced by functions that fail the test if called.
"""
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import cellregmap_tpu as crt
import cellregmap_tpu_torch as crp
from cellregmap_tpu import oracle
from cellregmap_tpu_torch import api, engine
from _torch_inputs import jax_davies_library  # noqa: F401

N_RHO = 21


def _data(seed=24, n=90, C=3, S=6, p=24):
    rng = np.random.default_rng(seed)
    E = rng.normal(size=(n, C))
    W = np.concatenate([np.ones((n, 1)), rng.normal(size=(n, p - 1))],
                       axis=1)
    G = rng.choice([0.0, 1.0, 2.0], size=(n, S), p=[0.49, 0.42, 0.09])
    G = (G - G.mean(0)) / G.std(0)
    hK = rng.normal(size=(n, 8)) / np.sqrt(8)
    y = (0.5 * rng.normal(size=n) + 0.3 * E @ rng.normal(size=C)
         + hK @ rng.normal(size=8) + W[:, 1:] @ rng.normal(size=p - 1)
         + 0.4 * G[:, 2] * E[:, 0])
    return dict(y=y, W=W, E=E, G=G, hK=hK)


def test_interaction_p24_matches_dense_oracle():
    """At p = 24 the JAX engine's interaction program takes longer than a
    quarter of an hour to compile on the CPU (its small algebra is unrolled
    over (p + 1)^3 terms), so the reference is the package's dense oracle,
    at the JAX suite's own oracle budgets (tests/test_api.py:38-43): rho1
    identical, Q at rtol 1e-6, p-values within 5e-8."""
    d = _data()
    # run_interaction's background from hK: K (.) E E^T
    pv_o, info_o = oracle.scan_interaction_dense(
        d["y"], d["W"], d["E"], G=d["G"],
        Ls=crp.get_L_values(d["hK"], d["E"]),
        rho_grid=np.linspace(0.0, 1.0, N_RHO))
    pv_t, info_t = crp.run_interaction(
        y=d["y"], E=d["E"], G=d["G"], W=d["W"], hK=d["hK"],
        config=crp.ScanConfig(n_rho=N_RHO), device="cpu")
    assert np.all((pv_t > 0) & (pv_t <= 1))
    assert np.array_equal(info_t["rho1"], info_o["rho1"])
    assert_allclose(info_t["Q"], info_o["Q"], rtol=1e-6)
    assert_allclose(pv_t, pv_o, rtol=0, atol=5e-8)


def test_interaction_80_rho_matches_jax():
    """``ScanConfig(n_rho=80)``, past the 64 rho points that the card's
    localize took before, against the JAX engine at the headline budget
    (within 1e-8, rho1 identical)."""
    d = _data(seed=80, p=2)
    cfg = dict(n_rho=80)
    pv_j, info_j = crt.run_interaction(
        y=d["y"], E=d["E"], G=d["G"], W=d["W"], hK=d["hK"],
        config=crt.ScanConfig(**cfg))
    pv_t, info_t = crp.run_interaction(
        y=d["y"], E=d["E"], G=d["G"], W=d["W"], hK=d["hK"],
        config=crp.ScanConfig(**cfg), device="cpu")
    assert np.array_equal(info_t["rho1"], info_j["rho1"])
    assert_allclose(pv_t, pv_j, rtol=0, atol=1e-8)


def test_interaction_p8_matches_jax():
    """p = 8, past the 8-column limit of K5's narrow instantiation, with 21
    rho points, against the JAX engine at the headline budget."""
    d = _data(seed=27, p=8)
    pv_j, info_j = crt.run_interaction(
        y=d["y"], E=d["E"], G=d["G"], W=d["W"], hK=d["hK"],
        config=crt.ScanConfig(n_rho=N_RHO))
    pv_t, info_t = crp.run_interaction(
        y=d["y"], E=d["E"], G=d["G"], W=d["W"], hK=d["hK"],
        config=crp.ScanConfig(n_rho=N_RHO), device="cpu")
    assert np.array_equal(info_t["rho1"], info_j["rho1"])
    assert_allclose(pv_t, pv_j, rtol=0, atol=1e-8)


def test_association_p24_matches_jax():
    d = _data(seed=25)
    cfg = dict(n_rho=N_RHO)
    pv_j, info_j = crt.run_association(d["y"], d["W"], d["E"], d["G"],
                                       hK=d["hK"],
                                       config=crt.ScanConfig(**cfg))
    pv_t, info_t = crp.run_association(d["y"], d["W"], d["E"], d["G"],
                                       hK=d["hK"],
                                       config=crp.ScanConfig(**cfg),
                                       device="cpu")
    assert np.array_equal(info_t["rho1"], info_j["rho1"])
    assert_allclose(pv_t, pv_j, rtol=0, atol=1e-9)


def test_fast_association_p24_matches_jax():
    d = _data(seed=26)
    cfg = dict(n_rho=N_RHO)
    pv_j, info_j = crt.run_association_fast(d["y"], d["W"], d["E"], d["G"],
                                            hK=d["hK"],
                                            config=crt.ScanConfig(**cfg))
    pv_t, info_t = crp.run_association_fast(d["y"], d["W"], d["E"],
                                            d["G"], hK=d["hK"],
                                            config=crp.ScanConfig(**cfg),
                                            device="cpu")
    assert np.array_equal(info_t["rho1"], info_j["rho1"])
    assert_allclose(pv_t, pv_j, rtol=1e-5, atol=1e-12)


@pytest.fixture
def card(monkeypatch):
    """The device reads as CUDA; a factorization fails the test."""
    monkeypatch.setattr(api, "_resolve_device",
                        lambda device=None: torch.device("cuda"))

    def never(*a, **kw):
        raise AssertionError("setup ran for a shape the card refuses")

    monkeypatch.setattr(engine, "build_null_context", never)
    monkeypatch.setattr(engine, "build_betas_context", never)


# (p, C, n_rho, the limit named): each past one limit of the envelope
REFUSED = [(33, 3, 11, "32 covariates"), (2, 65, 11, "64 contexts")]


@pytest.mark.parametrize("p,C,n_rho,limit", REFUSED)
def test_card_scanner_refused_at_construction(card, p, C, n_rho, limit):
    d = _data(p=p, C=C, n=120)
    with pytest.raises(ValueError, match=limit):
        crp.CellRegMap(y=d["y"], E=d["E"], W=d["W"], hK=d["hK"],
                       config=crp.ScanConfig(n_rho=n_rho))
    with pytest.raises(ValueError, match=limit):
        crp.run_interaction(y=d["y"], E=d["E"], G=d["G"], W=d["W"],
                            hK=d["hK"], config=crp.ScanConfig(n_rho=n_rho))


@pytest.mark.parametrize("n_rho", [65, 128])
def test_card_scanner_takes_any_rho_grid(card, n_rho):
    """A rho grid of any length makes a scanner on the card (the
    localize's argmax over rho is a kernel of its own)."""
    d = _data(p=2, n=120)
    crm = crp.CellRegMap(y=d["y"], E=d["E"], W=d["W"], hK=d["hK"],
                         config=crp.ScanConfig(n_rho=n_rho))
    assert crm.device.type == "cuda" and len(crm._rho_grid) == n_rho


def test_card_scanner_at_the_envelope_is_accepted(card):
    """p = 32, C = 64 and 64 rho points make a scanner on the card (the
    null context is built on first use, not here)."""
    d = _data(p=32, C=64, n=120)
    crm = crp.CellRegMap(y=d["y"], E=d["E"], W=d["W"], hK=d["hK"],
                         config=crp.ScanConfig(n_rho=64))
    assert crm.device.type == "cuda" and len(crm._rho_grid) == 64


# (p, C): effect sizes at q = C + rank[W, E] + 2 = 152 and the aggregate
# environment at rank[W, E] + 1 = 91 mean columns (past PR 7's 128 and 64),
# and the envelope's corner, q = 162 and 97 mean columns
WIDEST = [(30, 60), (32, 64)]


@pytest.mark.parametrize("p,C", WIDEST)
def test_card_effect_sizes_taken_to_setup(card, p, C):
    """K9 takes every q the envelope allows: the effect sizes go on to
    build the betas context (the ``card`` fixture's stand-in fails there)
    with no ``ValueError`` first."""
    d = _data(p=p, C=C, n=120)
    crm = crp.CellRegMap(y=d["y"], E=d["E"], W=d["W"], hK=d["hK"])
    with pytest.raises(AssertionError, match="setup ran"):
        crm.predict_interaction(d["G"], np.full(d["G"].shape[1], 0.3))


@pytest.mark.parametrize("p,C", WIDEST)
def test_card_aggregate_environment_taken_to_setup(card, p, C):
    """K10 takes every count of mean columns the envelope allows: the
    aggregate environment goes on to build the null context with no
    ``ValueError`` first."""
    d = _data(p=p, C=C, n=120)
    crm = crp.CellRegMap(y=d["y"], E=d["E"], W=d["W"], hK=d["hK"])
    assert engine.reduced_design_basis(d["W"], d["E"]).shape[1] == p + C
    with pytest.raises(AssertionError, match="setup ran"):
        crm.estimate_aggregate_environment(d["G"][:, 0])
