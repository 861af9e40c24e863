"""The plain versions of the port's kernels against the JAX engine, on the
CPU, and the wrappers' CPU dispatch.

K1 ``kr_contract`` against ``engine._kr_contract``; K4 ``best_rho_rotate``
against the engine's masked rotation loop (engine.py:684-688); K5
``score_core`` against ``engine.score_test_core`` per variant; K2
``delta_grid`` and K3 ``reml_localize`` against the interaction batch's
stage exits (``profile_stage`` "grid" and "stage2"); K7 (the ML
instantiations of both) against ``association_refit_kernel``; K10
``null_fit`` against ``_fit_over_rho``.  The CUDA kernels themselves are
held against these plain versions on the card by tests/test_torch_cuda.py
and chip_smoke.py.

Tolerances: the same f64 contractions summed in another order (BLAS vs
XLA) differ by ~n ulp of the largest partial sum, so results are compared
at 1e-12 of the output's largest entry; K5's K0^{-1} forms subtract the
eigenbasis part from the full-space Gram, which can cancel a few digits,
so it is compared at 1e-10 of the largest entry.  The fits: a grid
bracket may sit on a near-tie neighbour of the other side's argmax (its
lml within 1e-5 of the maximum in float32, 1e-12 in float64); the
localized Newton from the same brackets at rtol 1e-9 (delta) and 1e-10
(lml); the refit at the JAX package's Newton-vs-golden budgets (lml 1e-8
absolute, beta rtol 1e-6); the golden-section fits through
``null_fit.fit_gaps`` at 1e-10 (tests/test_torch_association.py says why
delta is not compared with delta).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from _torch_inputs import (captured, fit_dataset, kr_inputs, rotate_inputs,
                           score_inputs)
from cellregmap_tpu import engine as jengine
from cellregmap_tpu_torch import engine as tengine
from cellregmap_tpu_torch.kernels import best_rho_rotate as k4
from cellregmap_tpu_torch.kernels import delta_grid as k2
from cellregmap_tpu_torch.kernels import kr_contract as k1
from cellregmap_tpu_torch.kernels import null_fit as k10
from cellregmap_tpu_torch.kernels import reml_newton as k3
from cellregmap_tpu_torch.kernels import score_core as k5
from cellregmap_tpu_torch.models.lmm import FitResult
from test_api import _dataset

CASES = [(C, p) for C in (3, 10, 50) for p in (1, 2)]


def _close(got, want, rel):
    want = np.asarray(want)
    assert_allclose(np.asarray(got), want, rtol=0,
                    atol=rel * np.abs(want).max())


@pytest.mark.parametrize("C,p", CASES)
def test_kr_contract_plain_matches_jax(C, p):
    U, _, G = kr_inputs(C + 10 * p, K=C + 7)
    rng = np.random.default_rng(C * p)
    for V in (rng.normal(size=(U.shape[0], C)),      # T / AtA: C columns
              rng.normal(size=(U.shape[0], p))):     # AW: p columns
        want = jengine._kr_contract(jnp.asarray(U), jnp.asarray(V),
                                    jnp.asarray(G))
        got = k1.kr_contract_plain(torch.as_tensor(U), torch.as_tensor(V),
                                   torch.as_tensor(G))
        assert got.shape == want.shape
        _close(got, want, 1e-12)


@pytest.mark.parametrize("C,p", CASES)
def test_best_rho_rotate_plain_matches_jax(C, p):
    V, T, kb = rotate_inputs(C + p, C=C, S=11 + p)
    S, nrho = T.shape[2], V.shape[0]
    # the JAX engine's masked accumulation over every rho, on its (C, R, S)
    # layout of T
    Tj = jnp.asarray(T.transpose(1, 0, 2))
    O_k = jnp.asarray(np.eye(nrho)[kb])
    want = jnp.zeros((S, T.shape[0], C))
    for o in range(nrho):
        To = jnp.einsum("rq,crs->sqc", jnp.asarray(V[o]), Tj)
        want = want + O_k[:, o][:, None, None] * To
    At, slot = k4.best_rho_rotate_plain(torch.as_tensor(V),
                                        torch.as_tensor(T),
                                        torch.as_tensor(kb))
    # one phenotype: one slot, the (S, R, C) factor
    assert At.shape == (1,) + tuple(want.shape) and not bool(slot.any())
    _close(k4.gather(At, slot), want, 1e-12)


@pytest.mark.parametrize("C,p", CASES)
def test_score_core_plain_matches_jax(C, p):
    args = score_inputs(100 * C + p, C=C, p=p)
    (Sv, WGt, yt, At, WW, Wy, Wg, gg, gy, AW, Ag, Ay, AtA, kb, v0,
     v1, slot) = args
    Q, Wmat = k5.score_core_plain(*[torch.as_tensor(a) for a in args])
    S = At.shape[1]
    At = At[slot, np.arange(S)]               # each variant's own slot
    for s in range(S):
        k = kb[s]
        Xt = np.concatenate([WGt[k, :, :p], WGt[k, :, p + s][:, None]], 1)
        XX = np.block([[WW, Wg[:, s][:, None]],
                       [Wg[:, s][None, :], gg[s][None, None]]])
        Xy = np.concatenate([Wy, [gy[s]]])
        AX = np.concatenate([AW[:, :, s], Ag[:, s][:, None]], axis=1)
        Qj, Wj = jengine.score_test_core(
            jnp.asarray(Sv[k]), jnp.asarray(Xt), jnp.asarray(yt[k]),
            jnp.asarray(At[s]), jnp.asarray(XX), jnp.asarray(Xy),
            jnp.asarray(AX), jnp.asarray(Ay[:, s]), jnp.asarray(AtA[:, :, s]),
            v0[s], v1[s])
        _close(Q[s].numpy(), Qj, 1e-10)
        _close(Wmat[s].numpy(), Wj, 1e-10)


def _carried(d):
    """The JAX engine's null context and its port copy on the CPU."""
    ctx_j = jengine.build_null_context(d["y"], d["W"], d["E"], Ls=d["Ls"])
    ctx_t = tengine.null_context_from_numpy(
        {k: np.asarray(v) for k, v in ctx_j._asdict().items()}, "cpu")
    return ctx_j, ctx_t


@pytest.mark.parametrize("pW,f32", [(1, True), (2, True), (1, False)])
def test_grid_and_localize_plains_match_jax_stages(pW, f32):
    d = _dataset(seed=5 + pW, pW=pW, S=9)
    ctx_j, ctx_t = _carried(d)
    cfg = (-18.0, 18.0, 64, 60)
    G = jnp.asarray(d["G"])
    stage = lambda name: jengine.interaction_kernel(  # noqa: E731
        ctx_j, G, G, d["n"], delta_cfg=cfg, device_pvalues=False,
        profile_stage=name, localize_f32=f32)
    grid, st2 = stage("grid"), stage("stage2")
    Gt = torch.as_tensor(d["G"])
    calls = captured(lambda: tengine.interaction_batch(
        ctx_t, Gt, Gt, d["n"], delta_cfg=cfg, localize_f32=f32),
        ["delta_grid", "reml_localize"])
    # K2: the JAX brackets are the port's grid argmax, or a near-tie of it
    (args, kw), = calls["delta_grid"]
    _, _, lml = k2.delta_grid_plain(*args, **kw, return_lml=True)
    br_lo = torch.as_tensor(np.array(grid["br_lo"]))
    br_hi = torch.as_tensor(np.array(grid["br_hi"]))
    assert k2.bracket_shortfall(br_lo, br_hi, lml, cfg[0], cfg[1]) \
        <= (1e-5 if f32 else 1e-12)
    # K3 localize, from the JAX brackets
    (args, kw), = calls["reml_localize"]
    x, lml_all, kb = k3.reml_localize_plain(*args[:5], br_lo, br_hi,
                                            *args[7:], **kw)
    assert_allclose(torch.sigmoid(x).numpy(), np.asarray(st2["delta32"]),
                    rtol=1e-9)
    assert_allclose(lml_all.numpy(), np.asarray(st2["lml_all"]), rtol=1e-10)
    assert np.array_equal(kb.numpy(), np.asarray(st2["k_best"]))


@pytest.mark.parametrize("pW", [1, 2])
def test_refit_plains_match_jax(pW):
    """K7: the ML grid and the ML converge, run as plain functions on the
    refit's operands, against ``association_refit_kernel``."""
    d = _dataset(seed=23 + pW, pW=pW, S=8)
    ctx_j, ctx_t = _carried(d)
    cfg = (-18.0, 18.0, 256, 60)
    k = 4
    calls = captured(lambda: tengine.association_refit_batch(
        ctx_t, torch.as_tensor(d["G"]), k, d["n"], delta_cfg=cfg),
        ["delta_grid", "reml_converge"])
    (ga, gkw), = calls["delta_grid"]
    (ca, ckw) = calls["reml_converge"][0]
    br_lo, br_hi = k2.delta_grid_plain(*ga, **gkw)
    _, lml, _, beta = k3.reml_converge_plain(*ca[:7], br_lo, br_hi, *ca[9:],
                                             **ckw)
    lml_j, beta_j = jengine.association_refit_kernel(
        ctx_j, jnp.asarray(d["G"]), k, d["n"], delta_cfg=cfg)
    assert_allclose(lml.numpy(), np.asarray(lml_j), rtol=0, atol=1e-8)
    assert_allclose(beta.numpy(), np.asarray(beta_j), rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("restricted", [False, True])
def test_null_fit_plain_matches_jax(restricted):
    """K10 against ``_fit_over_rho`` (through the jitted
    ``null_association_kernel``): the JAX fits are optima of the port's
    plain objective, and agree with its fits at their deltas."""
    d = _dataset(seed=41, pW=2)
    ctx_j, ctx_t = _carried(d)
    cfg = (-18.0, 18.0, 256, 60)
    calls = captured(lambda: tengine._fit_over_rho(
        ctx_t, ctx_t.ZW, ctx_t.WW, ctx_t.Wy, d["n"], restricted, cfg),
        ["null_fit"])
    (args, kw), = calls["null_fit"]
    plain = k10.null_fit_plain(*args, **kw)
    fits_j, _ = jengine.null_association_kernel(
        ctx_j, d["n"], restricted=restricted, delta_cfg=cfg)
    fits_j = FitResult(*(torch.as_tensor(np.array(t)) for t in fits_j))
    gaps = k10.fit_gaps(fits_j, plain, args[0], d["n"], restricted)
    assert max(gaps.values()) <= 1e-10, gaps


def _fit_args():
    ctx, G, n = fit_dataset(3, p=1, nrho=3)
    calls = captured(lambda: tengine.interaction_batch(ctx, G, G, n),
                     ["delta_grid", "reml_localize", "reml_converge"])
    calls.update(captured(lambda: tengine._fit_over_rho(
        ctx, ctx.ZW, ctx.WW, ctx.Wy, n, False, (-18.0, 18.0, 16, 10)),
        ["null_fit"]))
    return {k: v[0] for k, v in calls.items()}


def _cpu_calls():
    U, V, G = (torch.as_tensor(a) for a in kr_inputs(1))
    Vr, T, kb = (torch.as_tensor(a) for a in rotate_inputs(2))
    args = [torch.as_tensor(a) for a in score_inputs(3)]
    fa = _fit_args()
    fit = lambda mod, name, plain: (  # noqa: E731
        mod, lambda: getattr(mod, name)(*fa[name][0], **fa[name][1]),
        lambda: plain(*fa[name][0], **fa[name][1]))
    return [
        (k1, lambda: k1.kr_contract(U, V, G),
         lambda: k1.kr_contract_plain(U, V, G)),
        (k4, lambda: k4.best_rho_rotate(Vr, T, kb),
         lambda: k4.best_rho_rotate_plain(Vr, T, kb)),
        (k5, lambda: k5.score_core(*args),
         lambda: k5.score_core_plain(*args)),
        fit(k2, "delta_grid", k2.delta_grid_plain),
        fit(k3, "reml_localize", k3.reml_localize_plain),
        fit(k3, "reml_converge", k3.reml_converge_plain),
        fit(k10, "null_fit", k10.null_fit_plain),
    ]


@pytest.mark.parametrize("which", range(7))
def test_cpu_wrapper_takes_plain_path_and_counts_nothing(which):
    mod, wrapper, plain = _cpu_calls()[which]
    before = mod.launches
    got, want = wrapper(), plain()
    assert mod.launches == before
    for a, b in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert torch.equal(a, b)


def test_wrappers_refuse_other_devices_without_launching():
    """A tensor that is neither on the CPU nor on a card is refused with an
    error, never computed by a fallback."""
    meta = lambda *shape: torch.empty(*shape, dtype=torch.float64,  # noqa
                                      device="meta")
    before = (k1.launches, k4.launches, k5.launches)
    with pytest.raises(ValueError, match="CUDA tensor"):
        k1.kr_contract(meta(5, 3), meta(5, 2), meta(5, 4))
    with pytest.raises(ValueError, match="CUDA tensor"):
        k4.best_rho_rotate(meta(2, 4, 4), meta(4, 2, 3),
                           torch.zeros(3, dtype=torch.int64, device="meta"))
    args = [meta(*np.shape(a)) for a in score_inputs(4)]
    for i in (13, 16):                      # k_best, slot
        args[i] = torch.zeros(args[i].shape, dtype=torch.int64,
                              device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        k5.score_core(*args)
    assert (k1.launches, k4.launches, k5.launches) == before
    def on_meta(a):
        if isinstance(a, torch.Tensor):
            return a.to("meta")
        return type(a)(*map(on_meta, a)) if isinstance(a, tuple) else a
    fa = _fit_args()
    before = (k2.launches, k3.launches, k10.launches)
    for mod, name in ((k2, "delta_grid"), (k3, "reml_localize"),
                      (k3, "reml_converge"), (k10, "null_fit")):
        args, kw = fa[name]
        with pytest.raises(ValueError, match="CUDA tensor"):
            getattr(mod, name)(*map(on_meta, args), **kw)
    assert (k2.launches, k3.launches, k10.launches) == before


def test_fit_kernels_reject_too_many_covariates():
    """p + 1 > 33 is refused on a card tensor, never run by the plain
    version."""
    ctx, G, n = fit_dataset(9, p=33, nrho=2, n=60, S=2)
    calls = captured(lambda: tengine.association_refit_batch(
        ctx, G, 0, n, delta_cfg=(-18.0, 18.0, 8, 60), newton_f64=1),
        ["delta_grid"])
    (args, kw), = calls["delta_grid"]
    meta = [a.to("meta") if isinstance(a, torch.Tensor) else a for a in args]
    with pytest.raises(ValueError, match="p \\+ 1 <= 33"):
        k2.delta_grid(*meta, **kw)


def test_score_core_rejects_too_many_columns():
    """C + p + 2 > 98 (the wide instantiation's limit) is refused."""
    args = [torch.as_tensor(a) for a in score_inputs(5, C=96, n=100, S=2)]
    args = [a.to("meta") for a in args]
    with pytest.raises(ValueError, match="C \\+ p \\+ 2"):
        k5.score_core(*args)
