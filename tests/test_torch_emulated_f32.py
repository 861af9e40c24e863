"""The float32 context's instantiations of K1, K2, K3 (localize and
converge), K4, K5 and K6a, run on the CPU under the emulator of
``tests/_cuda_emu.py`` against their plain float32 versions.

Tolerances, and why:

* K1 and K4 (f32 products with f32 sums of n terms): within sqrt(n)
  units of f32 rounding times the sum of the terms' magnitudes, entry by
  entry (the kernel's FMA chain and the plain BLAS product sum in other
  orders, n roundings each, whose errors grow as sqrt(n) where rounding
  behaves randomly; n eps is the worst case).
* K2: the kernel's bracket is the plain grid's argmax, or a point whose
  plain lml is within 1e-5 of the row's maximum (f32 sums in another
  order break a tie either way), and the argmax itself wherever the plain
  maximum leads the runner-up by more than 1e-6; the brackets are the
  f32-rounded grid logits.
* K3's localize: the Newton steps run in f32, so the kernel's and the
  plain version's iterates part at f32 rounding; the f64 lml evaluated
  there agrees to 1e-6 of max(|lml|, 1) (the optimum is flat), and the
  argmax over rho is the plain one wherever the plain lmls of the two
  do not tie within that.  The converge (f64 arithmetic on the same f32
  tensors from the same start) at rtol 1e-9, as the f64 converge's tests.
* K5 (f64 arithmetic on the widened f32 operands) at 1e-10 of each
  output's largest entry, as the f64 instantiation's tests.
* K6a in f32: within 1e-5 of each matrix's largest |lambda| at C = 3, 10,
  31, 32 (Jacobi), 33 and 50 (Householder and bisection), NaN exactly for
  a matrix with a NaN entry.

Each runs with a gene axis where the kernel has one (K2, K3, K4, K5).
"""
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from _cuda_emu import emulated, nan_outputs  # noqa: F401
from _torch_inputs import (captured, fit_dataset, kr_inputs, rotate_inputs,
                           score_gene_inputs, k_best_pattern)
from cellregmap_tpu_torch import engine
from cellregmap_tpu_torch.kernels import best_rho_rotate as k4
from cellregmap_tpu_torch.kernels import delta_grid as k2
from cellregmap_tpu_torch.kernels import kr_contract as k1
from cellregmap_tpu_torch.kernels import reml_newton as k3
from cellregmap_tpu_torch.kernels import score_core as k5
from cellregmap_tpu_torch.kernels import sym_eigvalsh as k6a

EPS32 = float(torch.finfo(torch.float32).eps)
DELTA_CFG = (-18.0, 18.0, 40, 60)
f32 = torch.float32


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("cuda_emu_f32")
    out = {}
    for name, mod in (("kr_contract", k1), ("delta_grid", k2),
                      ("reml_newton", k3), ("best_rho_rotate", k4),
                      ("score_core", k5), ("sym_eigvalsh", k6a)):
        (workdir / name).mkdir()
        out[name] = emulated(name, workdir / name)
        mod._bind(out[name])
    return out


def _sums_close(got, want, bound, n_terms):
    """|got - want| within sqrt(n_terms) eps(f32) of the terms'
    magnitudes."""
    err = (got.double() - want.double()).abs()
    tol = np.sqrt(n_terms) * EPS32
    assert bool((err <= tol * bound + 1e-30).all()), \
        float((err / (bound + 1e-30)).max() / EPS32)


@pytest.mark.parametrize("K,S", [(23, 37), (70, 70)])
def test_kr_contract_f32_matches_plain(libs, K, S):
    """Partial tiles on both axes; 97 cells (six chunks, the last
    ragged)."""
    U, V, G = (torch.as_tensor(a, dtype=f32) for a in kr_inputs(K + S, K=K,
                                                                 S=S))
    got = k1.call(libs["kr_contract"], U, V, G)
    want = k1.kr_contract_plain(U, V, G)
    assert got.dtype == f32 and got.shape == want.shape
    bound = k1.kr_contract_plain(U.double().abs(), V.double().abs(),
                                 G.double().abs())
    _sums_close(got, want, bound, U.shape[0])


@pytest.mark.parametrize("pattern", ["one", "distinct", "random"])
def test_best_rho_rotate_f32_matches_plain(libs, pattern):
    """Three genes' best rho over five points: each distinct (rho,
    variant) pair rotated once, in f32."""
    V, T, _ = rotate_inputs(11, R=70, C=3, S=23)
    kb = torch.as_tensor(k_best_pattern(pattern, 3, 5, 23,
                                        np.random.default_rng(5)))
    V, T = torch.as_tensor(V, dtype=f32), torch.as_tensor(T, dtype=f32)
    At, slot = k4.call(libs["best_rho_rotate"], V, T, kb)
    At_p, slot_p = k4.best_rho_rotate_plain(V, T, kb)
    assert At.dtype == f32 and torch.equal(slot, slot_p)
    bound = k4.gather(k4.best_rho_rotate_plain(V.double().abs(),
                                               T.double().abs(), kb)[0],
                      slot_p)
    _sums_close(k4.gather(At, slot), k4.gather(At_p, slot_p), bound,
                V.shape[1])


@pytest.mark.parametrize("pattern", ["one", "distinct"])
def test_score_core_f32_operands_match_plain(libs, pattern):
    """f32 factors, rows and Grams, f64 v0 and v1: the kernel widens as it
    loads, the plain version first."""
    args = score_gene_inputs(5, 3, pattern)
    args = [a.to(f32) if a.dtype == torch.float64 and i < 13 else a
            for i, a in enumerate(args)]
    Q, Wmat = k5.call(libs["score_core"], *args)
    Qr, Wr = k5.score_core_plain(*args)
    assert Q.dtype == torch.float64
    for got, want in ((Q, Qr), (Wmat, Wr)):
        err = float((got - want).abs().max())
        assert err <= 1e-10 * float(want.abs().max()), err


def _f32_batch(seed, genes=1, p=1, nrho=3):
    """The float32 context of a small dataset (R = 44 rows) and the
    arguments the engine gives K2 and K3 on it (one phenotype, or
    ``genes`` on a gene axis)."""
    ctx, G, n = fit_dataset(seed, p=p, nrho=nrho, n=70, donors=10, S=6)
    if genes > 1:
        rng = np.random.default_rng(seed)
        Y = ctx.y[None] + 0.6 * torch.as_tensor(rng.normal(size=(genes, n)))
        ctx = ctx._replace(y=Y, Zy=Y @ ctx.Z, Wy=Y @ ctx.W,
                           yy=(Y * Y).sum(dim=1))
    ctx = engine.NullContext(*(t.to(f32) for t in ctx))
    G = G.to(f32)
    return captured(lambda: engine.interaction_batch(
        ctx, G, G, n, delta_cfg=DELTA_CFG), ["delta_grid", "reml_localize",
                                             "reml_converge"])


@pytest.mark.parametrize("genes,p", [(1, 1), (3, 1), (1, 4), (2, 7)])
def test_delta_grid_f32_matches_plain(libs, genes, p):
    (args, kw), = _f32_batch(genes + 10 * p, genes, p)["delta_grid"]
    assert args[0].dtype == f32 and args[9] == f32
    br_lo, br_hi = k2.call(libs["delta_grid"], *args, **kw)
    lo_p, hi_p, lml = k2.delta_grid_plain(*args, **kw, return_lml=True)
    # the f32-rounded logits, widened exactly
    assert torch.equal(br_lo.to(f32).double(), br_lo)
    gs = br_lo.shape[:-2]
    for g in np.ndindex(*gs):
        gap = k2.bracket_shortfall(br_lo[g], br_hi[g], lml[g], -18.0, 18.0,
                                   f32)
        assert gap <= 1e-5, gap
    # the plain bracket itself wherever the plain grid resolves its
    # maximum (the runner-up more than 1e-6 below it: outside the two f32
    # programs' rounding); at a near-tie either neighbour, within 1e-5
    same = (br_lo == lo_p) & (br_hi == hi_p)
    top2 = lml.topk(2, dim=-1).values
    resolved = (top2[..., 0] - top2[..., 1]) > 1e-6 * top2[..., 0].abs()
    assert bool(resolved.any()) and bool(same[resolved].all())


@pytest.mark.parametrize("genes,p", [(1, 1), (3, 1), (1, 4), (2, 7)])
def test_reml_localize_and_converge_f32_match_plain(libs, genes, p):
    calls = _f32_batch(genes + 20 * p, genes, p)
    (args, kw), = calls["reml_localize"]
    x, lml_all, k_best = k3.call_localize(libs["reml_newton"], *args, **kw)
    x_p, lml_p, k_p = k3.reml_localize_plain(*args, **kw)
    # x is the f32 state, widened
    assert torch.equal(x.to(f32).double(), x)
    scale = lml_p.abs().clamp(min=1.0)
    assert float(((lml_all - lml_p).abs() / scale).max()) <= 1e-6
    best = lml_p.amax(dim=-1, keepdim=True)
    at_k = lml_p.gather(-1, k_best[..., None])
    assert bool(((best - at_k) <= 1e-6 * best.abs().clamp(min=1.0)).all())
    assert float((k_best == k_p).double().mean()) >= 0.9
    (cargs, ckw), = calls["reml_converge"]
    got = k3.call_converge(libs["reml_newton"], *cargs, **ckw)
    want = k3.reml_converge_plain(*cargs, **ckw)
    for g, w, name in zip(got, want, ("delta", "lml", "scale", "beta")):
        assert g.dtype == torch.float64 and g.shape == w.shape
        assert_allclose(g.numpy(), w.numpy(), rtol=1e-9, atol=1e-12,
                        err_msg=name)


def _weight_matrices(C):
    """K5's weight matrices at C contexts, rounded to f32, then a
    rank-deficient one, the zero matrix, a repeated-eigenvalue one and
    one with a NaN entry."""
    args = score_gene_inputs(C, 1, "one", C=C, p=1, n=80, R=37, S=3,
                             nrho=2)
    _, Wmat = k5.score_core_plain(*args)
    rng = np.random.default_rng(C)
    B = rng.normal(size=(C, max(C // 2, 1)))
    Qm = np.linalg.qr(rng.normal(size=(C, C)))[0]
    rep = Qm @ np.diag(np.r_[np.full(C // 2, 2.0),
                             np.ones(C - C // 2)]) @ Qm.T
    nan = rng.normal(size=(C, C))
    nan[C // 2, C - 1] = np.nan
    more = torch.as_tensor(np.stack([B @ B.T, np.zeros((C, C)), rep, nan]))
    return torch.cat([Wmat[0], more]).to(f32)


@pytest.mark.parametrize("C", [3, 10, 31, 32, 33, 50])
def test_sym_eigvalsh_f32_routes_match_plain(libs, C):
    A = _weight_matrices(C)
    lam, sweeps = k6a.call(libs["sym_eigvalsh"], A, return_sweeps=True)
    want = k6a.sym_eigvalsh_plain(A)
    assert lam.dtype == f32
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(lam), nan)
    assert bool(nan[-1].all()) and not bool(nan[:-1].any())
    lam, want = lam[:-1].double(), want[:-1].double()
    scale = want.abs().amax(dim=1, keepdim=True).clamp(min=1e-30)
    assert float(((lam - want).abs() / scale).max()) <= 1e-5
    assert bool((lam[:, 1:] >= lam[:, :-1]).all()) and bool((lam >= 0).all())
    cap = k6a.MAX_SWEEPS if C <= k6a.WARP_MAX_C else k6a.MAX_BISECT
    assert 0 < int(sweeps[:-1].max()) < cap and int(sweeps[-1]) == 0
