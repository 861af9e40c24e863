"""The plain versions of the port's kernels against the JAX engine, on the
CPU, and the wrappers' CPU dispatch.

K1 ``kr_contract`` against ``engine._kr_contract``; K4 ``best_rho_rotate``
against the engine's masked rotation loop (engine.py:684-688); K5
``score_core`` against ``engine.score_test_core`` per variant.  The CUDA
kernels themselves are held against these plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py.

Tolerances: the same f64 contractions summed in another order (BLAS vs
XLA) differ by ~n ulp of the largest partial sum, so results are compared
at 1e-12 of the output's largest entry; K5's K0^{-1} forms subtract the
eigenbasis part from the full-space Gram, which can cancel a few digits,
so it is compared at 1e-10 of the largest entry.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from _torch_inputs import kr_inputs, rotate_inputs, score_inputs
from cellregmap_tpu import engine as jengine
from cellregmap_tpu_torch.kernels import best_rho_rotate as k4
from cellregmap_tpu_torch.kernels import kr_contract as k1
from cellregmap_tpu_torch.kernels import score_core as k5

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
    got = k4.best_rho_rotate_plain(torch.as_tensor(V), torch.as_tensor(T),
                                   torch.as_tensor(kb))
    _close(got, want, 1e-12)


@pytest.mark.parametrize("C,p", CASES)
def test_score_core_plain_matches_jax(C, p):
    args = score_inputs(100 * C + p, C=C, p=p)
    (Sv, WGt, yt, At, WW, Wy, Wg, gg, gy, AW, Ag, Ay, AtA, kb, v0,
     v1) = args
    Q, Wmat = k5.score_core_plain(*[torch.as_tensor(a) for a in args])
    S = At.shape[0]
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


def _cpu_calls():
    U, V, G = (torch.as_tensor(a) for a in kr_inputs(1))
    Vr, T, kb = (torch.as_tensor(a) for a in rotate_inputs(2))
    args = [torch.as_tensor(a) for a in score_inputs(3)]
    return [
        (k1, lambda: k1.kr_contract(U, V, G),
         lambda: k1.kr_contract_plain(U, V, G)),
        (k4, lambda: k4.best_rho_rotate(Vr, T, kb),
         lambda: k4.best_rho_rotate_plain(Vr, T, kb)),
        (k5, lambda: k5.score_core(*args),
         lambda: k5.score_core_plain(*args)),
    ]


@pytest.mark.parametrize("which", [0, 1, 2])
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
    args[13] = torch.zeros(args[13].shape, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        k5.score_core(*args)
    assert (k1.launches, k4.launches, k5.launches) == before


def test_score_core_rejects_too_many_columns():
    args = [torch.as_tensor(a) for a in score_inputs(5, C=62)]
    args = [a.to("meta") for a in args]
    with pytest.raises(ValueError, match="C \\+ p \\+ 2"):
        k5.score_core(*args)
