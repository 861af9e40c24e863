"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU: the ``cuda`` fixture skips it, with
its reason, where there is none (as on a CPU-only test machine).  The file
imports neither jax nor the JAX package, so it runs on a machine with the
card and no jax:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerance: the kernels sum in another order than cuBLAS/torch, so the
outputs agree at 1e-12 of their largest entry (1e-10 for K5, whose K0^{-1}
forms subtract nearly equal Grams).
"""
import numpy as np
import pytest
import torch

from _torch_inputs import kr_inputs, rotate_inputs, score_inputs

CASES = [(C, p) for C in (3, 10, 50) for p in (1, 2)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _close(got, want, rel):
    err = float((got - want).abs().max())
    assert err <= rel * float(want.abs().max()), err


@pytest.mark.cuda
@pytest.mark.parametrize("C,p", CASES)
def test_kr_contract_kernel_matches_plain(cuda, C, p):
    from cellregmap_tpu_torch.kernels import kr_contract as k1

    U, _, G = (torch.as_tensor(a, device=cuda)
               for a in kr_inputs(C + p, n=301, K=71, S=130))
    for width in (C, p):
        V = torch.as_tensor(np.random.default_rng(width).normal(
            size=(U.shape[0], width)), device=cuda)
        before = k1.launches
        got = k1.kr_contract(U, V, G)
        assert k1.launches == before + 1
        _close(got, k1.kr_contract_plain(U, V, G), 1e-12)


@pytest.mark.cuda
@pytest.mark.parametrize("C,p", CASES)
def test_best_rho_rotate_kernel_matches_plain(cuda, C, p):
    from cellregmap_tpu_torch.kernels import best_rho_rotate as k4

    V, T, kb = (torch.as_tensor(a, device=cuda)
                for a in rotate_inputs(C + p, R=201, C=C, S=33 + p))
    before = k4.launches
    got = k4.best_rho_rotate(V, T, kb)
    assert k4.launches == before + 1
    _close(got, k4.best_rho_rotate_plain(V, T, kb), 1e-12)


@pytest.mark.cuda
@pytest.mark.parametrize("C,p", CASES)
def test_score_core_kernel_matches_plain(cuda, C, p):
    from cellregmap_tpu_torch.kernels import score_core as k5

    args = [torch.as_tensor(a, device=cuda)
            for a in score_inputs(C + p, C=C, p=p, n=160, R=130, S=21)]
    before = k5.launches
    Q, Wmat = k5.score_core(*args)
    assert k5.launches == before + 1
    Qr, Wr = k5.score_core_plain(*args)
    _close(Q, Qr, 1e-10)
    _close(Wmat, Wr, 1e-10)


@pytest.mark.cuda
def test_interaction_batch_never_syncs(cuda):
    """The batch program enqueues its work without waiting for the card:
    torch's sync debug mode raises on any synchronising call inside it."""
    from cellregmap_tpu_torch import engine

    rng = np.random.default_rng(1)
    n, C, donors, S = 200, 5, 20, 32
    E = rng.normal(size=(n, C)) / np.sqrt(C)
    hK = np.zeros((n, donors))
    hK[np.arange(n), np.arange(n) % donors] = 1.0
    y = rng.normal(size=n)
    ctx = engine.build_null_context(y, None, E, hK=hK, device=cuda)
    G = torch.as_tensor(rng.binomial(2, 0.3, size=(n, S)).astype(float),
                        device=cuda)
    engine.interaction_batch(ctx, G, G, n)      # builds and loads kernels
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = engine.interaction_batch(ctx, G, G, n)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert bool(torch.isfinite(out["Q"]).all())


@pytest.mark.cuda
def test_scan_on_card_matches_cpu(cuda):
    """A small scan on the card equals the same scan on the CPU (plain
    versions), and every batch went through the three kernels."""
    import cellregmap_tpu_torch as crp
    from cellregmap_tpu_torch import kernels

    rng = np.random.default_rng(0)
    n, C, donors, S = 300, 4, 30, 50
    E = rng.normal(size=(n, C)) / np.sqrt(C)
    hK = np.zeros((n, donors))
    hK[np.arange(n), np.arange(n) % donors] = 1.0
    G = rng.binomial(2, 0.3, size=(n, S)).astype(float)
    y = rng.normal(size=n) + 0.5 * G[:, 3] * E[:, 0]
    cfg = crp.ScanConfig(snp_batch=16)
    kernels.reset_launches()
    pv_g, info_g = crp.run_interaction(y, E, G, hK=hK, config=cfg,
                                       device=cuda)
    assert kernels.launch_counts() == {"kr_contract": 12,
                                       "best_rho_rotate": 4,
                                       "score_core": 4}
    pv_c, info_c = crp.run_interaction(y, E, G, hK=hK, config=cfg,
                                       device="cpu")
    assert np.max(np.abs(pv_g - pv_c)) <= 1e-8
    assert np.array_equal(info_g["rho1"], info_c["rho1"])
