"""Seeded inputs for the kernel tests of the PyTorch port.

The NumPy arrays are consistent with the interaction scan's algebra: each
rho has an orthonormal rotation of the cells, of which the first R rows
play the eigenbasis and the rest the complement, so the full-space Grams
exceed their eigenbasis parts by a PSD complement, as in the engine.  The
fit kernels take their operands from the engine itself: a small dataset's
null context (:func:`fit_dataset`) run through the engine with the
wrappers' arguments recorded (:func:`captured`).

:func:`jax_davies_library` keeps the JAX reference's Davies p-values
steady under pytest-xdist (import it into a test module: it is autouse).
"""
import os

import numpy as np
import pytest


@pytest.fixture(scope="module", autouse=True)
def jax_davies_library(tmp_path_factory):
    """The JAX package's native Davies library, loaded in this process.

    The package compiles it at first use into one cache file shared by
    every process (``cellregmap_tpu/utils/native.py``) and loads it once
    a process.  A worker that finds the file while another worker is still
    writing it fails to load it and, for the rest of its life, takes the
    package's Python ladder (Imhof / modified Liu) instead: interaction
    p-values up to 1.9e-7 away from Davies' (seen on
    ``test_interaction_p8_matches_jax`` under six workers, and reproduced
    with a truncated library in a fresh cache).  Where this process's load
    failed, the library is built again into a cache of the worker's own and
    loaded from there, so the reference is the package's Davies path."""
    from cellregmap_tpu.utils import native

    if native.get_qfc() is None:
        saved = os.environ.get("CELLREGMAP_TPU_CACHE")
        os.environ["CELLREGMAP_TPU_CACHE"] = str(
            tmp_path_factory.mktemp("jax_qfc"))
        try:
            native._TRIED = False
            native.get_qfc()
        finally:
            if saved is None:
                del os.environ["CELLREGMAP_TPU_CACHE"]
            else:
                os.environ["CELLREGMAP_TPU_CACHE"] = saved
    assert native.get_qfc() is not None, \
        "the JAX package's Davies library did not load"


def kr_inputs(seed, n=97, K=23, p=3, S=37):
    """U (n, K), V (n, p), G (n, S) for the Khatri-Rao contraction."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, K)), rng.normal(size=(n, p)),
            rng.normal(size=(n, S)))


def rotate_inputs(seed, nrho=5, R=41, C=3, S=19):
    """V (nrho, R, R) orthonormal, T (R, C, S), k_best (S,) covering every
    rho."""
    rng = np.random.default_rng(seed)
    V = np.stack([np.linalg.qr(rng.normal(size=(R, R)))[0]
                  for _ in range(nrho)])
    T = rng.normal(size=(R, C, S))
    k_best = rng.permutation(np.arange(S) % nrho).astype(np.int64)
    return V, T, k_best


def score_inputs(seed, C=3, p=1, n=64, R=40, S=9, nrho=4):
    """The positional arguments of ``score_core`` as numpy arrays:
    (Sv, WGt, yt, At, WW, Wy, Wg, gg, gy, AW, Ag, Ay, AtA, k_best, v0, v1,
    slot).  At holds two slots in K4's layout (2, S, R, C): variant s's
    factor in slot s % 2 (``slot``), a decoy of other values in the
    other."""
    rng = np.random.default_rng(seed)
    W = np.concatenate([np.ones((n, 1)), rng.normal(size=(n, p - 1))], 1)
    E0 = rng.normal(size=(n, C)) / np.sqrt(C)
    G = rng.normal(size=(n, S))
    y = rng.normal(size=n) + 0.3 * G[:, 0] * E0[:, 0]
    Qn = [np.linalg.qr(rng.normal(size=(n, n)))[0] for _ in range(nrho)]
    Sv = np.abs(rng.normal(size=(nrho, R))) * 2.0
    Sv[:, -3:] = 0.0                          # padded (inert) directions
    WG = np.concatenate([W, G], axis=1)
    WGt = np.stack([(Q.T @ WG)[:R] for Q in Qn])          # (nrho, R, p+S)
    yt = np.stack([(Q.T @ y)[:R] for Q in Qn])            # (nrho, R)
    k_best = (np.arange(S) % nrho).astype(np.int64)
    A = G[:, None, :] * E0[:, :, None]                    # (n, C, S)
    At1 = np.stack([(Qn[k_best[s]].T @ A[:, :, s])[:R] for s in range(S)])
    slot = (np.arange(S) % 2).astype(np.int64)
    At = np.empty((2,) + At1.shape)
    At[slot, np.arange(S)] = At1
    At[1 - slot, np.arange(S)] = 100.0 * np.random.default_rng(
        seed + 1).normal(size=At1.shape)
    AW = np.einsum("ncs,nj->cjs", A, W)
    Ag = np.einsum("ncs,ns->cs", A, G)
    Ay = np.einsum("ncs,n->cs", A, y)
    AtA = np.einsum("ncs,nds->cds", A, A)
    v0 = np.abs(rng.normal(size=S)) + 0.2
    v1 = np.abs(rng.normal(size=S)) + 0.5
    return (Sv, WGt, yt, At, W.T @ W, W.T @ y, W.T @ G, (G * G).sum(0),
            G.T @ y, AW, Ag, Ay, AtA, k_best, v0, v1, slot)


def k_best_pattern(pattern, genes, nrho, S, rng):
    """(genes, S) best rho: every gene at a variant's one rho ("one"), each
    at its own ("distinct", genes <= nrho) or drawn (else)."""
    if pattern == "one":          # every gene at one rho (a variant's own)
        kb = np.tile(np.arange(S) % nrho, (genes, 1))
    elif pattern == "distinct":   # every gene at its own rho
        kb = np.stack([rng.permutation(nrho)[:genes] for _ in range(S)]).T
    else:
        kb = rng.integers(0, nrho, size=(genes, S))
    return np.ascontiguousarray(kb, dtype=np.int64)


def score_gene_inputs(seed, genes, pattern, C=3, p=2, n=64, R=37, S=5,
                      nrho=4, device="cpu"):
    """``score_core``'s positional arguments with a gene axis: each gene's
    phenotype seeded apart, its best rho by ``pattern``, the factors in
    K4's slots (each distinct (rho, variant) pair once; NaN in the slots
    that no gene uses) and every Gram consistent with the rotations (the
    complements PSD, as the engine's); ``device`` the tensors'."""
    import torch

    from cellregmap_tpu_torch.kernels.best_rho_rotate import slots

    rng = np.random.default_rng(seed)
    W = np.concatenate([np.ones((n, 1)), rng.normal(size=(n, p - 1))], 1)
    E0 = rng.normal(size=(n, C)) / np.sqrt(C)
    G = rng.normal(size=(n, S))
    Y = rng.normal(size=(genes, n)) + 0.3 * G[:, 0] * E0[:, 0]
    Qn = [np.linalg.qr(rng.normal(size=(n, n)))[0] for _ in range(nrho)]
    Sv = np.abs(rng.normal(size=(nrho, R))) * 2.0
    Sv[:, -3:] = 0.0                          # padded (inert) directions
    WGt = np.stack([(Q.T @ np.concatenate([W, G], 1))[:R] for Q in Qn])
    yt = np.stack([np.stack([(Q.T @ y)[:R] for Q in Qn]) for y in Y])
    kb = k_best_pattern(pattern, genes, nrho, S, rng)
    slot, rank = slots(torch.as_tensor(kb), nrho)
    A = G[:, None, :] * E0[:, :, None]                    # (n, C, S)
    At = np.full((min(genes, nrho), S, R, C), np.nan)
    for k in range(nrho):
        for s in range(S):
            if rank[k, s] >= 0:
                At[int(rank[k, s]), s] = (Qn[k].T @ A[:, :, s])[:R]
    arrays = (Sv, WGt, yt, At, W.T @ W, Y @ W, W.T @ G, (G * G).sum(0),
              Y @ G, np.einsum("ncs,nj->cjs", A, W),
              np.einsum("ncs,ns->cs", A, G), np.einsum("ncs,gn->gcs", A, Y),
              np.einsum("ncs,nds->cds", A, A), kb,
              np.abs(rng.normal(size=(genes, S))) + 0.2,
              np.abs(rng.normal(size=(genes, S))) + 0.5)
    return [torch.as_tensor(np.ascontiguousarray(a), device=device)
            for a in arrays] + [slot.to(device)]


def fit_dataset(seed, p=1, nrho=3, n=80, C=3, donors=8, S=7, device="cpu",
                rho_grid=None):
    """A small interaction/association problem on ``device``: the port's
    null context over ``nrho`` rho points (``rho_grid``, else evenly
    spaced in [0, 1]; E + K (.) EE^T background, R = C (donors + 1)),
    genotypes G (n, S) as a tensor, and n."""
    import torch

    from cellregmap_tpu_torch import engine
    from cellregmap_tpu_torch.ops.hadamard import get_L_values

    rng = np.random.default_rng(seed)
    E = rng.normal(size=(n, C)) / np.sqrt(C)
    W = np.concatenate([np.ones((n, 1)), rng.normal(size=(n, p - 1))], 1)
    hK = np.zeros((n, donors))
    hK[np.arange(n), np.arange(n) % donors] = 1.0
    G = rng.binomial(2, 0.3, size=(n, S)).astype(float)
    G = (G - G.mean(0)) / np.maximum(G.std(0), 1e-9)
    y = (rng.normal(size=n) + 0.5 * E @ rng.normal(size=C)
         + 0.4 * hK @ rng.normal(size=donors) + 0.5 * G[:, 1] * E[:, 0])
    ctx = engine.build_null_context(y, W, E, Ls=get_L_values(hK, E),
                                    rho_grid=(np.linspace(0, 1, nrho)
                                              if rho_grid is None
                                              else rho_grid),
                                    device=device)
    return ctx, torch.as_tensor(G, device=device), n


def captured(run, names):
    """Run ``run()`` with the engine's kernel wrappers ``names`` recording
    their positional and keyword arguments; returns name -> [(args, kw)]."""
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


def betas_dataset(seed, p=1, n=80, C=3, donors=8, S=5, device="cpu"):
    """A small effect-size problem on ``device``: the port's betas context
    (background K (.) EE^T, Rk = C donors, rank permitting), genotypes G
    (n, S) and their MAF norms as tensors, and n."""
    import torch

    from cellregmap_tpu_torch import engine
    from cellregmap_tpu_torch.ops.hadamard import get_L_values

    rng = np.random.default_rng(seed)
    E = rng.normal(size=(n, C)) / np.sqrt(C)
    W = np.concatenate([np.ones((n, 1)), rng.normal(size=(n, p - 1))], 1)
    hK = np.zeros((n, donors))
    hK[np.arange(n), np.arange(n) % donors] = 1.0
    G = rng.binomial(2, 0.3, size=(n, S)).astype(float)
    y = (rng.normal(size=n) + 0.5 * E @ rng.normal(size=C)
         + 0.4 * hK @ rng.normal(size=donors) + 0.6 * G[:, 1] * E[:, 0])
    bctx = engine.build_betas_context(y, W, E, get_L_values(hK, E),
                                      device=device)
    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    return bctx, t(G), t(np.linspace(1.1, 1.9, S)), n


def tail_battery(seed, n=48, C=10):
    """(Q, lam) numpy pairs spanning the device tails' branches: random
    spectra with zero padding, Q from below the mean into the deep tail, a
    pair at the mean, a pair with lambda_max <= 0 (all zero: NaN in both
    packages), one far in the tail and rank-1 spectra (for non-negative
    weights s1^2 <= s2 by Cauchy-Schwarz, so Liu's noncentral branch is
    taken only where one weight is non-zero and rounding tips the
    equality)."""
    rng = np.random.default_rng(seed)
    lam = np.abs(rng.normal(size=(n, C))) * 10.0 ** rng.integers(
        -3, 2, size=(n, 1))
    lam[: n // 4, C // 2:] = 0.0
    q = lam.sum(1) * 10.0 ** rng.uniform(-1.0, 1.3, size=n)
    q[0] = lam[0].sum()
    lam[1] = 0.0
    q[2] = lam[2].sum() * 40.0
    q[3] = lam[3].max() * 120.0
    lam[4:8, 1:] = 0.0
    return q, lam


def assert_tails_close(got, want, rtol=1e-9):
    """Tail p-values (arrays or tensors) at ``rtol`` relative with an
    absolute floor of 1e-300, NaN exactly where ``want`` is NaN."""
    got, want = (np.asarray(t.cpu() if hasattr(t, "cpu") else t)
                 for t in (got, want))
    nan = np.isnan(want)
    assert np.array_equal(np.isnan(got), nan)
    gap = np.abs(got - want)[~nan] - rtol * np.abs(want)[~nan]
    assert gap.max() <= 1e-300, gap.max()
