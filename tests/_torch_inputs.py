"""Seeded NumPy inputs for the kernel tests of the PyTorch port.

The arrays are consistent with the interaction scan's algebra: each rho has
an orthonormal rotation of the cells, of which the first R rows play the
eigenbasis and the rest the complement, so the full-space Grams exceed
their eigenbasis parts by a PSD complement, as in the engine.
"""
import numpy as np


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
    (Sv, WGt, yt, At, WW, Wy, Wg, gg, gy, AW, Ag, Ay, AtA, k_best, v0, v1).
    """
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
    At = np.stack([(Qn[k_best[s]].T @ A[:, :, s])[:R] for s in range(S)])
    AW = np.einsum("ncs,nj->cjs", A, W)
    Ag = np.einsum("ncs,ns->cs", A, G)
    Ay = np.einsum("ncs,n->cs", A, y)
    AtA = np.einsum("ncs,nds->cds", A, A)
    v0 = np.abs(rng.normal(size=S)) + 0.2
    v1 = np.abs(rng.normal(size=S)) + 0.5
    return (Sv, WGt, yt, At, W.T @ W, W.T @ y, W.T @ G, (G * G).sum(0),
            G.T @ y, AW, Ag, Ay, AtA, k_best, v0, v1)
