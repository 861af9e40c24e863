"""Low-rank structured covariance algebra in torch (the JAX package's
``ops/lowrank.py``): the API shims of the reference's covariance layer
(cellregmap/_math.py:40-128: ``QSCov``, ``PMat``, ``ScoreStatistic``)
and numpy_sugar's ``economic_qs_linear`` / ``economic_qs``.

Every function works on tensors on the device of its inputs.  Anything
else is taken as a float64 tensor on the device of the object it meets, or
else on ``device``: the card unless the caller asks for the CPU
(``device="cpu"``), as every entry point of the port.  The
factorizations are the library's (``torch.linalg.eigh``, ``qr``,
``eigvalsh``, ``pinv``), outside any kernel of the scans, as the JAX
package's are XLA's.

Each covariance is kept as a half-factor, and solves use the eigen
identity

    (a Q S Q^T + b I)^{-1} v = (Q diag(1/(1+(a/b)S)) Q^T v + v - Q Q^T v) / b

(_math.py:58-76) in O(n r).  Zero eigenvalues are inert in every formula
below (a direction with S_i = 0 behaves exactly like the orthogonal
complement), so rank padding needs no masking.
"""
from __future__ import annotations

import numpy as np
import torch


def _tensor(x, like: torch.Tensor | None = None,
            device=None) -> torch.Tensor:
    """``x`` as a tensor: a tensor as it is (moved to ``like``'s device),
    anything else with ``like``'s dtype and device, or as float64 on
    ``device`` (None: the card, raising without one)."""
    if isinstance(x, torch.Tensor):
        return x if like is None else x.to(like.device)
    if like is not None:
        return torch.as_tensor(np.asarray(x), dtype=like.dtype,
                               device=like.device)
    from ..api import _resolve_device     # api imports this package
    return torch.as_tensor(np.asarray(x, np.float64),
                           device=_resolve_device(device))


def orthonormal_basis(F, device=None) -> torch.Tensor:
    """Orthonormal basis Z (n x R, R = min(n, m)) of span(F) for F (n x m).

    Extra columns beyond rank(F) are harmless: they receive zero eigenvalues
    in any Gram built on top of Z and are inert downstream.
    """
    return torch.linalg.qr(_tensor(F, device=device), mode="reduced")[0]


def gram_eigh(G, device=None):
    """Eigendecomposition of a PSD Gram matrix with eigenvalues clamped >= 0.

    Returns ``(S, V)`` with ``G ~= V diag(S) V^T``, S ascending.
    """
    G = _tensor(G, device=device)
    S, V = torch.linalg.eigh((G + G.T) / 2)
    return torch.clamp(S, min=0.0), V


def economic_qs_linear(G, device=None):
    """Economic eigendecomposition of ``G @ G.T`` from the factor ``G``.

    numpy_sugar's ``economic_qs_linear`` (consumed at the reference's
    cellregmap/_cellregmap.py:17).  Returns ``(Q0, S0)`` with ``G G^T ~=
    Q0 diag(S0) Q0^T`` and R = min(n, m) columns; zero eigenvalues are
    kept (inert), with their columns zeroed.
    """
    G = _tensor(G, device=device)
    n, m = G.shape
    if m > n:
        S, V = gram_eigh(G @ G.T)
        return V, S
    S, V = gram_eigh(G.T @ G)
    # columns with S ~ 0 are scaled noise: zero them out with S so that
    # they are exactly inert
    ok = S > torch.finfo(G.dtype).eps * max(n, m) * S.max()
    zero = torch.zeros_like(S)
    scale = torch.where(ok, torch.rsqrt(torch.where(ok, S, zero + 1.0)),
                        zero)
    return (G @ V) * scale[None, :], torch.where(ok, S, zero)


def economic_qs(K, device=None):
    """Economic eigendecomposition of a dense symmetric PSD matrix.

    The reference's local copy (_math.py:204-235) and numpy_sugar's
    ``economic_qs``: returns ``((Q0, Q1), S0)``, the eigenvectors split at
    the reference's cutoff sqrt(eps) (a host decision: the split's sizes
    depend on the values).
    """
    K = _tensor(K, device=device)
    S, Q = torch.linalg.eigh((K + K.T) / 2)
    ok = S >= float(np.sqrt(torch.finfo(K.dtype).eps))
    return (Q[:, ok], Q[:, ~ok]), S[ok]


def kinv_quad(ut, vt, uv, v0, v1, S, device=None):
    """Quadratic form u^T (v0 Q S Q^T + v1 I)^{-1} v from rotated coords.

    ``ut``, ``vt``: Q^T u and Q^T v (r x ...); ``uv``: the full inner
    products u^T v; ``v0``, ``v1``: the scalars of K = v0 Q S Q^T + v1 I;
    ``S``: eigenvalues (r,), zeros allowed.  Uses K^{-1} = (I - Q
    diag(omega) Q^T) / v1 with omega = v0 S / (v1 + v0 S).
    """
    ut = _tensor(ut, device=device)
    vt, uv, S = (_tensor(a, ut) for a in (vt, uv, S))
    omega = (v0 * S) / (v1 + v0 * S)
    corr = torch.einsum("r...,r,r...->...", ut, omega, vt)
    return (uv - corr) / v1


class QSCov:
    """``a K + b I`` with K = Q0 diag(S0) Q0^T (the reference's QSCov,
    _math.py:40-76)."""

    def __init__(self, Q0, S0, a=1.0, b=1.0, device=None):
        self._Q0 = _tensor(Q0, device=device)
        self._S0 = _tensor(S0, self._Q0)
        self._a = a
        self._b = b

    def _scaled(self, d, Qv):
        return d[:, None] * Qv if Qv.ndim == 2 else d * Qv

    def dot(self, v):
        v = _tensor(v, self._Q0)
        Qv = self._Q0.T @ v
        return (self._a * (self._Q0 @ self._scaled(self._S0, Qv))
                + self._b * v)

    def solve(self, v):
        v = _tensor(v, self._Q0)
        R0 = 1.0 / (1.0 + (self._a / self._b) * self._S0)
        Qv = self._Q0.T @ v
        return ((self._Q0 @ self._scaled(R0, Qv) + v - self._Q0 @ Qv)
                / self._b)

    def logdet(self):
        n, r = self._Q0.shape[0], self._S0.shape[0]
        return (torch.log(self._a * self._S0 + self._b).sum()
                + (n - r) * float(np.log(self._b)))


class PMat:
    """P = K^{-1} - K^{-1} W (W^T K^{-1} W)^{-1} W^T K^{-1}, matrix-free
    (the reference's PMat, _math.py:79-93); the inner solve takes lstsq
    semantics (the pseudo-inverse's rcond) like the reference's
    ``rsolve``."""

    def __init__(self, qscov: QSCov, W):
        self._qscov = qscov
        self._W = _tensor(W, qscov._Q0)
        self._KiW = qscov.solve(self._W)

    def dot(self, v):
        v = _tensor(v, self._W)
        Kiv = self._qscov.solve(v)
        A = self._W.T @ self._KiW
        Ainv = torch.linalg.pinv((A + A.T) / 2, hermitian=True)
        x = Ainv @ (self._KiW.T @ v)
        return Kiv - self._KiW @ x


class ScoreStatistic:
    """Q = 1/2 y^T P (dK) P y with dK given by its half-factor sqrt_dK (the
    reference's ScoreStatistic, _math.py:102-128)."""

    def __init__(self, P: PMat, K: QSCov, sqrt_dK):
        self._P = P
        self._K = K
        self._sqrt_dK = _tensor(sqrt_dK, P._W)

    def statistic(self, y):
        t = self._sqrt_dK.T @ self._P.dot(y)
        return (t * t).sum() / 2

    def matrix_for_dist_weights(self):
        return self._sqrt_dK.T @ self._P.dot(self._sqrt_dK) / 2

    def distr_weights(self):
        M = self.matrix_for_dist_weights()
        w = torch.linalg.eigvalsh((M + M.T) / 2)
        return w[w > 1e-16]
