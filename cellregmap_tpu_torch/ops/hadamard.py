"""Hadamard-product low-rank factorization (host NumPy).

The background kernel K (.) EE^T never needs to be materialized: with the
thin SVD E = U diag(s) V^T,

    K (.) EE^T = sum_i L_i L_i^T,   L_i = diag(u_i * s_i) @ hK,

where hK hK^T = K (the reference's ``get_L_values``,
_cellregmap.py:533-545).  A copy of ``cellregmap_tpu.ops.hadamard``.
"""
from __future__ import annotations

import numpy as np


def _economic_svd(E):
    """Thin SVD with numpy_sugar's absolute cutoff sqrt(eps) on singular
    values (numpy_sugar.linalg.economic_svd semantics)."""
    E = np.asarray(E, float)
    U, s, _ = np.linalg.svd(E, full_matrices=False)
    keep = s >= np.sqrt(np.finfo(float).eps)
    return U[:, keep], s[keep]


def get_L_values(hK, E):
    """List of factors L_i with sum_i L_i L_i^T = (hK hK^T) (.) (E E^T),
    one (n x k) array per retained singular vector of E."""
    hK = np.asarray(hK, float)
    U, s = _economic_svd(E)
    us = U * s[None, :]
    return [us[:, i : i + 1] * hK for i in range(us.shape[1])]
