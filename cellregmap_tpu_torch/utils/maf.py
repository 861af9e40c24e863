"""Minor-allele frequencies (reference _cellregmap.py:589-638), NumPy.

The port's own copy of ``cellregmap_tpu.utils.maf.compute_maf`` for NumPy
arrays: the port never imports the JAX package.
"""
from __future__ import annotations

import numpy as np


def compute_maf(X):
    """Minor allele frequency of each column of ``X`` (samples on axis 0,
    variants on axis 1), which encodes 0, 1, 2 (allele counts or dosage)
    with NaN for missing values."""
    X = np.asarray(X, float)
    s0 = np.nansum(X, axis=0) / (2 * np.logical_not(np.isnan(X)).sum(axis=0))
    return np.minimum(s0, 1 - s0)
