"""Phenotype simulation framework (the port's own copy of
``cellregmap_tpu.sim``, NumPy only).

Semantics-compatible rebuild of the reference simulator
(cellregmap/_simulate.py:1-479): genotype sampling from MAF
under Hardy-Weinberg, block covariance/kinship builders with jitter,
variance budgeting summing to 1, exact empirical moment matching of each
phenotype component, and full phenotype generators returning ``Simulation``
namedtuples.  Host-side NumPy (data generation is not a device hot path);
the engine consumes the arrays directly.
"""
from __future__ import annotations

from collections import namedtuple
from typing import List, Union

import numpy as np
from numpy.random import Generator

from ._types import Term

Variances = namedtuple("Variances", "g gxe k e n")
Simulation = namedtuple(
    "Simulation", "mafs y offset beta_g y_g y_gxe y_k y_e y_n variances G E Lk Ls K M"
)


def sample_maf(n_snps: int, maf_min: float, maf_max: float, random: Generator):
    assert 0 <= maf_min <= maf_max <= 1
    return random.random(n_snps) * (maf_max - maf_min) + maf_min


def sample_genotype(n_samples: int, mafs, random: Generator):
    """Hardy-Weinberg trinomial draws per SNP (reference :39-47)."""
    G = []
    for maf in np.asarray(mafs, float):
        probs = [(1 - maf) ** 2, 1 - ((1 - maf) ** 2 + maf**2), maf**2]
        G.append(random.choice([0.0, 1.0, 2.0], p=probs, size=n_samples))
    return np.stack(G, axis=1)


def column_normalize(X):
    X = np.asarray(X, float)
    with np.errstate(divide="raise", invalid="raise"):
        return (X - X.mean(0)) / X.std(0)


def jitter(K, eps: float = 1e-8):
    """Small diagonal offset guaranteeing full-rankness (reference :96-101)."""
    K += eps * np.eye(K.shape[0])
    return K


def _symmetric_decomp(H):
    """Economic symmetric factor: U sqrt(S) with numpy_sugar's absolute
    singular-value cutoff sqrt(eps) ~ 1.49e-8 — this drops jitter-level
    modes, keeping factor widths at the block rank (reference :477-479)."""
    U, S, _ = np.linalg.svd(H, full_matrices=False)
    keep = S >= np.sqrt(np.finfo(float).eps)
    return U[:, keep] * np.sqrt(S[keep])[None, :]


def sample_covariance_matrix(n_samples: int, groups: List[List[int]]):
    """Block-membership kernel, diagonal-mean normalized, jittered (:83-93)."""
    X = np.zeros((n_samples, len(groups)))
    for i, idx in enumerate(groups):
        X[idx, i] = 1.0
    K = X @ X.T
    K /= K.diagonal().mean()
    jitter(K)
    return _symmetric_decomp(K), K


def create_environment_matrix(n_samples: int, n_env: int,
                              groups: List[List[int]], random: Generator):
    """Gaussian contexts + group structure, jointly normalized (:57-68)."""
    E = random.normal(size=[n_samples, n_env])
    E = column_normalize(E)
    EE = E @ E.T
    EE /= EE.diagonal().mean()
    H = sample_covariance_matrix(n_samples, groups)[1]
    M = EE + H
    M /= M.diagonal().mean()
    jitter(M)
    return _symmetric_decomp(M)


def create_environment_vector(n_samples: int, groups: List[List[int]],
                              random: Generator):
    E = np.zeros((n_samples, 1))
    values = random.choice([-1, 1], 2, False)
    for value, group in zip(values, groups):
        E[group, 0] = value
    return E


def create_variances(r0, v0, has_kinship=True) -> Variances:
    """Variance budget with total 1 (reference :104-158).

    sigma2_g = v0 (1-r0), sigma2_gxe = v0 r0, and the non-genetic terms split
    the remainder equally (3 ways with kinship, 2 without).
    """
    v_g = v0 * (1 - r0)
    v_gxe = v0 * r0
    if has_kinship:
        v = (1 - v_gxe - v_g) / 3
        return Variances(g=v_g, gxe=v_gxe, k=v, e=v, n=v)
    v = (1 - v_gxe - v_g) / 2
    return Variances(g=v_g, gxe=v_gxe, k=None, e=v, n=v)


def _ensure_moments(arr, mean: float, variance: float):
    """Exact empirical moment matching in place (reference :470-474)."""
    arr -= arr.mean(0) + mean
    with np.errstate(divide="raise", invalid="raise"):
        arr /= arr.std(0)
    arr *= np.sqrt(variance)


def sample_persistent_effsizes(n_effects: int, causal_indices: list,
                               variance: float, random: Generator):
    """beta with support on causal SNPs and sum beta^2 = variance (:161-201)."""
    effsizes = np.zeros(n_effects)
    if variance == 0.0:
        return effsizes
    effsizes[causal_indices] = random.choice([+1.0, -1.0],
                                             size=len(causal_indices))
    effsizes *= np.sqrt(variance / len(causal_indices))
    return effsizes


def sample_persistent_effects(X, effsizes, variance: float):
    y_g = X @ effsizes
    if variance > 0:
        _ensure_moments(y_g, 0, variance)
    return y_g


def sample_gxe_effects(G, E, causal_indices: list, variance: float,
                       random: Generator):
    """y_gxe = sum_i g_i (E alpha_i), alpha_i ~ N(0, v_i I) (:211-263)."""
    n_samples = G.shape[0]
    n_envs = E.shape[1]
    y2 = np.zeros(n_samples)
    if variance == 0.0:
        return y2
    n_causals = len(causal_indices)
    vi = variance / n_causals
    for causal in causal_indices:
        alpha = np.sqrt(vi) * random.normal(size=n_envs)
        if n_envs > 1:
            _ensure_moments(alpha, 0, np.sqrt(vi))
        beta = E @ alpha
        y2 += G[:, causal] * beta
    _ensure_moments(y2, 0, variance)
    return y2


def _sample_random_effect(X, variance: float, random: Generator):
    u = np.sqrt(variance) * random.normal(size=X.shape[1])
    y = X @ u
    _ensure_moments(y, 0, variance)
    return y


def sample_random_effect(X, variance: float, random: Generator):
    """Random effect from a factor or a tuple of factors (:285-305)."""
    if not isinstance(X, tuple):
        return _sample_random_effect(X, variance, random)
    y = np.zeros(X[0].shape[0])
    for L in X:
        u = np.sqrt(variance) * random.normal(size=L.shape[1])
        y += L @ u
    _ensure_moments(y, 0, variance)
    return y


def sample_noise_effects(n_samples: int, variance: float, random: Generator):
    y5 = np.sqrt(variance) * random.normal(size=n_samples)
    _ensure_moments(y5, 0, variance)
    return y5


def _expand_cells(G, n_cells, n_individuals):
    G = np.repeat(G, n_cells, axis=0)
    n_samples = G.shape[0]
    if np.isscalar(n_cells):
        individual_groups = np.array_split(range(n_samples), n_individuals)
    else:
        individual_groups = np.split(range(n_samples),
                                     np.cumsum(n_cells))[:-1]
    return G, n_samples, individual_groups


def sample_phenotype_gxe(
    offset: float,
    n_individuals: int,
    n_snps: int,
    n_cells: Union[int, List[int]],
    n_env_groups: int,
    maf_min: float,
    maf_max: float,
    g_causals: list,
    gxe_causals: list,
    variances: Variances,
    random: Generator,
    env_term: Term = Term.RANDOM,
    **_ignored,
) -> Simulation:
    """Full phenotype generator with K (.) EE^T background (reference :315-397)."""
    mafs = sample_maf(n_snps, maf_min, maf_max, random)
    G = sample_genotype(n_individuals, mafs, random)
    G, n_samples, individual_groups = _expand_cells(G, n_cells, n_individuals)
    G = column_normalize(G)

    env_groups = np.array_split(random.permutation(range(n_samples)),
                                n_env_groups)
    E = sample_covariance_matrix(n_samples, env_groups)[0]
    Lk, K = sample_covariance_matrix(n_samples, individual_groups)
    U, S, _ = np.linalg.svd(E, full_matrices=False)
    us = U * S
    Ls = tuple(us[:, i : i + 1] * Lk for i in range(us.shape[1]))

    beta_g = sample_persistent_effsizes(n_snps, g_causals, variances.g, random)
    y_g = sample_persistent_effects(G, beta_g, variances.g)
    y_gxe = sample_gxe_effects(G, E, gxe_causals, variances.gxe, random)
    y_k = sample_random_effect(Ls, variances.k, random)

    if env_term is Term.RANDOM:
        y_e = sample_random_effect(E, variances.e, random)
    elif env_term is Term.FIXED:
        ne = E.shape[1]
        beta_e = sample_persistent_effsizes(ne, list(range(ne)),
                                            variances.e, random)
        y_e = sample_persistent_effects(E, beta_e, variances.e)
    else:
        raise ValueError("Invalid term.")

    y_n = sample_noise_effects(n_samples, variances.n, random)
    M = np.ones((K.shape[0], 1))
    y = offset + y_g + y_gxe + y_k + y_e + y_n
    return Simulation(
        mafs=mafs, offset=offset, beta_g=beta_g, y_g=y_g, y_gxe=y_gxe,
        y_k=y_k, y_e=y_e, y_n=y_n, y=y, variances=variances,
        Lk=Lk, Ls=Ls, K=K, E=E, G=G, M=M,
    )


def sample_phenotype(
    offset: float,
    n_individuals: int,
    n_snps: int,
    n_cells: Union[int, List[int]],
    n_env: int,
    n_env_groups: int,
    maf_min: float,
    maf_max: float,
    g_causals: list,
    gxe_causals: list,
    variances: Variances,
    random: Generator,
) -> Simulation:
    """Phenotype generator with plain kinship background (reference :400-467)."""
    mafs = sample_maf(n_snps, maf_min, maf_max, random)
    G = sample_genotype(n_individuals, mafs, random)
    G, n_samples, individual_groups = _expand_cells(G, n_cells, n_individuals)
    G = column_normalize(G)

    env_groups = np.array_split(random.permutation(range(n_samples)),
                                n_env_groups)
    E = create_environment_matrix(n_samples, n_env, env_groups, random)
    Lk, K = sample_covariance_matrix(n_samples, individual_groups)

    beta_g = sample_persistent_effsizes(n_snps, g_causals, variances.g, random)
    y_g = sample_persistent_effects(G, beta_g, variances.g)
    y_gxe = sample_gxe_effects(G, E, gxe_causals, variances.gxe, random)
    y_k = sample_random_effect(Lk, variances.k, random)
    y_e = sample_random_effect(E, variances.e, random)
    y_n = sample_noise_effects(n_samples, variances.n, random)

    M = np.ones((K.shape[0], 1))
    y = offset + y_g + y_gxe + y_k + y_e + y_n
    return Simulation(
        mafs=mafs, offset=offset, beta_g=beta_g, y_g=y_g, y_gxe=y_gxe,
        y_k=y_k, y_e=y_e, y_n=y_n, y=y, variances=variances,
        Lk=Lk, Ls=None, K=K, E=E, G=G, M=M,
    )
