"""The port's own simulator (``cellregmap_tpu_torch.sim``): the invariants
of tests/test_sim.py, test for test with the same seeds."""
import numpy as np
import pytest
from numpy.testing import assert_allclose

from cellregmap_tpu_torch import Term, create_variances, sim
from cellregmap_tpu_torch.sim import (
    column_normalize,
    sample_covariance_matrix,
    sample_genotype,
    sample_gxe_effects,
    sample_maf,
    sample_persistent_effsizes,
    sample_phenotype,
    sample_phenotype_gxe,
)


def test_maf_bounds():
    rng = np.random.default_rng(0)
    mafs = sample_maf(50, 0.1, 0.4, rng)
    assert np.all((mafs >= 0.1) & (mafs <= 0.4))


def test_genotype_domain():
    rng = np.random.default_rng(0)
    G = sample_genotype(200, [0.2, 0.5], rng)
    assert set(np.unique(G)) <= {0.0, 1.0, 2.0}


def test_column_normalize_exact():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(50, 4)) * 3 + 1
    Xn = column_normalize(X)
    assert_allclose(Xn.mean(0), 0, atol=1e-12)
    assert_allclose(Xn.std(0), 1, atol=1e-12)


def test_covariance_matrix_properties():
    groups = np.array_split(range(30), 5)
    L, K = sample_covariance_matrix(30, groups)
    assert_allclose(K.diagonal().mean(), 1.0, atol=1e-6)
    assert np.linalg.matrix_rank(K) == 30  # jittered to full rank
    assert_allclose(L @ L.T, K, atol=1e-7)


def test_variance_budget():
    v = create_variances(0.5, 0.4)
    total = v.g + v.gxe + v.k + v.e + v.n
    assert_allclose(total, 1.0)
    v2 = create_variances(0.3, 0.6, has_kinship=False)
    assert v2.k is None
    assert_allclose(v2.g + v2.gxe + v2.e + v2.n, 1.0)


def test_persistent_effsizes_sum():
    rng = np.random.default_rng(0)
    beta = sample_persistent_effsizes(20, [3, 7], 0.25, rng)
    assert_allclose((beta**2).sum(), 0.25)
    assert np.count_nonzero(beta) == 2


def test_gxe_effect_variance():
    rng = np.random.default_rng(0)
    G = column_normalize(sample_genotype(500, sample_maf(10, 0.2, 0.45, rng),
                                         rng))
    E = column_normalize(rng.normal(size=(500, 4))) / 2
    y = sample_gxe_effects(G, E, [2, 5], 0.3, rng)
    assert_allclose(y.var(), 0.3, rtol=1e-10)
    assert_allclose(y.mean(), 0.0, atol=1e-12)


@pytest.mark.parametrize("env_term", [Term.RANDOM, Term.FIXED])
def test_sample_phenotype_gxe_decomposition(env_term):
    rng = np.random.default_rng(0)
    v = create_variances(0.5, 0.5)
    s = sample_phenotype_gxe(
        offset=0.3, n_individuals=30, n_snps=10, n_cells=3, n_env_groups=3,
        maf_min=0.2, maf_max=0.45, g_causals=[1], gxe_causals=[4],
        variances=v, random=rng, env_term=env_term,
    )
    assert s.y.shape == (90,)
    # exact component variances
    assert_allclose(s.y_g.var(), v.g, rtol=1e-9)
    assert_allclose(s.y_gxe.var(), v.gxe, rtol=1e-9)
    assert_allclose(s.y_k.var(), v.k, rtol=1e-9)
    assert_allclose(s.y_e.var(), v.e, rtol=1e-9)
    assert_allclose(s.y_n.var(), v.n, rtol=1e-9)
    # exact sum decomposition
    assert_allclose(
        s.y, s.offset + s.y_g + s.y_gxe + s.y_k + s.y_e + s.y_n, atol=1e-12
    )
    # Ls encode K (.) EE^T
    got = sum(L @ L.T for L in s.Ls)
    assert_allclose(got, s.K * (s.E @ s.E.T), atol=1e-6)


def test_sample_phenotype_ragged_cells():
    rng = np.random.default_rng(1)
    v = create_variances(0.5, 0.5)
    n_cells = np.arange(10) + 1
    s = sample_phenotype(
        offset=0.0, n_individuals=10, n_snps=5, n_cells=n_cells, n_env=2,
        n_env_groups=3, maf_min=0.3, maf_max=0.45, g_causals=[0],
        gxe_causals=[2], variances=v, random=rng,
    )
    assert s.y.shape == (n_cells.sum(),)
    assert s.G.shape == (n_cells.sum(), 5)
