"""K4's float32 product (``csrc/best_rho_rotate.cu``,
``crm_best_rho_rotate_f32``: a 128 x 128 tile of one rho's columns a
block, 8 x 8 FP32 sums a thread over a three-stage ring of 32-row chunks)
and K6b (``csrc/mixture_tails.cu``: a group of lanes a pair, the whole
warp on a noncentral Liu series), run on the CPU under the emulator of
``tests/_cuda_emu.py``, against their plain torch versions.

K4-f32 on the one / distinct / random rho patterns of 3 and 16 genes and
a single phenotype, at R = 129, 130 and 131 (the 4-byte copies of V's
rows, R % 4 != 0; two q tiles, the second ragged) and R = 132 (16-byte
copies), C = 1, 3, 8 (16-byte copies of the variants' runs), 10 and 64;
with 3 rho points and 40 variants a rho's 10-context columns cross a
128-column tile and end inside the next.  The slots equal the plain
version's, the factors gathered through them within sqrt(R) eps(f32) of
the terms' magnitudes, and a second launch (another order of the
emulator's threads) bit-equal to the first.

K6b at C = 1, 2, 5, 10, 33 and 64 (37 pairs: up to C = 16 a warp a pair,
the bisection speculated 3 steps a round up to C = 8 and 2 to C = 16,
and again from a build that takes the grouped route of large batches,
one lane a pair up to C = 2, 4 and 8 lanes at C = 5 and 10; a warp a
pair from C = 33; the last block ragged at every width) on
``tail_battery``'s pairs (zero padding, Q at the mean: the near-mean
branch; all-zero weights: lambda_max <= 0, NaN in both; rank-1 spectra,
whose Liu match rounds onto the noncentral series) and on pairs of mixed
and all-negative weights, a NaN weight and Q deep in the tail (the plain
Liu p-value near 1e-300): both tails within 1e-9 relative (floor 1e-300)
of the plain version, NaN exactly where it is NaN, and a second launch
bit-equal to the first.  Near the mean, where float64 rounding alone
parts two evaluations of the saddlepoint by more than 1e-9: the plain
version and ``chip_smoke.saddlepoint_extended`` (its formula in long
double) against a 50-digit evaluation, and K6b on Q 1e-2 to 3e-5 from the
mean held by ``chip_smoke.check_tails`` (the card checks' rule: the
near pairs against the long-double formula within 1e-9 + min(1e-15 /
d^2, 1e-6), every other tail within 1e-9 of the plain version).
"""
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import chip_smoke as cs
from _cuda_emu import emulated, nan_outputs  # noqa: F401
from _torch_inputs import (assert_tails_close, k_best_pattern,
                           rotate_inputs, tail_battery)
from cellregmap_tpu_torch.kernels import best_rho_rotate as k4
from cellregmap_tpu_torch.kernels import mixture_tails as k6b

EPS32 = float(torch.finfo(torch.float32).eps)
f32 = torch.float32

# (pattern, genes, nrho, R, C, S)
ROTATE_CASES = [
    ("one", 3, 3, 131, 10, 40),        # a rho's columns cross a tile
    ("distinct", 3, 5, 130, 10, 40),
    ("random", 3, 5, 132, 8, 23),      # 16-byte copies of both operands
    ("random", 16, 11, 131, 3, 17),
    ("distinct", 16, 16, 64, 4, 9),
    ("one", 1, 3, 129, 1, 300),        # 100 variants a rho, one context
    ("random", 3, 2, 67, 64, 5),       # C = 64: two tiles a variant
]
# (C, build): up to C = 16 at these 37 pairs a warp a pair with its
# bisection speculated (3 steps a round up to C = 8, 2 to 16), and the
# grouped route of larger batches from a build that never speculates;
# from C = 17 one route
TAIL_CASES = [(C, build) for C in (1, 2, 5, 10)
              for build in ("mixture_tails", "mixture_tails grouped")] + [
    (33, "mixture_tails"), (64, "mixture_tails")]


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("cuda_emu_k4f32_k6b")
    builds = {"best_rho_rotate": ("best_rho_rotate", ()),
              "mixture_tails": ("mixture_tails", ()),
              "mixture_tails grouped": ("mixture_tails",
                                        ("CRM_MT_SPEC_MAX_PAIRS=0",))}
    for i, key in enumerate(builds):
        (workdir / str(i)).mkdir()
    with ThreadPoolExecutor(len(builds)) as pool:
        built = dict(zip(builds, pool.map(
            lambda item: emulated(item[1][0], workdir / str(item[0]),
                                  defines=item[1][1]),
            enumerate(builds.values()))))
    k4._bind(built["best_rho_rotate"])
    k6b._bind(built["mixture_tails"])
    k6b._bind(built["mixture_tails grouped"])
    return built


@pytest.mark.parametrize("pattern,genes,nrho,R,C,S", ROTATE_CASES)
def test_rotate_f32_matches_plain(libs, pattern, genes, nrho, R, C, S):
    V, T, _ = rotate_inputs(R + C, nrho=nrho, R=R, C=C, S=S)
    kb = torch.as_tensor(k_best_pattern(pattern, genes, nrho, S,
                                        np.random.default_rng(R)))
    if genes == 1:
        kb = kb[0]
    V, T = torch.as_tensor(V, dtype=f32), torch.as_tensor(T, dtype=f32)
    At, slot = k4.call(libs["best_rho_rotate"], V, T, kb)
    At_p, slot_p = k4.best_rho_rotate_plain(V, T, kb)
    assert At.dtype == f32 and At.shape == At_p.shape
    assert torch.equal(slot, slot_p)
    got, want = k4.gather(At, slot), k4.gather(At_p, slot_p)
    mags = k4.gather(k4.best_rho_rotate_plain(V.double().abs(),
                                              T.double().abs(), kb)[0],
                     slot_p)
    err = (got.double() - want.double()).abs()
    tol = np.sqrt(R) * EPS32
    assert bool((err <= tol * mags + 1e-30).all()), \
        float((err / (mags + 1e-30)).max() / EPS32)
    again = k4.gather(*k4.call(libs["best_rho_rotate"], V, T, kb))
    assert torch.equal(again, got)


def _deep_tail_q(lam, target=1e-300):
    """The Q whose plain Liu p-value is the largest of a fine geometric
    grid below ``target`` x 1e5 that stays above ``target``."""
    lam = torch.as_tensor(lam)[None]
    m = torch.logspace(0.0, 4.0, 4000, dtype=torch.float64)
    q = lam.sum() * m
    pv = k6b.mixture_tails_plain(q, lam.expand(len(m), -1))[0]
    ok = (pv > target) & (pv < target * 1e5)
    assert bool(ok.any())
    return float(q[ok][-1])


def tail_pairs(C, n=37, seed=17):
    """``tail_battery``'s pairs with four of its rows replaced: mixed
    weights, all-negative weights (lambda_max < 0), a NaN weight and Q in
    the deep tail."""
    q, lam = tail_battery(seed + C, n=n, C=C)
    rng = np.random.default_rng(seed)
    lam[8] = rng.normal(size=C)
    q[8] = abs(lam[8]).sum()
    lam[9] = -np.abs(rng.normal(size=C)) - 0.1
    q[9] = 0.5
    lam[10, 0] = np.nan
    q[11] = _deep_tail_q(lam[11])
    return torch.as_tensor(q), torch.as_tensor(lam)


@pytest.mark.parametrize("C,build", TAIL_CASES)
def test_mixture_tails_matches_plain(libs, C, build):
    q, lam = tail_pairs(C)
    got = k6b.call(libs[build], q, lam)
    want = k6b.mixture_tails_plain(q, lam)
    assert_tails_close(got, want)
    assert bool(torch.isnan(want[0][10])) and bool(torch.isnan(want[1][10]))
    assert 1e-300 < float(got[0][11]) < 1e-295
    # lambda_max <= 0 and Q at the mean: the saddlepoint takes Liu's value
    assert torch.equal(_bits(got[1][[0, 9]]), _bits(got[0][[0, 9]]))
    again = k6b.call(libs[build], q, lam)
    assert all(torch.equal(_bits(a), _bits(b)) for a, b in zip(again, got))


def _bits(t):
    return t.contiguous().view(torch.int64)


NEAR_D = (1e-2, 3e-3, 1e-3, 3e-4, 1e-4, 3e-5)


def _near_pairs(C, ds):
    """C seeded weights, and Q a relative distance d above and below their
    mean for each d of ``ds``."""
    lam = np.abs(np.random.default_rng(C).normal(size=C))
    d = np.concatenate([np.asarray(ds), -np.asarray(ds)])
    return lam.sum() * (1.0 + d), np.tile(lam, (len(d), 1))


def _saddlepoint_50_digits(q, lam):
    """The plain saddlepoint's formula (its bracket, 100 bisection steps,
    K, K'' and the Lugannani-Rice z) at 50 digits, pair by pair."""
    mpmath = pytest.importorskip("mpmath")
    mpmath.mp.dps = 50
    out = []
    for qi, li in zip(q, lam):
        L = [mpmath.mpf(float(x)) for x in li]
        Q = mpmath.mpf(float(qi))
        hi = 1 / (2 * max(L))
        a = -abs(hi) * 1000 - max(sum(L), 1) / Q * 1000 - 1000
        b = hi * (1 - mpmath.mpf(1e-12))
        for _ in range(100):
            mid = (a + b) / 2
            if sum(x / (1 - 2 * mid * x) for x in L) < Q:
                a = mid
            else:
                b = mid
        t = (a + b) / 2
        K = -sum(mpmath.log1p(-2 * t * x) for x in L) / 2
        kpp = sum(2 * x * x / (1 - 2 * t * x) ** 2 for x in L)
        w = mpmath.sign(t) * mpmath.sqrt(2 * (t * Q - K))
        v = t * mpmath.sqrt(kpp)
        out.append(float(1 - mpmath.ncdf(w + mpmath.log(v / w) / w)))
    return np.array(out)


@pytest.mark.parametrize("C", [10, 64])
def test_saddlepoint_rounding_near_the_mean(C):
    """Why K6b's saddlepoint is held near the mean to its formula in
    extended precision (``chip_smoke.SADDLE_NEAR_MEAN``), not to the plain
    version: the plain float64 version against a 50-digit evaluation of
    the same formula at Q a relative distance d from the mean is within
    1e-9 from d = 1e-2, within SADDLE_NEAR_MEAN / d^2 closer in, and past
    1e-9 at d = 1e-5."""
    ds = (1e-2, 1e-3, 1e-4, 1e-5)
    q, lam = _near_pairs(C, ds)
    exact = _saddlepoint_50_digits(q, lam)
    plain = k6b.mixture_tails_plain(torch.as_tensor(q),
                                    torch.as_tensor(lam))[1].numpy()
    rel = np.abs(plain - exact) / exact
    d = np.abs(q / lam.sum(1) - 1.0)
    assert (rel <= 1e-9 + cs.SADDLE_NEAR_MEAN / d ** 2).all(), (d, rel)
    worst = {x: rel[np.isclose(d, x)].max() for x in ds}
    assert worst[1e-2] <= 1e-9 and worst[1e-5] > 1e-9, worst


@pytest.mark.parametrize("C", [10, 64])
def test_saddlepoint_extended_matches_50_digits(C):
    """``chip_smoke.saddlepoint_extended``, the reference K6b's saddlepoint
    is held to near the mean, against the 50-digit evaluation from d =
    1e-2 to 3e-5: within a thousandth of the float64 allowance,
    SADDLE_NEAR_MEAN / d^2 (the long double's own rounding, ~1e-19 / d^2:
    6e-11 at d = 3e-5, where the kernel is allowed 1e-6)."""
    q, lam = _near_pairs(C, NEAR_D)
    ext, v = cs.saddlepoint_extended(q, lam)
    exact = _saddlepoint_50_digits(q, lam)
    assert (np.abs(v) >= 1e-8).all()
    d = np.abs(q / lam.sum(1) - 1.0)
    rel = np.abs(ext - exact) / exact
    assert (rel <= 1e-15 + 1e-3 * cs.SADDLE_NEAR_MEAN / d ** 2).all(), rel


@pytest.mark.parametrize("C", [10, 64])
def test_mixture_tails_near_the_mean(libs, C):
    """K6b by ``chip_smoke.check_tails``'s rule on Q within 1e-2 to 3e-5
    of the mean: the pairs from 1e-3 in against the long-double formula
    within 1e-9 + min(1e-15 / d^2, 1e-6), the others and every Liu tail
    within 1e-9 of the plain version."""
    q, lam = (torch.as_tensor(a) for a in _near_pairs(C, NEAR_D))
    got = k6b.call(libs["mixture_tails"], q, lam)
    gaps = cs.check_tails(got, k6b.mixture_tails_plain(q, lam), q, lam,
                          f"K6b near the mean, C = {C}")
    assert gaps["near_mean"] == 8 and gaps["near_d_min"] < 3.1e-5
