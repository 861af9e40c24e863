"""The float32 context's K1 and K2 as redesigned for the tensor cores,
run on the CPU under the emulator of ``tests/_cuda_emu.py`` against their
plain float32 versions:

* K1-f32, K > 32: split-TF32 products (``csrc/tf32mma.cuh``) over 128 x
  128 tiles of the Khatri-Rao operand; K <= 32: FP32 FMA with the cells
  split over warps and blocks, the blocks' partial sums added in order;
* K2-f32: the weights and the sums in one kernel (split TF32), then the
  epilogue; REML and ML, with the gene axis, the per-gene slot, the
  chunked gene path (a build with ``CRM_GRID_CHUNK_BYTES`` lowered) and a
  failed f32 factorization.

Tolerances, and why:

* K1 (f32 sums of n terms): within sqrt(n) units of f32 rounding of the
  sum of the terms' magnitudes, entry by entry.  Split TF32 holds each
  product to a few units of f32 rounding (x = hi + lo, the dropped lo lo
  and lo's own rounding each below 2^-22 |a b|), and the kernel and the
  plain BLAS product sum in other orders; n eps is the worst case.
* K2: the kernel's bracket is the plain grid's argmax, or a point whose
  plain lml is within 1e-5 of the row's maximum (f32 sums in another
  order break a tie either way), the brackets the f32-rounded grid logits
  (REML) or the f64 logits (ML), NaN outside a gene's slot column; a grid
  point whose f32 factorization fails keeps its NaN and never wins.
* The TF32 rounding (the same integer arithmetic in the emulator and on
  the card): bit for bit the PTX ISA's cvt.rna.tf32.f32 (nearest, ties
  away from zero, 10 mantissa bits) on every finite value and inf, past
  the largest TF32 value to inf; a NaN stays a NaN unless its payload lies
  in the low 13 bits alone (then inf).
"""
import ctypes

import numpy as np
import pytest
import torch

from _cuda_emu import emulated, nan_outputs  # noqa: F401
from _torch_inputs import captured, fit_dataset, kr_inputs
from cellregmap_tpu_torch import engine
from cellregmap_tpu_torch.kernels import delta_grid as k2
from cellregmap_tpu_torch.kernels import kr_contract as k1

EPS32 = float(torch.finfo(torch.float32).eps)
f32 = torch.float32
LO, HI = -18.0, 18.0

ROUND_SRC = r"""
#include <cuda_runtime.h>
#include "tf32mma.cuh"
extern "C" void round_tf32(const unsigned* x, unsigned* out, int n) {
  for (int i = 0; i < n; ++i) {
    float f;
    std::memcpy(&f, x + i, 4);
    out[i] = tf32_bits(f);
  }
}
__global__ void unused(int) {}
extern "C" int launch_unused() {
  unused<<<1, 1, 0, nullptr>>>(0);
  return 0;
}
"""


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("cuda_emu_k1_k2_f32")
    out = {}
    for name, mod, defines in (
            ("kr_contract", k1, ()), ("delta_grid", k2, ()),
            # a gene chunk's scratch below one gene's: the chunked path
            ("delta_grid_chunked", k2, ("CRM_GRID_CHUNK_BYTES=4096",))):
        (workdir / name).mkdir()
        src = name.split("_chunked")[0]
        out[name] = emulated(src, workdir / name, defines=defines)
        mod._bind(out[name])
    (workdir / "round").mkdir()
    out["round"] = emulated("round", workdir / "round", source=ROUND_SRC)
    return out


def _cvt_rna_tf32(u):
    """cvt.rna.tf32.f32 on a non-NaN f32's bits, from the PTX ISA's
    definition: the magnitude rounded to 10 mantissa bits, nearest, ties
    away from zero (the low 13 bits cleared); inf kept."""
    sign, mag = u & 0x80000000, u & 0x7FFFFFFF
    if mag == 0x7F800000:
        return u
    keep, rest = mag >> 13, mag & 0x1FFF
    if rest >= 0x1000:           # half an ulp or more: away from zero
        keep += 1                # (past the largest finite value: inf)
    return sign | (keep << 13)


def test_tf32_rounding_matches_cvt_rna(libs):
    """Ties (exactly half an ulp: away from zero, both signs), either side
    of a tie, a carry into the exponent, the largest finite value (to
    inf), subnormals, zeros, inf and NaNs; then 4096 seeded patterns."""
    chosen = [0x3F801000, 0xBF801000, 0x3F800FFF, 0x3F801001, 0x3F803000,
              0x3FFFF000, 0x3FFFFFFF, 0x7F7FFFFF, 0x7F7FEFFF, 0x00001000,
              0x80001000, 0x00000FFF, 0x007FF000, 0x00000000, 0x80000000,
              0x7F800000, 0xFF800000, 0x7FC00000, 0x7F800001, 0x3F800000]
    rng = np.random.default_rng(14)
    bits = np.concatenate([np.array(chosen, dtype=np.uint32),
                           rng.integers(0, 2 ** 32, 4096,
                                        dtype=np.uint64).astype(np.uint32)])
    out = np.empty_like(bits)
    u32 = ctypes.POINTER(ctypes.c_uint32)
    libs["round"].round_tf32(bits.ctypes.data_as(u32),
                             out.ctypes.data_as(u32), ctypes.c_int(len(bits)))
    nan = (bits & 0x7FFFFFFF) > 0x7F800000
    want = np.array([_cvt_rna_tf32(int(u)) for u in bits[~nan]],
                    dtype=np.uint32)
    bad = np.nonzero(out[~nan] != want)[0]
    assert bad.size == 0, [(hex(bits[~nan][i]), hex(out[~nan][i]),
                            hex(want[i])) for i in bad[:5]]
    assert out[0] == 0x3F802000 and out[1] == 0xBF802000   # ties away
    assert out[7] == 0x7F800000                             # to inf
    # a NaN stays a NaN, or becomes inf when its payload lies in the low
    # 13 bits alone
    low_only = (bits & 0x007FE000) == 0
    assert bool(nan.any()) and bool(
        ((out[nan] & 0x7FFFFFFF) == np.where(
            low_only[nan], 0x7F800000, out[nan] & 0x7FFFFFFF)).all())
    assert bool((((out[nan] & 0x7FFFFFFF) > 0x7F800000)
                 | low_only[nan]).all())


def _sums_close(got, want, mags, n_terms):
    """|got - want| within sqrt(n_terms) eps(f32) of the terms'
    magnitudes."""
    err = (got.double() - want.double()).abs()
    tol = np.sqrt(n_terms) * EPS32
    assert bool((err <= tol * mags + 1e-30).all()), \
        float((err / (mags + 1e-30)).max() / EPS32)


def _k1_case(lib, n, K, p, S, seed):
    U, V, G = (torch.as_tensor(a, dtype=f32)
               for a in kr_inputs(seed, n=n, K=K, p=p, S=S))
    got = k1.call(lib, U, V, G)
    want = k1.kr_contract_plain(U, V, G)
    assert got.dtype == f32 and got.shape == want.shape == (K, p, S)
    mags = k1.kr_contract_plain(U.double().abs(), V.double().abs(),
                                G.double().abs())
    _sums_close(got, want, mags, n)
    return got


@pytest.mark.parametrize("n,K,p,S", [
    (97, 150, 1, 70),     # 4-byte copies (K, S not multiples of 4), p = 1
    (97, 132, 10, 68),    # 16-byte copies, p = 10, partial tiles
    (45, 33, 3, 130)])    # K just past the small route, a ragged chunk
def test_kr_contract_f32_tensor_core_route(libs, n, K, p, S):
    _k1_case(libs["kr_contract"], n, K, p, S, seed=K + S)


@pytest.mark.parametrize("n,K,p,S,splits", [
    (300, 10, 1, 40, 4),      # A^T W's shape: the cells over 4 blocks
    (260, 20, 3, 33, 4),      # 17..32 rows, two columns of V a block
    (100, 7, 5, 9, 1)])       # one split: M written directly
def test_kr_contract_f32_small_route_splits(libs, n, K, p, S, splits):
    lib = libs["kr_contract"]
    want_bytes = splits * K * p * S * 4 if splits > 1 else 0
    assert lib.crm_kr_contract_f32_workspace(n, K, p, S) == want_bytes
    _k1_case(lib, n, K, p, S, seed=n + K)


def _grid_batch(seed, genes, p, ml, nrho=3, S=7, k=None):
    """The f32 context of a small dataset (R = 27) and K2's arguments on
    it: the interaction's REML grid, or the association refit's ML grid
    (genes > 1: each gene at its own rho, ``k``)."""
    ctx, G, n = fit_dataset(seed, p=p, nrho=nrho, n=70, donors=8, S=S)
    if genes > 1:
        rng = np.random.default_rng(seed)
        Y = ctx.y[None] + 0.6 * torch.as_tensor(rng.normal(size=(genes, n)))
        ctx = ctx._replace(y=Y, Zy=Y @ ctx.Z, Wy=Y @ ctx.W,
                           yy=(Y * Y).sum(dim=1))
    ctx = engine.NullContext(*(t.to(f32) for t in ctx))
    G = G.to(f32)
    cfg = (LO, HI, 40, 60)
    if not ml:
        run = lambda: engine.interaction_batch(  # noqa: E731
            ctx, G, G, n, delta_cfg=cfg)
    elif genes == 1:
        run = lambda: engine.association_refit_batch(  # noqa: E731
            ctx, G, 1, n, delta_cfg=cfg)
    else:
        run = lambda: engine.association_refit_multigene_batch(  # noqa
            ctx, G, np.asarray(k), n, delta_cfg=cfg)
    (args, kw), = captured(run, ["delta_grid"])["delta_grid"]
    assert args[0].dtype == f32 and args[9] == f32
    return args, kw


def _assert_grid(lib, args, kw):
    """The module doc's K2 rule: brackets on the plain argmax or a tie
    within 1e-5, as the context's logits; NaN outside the slot columns."""
    dkw = dict(kw, slot=torch.as_tensor(kw["slot"])) if "slot" in kw else kw
    br_lo, br_hi = k2.call(lib, *args, **dkw)
    plo, phi, lml = k2.delta_grid_plain(*args, **kw, return_lml=True)
    assert torch.equal(torch.isnan(br_lo), torch.isnan(plo))
    restricted = kw.get("restricted", True)
    ctx_dt = f32 if restricted else torch.float64
    if restricted:   # the f32-rounded logits, widened exactly
        assert torch.equal(br_lo.to(f32).double(), br_lo)
    logit = k2.logit_grid(LO, HI, lml.shape[-1], "cpu", ctx_dt)
    fin = ~torch.isnan(br_lo)
    for br in (br_lo, br_hi):
        assert float((br[fin][:, None] - logit).abs().amin(dim=1).max()) \
            <= 1e-12
    if "slot" in kw:
        for g, s in enumerate(kw["slot"]):
            gap = k2.bracket_shortfall(br_lo[g, :, s:s + 1],
                                       br_hi[g, :, s:s + 1], lml[g], LO, HI,
                                       ctx_dt)
            assert gap <= 1e-5, gap
    else:
        for g in np.ndindex(*br_lo.shape[:-2]):
            gap = k2.bracket_shortfall(br_lo[g], br_hi[g], lml[g], LO, HI,
                                       ctx_dt)
            assert gap <= 1e-5, gap
    return br_lo, br_hi, lml


@pytest.mark.parametrize("ml", [False, True])
@pytest.mark.parametrize("genes,p", [(1, 1), (3, 1), (1, 4), (3, 4)])
def test_delta_grid_f32_fused_sums(libs, genes, p, ml):
    """REML (the interaction's grid, 3 rho) and ML (the association
    refit's: one rho, or each gene at its own slot of three)."""
    args, kw = _grid_batch(400 + 10 * genes + p, genes, p, ml,
                           k=[2, 0, 2][:genes])
    if ml and genes > 1:
        assert len(set(kw["slot"])) == 2       # two distinct rho
    _assert_grid(libs["delta_grid"], args, kw)


def test_delta_grid_f32_widest(libs):
    """p = 15 (the float32 context's widest: the shared tile holds the
    120 W_i W_j columns alone, the genes' sums tiles of their own) with
    three genes; p = 16 is refused."""
    args, kw = _grid_batch(415, 3, 15, False)
    _assert_grid(libs["delta_grid"], args, kw)
    wide, _ = _grid_batch(416, 1, 16, False)
    with pytest.raises(RuntimeError):
        k2.call(libs["delta_grid"], *wide)


@pytest.mark.parametrize("ml", [False, True])
def test_delta_grid_f32_gene_chunks(libs, ml):
    """A gene chunk's scratch below one gene's: a chunk a gene, 5 genes of
    17 variants (g y tiles of several genes at nS < 128), each chunk's
    brackets as the whole launch's."""
    args, kw = _grid_batch(430 + ml, 5, 2, ml, S=17, k=[1, 0, 2, 2, 1])
    got = _assert_grid(libs["delta_grid_chunked"], args, kw)
    whole = _assert_grid(libs["delta_grid"], args, kw)
    for a, b in zip(got[:2], whole[:2]):
        assert torch.equal(torch.isnan(a), torch.isnan(b))


def test_delta_grid_f32_keeps_failed_factorizations_nan(libs):
    """The intercept in the span of a donors' one-hot background: at rho =
    0 and small delta the f32 normal matrix is indefinite and the plain
    grid's Cholesky is NaN there; those points are masked, and the
    kernel's brackets avoid them as the plain version's do (256 grid
    points: four tiles of 64)."""
    rng = np.random.default_rng(0)
    n, C, donors, S = 120, 4, 12, 16
    E = rng.normal(size=(n, C)) / np.sqrt(C)
    hK = np.zeros((n, donors))
    hK[np.arange(n), np.arange(n) % donors] = 1.0
    G = rng.binomial(2, 0.3, size=(n, S)).astype(float)
    G = (G - G.mean(0)) / np.maximum(G.std(0), 1e-9)
    y = rng.normal(size=n) + 0.8 * G[:, 3] * E[:, 0]
    y = y + 0.5 * np.random.default_rng(1).normal(size=n)
    ctx = engine.build_null_context(y, np.ones((n, 1)), E, hK=hK,
                                    rho_grid=np.linspace(0, 1, 11),
                                    device="cpu", dtype=f32)
    (args, kw), = captured(lambda: engine.association_refit_batch(
        ctx, torch.as_tensor(G, dtype=f32), 0, n,
        delta_cfg=(LO, HI, 256, 60)), ["delta_grid"])["delta_grid"]
    _, _, lml = _assert_grid(libs["delta_grid"], args, kw)
    assert int((~torch.isfinite(lml)).sum()) > 0
