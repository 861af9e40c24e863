"""The tensor-core kernels, run on the CPU under the emulator of
``_cuda_emu.py``, against their plain versions.

1. ``csrc/dmma.cuh``: the portable body of each FP64 tensor-core product
   (mma.sync m8n8k4 and m16n8k8; on the card each is one PTX instruction)
   against a plain product, its operands and result placed by the PTX
   ISA's fragment layout.
2. K1 (``csrc/kr_contract.cu``) at the shapes its tiling has to mask: K
   not a multiple of the 64-row tile, p S not a multiple of the column
   tile, odd n and odd widths (the 8-byte copies), and the small-K kernel
   (K <= 32, the cells split over a block's warps); each within 1e-12 of
   ``kr_contract_plain``'s largest entry.
3. K3's localize on its product route (``csrc/reml_newton.cu``: the pair
   sums a tensor-core product a rho, the genotype's sums, the epilogue) at
   p + 1 = 17, 25 and 33 over 21 rho points, with the f32-rounded steps
   (``round32``) and without, one call with a gene axis, and at p + 1 = 4
   (the register instantiation), 5 and 9; each held to
   ``reml_localize_plain`` as chip_smoke.py holds it: k_best equal, x
   within rtol 1e-9, lml within rtol 1e-10.

The localize is built with one-warp product blocks
(``CRM_LOC_GEMM_WARPS=1``), which keeps the emulation to seconds a case;
tests/test_torch_emulated_wide.py runs the four-warp build the card uses.
"""
import ctypes

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from _cuda_emu import emulated, nan_outputs  # noqa: F401
from _torch_inputs import captured, fit_dataset
from cellregmap_tpu_torch import engine
from cellregmap_tpu_torch.kernels import kr_contract as k1
from cellregmap_tpu_torch.kernels import reml_newton as k3

DMMA_SOURCE = r"""
#include <cuda_runtime.h>
#include "dmma.cuh"

// one warp: fragments of A (M x K) and B (K x N) row-major by the layout,
// D = C + A B written back by it
__global__ void m8n8k4(const double* A, const double* B, double* D) {
  const int lane = threadIdx.x, g = lane >> 2, t = lane & 3;
  double d[2] = {D[g * 8 + 2 * t], D[g * 8 + 2 * t + 1]};
  dmma_m8n8k4(d, A[g * 4 + t], B[t * 8 + g]);
  D[g * 8 + 2 * t] = d[0];
  D[g * 8 + 2 * t + 1] = d[1];
}

__global__ void m16n8k8(const double* A, const double* B, double* D) {
  const int lane = threadIdx.x, g = lane >> 2, t = lane & 3;
  double a[4], b[2], d[4];
  for (int i = 0; i < 4; ++i)
    a[i] = A[(g + 8 * (i & 1)) * 8 + t + 4 * (i >> 1)];
  for (int i = 0; i < 2; ++i) b[i] = B[(t + 4 * i) * 8 + g];
  for (int i = 0; i < 4; ++i) d[i] = D[(g + 8 * (i >> 1)) * 8 + 2 * t + (i & 1)];
  dmma_m16n8k8(d, a, b);
  for (int i = 0; i < 4; ++i) D[(g + 8 * (i >> 1)) * 8 + 2 * t + (i & 1)] = d[i];
}

extern "C" int run(int shape, const double* A, const double* B, double* D) {
  auto k = shape == 0 ? m8n8k4 : m16n8k8;
  k<<<1, 32, 0, nullptr>>>(A, B, D);
  return cudaGetLastError();
}
"""

# (n, K, p, S): large-K tiles (K > 32) with ragged K, p S and n, odd and
# even widths; then the small-K kernel (one and two m16 tiles, JB 1 and 2)
KR_CASES = [(71, 79, 3, 37), (97, 130, 2, 70), (64, 66, 1, 40),
            (101, 10, 10, 37), (63, 23, 1, 50), (75, 32, 3, 33),
            (9, 5, 2, 9)]


def _p(t):
    return ctypes.c_void_p(t.data_ptr())


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("cuda_emu_redesign")
    out = {"dmma": emulated("dmma_probe", workdir, source=DMMA_SOURCE),
           "kr_contract": emulated("kr_contract", workdir),
           "reml_newton": emulated("reml_newton", workdir,
                                   defines=["CRM_LOC_GEMM_WARPS=1"])}
    k1._bind(out["kr_contract"])
    k3._bind(out["reml_newton"])
    return out


@pytest.mark.parametrize("shape,m,k", [(0, 8, 4), (1, 16, 8)])
def test_dmma_portable_body_matches_plain_product(libs, shape, m, k):
    rng = np.random.default_rng(shape)
    A, B, C = (torch.as_tensor(rng.normal(size=s))
               for s in ((m, k), (k, 8), (m, 8)))
    D = C.clone()
    assert libs["dmma"].run(shape, _p(A), _p(B), _p(D)) == 0
    assert_allclose(D.numpy(), (C + A @ B).numpy(), rtol=1e-14, atol=1e-14)


@pytest.mark.parametrize("n,K,p,S", KR_CASES)
def test_kr_contract_tiles_match_plain(libs, n, K, p, S):
    rng = np.random.default_rng(n * K + p)
    U, V, G = (torch.as_tensor(rng.normal(size=s))
               for s in ((n, K), (n, p), (n, S)))
    M = torch.full((K, p, S), np.nan, dtype=torch.float64)
    assert libs["kr_contract"].crm_kr_contract(
        _p(U), _p(V), _p(G), _p(M), n, K, p, S, None) == 0
    ref = k1.kr_contract_plain(U, V, G)
    err = float((M - ref).abs().max())
    assert err <= 1e-12 * float(ref.abs().max()), err


def _localize_call(p1, f32, genes=0, seed=270):
    ctx, G, n = fit_dataset(seed + p1, p=p1 - 1, nrho=21, S=3)
    if genes:
        rng = np.random.default_rng(seed)
        Y = ctx.y[None] + 0.4 * torch.as_tensor(rng.normal(size=(genes, n)))
        ctx = ctx._replace(y=Y, Zy=Y @ ctx.Z, Wy=Y @ ctx.W,
                           yy=(Y * Y).sum(dim=1))
        run = lambda: engine.interaction_multigene_batch(  # noqa: E731
            ctx, G, G, n, delta_cfg=(-18.0, 18.0, 16, 60), newton_f32=2,
            newton_f64=1)
    else:
        run = lambda: engine.interaction_batch(  # noqa: E731
            ctx, G, G, n, delta_cfg=(-18.0, 18.0, 16, 60), newton_f32=2,
            newton_f64=1, localize_f32=f32)
    (args, kw), = captured(run, ["reml_localize"])["reml_localize"]
    c = lambda a: a.contiguous() if isinstance(a, torch.Tensor) else a  # noqa
    args = tuple(type(a)(*map(c, a)) if isinstance(a, tuple) else c(a)
                 for a in args)
    assert args[3].CWW.shape[0] + 1 == p1 and args[0].shape[0] == 21
    assert args[9] == f32
    return args, kw


def _localize_close(lib, args, kw):
    x, lml_all, kb = k3.call_localize(lib, *args, **kw)
    xp, lml_p, kb_p = k3.reml_localize_plain(*args, **kw)
    assert torch.equal(kb, kb_p)
    assert_allclose(x.numpy(), xp.numpy(), rtol=1e-9, atol=1e-9)
    assert_allclose(lml_all.numpy(), lml_p.numpy(), rtol=1e-10)


@pytest.mark.parametrize("f32", [True, False])
@pytest.mark.parametrize("p1", [17, 25, 33])
def test_localize_product_route_matches_plain(libs, p1, f32):
    args, kw = _localize_call(p1, f32)
    _localize_close(libs["reml_newton"], args, kw)


def test_localize_product_route_gene_axis(libs):
    """Three phenotypes at p + 1 = 17: a gene at a time through one
    scratch, every gene's x, lml and k_best written."""
    args, kw = _localize_call(17, True, genes=3)
    assert args[2].shape[0] == 3
    _localize_close(libs["reml_newton"], args, kw)


@pytest.mark.parametrize("p1", [4, 5, 9])
def test_localize_either_side_of_the_product_route(libs, p1):
    """p + 1 = 4, the widest register instantiation (a block a variant),
    and 5 and 9, on the product route from there."""
    args, kw = _localize_call(p1, True)
    _localize_close(libs["reml_newton"], args, kw)
