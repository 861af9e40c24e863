"""The port's CUDA kernel sources, run on the CPU under an emulator, against
their plain torch versions.

The card alone compiles the kernels for real (tests/test_torch_cuda.py and
chip_smoke.py).  Here each ``csrc/*.cu`` is compiled by g++ against a small
header that emulates the CUDA subset the kernels use: a launch runs its
blocks one after another, each block as one std::thread per CUDA thread,
``__shared__`` arrays are block-wide statics and ``__syncthreads`` is a
std::barrier.  That runs the kernels' own indexing, tiling, masking and
synchronisation at small shapes, on every test run.

Tolerance: the emulated kernel sums in its own order (FMA on the host), so
it agrees with the plain versions at 1e-12 of the output's largest entry
(1e-10 for K5, whose K0^{-1} forms subtract nearly equal Grams).
"""
import ctypes
import re
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_inputs import kr_inputs, rotate_inputs, score_inputs
from cellregmap_tpu_torch.kernels import best_rho_rotate as k4
from cellregmap_tpu_torch.kernels import kr_contract as k1
from cellregmap_tpu_torch.kernels import score_core as k5

CSRC = Path(__file__).resolve().parent.parent / "cellregmap_tpu_torch" / "csrc"
CASES = [(C, p) for C in (3, 10, 50) for p in (1, 2)]

EMU_RUNTIME = r"""
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <thread>
#include <vector>
using std::max;
using std::min;
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct emu_uint3 { unsigned x, y, z; };
inline thread_local emu_uint3 threadIdx, blockIdx;
inline dim3 blockDim, gridDim;
typedef void* cudaStream_t;
inline int cudaGetLastError() { return 0; }
inline std::barrier<>* emu_block_barrier = nullptr;
#define __global__
#define __device__
#define __shared__ static
#define __restrict__
#define __launch_bounds__(n)
inline void __syncthreads() { emu_block_barrier->arrive_and_wait(); }
template <class F, class... A>
void emu_launch(F kernel, dim3 grid, dim3 block, A... args) {
  gridDim = grid;
  blockDim = block;
  const unsigned nt = block.x * block.y * block.z;
  for (unsigned bz = 0; bz < grid.z; ++bz)
    for (unsigned by = 0; by < grid.y; ++by)
      for (unsigned bx = 0; bx < grid.x; ++bx) {
        std::barrier<> bar(nt);
        emu_block_barrier = &bar;
        std::vector<std::thread> threads;
        for (unsigned t = 0; t < nt; ++t)
          threads.emplace_back([&, t]() {
            threadIdx = {t, 0, 0};
            blockIdx = {bx, by, bz};
            kernel(args...);
          });
        for (auto& th : threads) th.join();
      }
}
"""


def _emulated(name, workdir):
    src = (CSRC / f"{name}.cu").read_text()
    src = src.replace("#include <cuda_runtime.h>", '#include "emu_runtime.h"')
    # kernel<<<grid, block, smem, stream>>>(args)  ->  emu_launch(kernel, ...)
    src, n = re.subn(r"(\w+)<<<([^,]+),\s*([^,]+),\s*[^,]+,\s*[^>]+>>>\(",
                     r"emu_launch(\1, \2, \3, ", src)
    assert n == 1, f"{name}.cu: expected one kernel launch, found {n}"
    (workdir / "emu_runtime.h").write_text(EMU_RUNTIME)
    cpp = workdir / f"{name}.cpp"
    cpp.write_text(src)
    lib = workdir / f"lib{name}.so"
    subprocess.run(["g++", "-std=c++20", "-O1", "-shared", "-fPIC",
                    "-I", str(workdir), "-o", str(lib), str(cpp),
                    "-lpthread"], check=True, capture_output=True,
                   timeout=300)
    return ctypes.CDLL(str(lib))


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("cuda_emu")
    out = {}
    for name, mod in (("kr_contract", k1), ("best_rho_rotate", k4),
                      ("score_core", k5)):
        out[name] = _emulated(name, workdir)
        mod._bind(out[name])
    return out


def _p(t):
    return ctypes.c_void_p(t.data_ptr())


def _close(got, want, rel):
    err = float((got - want).abs().max())
    assert err <= rel * float(want.abs().max()), err


@pytest.mark.parametrize("C,p", CASES)
def test_kr_contract_source_matches_plain(libs, C, p):
    U, _, G = (torch.as_tensor(a) for a in kr_inputs(C + p, n=70, K=C + 69,
                                                        S=37))
    for width in (C, p):
        V = torch.as_tensor(np.random.default_rng(width).normal(
            size=(U.shape[0], width)))
        n, K = U.shape
        S = G.shape[1]
        M = torch.full((K, width, S), np.nan, dtype=torch.float64)
        err = libs["kr_contract"].crm_kr_contract(
            _p(U), _p(V), _p(G), _p(M), n, K, width, S, None)
        assert err == 0
        _close(M, k1.kr_contract_plain(U, V, G), 1e-12)


@pytest.mark.parametrize("C,p", CASES)
def test_best_rho_rotate_source_matches_plain(libs, C, p):
    V, T, kb = (torch.as_tensor(a)
                for a in rotate_inputs(C + p, R=130, C=C, S=5 + p))
    R, C_, S = T.shape
    At = torch.full((S, R, C_), np.nan, dtype=torch.float64)
    order = torch.argsort(kb)
    err = libs["best_rho_rotate"].crm_best_rho_rotate(
        _p(V), _p(T), _p(kb), _p(order), _p(At), R, C_, S, None)
    assert err == 0
    _close(At, k4.best_rho_rotate_plain(V, T, kb), 1e-12)


@pytest.mark.parametrize("C,p", CASES)
def test_score_core_source_matches_plain(libs, C, p):
    args = [torch.as_tensor(a)
            for a in score_inputs(C + p, C=C, p=p, n=80, R=37, S=6)]
    S, R, C_ = args[3].shape
    Q = torch.full((S,), np.nan, dtype=torch.float64)
    Wmat = torch.full((S, C_, C_), np.nan, dtype=torch.float64)
    err = libs["score_core"].crm_score_core(
        *[_p(t) for t in args + [Q, Wmat]], R, C_, p, S, None)
    assert err == 0
    Qr, Wr = k5.score_core_plain(*args)
    _close(Q, Qr, 1e-10)
    _close(Wmat, Wr, 1e-10)
