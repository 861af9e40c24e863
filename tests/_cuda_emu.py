"""Compile the port's CUDA sources for the CPU, under a small emulation of
the CUDA subset they use (the tests of ``test_torch_cuda_emulated.py`` and
``test_torch_emulated_multigene_association.py``).

A launch runs its blocks one after another, each block as one std::thread
per CUDA thread; ``__shared__`` arrays are block-wide statics,
``__syncthreads`` is a std::barrier and a warp shuffle is an exchange
through a per-warp buffer between two per-warp barriers.
"""
import ctypes
import re
import subprocess
from pathlib import Path

import pytest
import torch

CSRC = Path(__file__).resolve().parent.parent / "cellregmap_tpu_torch" / "csrc"

EMU_RUNTIME = r"""
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>
using std::erf;
using std::erfc;
using std::exp;
using std::fabs;
using std::fmax;
using std::isfinite;
using std::isinf;
using std::isnan;
using std::lgamma;
using std::log;
using std::log1p;
using std::nan;
using std::max;
using std::min;
using std::sqrt;
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct emu_uint3 { unsigned x, y, z; };
inline thread_local emu_uint3 threadIdx, blockIdx;
inline dim3 blockDim, gridDim;
typedef void* cudaStream_t;
// a launch given a stream (the tests pass none: a non-null stream is an
// argument list out of step with the entry point's) fails
inline int emu_error = 0;
inline int cudaGetLastError() {
  const int e = emu_error;
  emu_error = 0;
  return e;
}
inline std::barrier<>* emu_block_barrier = nullptr;
inline std::vector<std::unique_ptr<std::barrier<>>> emu_warp_barriers;
inline unsigned char emu_xchg[1024][8];
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __shared__ static
#define __restrict__
#define __launch_bounds__(...)
#define __align__(n) alignas(n)
typedef int cudaError_t;
constexpr int cudaSuccess = 0;
constexpr int cudaErrorInvalidValue = 1;
constexpr int cudaFuncAttributeMaxDynamicSharedMemorySize = 8;
template <class F> int cudaFuncSetAttribute(F, int, int) { return 0; }
inline float __frcp_rn(float x) { return 1.0f / x; }
inline double __drcp_rn(double x) { return 1.0 / x; }
inline void __syncthreads() { emu_block_barrier->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) {
  emu_warp_barriers[threadIdx.x / 32]->arrive_and_wait();
}
// value of thread `src` (same block) to every thread of the calling warp
template <class T> T emu_exchange(T v, unsigned src) {
  const unsigned t = threadIdx.x;
  std::barrier<>& bar = *emu_warp_barriers[t / 32];
  std::memcpy(emu_xchg[t], &v, sizeof(T));
  bar.arrive_and_wait();
  T r;
  std::memcpy(&r, emu_xchg[src], sizeof(T));
  bar.arrive_and_wait();
  return r;
}
template <class T> T __shfl_xor_sync(unsigned, T v, int mask) {
  const unsigned t = threadIdx.x;
  return emu_exchange(v, (t & ~31u) | ((t & 31u) ^ (unsigned)mask));
}
template <class T> T __shfl_sync(unsigned, T v, int lane) {
  return emu_exchange(v, (threadIdx.x & ~31u) | ((unsigned)lane & 31u));
}
// the lanes' predicates as a mask (whole warps of 32)
inline unsigned __ballot_sync(unsigned, int pred) {
  const unsigned t = threadIdx.x, w0 = t & ~31u;
  std::barrier<>& bar = *emu_warp_barriers[t / 32];
  emu_xchg[t][0] = pred ? 1 : 0;
  bar.arrive_and_wait();
  unsigned m = 0;
  for (unsigned l = 0; l < 32 && w0 + l < blockDim.x; ++l)
    if (emu_xchg[w0 + l][0]) m |= 1u << l;
  bar.arrive_and_wait();
  return m;
}
template <class T> T __shfl_up_sync(unsigned, T v, unsigned d) {
  const unsigned t = threadIdx.x;
  return emu_exchange(v, (t & 31u) >= d ? t - d : t);
}
inline int __popc(unsigned x) { return __builtin_popcount(x); }
template <class F, class... A>
void emu_launch(F kernel, dim3 grid, dim3 block, cudaStream_t stream,
                A... args) {
  if (stream != nullptr) {
    emu_error = 400;  // cudaErrorInvalidResourceHandle
    return;
  }
  gridDim = grid;
  blockDim = block;
  const unsigned nt = block.x * block.y * block.z;
  for (unsigned bz = 0; bz < grid.z; ++bz)
    for (unsigned by = 0; by < grid.y; ++by)
      for (unsigned bx = 0; bx < grid.x; ++bx) {
        std::barrier<> bar(nt);
        emu_block_barrier = &bar;
        emu_warp_barriers.clear();
        for (unsigned w = 0; w * 32 < nt; ++w)
          emu_warp_barriers.emplace_back(
              new std::barrier<>(std::min(32u, nt - 32 * w)));
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


def emulated(name, workdir, defines=(), source=None):
    """The library of ``csrc/<name>.cu`` (or of the CUDA text ``source``,
    which may include the ``csrc`` headers) built for the emulator in
    ``workdir``; ``defines`` are extra ``-D`` macro definitions."""
    src = source if source is not None else (CSRC / f"{name}.cu").read_text()
    src = src.replace("#include <cuda_runtime.h>", '#include "emu_runtime.h"')
    # dynamic shared memory: a block-wide static buffer of the card's limit
    src = re.sub(r"extern __shared__ __align__\((\d+)\) unsigned char "
                 r"(\w+)\[\];", r"alignas(\1) static unsigned char "
                 r"\2[232448];", src)
    # kernel<<<grid, block, smem, stream>>>(args)  ->  emu_launch(kernel, ...)
    src, n = re.subn(r"(\w+)<<<([^,]+),\s*([^,]+),\s*[^,]+,\s*([^>]+)>>>\(",
                     r"emu_launch(\1, \2, \3, \4, ", src)
    assert n >= 1, f"{name}.cu: no kernel launch found"
    (workdir / "emu_runtime.h").write_text(EMU_RUNTIME)
    cpp = workdir / f"{name}.cpp"
    cpp.write_text(src)
    lib = workdir / f"lib{name}.so"
    subprocess.run(["g++", "-std=c++20", "-O1", "-shared", "-fPIC",
                    *(f"-D{d}" for d in defines),
                    "-I", str(workdir), "-I", str(CSRC), "-o", str(lib),
                    str(cpp),
                    "-lpthread"], check=True, capture_output=True,
                   timeout=300)
    return ctypes.CDLL(str(lib))


@pytest.fixture(autouse=True)
def nan_outputs(monkeypatch):
    """Every ``torch.empty`` and ``torch.empty_like`` of a test (the
    wrappers' ``call`` helpers allocate the kernels' outputs with them)
    comes back filled with a sentinel, NaN or -1, so that an output entry
    the kernel never writes fails the comparison instead of holding
    whatever was in memory."""
    def sentinel(alloc):
        def alloc_filled(*args, **kw):
            t = alloc(*args, **kw)
            if t.is_floating_point():
                t.fill_(float("nan"))
            elif t.dtype != torch.bool:
                t.fill_(-1)
            return t
        return alloc_filled

    for name in ("empty", "empty_like"):
        monkeypatch.setattr(torch, name, sentinel(getattr(torch, name)))
