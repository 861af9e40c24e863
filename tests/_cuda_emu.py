"""Compile the port's CUDA sources for the CPU, under a small emulation of
the CUDA subset they use (the tests of ``test_torch_cuda_emulated.py`` and
``test_torch_emulated_multigene_association.py``).

A launch runs its blocks one after another, each block's CUDA threads as
coroutines on the calling thread (a stack each, switched by a few lines of
x86-64 assembly); ``__shared__`` arrays are block-wide statics,
``__syncthreads`` and ``__syncwarp`` are barriers whose waiters yield to
the scheduler, and a warp shuffle is an exchange through one of two
per-warp buffers, alternating, behind one warp barrier.

A thread runs until it waits at a barrier or ends, so a block's
interleaving is the scheduler's order, which changes from block to block
(the launch's count plus the block's index picks one of four):

* round robin: each thread that can run, in index order, once a pass;
* run ahead, lowest index first: always the lowest-numbered thread that
  can run, so warp 0 goes on past each barrier as far as it can before
  the higher warps move (a warp that writes shared memory for the next
  step before the others read this step's value is caught here);
* run ahead, highest index first: the same with the last warp ahead;
* run ahead in a seeded random order of the threads (lanes of one warp
  out of order too).

What it cannot show: an interleaving inside the stretch between two
barriers (a thread's stretch runs whole, so a race between two threads
that both write one location with no barrier between them, or a read
that depends on another thread's progress within a stretch, passes or
fails by the order alone), a missing ``__syncwarp`` inside a warp whose
lanes the card would keep in step, and memory ordering: every write is
seen at once by every later reader.
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
#include <cmath>
#include <cstdint>
#include <cstring>
#include <memory>
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
// the running CUDA thread's indices (set by the scheduler at each switch)
inline emu_uint3 threadIdx, blockIdx;
inline dim3 blockDim, gridDim;
typedef void* cudaStream_t;
// a launch given a stream (the tests pass none: a non-null stream is an
// argument list out of step with the entry point's) fails; a block whose
// threads all wait on barriers that cannot complete fails with 999
inline int emu_error = 0;
inline int cudaGetLastError() {
  const int e = emu_error;
  emu_error = 0;
  return e;
}
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
inline long long __double_as_longlong(double x) {
  long long r;
  std::memcpy(&r, &x, sizeof r);
  return r;
}
inline double __longlong_as_double(long long x) {
  double r;
  std::memcpy(&r, &x, sizeof r);
  return r;
}
using std::fma;

// A block's threads are coroutines on the calling thread, each with a
// stack of its own, switched by emu_switch (the callee-saved registers
// pushed on the old stack, the stack pointer swapped, the new one's
// popped): a barrier's waiters yield to the scheduler, which resumes the
// block's threads in turn.
extern "C" void emu_switch(void** save_sp, void* load_sp);
asm(R"(
.text
.p2align 4
.hidden emu_switch
.globl emu_switch
.type emu_switch, @function
emu_switch:
  pushq %rbp
  pushq %rbx
  pushq %r12
  pushq %r13
  pushq %r14
  pushq %r15
  movq %rsp, (%rdi)
  movq %rsi, %rsp
  popq %r15
  popq %r14
  popq %r13
  popq %r12
  popq %rbx
  popq %rbp
  ret
.size emu_switch, .-emu_switch
)");
constexpr unsigned EMU_STACK = 1u << 18;   // bytes a thread
inline std::vector<std::unique_ptr<char[]>> emu_stacks;
inline std::vector<void*> emu_sp;          // each thread's saved stack
inline std::vector<char> emu_done;
inline void* emu_sched_sp = nullptr;
inline unsigned emu_cur = 0;
inline unsigned long emu_progress = 0;
inline unsigned long emu_launches = 0;
inline void (*emu_body)(void*) = nullptr;
inline void* emu_body_arg = nullptr;
inline void emu_yield() { emu_switch(&emu_sp[emu_cur], emu_sched_sp); }
[[noreturn]] inline void emu_entry() {
  emu_body(emu_body_arg);
  emu_done[emu_cur] = 1;
  ++emu_progress;
  emu_switch(&emu_sp[emu_cur], emu_sched_sp);
  __builtin_unreachable();
}
struct EmuBarrier;
// the barrier each thread waits at (null: none) and its generation then
inline std::vector<const EmuBarrier*> emu_wait_bar;
inline std::vector<unsigned> emu_wait_gen;
struct EmuBarrier {
  unsigned expected = 0, count = 0, gen = 0;
  void arrive_and_wait() {
    const unsigned g = gen;
    if (++count == expected) {
      count = 0;
      ++gen;
      ++emu_progress;
      return;
    }
    emu_wait_bar[emu_cur] = this;
    emu_wait_gen[emu_cur] = g;
    while (gen == g) emu_yield();
    emu_wait_bar[emu_cur] = nullptr;
  }
};
// thread t can run: not ended, and not at a barrier still closed
inline bool emu_runnable(unsigned t) {
  return !emu_done[t] &&
         !(emu_wait_bar[t] && emu_wait_bar[t]->gen == emu_wait_gen[t]);
}
// resume thread t until it waits or ends
inline void emu_resume(unsigned t, unsigned bx, unsigned by, unsigned bz) {
  emu_cur = t;
  threadIdx = {t, 0, 0};
  blockIdx = {bx, by, bz};
  emu_switch(&emu_sched_sp, emu_sp[t]);
}
inline EmuBarrier emu_block_barrier;
inline std::vector<EmuBarrier> emu_warp_barriers;
// two exchange buffers, alternating by each thread's count of exchanges:
// a lane writes buffer b only after the barrier of the exchange before,
// which every lane passes after reading buffer b of the one before that
inline unsigned char emu_xchg[2][1024][8];
inline unsigned emu_parity[1024];
inline void __syncthreads() { emu_block_barrier.arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) {
  emu_warp_barriers[threadIdx.x / 32].arrive_and_wait();
}
// value of thread `src` (same block) to every thread of the calling warp
template <class T> T emu_exchange(T v, unsigned src) {
  const unsigned t = threadIdx.x, b = emu_parity[t] ^= 1u;
  std::memcpy(emu_xchg[b][t], &v, sizeof(T));
  __syncwarp();
  T r;
  std::memcpy(&r, emu_xchg[b][src], sizeof(T));
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
  const unsigned t = threadIdx.x, w0 = t & ~31u, b = emu_parity[t] ^= 1u;
  emu_xchg[b][t][0] = pred ? 1 : 0;
  __syncwarp();
  unsigned m = 0;
  for (unsigned l = 0; l < 32 && w0 + l < blockDim.x; ++l)
    if (emu_xchg[b][w0 + l][0]) m |= 1u << l;
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
  while (emu_stacks.size() < nt)
    emu_stacks.emplace_back(new char[EMU_STACK]);
  emu_sp.resize(nt);
  emu_done.resize(nt);
  emu_wait_bar.assign(nt, nullptr);
  emu_wait_gen.assign(nt, 0);
  std::vector<unsigned> order(nt);
  const unsigned long launch = emu_launches++;
  auto body = [&]() { kernel(args...); };
  emu_body = [](void* f) { (*static_cast<decltype(body)*>(f))(); };
  emu_body_arg = &body;
  for (unsigned bz = 0; bz < grid.z; ++bz)
    for (unsigned by = 0; by < grid.y; ++by)
      for (unsigned bx = 0; bx < grid.x; ++bx) {
        emu_block_barrier = EmuBarrier{nt, 0, 0};
        emu_warp_barriers.assign((nt + 31) / 32, EmuBarrier{});
        for (unsigned w = 0; w * 32 < nt; ++w)
          emu_warp_barriers[w].expected = std::min(32u, nt - 32 * w);
        for (unsigned t = 0; t < nt; ++t) {
          // a fresh stack: six zero registers under emu_entry's address,
          // which emu_switch's ret takes with the stack as after a call
          auto top = reinterpret_cast<std::uintptr_t>(emu_stacks[t].get() +
                                                      EMU_STACK) & ~15ull;
          void** sp = reinterpret_cast<void**>(top - 64);
          for (int i = 0; i < 6; ++i) sp[i] = nullptr;
          sp[6] = reinterpret_cast<void*>(&emu_entry);
          emu_sp[t] = sp;
          emu_done[t] = 0;
          emu_parity[t] = 0;
          emu_wait_bar[t] = nullptr;
        }
        // the block's scheduler (the module's doc): the order the threads
        // are tried in, and whether each pass is round robin or the first
        // thread that can run in that order
        const unsigned long blk = (bz * grid.y + by) * grid.x + bx;
        const unsigned mode = (unsigned)((launch + blk) % 4);
        for (unsigned t = 0; t < nt; ++t) order[t] = mode == 2 ? nt - 1 - t : t;
        if (mode == 3) {
          unsigned long long x = 0x9e3779b97f4a7c15ull * (launch * 131 + blk + 1);
          for (unsigned t = nt - 1; t > 0; --t) {   // Fisher-Yates
            x ^= x >> 12;
            x ^= x << 25;
            x ^= x >> 27;
            std::swap(order[t], order[(x * 0x2545f4914f6cdd1dull >> 33) % (t + 1)]);
          }
        }
        for (unsigned left = nt; left > 0;) {
          bool ran = false;
          for (unsigned i = 0; i < nt; ++i) {
            const unsigned t = order[i];
            if (!emu_runnable(t)) continue;
            const unsigned long before = emu_progress;
            emu_resume(t, bx, by, bz);
            ran = true;
            if (emu_done[t]) --left;
            // run ahead: a barrier opened (or a thread ended), so start
            // again from the first thread of the order
            if (mode != 0 && emu_progress != before) break;
          }
          if (left > 0 && !ran) {
            emu_error = 999;   // every thread left waits: a deadlock
            return;
          }
        }
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
