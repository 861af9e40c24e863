// K1: Khatri-Rao contraction, f64, for sm_90a.
//
//   M[k, j, s] = sum_n U[n, k] * V[n, j] * G[n, s]      -> (K, p, S)
//
// Replaces: cellregmap_tpu/engine.py `_kr_contract` (and its callers
// `_khatri_rao_rotate`, `_e0_weighted_grams`, `_cross_weighted_grams`),
// which XLA ran as one (K, n) @ (n, p*S) matmul over a materialized
// Khatri-Rao operand, cell-blocked to bound the TPU's f64 limb expansion.
//
// What bounds it on the H100: operations.  At the scan's headline shape
// (n=2000, K=R=1010, p=C=10, S=512) the T contraction does 2nKpS = 2.1e10
// f64 flop on 16 MB of input and 41 MB of output: ~250 flop per byte, far
// above the f64 ridge point (67 TFLOP/s FP64 tensor core / 3.35 TB/s = 20).
//
// Design: a tiled product M = U^T (V o G) on the FP64 tensor cores
// (dmma.cuh, mma.sync m16n8k8: the shape that reaches the card's 67 TFLOP/s
// with four warps a block).  A block's output tile lies within columns j0,
// j0 + JB of V and one 32- or 64-wide range of s, so the Khatri-Rao
// operand is never materialized: the block stages U[cells, k-tile],
// G[cells, s-tile] and V[cells, j0 .. j0 + JB) and each warp scales its G
// fragment by V[n, j] as it loads it (the product V G rounded as the plain
// version's `V[:, j] * G`), so one staged G tile serves JB columns of V.
//
// Two kernels, one launch a call, M written once with no scratch:
// * K > 32 (T = Z^T (E0 o G), the effect sizes' Ua): a 64 (k) x 64 (s)
//   tile of four warps (2 x 2, each a 32 x 32 x JB sub-tile) over a
//   three-stage cp.async ring of 32-cell chunks (16-byte copies where the
//   rows allow, 8-byte ones at odd widths), one barrier a chunk; the
//   shared rows are padded to 4 mod 16 doubles, so the fragment loads of a
//   half-warp fall in distinct banks.
// * K <= 32 (the context Grams: kr_small_kernel below), the cells split
//   over a block's warps.
//
// The float32 context (the screen's, cellregmap_tpu/engine.py:316-326 run
// on an f32 NullContext) takes the same contraction in f32 with f32 sums,
// two routes chosen by K:
// * K > 32 (T, the effect sizes' Ua, C > 32): kr_tf32_kernel below,
//   split-TF32 products on the tensor cores (tf32mma.cuh: each operand
//   hi + lo in TF32, three products a term, a fresh f32 partial a step):
//   f32-accurate sums on the 495 TFLOP/s TF32 rate instead of the 67 of
//   the FP32 pipes.  Its bound at the screen's T (n = 2000, K = R = 1000,
//   C = 10, S = 1024) is operations: 3 x 2 n K C S = 1.2e11 TF32 flop,
//   0.248 ms (0.611 ms for the same sums by FP32 FMA).
// * K <= 32 (the context Grams A^T A, A^T W): kr_small_f32_kernel, FP32
//   FMA with the cells split over a block's warps and over blocks, the
//   blocks' partial sums added in a fixed order by a second launch.
#include <cuda_runtime.h>
#include <cstdint>

#include "async_copy.cuh"
#include "dmma.cuh"
#include "tf32mma.cuh"

namespace {

// the ring's depth and the columns of V a block takes: the fastest of
// 16 or 32 cells a chunk, 3 or 4 stages and 1 or 2 columns at the
// headline's T (an H100 80GB HBM3 at 700 W: 0.555 ms for a 32-cell ring
// of 3 with 2 columns, 0.61-0.69 ms for the others)
constexpr int THREADS = 128;  // four warps
constexpr int NC = 32;        // cells a staged chunk
constexpr int STAGES = 3;     // chunks in flight
constexpr int JB_MAX = 2;     // columns of V a large-K block takes
constexpr int PAD = 4;        // row padding: 4 mod 16 doubles

constexpr int WK = 2;          // warps along k
constexpr int BM = 32 * WK;    // k rows a block
constexpr int BS = 64;         // s columns a block (two warps)
constexpr int LDU = BM + PAD;
constexpr int LDG = BS + PAD;
constexpr int STAGE = NC * (LDU + LDG);  // doubles, V apart

template <int JB>
constexpr int smem_doubles() {
  return STAGES * (STAGE + NC * JB);
}

// rows [n0, n0 + NC) of a row-major (n, width) matrix, columns [c0, c0 +
// cols), into a shared tile of leading dimension ld; zero outside
__device__ __forceinline__ void stage_rows(double* dst, int ld,
                                           const double* __restrict__ src,
                                           int n, int width, int n0, int c0,
                                           int cols, bool vec) {
  if (vec) {  // width even and src 16-byte aligned: pairs of columns
    const int pairs = cols / 2;
    for (int e = threadIdx.x; e < NC * pairs; e += THREADS) {
      const int r = e / pairs, c = 2 * (e - r * pairs);
      double* d = dst + r * ld + c;
      if (n0 + r < n && c0 + c < width) {
        cp_async16(d, src + (int64_t)(n0 + r) * width + c0 + c);
      } else {
        d[0] = 0.0;
        d[1] = 0.0;
      }
    }
  } else {
    for (int e = threadIdx.x; e < NC * cols; e += THREADS) {
      const int r = e / cols, c = e - r * cols;
      double* d = dst + r * ld + c;
      if (n0 + r < n && c0 + c < width)
        cp_async8(d, src + (int64_t)(n0 + r) * width + c0 + c);
      else
        *d = 0.0;
    }
  }
}

template <int JB>
__global__ void __launch_bounds__(THREADS)
kr_contract_kernel(const double* __restrict__ U, const double* __restrict__ V,
                   const double* __restrict__ G, double* __restrict__ M,
                   int n, int K, int p, int S, int vec_u, int vec_g) {
  extern __shared__ __align__(16) unsigned char kr_dyn[];
  double* sm = reinterpret_cast<double*>(kr_dyn);
  const int s0 = blockIdx.x * BS;
  const int k0 = blockIdx.y * BM;
  const int j0 = blockIdx.z * JB;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int wk = warp % WK, ws = warp / WK;  // the warp's sub-tile

  auto u_tile = [&](int b) { return sm + b * (STAGE + NC * JB); };
  auto g_tile = [&](int b) { return u_tile(b) + NC * LDU; };
  auto v_tile = [&](int b) { return u_tile(b) + STAGE; };

  auto load = [&](int b, int chunk) {
    const int n0 = chunk * NC;
    stage_rows(u_tile(b), LDU, U, n, K, n0, k0, BM, vec_u != 0);
    stage_rows(g_tile(b), LDG, G, n, S, n0, s0, BS, vec_g != 0);
    for (int e = threadIdx.x; e < NC * JB; e += THREADS) {
      const int r = e / JB, jj = e - r * JB;
      double* d = v_tile(b) + e;
      if (n0 + r < n && j0 + jj < p)
        cp_async8(d, V + (int64_t)(n0 + r) * p + j0 + jj);
      else
        *d = 0.0;
    }
  };

  double acc[JB][2][4][4];
#pragma unroll
  for (int jj = 0; jj < JB; ++jj)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[jj][mt][nt][i] = 0.0;

  const int chunks = (n + NC - 1) / NC;
#pragma unroll
  for (int c = 0; c < STAGES - 1; ++c) {
    if (c < chunks) load(c, c);
    cp_async_commit();
  }
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int next = c + STAGES - 1;
    if (next < chunks) load(next % STAGES, next);
    cp_async_commit();
    const int b = c % STAGES;
    const double* us = u_tile(b) + wk * 32;
    const double* gs = g_tile(b) + ws * 32;
    const double* vs = v_tile(b);
#pragma unroll
    for (int step = 0; step < NC / 8; ++step) {
      const int c8 = step * 8;
      double a[2][4], bg[4][2], v[JB][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          a[mt][i] = us[(c8 + t + 4 * (i >> 1)) * LDU + mt * 16 + g +
                        8 * (i & 1)];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 2; ++i)
          bg[nt][i] = gs[(c8 + t + 4 * i) * LDG + nt * 8 + g];
#pragma unroll
      for (int jj = 0; jj < JB; ++jj)
#pragma unroll
        for (int i = 0; i < 2; ++i) v[jj][i] = vs[(c8 + t + 4 * i) * JB + jj];
#pragma unroll
      for (int jj = 0; jj < JB; ++jj)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const double bv[2] = {v[jj][0] * bg[nt][0], v[jj][1] * bg[nt][1]};
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
            dmma_m16n8k8(acc[jj][mt][nt], a[mt], bv);
        }
    }
  }
  cp_async_wait<0>();

  // d[i] of tile (mt, nt): row mt 16 + g + 8 (i >> 1), column nt 8 + 2t + (i & 1)
#pragma unroll
  for (int jj = 0; jj < JB; ++jj)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int k = k0 + wk * 32 + mt * 16 + g + 8 * (i >> 1);
          const int sc = s0 + ws * 32 + nt * 8 + 2 * t + (i & 1);
          const int j = j0 + jj;
          if (k < K && sc < S && j < p)
            M[((int64_t)k * p + j) * S + sc] = acc[jj][mt][nt][i];
        }
}

// K <= 32 (the context Grams A^T A, A^T W, A^T B: K = C): a block a (32
// s, JB j) tile of all K rows (MT m16 tiles), its SPLIT warps over the
// cells, each loading its fragments from global memory (the operands are
// L2-resident at these widths: G is read once a column group of V) and
// unrolling the 8-cell steps, so that many independent loads are in
// flight; the warps' partials are then added in shared memory in warp
// order, so a result never depends on the schedule (no atomics).  A
// 64-row tile would leave 84% of it empty at K = 10, and a block that
// walked all the cells alone would wait on one chunk's latency at a time.
constexpr int SPLIT = 8;  // warps of a small-K block

template <int MT, int JB>
constexpr int small_smem_doubles() {
  return SPLIT * JB * MT * 16 * 32;
}

template <int MT, int JB>
__global__ void __launch_bounds__(32 * SPLIT)
kr_small_kernel(const double* __restrict__ U, const double* __restrict__ V,
                const double* __restrict__ G, double* __restrict__ M, int n,
                int K, int p, int S) {
  extern __shared__ __align__(16) unsigned char kr_small_dyn[];
  double* red = reinterpret_cast<double*>(kr_small_dyn);
  constexpr int ROWS = MT * 16;
  const int s0 = blockIdx.x * 32;
  const int j0 = blockIdx.y * JB;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int steps = (n + 7) / 8;
  const int per = (steps + SPLIT - 1) / SPLIT;  // 8-cell steps a warp
  const int st0 = warp * per, st1 = min(steps, st0 + per);

  double acc[JB][MT][4][4];
#pragma unroll
  for (int jj = 0; jj < JB; ++jj)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[jj][mt][nt][i] = 0.0;

#pragma unroll 4
  for (int st = st0; st < st1; ++st) {
    const int c8 = st * 8;
    double a[MT][4], bg[4][2], v[JB][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int nn = c8 + t + 4 * (i >> 1), k = mt * 16 + g + 8 * (i & 1);
        a[mt][i] = nn < n && k < K ? U[(int64_t)nn * K + k] : 0.0;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int nn = c8 + t + 4 * i;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int sc = s0 + nt * 8 + g;
        bg[nt][i] = nn < n && sc < S ? G[(int64_t)nn * S + sc] : 0.0;
      }
#pragma unroll
      for (int jj = 0; jj < JB; ++jj)
        v[jj][i] = nn < n && j0 + jj < p ? V[(int64_t)nn * p + j0 + jj] : 0.0;
    }
#pragma unroll
    for (int jj = 0; jj < JB; ++jj)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const double bv[2] = {v[jj][0] * bg[nt][0], v[jj][1] * bg[nt][1]};
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          dmma_m16n8k8(acc[jj][mt][nt], a[mt], bv);
      }
  }

  // d[i] of tile (mt, nt): row mt 16 + g + 8 (i >> 1), column nt 8 + 2t + (i & 1)
#pragma unroll
  for (int jj = 0; jj < JB; ++jj)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = mt * 16 + g + 8 * (i >> 1);
          const int col = nt * 8 + 2 * t + (i & 1);
          red[((warp * JB + jj) * ROWS + row) * 32 + col] = acc[jj][mt][nt][i];
        }
  __syncthreads();
  for (int e = threadIdx.x; e < JB * ROWS * 32; e += 32 * SPLIT) {
    double v = red[e];
#pragma unroll
    for (int w = 1; w < SPLIT; ++w) v += red[w * JB * ROWS * 32 + e];
    const int jj = e / (ROWS * 32), k = (e / 32) % ROWS, s = s0 + e % 32;
    const int j = j0 + jj;
    if (k < K && s < S && j < p) M[((int64_t)k * p + j) * S + s] = v;
  }
}

template <int MT, int JB>
int launch_small(const double* U, const double* V, const double* G,
                 double* M, int n, int K, int p, int S, cudaStream_t stream) {
  auto kernel = kr_small_kernel<MT, JB>;
  const int bytes = (int)sizeof(double) * small_smem_doubles<MT, JB>();
  // the shared-memory limit, raised once a process
  static const int err = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err) return err;
  const dim3 grid((S + 31) / 32, (p + JB - 1) / JB);
  kernel<<<grid, 32 * SPLIT, bytes, stream>>>(U, V, G, M, n, K, p, S);
  return (int)cudaGetLastError();
}

template <int JB>
int launch(const double* U, const double* V, const double* G, double* M,
           int n, int K, int p, int S, cudaStream_t stream) {
  auto kernel = kr_contract_kernel<JB>;
  const int bytes = (int)sizeof(double) * smem_doubles<JB>();
  // the shared-memory limit, raised once a process
  static const int err = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err) return err;
  const dim3 grid((S + BS - 1) / BS, (K + BM - 1) / BM, (p + JB - 1) / JB);
  const int vec_u = K % 2 == 0 && (reinterpret_cast<uintptr_t>(U) & 15) == 0;
  const int vec_g = S % 2 == 0 && (reinterpret_cast<uintptr_t>(G) & 15) == 0;
  kernel<<<grid, THREADS, bytes, stream>>>(U, V, G, M, n, K, p, S, vec_u,
                                           vec_g);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The float32 context, K > 32: split TF32 on the tensor cores
// ---------------------------------------------------------------------------
// A block is a 128 (k) x 128 (column) tile of M = U^T B, B the Khatri-Rao
// operand B[n, (j, s)] = V[n, j] G[n, s] of two columns of V (j0, j0 + 1)
// and 64 of G; 8 warps, 2 (k) x 4 (columns), each a 64 x 32 sub-tile (4 x
// 4 m16n8k8 tiles).  32-cell chunks of U, G and V arrive in a 3-stage ring
// of cp.async copies (16 bytes where the rows allow); each staged value is
// then split once, U[n, k] and V[n, j] G[n, s] (rounded to f32 as the
// plain version's `V[:, j] * G`), into (hi, lo) pairs of a second,
// double-buffered pair of tiles, rows padded to 4 mod 16 pairs so that a
// half-warp's fragment loads fall in distinct banks.  A chunk's split runs
// a chunk ahead of its products, one barrier a chunk.
constexpr int T_THREADS = 256;
constexpr int T_BM = 128;             // k rows a block
constexpr int T_JB = 2;               // columns of V a block
constexpr int T_BS = 64;              // columns of G a block
constexpr int T_BC = T_JB * T_BS;     // Khatri-Rao columns a block
constexpr int T_NC = 32;              // cells a chunk
constexpr int T_STAGES = 3;
constexpr int T_LD2 = 132;            // (hi, lo) pairs a split row
constexpr int T_FRESH = 1;            // 8-cell steps a partial
constexpr int T_RAW = T_NC * (T_BM + T_BS + T_JB);   // floats a raw stage
constexpr int T_SPLIT = 2 * T_NC * T_LD2;            // floats a split tile
constexpr int T_SMEM = 4 * (T_STAGES * T_RAW + 4 * T_SPLIT);   // bytes

__global__ void __launch_bounds__(T_THREADS, 1)
kr_tf32_kernel(const float* __restrict__ U, const float* __restrict__ V,
               const float* __restrict__ G, float* __restrict__ M, int n,
               int K, int p, int S, int vec_u, int vec_g) {
  extern __shared__ __align__(16) unsigned char kr_tf32_dyn[];
  float* sm = reinterpret_cast<float*>(kr_tf32_dyn);
  const int s0 = blockIdx.x * T_BS, k0 = blockIdx.y * T_BM;
  const int j0 = blockIdx.z * T_JB;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int wk = warp & 1, wc = warp >> 1;   // the warp's sub-tile

  auto raw_u = [&](int b) { return sm + b * T_RAW; };
  auto raw_g = [&](int b) { return raw_u(b) + T_NC * T_BM; };
  auto raw_v = [&](int b) { return raw_g(b) + T_NC * T_BS; };
  // split tiles: U's (cell, k) and B's (cell, column) pairs
  auto split_a = [&](int b) { return sm + T_STAGES * T_RAW + b * 2 * T_SPLIT; };
  auto split_b = [&](int b) { return split_a(b) + T_SPLIT; };

  // chunk `chunk` into raw stage b (cells past n and columns past K, S
  // are left as they are: the split masks them)
  auto load = [&](int b, int chunk) {
    const int n0 = chunk * T_NC;
    if (vec_u) {
      for (int e = tid; e < T_NC * T_BM / 4; e += T_THREADS) {
        const int r = e / (T_BM / 4), c = 4 * (e % (T_BM / 4));
        if (n0 + r < n && k0 + c < K)
          cp_async16(raw_u(b) + r * T_BM + c,
                     U + (int64_t)(n0 + r) * K + k0 + c);
      }
    } else {
      for (int e = tid; e < T_NC * T_BM; e += T_THREADS) {
        const int r = e / T_BM, c = e % T_BM;
        if (n0 + r < n && k0 + c < K)
          cp_async4(raw_u(b) + e, U + (int64_t)(n0 + r) * K + k0 + c);
      }
    }
    if (vec_g) {
      for (int e = tid; e < T_NC * T_BS / 4; e += T_THREADS) {
        const int r = e / (T_BS / 4), c = 4 * (e % (T_BS / 4));
        if (n0 + r < n && s0 + c < S)
          cp_async16(raw_g(b) + r * T_BS + c,
                     G + (int64_t)(n0 + r) * S + s0 + c);
      }
    } else {
      for (int e = tid; e < T_NC * T_BS; e += T_THREADS) {
        const int r = e / T_BS, c = e % T_BS;
        if (n0 + r < n && s0 + c < S)
          cp_async4(raw_g(b) + e, G + (int64_t)(n0 + r) * S + s0 + c);
      }
    }
    for (int e = tid; e < T_NC * T_JB; e += T_THREADS) {
      const int r = e / T_JB, jj = e % T_JB;
      if (n0 + r < n && j0 + jj < p)
        cp_async4(raw_v(b) + e, V + (int64_t)(n0 + r) * p + j0 + jj);
    }
  };

  // raw stage b (chunk `chunk`) -> (hi, lo) tiles of buffer sb, in pairs
  // of neighbouring values (a thread's pair one 16-byte store, the warp's
  // stores contiguous); zero outside the operands.  A chunk's 4096 pairs
  // (U's, then B's), 16 a thread, in four quarters (`quarter`), one
  // before each 8-cell step of the chunk before.
  auto split = [&](int b, int sb, int chunk, int quarter) {
    const int n0 = chunk * T_NC;
    for (int i = 4 * quarter; i < 4 * quarter + 4; ++i) {
      int u = tid + i * T_THREADS;
      const bool is_a = u < T_NC * T_BM / 2;
      u -= is_a ? 0 : T_NC * T_BM / 2;
      const int w = is_a ? T_BM / 2 : T_BC / 2;   // pairs a row
      const int r = u / w, c = 2 * (u - r * w);
      float x0, x1, v = 1.0f;
      bool ok0 = n0 + r < n, ok1 = ok0;
      if (is_a) {
        load_pair(raw_u(b) + r * T_BM + c, x0, x1);
        ok0 = ok0 && k0 + c < K;
        ok1 = ok1 && k0 + c + 1 < K;
      } else {
        const int jj = c / T_BS, sc = c - jj * T_BS;
        load_pair(raw_g(b) + r * T_BS + sc, x0, x1);
        v = raw_v(b)[r * T_JB + jj];
        ok0 = ok0 && j0 + jj < p && s0 + sc < S;
        ok1 = ok0 && s0 + sc + 1 < S;
      }
      // V G rounded as the plain version's (v = 1 for U)
      float q[4];
      tf32_split(ok0 ? v * x0 : 0.0f, q[0], q[1]);
      tf32_split(ok1 ? v * x1 : 0.0f, q[2], q[3]);
      store4((is_a ? split_a(sb) : split_b(sb)) + 2 * (r * T_LD2 + c), q);
    }
  };

  float acc[4][4][4], part[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.0f;

  const int chunks = (n + T_NC - 1) / T_NC;
#pragma unroll
  for (int c = 0; c < T_STAGES; ++c) {
    if (c < chunks) load(c, c);
    cp_async_commit();
  }
  cp_async_wait<T_STAGES - 1>();
  __syncthreads();
  for (int q = 0; q < 4; ++q) split(0, 0, 0, q);
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait<T_STAGES - 2>();   // chunk c + 1 landed
    // chunk c + 1 seen by every thread, chunk c - 1's products done
    __syncthreads();
    if (c + T_STAGES < chunks) load(c % T_STAGES, c + T_STAGES);
    cp_async_commit();
    const bool more = c + 1 < chunks;
    const float* sa = split_a(c & 1) + 2 * (wk * 64 + g);
    const float* sbt = split_b(c & 1) + 2 * (wc * 32 + g);
    // the 8-cell steps in order, not unrolled (fewer live registers), a
    // quarter of the next chunk's split before each (the warp's loads,
    // arithmetic and stores issue while its products run); a fresh
    // partial each T_FRESH steps, then added to the sums
#pragma unroll 1
    for (int c8 = 0; c8 < T_NC; c8 += 8) {
      if (more) split((c + 1) % T_STAGES, (c + 1) & 1, c + 1, c8 / 8);
      float ah[4][4], al[4][4], bh[4][2], bl[4][2];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          load_pair(sa + 2 * ((c8 + t + 4 * (i >> 1)) * T_LD2 + mt * 16 +
                              8 * (i & 1)),
                    ah[mt][i], al[mt][i]);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 2; ++i)
          load_pair(sbt + 2 * ((c8 + t + 4 * i) * T_LD2 + nt * 8),
                    bh[nt][i], bl[nt][i]);
      const int step = c8 / 8;
      tf32x3_tiles(part, ah, al, bh, bl, step % T_FRESH == 0);
      if (step % T_FRESH == T_FRESH - 1) tf32_flush(acc, part);
    }
  }
  cp_async_wait<0>();

  // d[i] of tile (mt, nt): row mt 16 + g + 8 (i >> 1), column nt 8 + 2t +
  // (i & 1); a pair of neighbouring s a store where S is even
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = k0 + wk * 64 + mt * 16 + g + 8 * h;
        const int c = wc * 32 + nt * 8 + 2 * t;
        const int j = j0 + c / T_BS, sc = s0 + c % T_BS;
        if (k >= K || j >= p || sc >= S) continue;
        float* dst = M + ((int64_t)k * p + j) * S + sc;
        store_pair(dst, acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1],
                   sc + 1 < S, (S & 1) == 0);
      }
}

// ---------------------------------------------------------------------------
// The float32 context, K <= 32: FP32 FMA, the cells split over warps and
// blocks
// ---------------------------------------------------------------------------
// A block is a (32 s, JB j) tile of all K rows, its 8 warps over the cells
// of the block's share (blockIdx.z of `splits`), a cell at a time: lane l
// takes s0 + l, U's row and V's columns are loads every lane of the warp
// shares.  The warps' sums are added in shared memory in warp order, and
// the splits' (written to `part`) by kr_splits_kernel in split order, so a
// result never depends on the schedule.  splits = 1: M directly.
constexpr int S_WARPS = 8;

template <int KM, int JB>
__global__ void __launch_bounds__(32 * S_WARPS)
kr_small_f32_kernel(const float* __restrict__ U, const float* __restrict__ V,
                    const float* __restrict__ G, float* __restrict__ M,
                    float* __restrict__ part, int n, int K, int p, int S) {
  extern __shared__ __align__(16) unsigned char kr_small32_dyn[];
  float* red = reinterpret_cast<float*>(kr_small32_dyn);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int s = blockIdx.x * 32 + lane, j0 = blockIdx.y * JB;
  const int z = blockIdx.z, splits = gridDim.z;
  const int n0 = (int)((int64_t)z * n / splits);
  const int n1 = (int)((int64_t)(z + 1) * n / splits);
  const bool live = s < S;

  float acc[KM][JB];
#pragma unroll
  for (int k = 0; k < KM; ++k)
#pragma unroll
    for (int jj = 0; jj < JB; ++jj) acc[k][jj] = 0.0f;

#pragma unroll 4
  for (int nn = n0 + warp; nn < n1; nn += S_WARPS) {
    const float gv = live ? G[(int64_t)nn * S + s] : 0.0f;
    float vg[JB];
#pragma unroll
    for (int jj = 0; jj < JB; ++jj)   // V G rounded as the plain version's
      vg[jj] = j0 + jj < p ? V[(int64_t)nn * p + j0 + jj] * gv : 0.0f;
    const float* u = U + (int64_t)nn * K;
#pragma unroll
    for (int k = 0; k < KM; ++k) {
      if (k < K) {
        const float uk = u[k];
#pragma unroll
        for (int jj = 0; jj < JB; ++jj) acc[k][jj] = fmaf(uk, vg[jj], acc[k][jj]);
      }
    }
  }

#pragma unroll
  for (int k = 0; k < KM; ++k)
#pragma unroll
    for (int jj = 0; jj < JB; ++jj)
      red[((warp * KM + k) * JB + jj) * 32 + lane] = acc[k][jj];
  __syncthreads();
  for (int e = threadIdx.x; e < KM * JB * 32; e += 32 * S_WARPS) {
    const int k = e / (JB * 32), jj = (e / 32) % JB;
    const int sc = blockIdx.x * 32 + e % 32, j = j0 + jj;
    if (k >= K || j >= p || sc >= S) continue;
    float v = red[e];
#pragma unroll
    for (int w = 1; w < S_WARPS; ++w) v += red[w * KM * JB * 32 + e];
    const int64_t at = ((int64_t)k * p + j) * S + sc;
    if (splits == 1)
      M[at] = v;
    else
      part[(int64_t)z * K * p * S + at] = v;
  }
}

// M = the splits' partial sums, added in split order
__global__ void __launch_bounds__(256)
kr_splits_kernel(const float* __restrict__ part, float* __restrict__ M,
                 int64_t total, int splits) {
  const int64_t e = (int64_t)blockIdx.x * 256 + threadIdx.x;
  if (e >= total) return;
  float v = part[e];
  for (int z = 1; z < splits; ++z) v += part[z * total + e];
  M[e] = v;
}

// the splits of the cells for a small-K call: enough blocks for two a SM
// (132 SMs), each split at least 64 cells, at most 16
int small_splits(int n, int K, int p, int S, int jb) {
  const int tiles = (S + 31) / 32 * ((p + jb - 1) / jb);
  int z = (2 * 132 + tiles - 1) / tiles;
  z = z > 16 ? 16 : z;
  z = z > n / 64 ? n / 64 : z;
  return z < 1 ? 1 : z;
}

int small_jb(int K, int p) {
  if (K <= 16) return p >= 4 ? 4 : (p >= 2 ? 2 : 1);
  return p >= 2 ? 2 : 1;
}

template <int KM, int JB>
int launch_small_f32(const float* U, const float* V, const float* G, float* M,
                     float* part, int n, int K, int p, int S,
                     cudaStream_t stream) {
  auto kernel = kr_small_f32_kernel<KM, JB>;
  const int bytes = (int)sizeof(float) * S_WARPS * KM * JB * 32;
  // the shared-memory limit, raised once a process
  static const int err = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err) return err;
  const int splits = small_splits(n, K, p, S, JB);
  const dim3 grid((S + 31) / 32, (p + JB - 1) / JB, splits);
  kernel<<<grid, 32 * S_WARPS, bytes, stream>>>(U, V, G, M, part, n, K, p,
                                                S);
  int e = (int)cudaGetLastError();
  if (e || splits == 1) return e;
  const int64_t total = (int64_t)K * p * S;
  auto reduce = kr_splits_kernel;
  reduce<<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(part, M, total,
                                                              splits);
  return (int)cudaGetLastError();
}

int launch_tf32(const float* U, const float* V, const float* G, float* M,
                int n, int K, int p, int S, cudaStream_t stream) {
  auto kernel = kr_tf32_kernel;
  // the shared-memory limit, raised once a process
  static const int err = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T_SMEM);
  if (err) return err;
  const dim3 grid((S + T_BS - 1) / T_BS, (K + T_BM - 1) / T_BM,
                  (p + T_JB - 1) / T_JB);
  const int vec_u = K % 4 == 0 && (reinterpret_cast<uintptr_t>(U) & 15) == 0;
  const int vec_g = S % 4 == 0 && (reinterpret_cast<uintptr_t>(G) & 15) == 0;
  kernel<<<grid, T_THREADS, T_SMEM, stream>>>(U, V, G, M, n, K, p, S, vec_u,
                                              vec_g);
  return (int)cudaGetLastError();
}

}  // namespace

// U (n, K), V (n, p), G (n, S), M (K, p, S): all row-major f64 on the card.
// Launches on `stream`; returns cudaGetLastError().
extern "C" int crm_kr_contract(const double* U, const double* V,
                               const double* G, double* M, int n, int K,
                               int p, int S, cudaStream_t stream) {
  if (K <= 16)
    return p >= 2 ? launch_small<1, 2>(U, V, G, M, n, K, p, S, stream)
                  : launch_small<1, 1>(U, V, G, M, n, K, p, S, stream);
  if (K <= 32)
    return p >= 2 ? launch_small<2, 2>(U, V, G, M, n, K, p, S, stream)
                  : launch_small<2, 1>(U, V, G, M, n, K, p, S, stream);
  return p >= 2 ? launch<JB_MAX>(U, V, G, M, n, K, p, S, stream)
                : launch<1>(U, V, G, M, n, K, p, S, stream);
}

// Bytes of scratch a crm_kr_contract_f32 call with these sizes needs: the
// small-K route's split partial sums (none for K > 32 or one split).
extern "C" int64_t crm_kr_contract_f32_workspace(int n, int K, int p,
                                                 int S) {
  if (K > 32) return 0;
  const int z = small_splits(n, K, p, S, small_jb(K, p));
  return z > 1 ? (int64_t)z * K * p * S * (int64_t)sizeof(float) : 0;
}

// The float32 context's contraction: U (n, K), V (n, p), G (n, S), M (K,
// p, S), all row-major f32 on the card, f32 sums; work:
// crm_kr_contract_f32_workspace bytes on the card (null where 0).
// Launches on `stream`; returns the first CUDA error of its launches.
extern "C" int crm_kr_contract_f32(const float* U, const float* V,
                                   const float* G, float* M, void* work,
                                   int n, int K, int p, int S,
                                   cudaStream_t stream) {
  float* part = static_cast<float*>(work);
  if (K > 32) return launch_tf32(U, V, G, M, n, K, p, S, stream);
  const int jb = small_jb(K, p);
  if (K <= 16) {
    if (jb == 4)
      return launch_small_f32<16, 4>(U, V, G, M, part, n, K, p, S, stream);
    if (jb == 2)
      return launch_small_f32<16, 2>(U, V, G, M, part, n, K, p, S, stream);
    return launch_small_f32<16, 1>(U, V, G, M, part, n, K, p, S, stream);
  }
  if (jb == 2)
    return launch_small_f32<32, 2>(U, V, G, M, part, n, K, p, S, stream);
  return launch_small_f32<32, 1>(U, V, G, M, part, n, K, p, S, stream);
}
