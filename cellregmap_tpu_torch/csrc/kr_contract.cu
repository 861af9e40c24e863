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
// on an f32 NullContext) takes the same contraction in f32 with f32 sums:
// kr_f32_kernel below, plain FP32 FMA on the CUDA cores.  mma.sync has no
// f32 form, and TF32 (10 mantissa bits) is not the reference's f32.  A
// block is a 64 (k) x 64 (s) tile of one column j of V, 256 threads of 4 x
// 4 sums each, over a two-stage cp.async ring of 16-cell chunks of U, G and
// V[:, j]; each staged G value is scaled by V[n, j] as it is read (the
// product rounded to f32, as the plain version's `V[:, j] * G`).  Its
// bound at the screen's T (n = 2000, K = R = 1000, C = 10, S = 1024) is
// operations: 2 n K C S = 4.1e10 flop, 0.61 ms at 67 TFLOP/s.
#include <cuda_runtime.h>
#include <cstdint>

#include "async_copy.cuh"
#include "dmma.cuh"

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
// The float32 context: FP32 FMA, a 64 x 64 tile of one column of V a block
// ---------------------------------------------------------------------------
constexpr int F_THREADS = 256;  // 16 x 16 threads, 4 x 4 sums each
constexpr int F_BM = 64;        // k rows a block
constexpr int F_BS = 64;        // s columns a block
constexpr int F_NC = 16;        // cells a staged chunk

__global__ void __launch_bounds__(F_THREADS)
kr_f32_kernel(const float* __restrict__ U, const float* __restrict__ V,
              const float* __restrict__ G, float* __restrict__ M, int n,
              int K, int p, int S) {
  __align__(16) __shared__ float us[2][F_NC][F_BM];
  __align__(16) __shared__ float gs[2][F_NC][F_BS];
  __shared__ float vs[2][F_NC];
  const int s0 = blockIdx.x * F_BS, k0 = blockIdx.y * F_BM, j = blockIdx.z;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  auto load = [&](int b, int chunk) {
    const int n0 = chunk * F_NC;
    for (int e = tid; e < F_NC * F_BM; e += F_THREADS) {
      const int r = e / F_BM, c = e - r * F_BM;
      float* d = &us[b][r][c];
      if (n0 + r < n && k0 + c < K)
        cp_async4(d, U + (int64_t)(n0 + r) * K + k0 + c);
      else
        *d = 0.0f;
    }
    for (int e = tid; e < F_NC * F_BS; e += F_THREADS) {
      const int r = e / F_BS, c = e - r * F_BS;
      float* d = &gs[b][r][c];
      if (n0 + r < n && s0 + c < S)
        cp_async4(d, G + (int64_t)(n0 + r) * S + s0 + c);
      else
        *d = 0.0f;
    }
    for (int r = tid; r < F_NC; r += F_THREADS) {
      if (n0 + r < n)
        cp_async4(&vs[b][r], V + (int64_t)(n0 + r) * p + j);
      else
        vs[b][r] = 0.0f;
    }
  };

  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.0f;

  const int chunks = (n + F_NC - 1) / F_NC;
  load(0, 0);
  cp_async_commit();
  for (int c = 0; c < chunks; ++c) {
    if (c + 1 < chunks) load((c + 1) & 1, c + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // chunk c landed for every thread
    const int b = c & 1;
#pragma unroll
    for (int r = 0; r < F_NC; ++r) {
      float a[4], g[4];
      load4(&us[b][r][ty * 4], a);
      load4(&gs[b][r][tx * 4], g);
      const float v = vs[b][r];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float gv = v * g[q];  // V G rounded as the plain version's
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][q] = fmaf(a[i], gv, acc[i][q]);
      }
    }
    __syncthreads();  // every thread is done with buffer b before its reload
  }
  cp_async_wait<0>();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = k0 + ty * 4 + i;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int sc = s0 + tx * 4 + q;
      if (k < K && sc < S) M[((int64_t)k * p + j) * S + sc] = acc[i][q];
    }
  }
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

// The float32 context's contraction: U (n, K), V (n, p), G (n, S), M (K,
// p, S), all row-major f32 on the card, f32 sums.  Launches on `stream`;
// returns cudaGetLastError().
extern "C" int crm_kr_contract_f32(const float* U, const float* V,
                                   const float* G, float* M, int n, int K,
                                   int p, int S, cudaStream_t stream) {
  const dim3 grid((S + F_BS - 1) / F_BS, (K + F_BM - 1) / F_BM, p);
  auto kernel = kr_f32_kernel;
  kernel<<<grid, F_THREADS, 0, stream>>>(U, V, G, M, n, K, p, S);
  return (int)cudaGetLastError();
}
