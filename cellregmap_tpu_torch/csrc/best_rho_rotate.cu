// K4: best-rho rotation of the score factor, f64, for sm_90a.
//
//   At[g, s, q, c] = sum_r V[k_gs, r, q] * T[r, c, s]
//
// V (nrho, R, R) holds the per-rho eigenvectors, T (R, C, S) the
// Khatri-Rao rotated score factor (K1's output layout), k_gs gene g's best
// rho at variant s (one gene for a single phenotype; a tile of genes for
// the gene-batched scan, all rotating the one shared T).
//
// Replaces: cellregmap_tpu/engine.py `interaction_batch` lines 672-688,
// which on the TPU ran as a masked sum over ALL nrho rotations
// (nrho x 2 R^2 C S flop).
//
// The contract: each distinct (rho, variant) pair is rotated and stored
// once.  At variant s the rho points that some gene picks are ranked in
// ascending order; slot[g, s] is the rank of k_gs, and
//
//   At_slots[slot[g, s], s] = V[k_gs]^T T[:, :, s]      (m, S, R, C)
//
// with m = min(genes, nrho) slots (one for a single phenotype, so that
// At_slots is the (S, R, C) score factor).  Genes that share a best rho
// share its product: at 16 genes x 512 variants (11 rho) only ~500 of the
// 8192 products are distinct.  Slots past a variant's count of distinct
// rho are never written (the caller allocates At_slots uninitialised).
//
// What bounds it on the H100: operations, 2 R^2 C flop per distinct pair
// (1.05e10 at R = 1010, C = 10, 512 pairs), on the FP64 tensor cores.
//
// Design: a grouped GEMM, one group per rho k.  The variants that any gene
// sends to k, in ascending order, give N_k = C n_k columns (variant-major,
// context-minor), multiplied by the R x R V[k]^T.  Four launches from one
// entry point, with no host between them:
// * rotate_slots_kernel, a thread a variant: the used (k, s) pairs, their
//   ranks (the slots) and slot[g, s];
// * rotate_lists_kernel, a block a rho: the variants that use k, in order
//   (a block-wide prefix sum), and their count n_k;
// * rotate_transpose_kernel: T (R, C, S) to Tt (S, R, C), so that a
//   variant's rows of C contexts are contiguous (a gathered column of T
//   would read one 32-byte sector for each 8-byte value);
// * rotate_gemm_kernel: one block per (64-column tile of one rho's
//   columns, 64-row q tile), four warps of 32 x 32 on mma.sync m16n8k8
//   (dmma.cuh), fed by a three-stage cp.async ring of 32-row chunks of
//   V[k] (16-byte copies) and of the gathered Tt columns (8-byte copies),
//   as K1's T (kr_contract.cu).  The work list is (rho, column tile) in
//   rho order, read from the counts by each block; the grid is sized for
//   the most tiles the pairs could need, and a block past the last tile
//   exits at once.  The q tiles of a column tile run next to each other
//   (its Tt columns stay in L2), and a rho's tiles follow one another
//   (its V[k], 8 MB, stays in L2).
//
// The float32 context (the screen's, engine.py:672-688 on an f32
// NullContext: V and T f32, the product and its sums f32) runs the same
// slots, lists and transpose, then rotate_product_f32_kernel: plain FP32
// FMA (mma.sync has no f32 form, and TF32 is not the reference's f32), on
// the same work list with a 128 (q) x 128 (column) tile a block: 256
// threads of 8 x 8 sums, each row step four float4 loads from shared
// memory (two rows of V[k]'s tile, a broadcast, and two of the gathered
// columns, a quarter warp 128 contiguous bytes: no bank conflict) for 64
// FMAs, 4 a loaded float (a chunk's 32 row steps unrolled 8 at a time:
// wholly unrolled they take more registers and run 13% slower).  A
// three-stage cp.async ring of 32-row chunks with one barrier a chunk
// (96 KB; two blocks an SM at <= 128 registers):
// V[k]'s rows by 16-byte copies (4-byte where R % 4 != 0), and each
// variant's run Tt[s, r0:r0+32, 0:C], contiguous, by 16-byte copies where
// C % 4 == 0 (else 4-byte), to its columns of the tile.  Each sum runs
// over r in order, one fmaf a row, so a launch's bits repeat.  The
// 128-wide tiles halve the L2 traffic of 64-wide ones (each V[k] read
// once a column tile, each column once a q tile).  Its bound is the same
// 2 R^2 C flop per distinct pair, at the 67 TFLOP/s of the FP32 pipes.
#include <cuda_runtime.h>
#include <cstdint>

#include "async_copy.cuh"
#include "dmma.cuh"

namespace {

constexpr int THREADS = 128;   // four warps
constexpr int NC = 32;         // rows of r a staged chunk
constexpr int STAGES = 3;      // chunks in flight
constexpr int PAD = 4;         // row padding: 4 mod 16 doubles
constexpr int BM = 64;         // q rows a block (two warps)
constexpr int BN = 64;         // columns a block (two warps)
constexpr int LDA = BM + PAD;
constexpr int LDB = BN + PAD;
constexpr int STAGE = NC * (LDA + LDB);  // doubles a stage
constexpr int SCAN = 256;      // threads of a lists block

inline int64_t round_up(int64_t a, int64_t b) {
  return (a + b - 1) / b * b;
}

// the scratch, in bytes: rank (nrho, S) and list (nrho, S) int32, count
// (nrho,) int32, then Tt (S, R, C) f64 at a 256-byte boundary
struct Layout {
  int64_t rank, list, count, tt, total;
};

inline Layout layout(int nrho, int R, int C, int S, int esize = 8) {
  Layout L;
  const int64_t ks = (int64_t)nrho * S * 4;
  L.rank = 0;
  L.list = round_up(ks, 256);
  L.count = L.list + round_up(ks, 256);
  L.tt = L.count + round_up((int64_t)nrho * 4, 256);
  L.total = L.tt + (int64_t)S * R * C * esize;
  return L;
}

// tiles of 64 columns that the pairs could need at most: C P / 64 + nrho
// with P <= min(genes, nrho) S distinct pairs
inline int64_t max_tiles(int nrho, int C, int S, int genes) {
  const int64_t m = genes < nrho ? genes : nrho;
  return (int64_t)C * m * S / BN + nrho;
}

// rank[k, s]: the slot of rho k at variant s (-1 where no gene picks it);
// slot[g, s] = rank[k_best[g, s], s]
__global__ void rotate_slots_kernel(const int64_t* __restrict__ k_best,
                                    int* __restrict__ rank,
                                    int64_t* __restrict__ slot, int nrho,
                                    int S, int genes) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= S) return;
  for (int k = 0; k < nrho; ++k) rank[(int64_t)k * S + s] = -1;
  for (int g = 0; g < genes; ++g)  // marked 0: picked by some gene
    rank[k_best[(int64_t)g * S + s] * S + s] = 0;
  int used = 0;
  for (int k = 0; k < nrho; ++k) {
    int* r = rank + (int64_t)k * S + s;
    if (*r == 0) *r = used++;
  }
  for (int g = 0; g < genes; ++g) {
    const int64_t i = (int64_t)g * S + s;
    slot[i] = rank[k_best[i] * S + s];
  }
}

// list[k, 0 .. n_k): the variants at which some gene picks rho k, in
// ascending order; count[k] = n_k.  A block a rho, a prefix sum over each
// SCAN variants in shared memory.
__global__ void __launch_bounds__(SCAN)
rotate_lists_kernel(const int* __restrict__ rank, int* __restrict__ list,
                    int* __restrict__ count, int S) {
  __shared__ int scan[2][SCAN];
  const int k = blockIdx.x;
  const int t = threadIdx.x;
  const int* rk = rank + (int64_t)k * S;
  int* lk = list + (int64_t)k * S;
  int base = 0;
  for (int s0 = 0; s0 < S; s0 += SCAN) {
    const int s = s0 + t;
    const int flag = s < S && rk[s] >= 0 ? 1 : 0;
    int cur = 0;
    scan[0][t] = flag;
    __syncthreads();
    for (int off = 1; off < SCAN; off <<= 1) {  // inclusive, Hillis-Steele
      const int v = scan[cur][t] + (t >= off ? scan[cur][t - off] : 0);
      scan[cur ^ 1][t] = v;
      cur ^= 1;
      __syncthreads();
    }
    if (flag) lk[base + scan[cur][t] - 1] = s;
    base += scan[cur][SCAN - 1];
    __syncthreads();  // the buffers are rewritten by the next chunk
  }
  if (t == 0) count[k] = base;
}

// Tt (S, R C) = T (R C, S)^T, 32 x 32 tiles through shared memory
template <class F>
__global__ void __launch_bounds__(256)
rotate_transpose_kernel(const F* __restrict__ T, F* __restrict__ Tt,
                        int64_t RC, int S) {
  __shared__ F tile[32][33];
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  const int s0 = blockIdx.x * 32;
  const int64_t e0 = (int64_t)blockIdx.y * 32;
  for (int i = ty; i < 32; i += 8) {
    const int64_t e = e0 + i;
    const int s = s0 + tx;
    if (e < RC && s < S) tile[i][tx] = T[e * S + s];
  }
  __syncthreads();
  for (int i = ty; i < 32; i += 8) {
    const int s = s0 + i;
    const int64_t e = e0 + tx;
    if (e < RC && s < S) Tt[(int64_t)s * RC + e] = tile[tx][i];
  }
}

__global__ void __launch_bounds__(THREADS)
rotate_gemm_kernel(const double* __restrict__ V,
                   const double* __restrict__ Tt, const int* __restrict__ rank,
                   const int* __restrict__ list, const int* __restrict__ count,
                   double* __restrict__ At, int nrho, int R, int C, int S,
                   int qtiles, int vec_a) {
  extern __shared__ __align__(16) unsigned char rot_dyn[];
  double* sm = reinterpret_cast<double*>(rot_dyn);
  // per column of the tile: its source offset in Tt (without the row)
  // and its destination offset in At_slots (without q), -1 past N_k
  int64_t* src = reinterpret_cast<int64_t*>(sm + STAGES * STAGE);
  int64_t* dst = src + BN;

  // the work item: (rho k, column tile) in rho order, then the q tile
  const int64_t item = blockIdx.x / qtiles;
  const int q0 = (int)(blockIdx.x % qtiles) * BM;
  int k = -1;
  int64_t n0 = 0, ncols = 0;
  {
    int64_t start = 0;
    for (int kk = 0; kk < nrho; ++kk) {
      const int64_t nk = (int64_t)count[kk] * C;
      const int64_t tiles = (nk + BN - 1) / BN;
      if (item < start + tiles) {
        k = kk;
        n0 = (item - start) * BN;
        ncols = nk;
        break;
      }
      start += tiles;
    }
  }
  if (k < 0) return;  // past the last tile: the whole block exits

  const int64_t RCs = (int64_t)R * C;
  for (int col = threadIdx.x; col < BN; col += THREADS) {
    const int64_t n = n0 + col;
    if (n < ncols) {
      const int j = (int)(n / C), c = (int)(n - (int64_t)j * C);
      const int s = list[(int64_t)k * S + j];
      const int sl = rank[(int64_t)k * S + s];
      src[col] = s * RCs + c;
      dst[col] = ((int64_t)sl * S + s) * RCs + c;
    } else {
      src[col] = -1;
      dst[col] = -1;
    }
  }
  __syncthreads();

  const double* Vk = V + (int64_t)k * R * R;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp % 2, wn = warp / 2;  // the warp's 32 x 32 sub-tile
  auto a_tile = [&](int b) { return sm + b * STAGE; };
  auto b_tile = [&](int b) { return sm + b * STAGE + NC * LDA; };

  auto load = [&](int b, int chunk) {
    const int r0 = chunk * NC;
    double* as = a_tile(b);
    if (vec_a) {  // R even: pairs of q, 16-byte aligned
      for (int e = threadIdx.x; e < NC * BM / 2; e += THREADS) {
        const int rr = e / (BM / 2), qq = 2 * (e - rr * (BM / 2));
        double* d = as + rr * LDA + qq;
        if (r0 + rr < R && q0 + qq < R) {
          cp_async16(d, Vk + (int64_t)(r0 + rr) * R + q0 + qq);
        } else {
          d[0] = 0.0;
          d[1] = 0.0;
        }
      }
    } else {
      for (int e = threadIdx.x; e < NC * BM; e += THREADS) {
        const int rr = e / BM, qq = e - rr * BM;
        double* d = as + rr * LDA + qq;
        if (r0 + rr < R && q0 + qq < R)
          cp_async8(d, Vk + (int64_t)(r0 + rr) * R + q0 + qq);
        else
          *d = 0.0;
      }
    }
    double* bs = b_tile(b);
    for (int e = threadIdx.x; e < NC * BN; e += THREADS) {
      const int rr = e / BN, col = e - rr * BN;
      double* d = bs + rr * LDB + col;
      if (r0 + rr < R && src[col] >= 0)
        cp_async8(d, Tt + src[col] + (int64_t)(r0 + rr) * C);
      else
        *d = 0.0;
    }
  };

  double acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.0;

  const int chunks = (R + NC - 1) / NC;
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
    const double* as = a_tile(b) + wm * 32;
    const double* bs = b_tile(b) + wn * 32;
#pragma unroll
    for (int step = 0; step < NC / 8; ++step) {
      const int c8 = step * 8;
      double a[2][4], bb[4][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          a[mt][i] = as[(c8 + t + 4 * (i >> 1)) * LDA + mt * 16 + g +
                        8 * (i & 1)];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 2; ++i)
          bb[nt][i] = bs[(c8 + t + 4 * i) * LDB + nt * 8 + g];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) dmma_m16n8k8(acc[mt][nt], a[mt], bb[nt]);
    }
  }
  cp_async_wait<0>();

  // d[i] of tile (mt, nt): row mt 16 + g + 8 (i >> 1), column
  // nt 8 + 2t + (i & 1)
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int q = q0 + wm * 32 + mt * 16 + g + 8 * (i >> 1);
        const int col = wn * 32 + nt * 8 + 2 * t + (i & 1);
        if (q < R && dst[col] >= 0)
          At[dst[col] + (int64_t)q * C] = acc[mt][nt][i];
      }
}

// The float32 context's grouped product (the header): a block a (128-column
// tile of one rho's columns, 128-row q tile), 256 threads of 8 x 8 FP32
// sums each, over a three-stage cp.async ring of 32-row chunks.
constexpr int P32_THREADS = 256;
constexpr int P32_BM = 128;      // q rows a block
constexpr int P32_BN = 128;      // columns a block
constexpr int P32_NC = 32;       // rows of r a staged chunk
constexpr int P32_STAGE = P32_NC * (P32_BM + P32_BN);  // floats a stage

// column tiles the pairs could need at most: C P / 128 + nrho with P <=
// min(genes, nrho) S distinct pairs
inline int64_t max_tiles_f32(int nrho, int C, int S, int genes) {
  const int64_t m = genes < nrho ? genes : nrho;
  return (int64_t)C * m * S / P32_BN + nrho;
}

inline int rotate_f32_smem() {
  return (int)(sizeof(float) * STAGES * P32_STAGE +
               sizeof(int64_t) * 2 * P32_BN);
}

__global__ void __launch_bounds__(P32_THREADS, 2)
rotate_product_f32_kernel(const float* __restrict__ V,
                          const float* __restrict__ Tt,
                          const int* __restrict__ rank,
                          const int* __restrict__ list,
                          const int* __restrict__ count,
                          float* __restrict__ At, int nrho, int R, int C,
                          int S, int qtiles, int vec_a, int vec_b) {
  extern __shared__ __align__(16) unsigned char rot_dyn[];
  float* sm = reinterpret_cast<float*>(rot_dyn);
  // per column of the tile: its source offset in Tt (without the row)
  // and its destination offset in At_slots (without q), -1 past N_k
  int64_t* src = reinterpret_cast<int64_t*>(sm + STAGES * P32_STAGE);
  int64_t* dst = src + P32_BN;

  const int64_t item = blockIdx.x / qtiles;
  const int q0 = (int)(blockIdx.x % qtiles) * P32_BM;
  int k = -1;
  int64_t n0 = 0, ncols = 0;
  {
    int64_t start = 0;
    for (int kk = 0; kk < nrho; ++kk) {
      const int64_t nk = (int64_t)count[kk] * C;
      const int64_t tiles = (nk + P32_BN - 1) / P32_BN;
      if (item < start + tiles) {
        k = kk;
        n0 = (item - start) * P32_BN;
        ncols = nk;
        break;
      }
      start += tiles;
    }
  }
  if (k < 0) return;  // past the last tile: the whole block exits

  const int tid = threadIdx.x;
  const int64_t RCs = (int64_t)R * C;
  for (int col = tid; col < P32_BN; col += P32_THREADS) {
    const int64_t n = n0 + col;
    if (n < ncols) {
      const int j = (int)(n / C), c = (int)(n - (int64_t)j * C);
      const int s = list[(int64_t)k * S + j];
      const int sl = rank[(int64_t)k * S + s];
      src[col] = s * RCs + c;
      dst[col] = ((int64_t)sl * S + s) * RCs + c;
    } else {
      src[col] = -1;
      dst[col] = -1;
    }
  }
  __syncthreads();

  // Each thread copies one column (or four) of each operand, the same at
  // every chunk: a warp takes a row of V[k]'s tile (contiguous) and a row
  // of the gathered columns, each variant's C contexts contiguous in Tt
  // (over a chunk, the block reads each variant's run Tt[s, r0:r0+32,
  // 0:C], contiguous).  Rows past R and columns past N_k are zeros.
  const float* Vk = V + (int64_t)k * R * R;
  const int a_q = vec_a ? 4 * (tid % 32) : tid % P32_BM;
  const int a_r = vec_a ? tid / 32 : tid / P32_BM;
  const bool a_in = q0 + a_q < R;
  const float* a_src = Vk + q0 + a_q;
  const int b_col = vec_b ? 4 * (tid % 32) : tid % P32_BN;
  const int b_r = vec_b ? tid / 32 : tid / P32_BN;
  const int64_t b_off = src[b_col];
  const float* b_src = Tt + b_off;
  auto load = [&](int b, int chunk) {
    const int r0 = chunk * P32_NC;
    float* as = sm + b * P32_STAGE;
    float* bs = as + P32_NC * P32_BM;
    if (vec_a) {  // R % 4 == 0: four q a copy, 16-byte aligned
#pragma unroll
      for (int rr = a_r; rr < P32_NC; rr += P32_THREADS / 32) {
        float* d = as + rr * P32_BM + a_q;
        if (r0 + rr < R && a_in)
          cp_async16(d, a_src + (int64_t)(r0 + rr) * R);
        else
          d[0] = d[1] = d[2] = d[3] = 0.0f;
      }
    } else {
#pragma unroll 4
      for (int rr = a_r; rr < P32_NC; rr += P32_THREADS / P32_BM) {
        float* d = as + rr * P32_BM + a_q;
        if (r0 + rr < R && a_in)
          cp_async4(d, a_src + (int64_t)(r0 + rr) * R);
        else
          *d = 0.0f;
      }
    }
    if (vec_b) {  // C % 4 == 0: four contexts of one variant a copy
#pragma unroll
      for (int rr = b_r; rr < P32_NC; rr += P32_THREADS / 32) {
        float* d = bs + rr * P32_BN + b_col;
        if (r0 + rr < R && b_off >= 0)
          cp_async16(d, b_src + (int64_t)(r0 + rr) * C);
        else
          d[0] = d[1] = d[2] = d[3] = 0.0f;
      }
    } else {
#pragma unroll 4
      for (int rr = b_r; rr < P32_NC; rr += P32_THREADS / P32_BN) {
        float* d = bs + rr * P32_BN + b_col;
        if (r0 + rr < R && b_off >= 0)
          cp_async4(d, b_src + (int64_t)(r0 + rr) * C);
        else
          *d = 0.0f;
      }
    }
  };

  // the thread's sums: q rows qa.. qa + 3 and qb.., columns ca.. and cb..
  // (thread (ty, tx) of 16 x 16: a warp reads two rows' float4s of V[k]'s
  // tile, a broadcast, and 16 of the columns', each quarter warp 128
  // contiguous bytes: no bank conflict)
  const int qa = 4 * (tid / 16), qb = qa + 64;
  const int ca = 4 * (tid % 16), cb = ca + 64;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  const int chunks = (R + P32_NC - 1) / P32_NC;
#pragma unroll
  for (int c = 0; c < STAGES - 1; ++c) {
    if (c < chunks) load(c, c);
    cp_async_commit();
  }
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait<STAGES - 2>();
    // chunk c landed for every thread, and every thread is done with
    // chunk c - 1, whose stage the next load takes
    __syncthreads();
    const int next = c + STAGES - 1;
    if (next < chunks) load(next % STAGES, next);
    cp_async_commit();
    const float* as = sm + (c % STAGES) * P32_STAGE;
    const float* bs = as + P32_NC * P32_BM;
#pragma unroll 8
    for (int rr = 0; rr < P32_NC; ++rr) {
      float a0[4], a1[4], b0[4], b1[4];
      load4(as + rr * P32_BM + qa, a0);
      load4(as + rr * P32_BM + qb, a1);
      load4(bs + rr * P32_BN + ca, b0);
      load4(bs + rr * P32_BN + cb, b1);
      const float av[8] = {a0[0], a0[1], a0[2], a0[3],
                           a1[0], a1[1], a1[2], a1[3]};
      const float bv[8] = {b0[0], b0[1], b0[2], b0[3],
                           b1[0], b1[1], b1[2], b1[3]};
#pragma unroll
      for (int i = 0; i < 8; ++i)  // a row of sums at a time
#pragma unroll
        for (int j = 0; j < 8; ++j)
          acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int q = q0 + (i < 4 ? qa : qb) + (i & 3);
    if (q >= R) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = (j < 4 ? ca : cb) + (j & 3);
      if (dst[col] >= 0) At[dst[col] + (int64_t)q * C] = acc[i][j];
    }
  }
}

}  // namespace

// Bytes of scratch a crm_best_rho_rotate call with these sizes needs.
extern "C" int64_t crm_best_rho_rotate_workspace(int nrho, int R, int C,
                                                 int S) {
  return layout(nrho, R, C, S).total;
}

// V (nrho, R, R), T (R, C, S), k_best (genes, S) int64 in [0, nrho) ->
// At_slots (min(genes, nrho), S, R, C), slot (genes, S) int64: row-major
// on the card (a single phenotype is genes = 1).  work:
// crm_best_rho_rotate_workspace bytes, 256-byte aligned.  Launches on
// `stream`; returns the first launch's CUDA error, 0 if none.
extern "C" int crm_best_rho_rotate(const double* V, const double* T,
                                   const int64_t* k_best, double* At,
                                   int64_t* slot, void* work, int nrho,
                                   int R, int C, int S, int genes,
                                   cudaStream_t stream) {
  const Layout L = layout(nrho, R, C, S);
  unsigned char* base = static_cast<unsigned char*>(work);
  int* rank = reinterpret_cast<int*>(base + L.rank);
  int* list = reinterpret_cast<int*>(base + L.list);
  int* count = reinterpret_cast<int*>(base + L.count);
  double* Tt = reinterpret_cast<double*>(base + L.tt);
  int err;

  auto slots = rotate_slots_kernel;
  const unsigned sblocks = (unsigned)((S + 127) / 128);
  slots<<<sblocks, 128, 0, stream>>>(k_best, rank, slot, nrho, S, genes);
  if ((err = (int)cudaGetLastError())) return err;

  auto lists = rotate_lists_kernel;
  lists<<<nrho, SCAN, 0, stream>>>(rank, list, count, S);
  if ((err = (int)cudaGetLastError())) return err;

  const int64_t RC = (int64_t)R * C;
  const dim3 tgrid((unsigned)((S + 31) / 32), (unsigned)((RC + 31) / 32));
  auto transpose = rotate_transpose_kernel<double>;
  transpose<<<tgrid, 256, 0, stream>>>(T, Tt, RC, S);
  if ((err = (int)cudaGetLastError())) return err;

  const int qtiles = (R + BM - 1) / BM;
  const unsigned blocks = (unsigned)(max_tiles(nrho, C, S, genes) * qtiles);
  const int smem = (int)(sizeof(double) * STAGES * STAGE +
                         sizeof(int64_t) * 2 * BN);
  static const int set = (int)cudaFuncSetAttribute(
      rotate_gemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if ((err = set)) return err;
  auto gemm = rotate_gemm_kernel;
  gemm<<<blocks, THREADS, smem, stream>>>(V, Tt, rank, list, count, At, nrho,
                                          R, C, S, qtiles, R % 2 == 0);
  return (int)cudaGetLastError();
}

// Bytes of scratch a crm_best_rho_rotate_f32 call with these sizes needs.
extern "C" int64_t crm_best_rho_rotate_f32_workspace(int nrho, int R, int C,
                                                     int S) {
  return layout(nrho, R, C, S, 4).total;
}

// The float32 context: V (nrho, R, R) and T (R, C, S) f32, k_best as
// crm_best_rho_rotate's -> At_slots (min(genes, nrho), S, R, C) f32, slot
// (genes, S) int64.  work: crm_best_rho_rotate_f32_workspace bytes, 256-byte
// aligned.  Launches on `stream`; returns the first launch's CUDA error, 0
// if none.
extern "C" int crm_best_rho_rotate_f32(const float* V, const float* T,
                                       const int64_t* k_best, float* At,
                                       int64_t* slot, void* work, int nrho,
                                       int R, int C, int S, int genes,
                                       cudaStream_t stream) {
  const Layout L = layout(nrho, R, C, S, 4);
  unsigned char* base = static_cast<unsigned char*>(work);
  int* rank = reinterpret_cast<int*>(base + L.rank);
  int* list = reinterpret_cast<int*>(base + L.list);
  int* count = reinterpret_cast<int*>(base + L.count);
  float* Tt = reinterpret_cast<float*>(base + L.tt);
  int err;

  auto slots = rotate_slots_kernel;
  const unsigned sblocks = (unsigned)((S + 127) / 128);
  slots<<<sblocks, 128, 0, stream>>>(k_best, rank, slot, nrho, S, genes);
  if ((err = (int)cudaGetLastError())) return err;

  auto lists = rotate_lists_kernel;
  lists<<<nrho, SCAN, 0, stream>>>(rank, list, count, S);
  if ((err = (int)cudaGetLastError())) return err;

  const int64_t RC = (int64_t)R * C;
  const dim3 tgrid((unsigned)((S + 31) / 32), (unsigned)((RC + 31) / 32));
  auto transpose = rotate_transpose_kernel<float>;
  transpose<<<tgrid, 256, 0, stream>>>(T, Tt, RC, S);
  if ((err = (int)cudaGetLastError())) return err;

  const int qtiles = (R + P32_BM - 1) / P32_BM;
  const unsigned blocks =
      (unsigned)(max_tiles_f32(nrho, C, S, genes) * qtiles);
  const int smem = rotate_f32_smem();
  static const int set = (int)cudaFuncSetAttribute(
      rotate_product_f32_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if ((err = set)) return err;
  auto gemm = rotate_product_f32_kernel;
  gemm<<<blocks, P32_THREADS, smem, stream>>>(V, Tt, rank, list, count, At,
                                            nrho, R, C, S, qtiles,
                                            R % 4 == 0, C % 4 == 0);
  return (int)cudaGetLastError();
}
