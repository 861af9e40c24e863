// K2 (and the grid half of K7): the coarse delta grid of the profiled GLS
// fits, for sm_90a.
//
// For variant s, rho point o and grid point k (delta_k = sigmoid(logit_k),
// logit_k a linspace from lo to hi), with eigen-weights
// w_kr = 1 / ((1 - delta_k) S_or + delta_k), X = [W, g] and complement
// weight ic = 1 / delta_k:
//
//   A = sum_r w_kr x_r x_r^T + C_XX ic,  b = sum_r w_kr x_r y_r + C_Xy ic,
//   q = sum_r w_kr y_r^2 + C_yy ic,      logdet D = sum_r log d_kr
//                                                   + (n - R) log delta_k,
//   beta = (A + ridge)^{-1} b (ridge Cholesky),  rss = q - b^T beta,
//
// then the lml, and per (s, o) the argmax over k and the bracket
// [logit_{k-1}, logit_{k+1}] (the full [lo, hi] when no grid point is
// finite).  Objectives, as in the reference:
//   REML (interaction, cellregmap_tpu/engine.py:460-532): nu = n - p - 1,
//     lml = -(nu log(2 pi rss / nu) + logdet D + logdet A - logdet X^TX
//     + nu) / 2; a point with rss <= 128 eps(T) q is excluded (:500);
//   ML (association refit, :957-989): lml = -(n log(2 pi rss / n)
//     + logdet D + n) / 2, no logdet terms; only rss <= 8 tiny(T) is
//     excluded (:978).
// T is the working type (float under hybrid localization): every rotated
// product is formed in f64 and rounded to T (the reference's tensor sets,
// engine.py:422-434), the weights, the sums and the small algebra run in T.
//
// Replaces: cellregmap_tpu/engine.py `interaction_batch` stage 1a
// (:460-532) and `association_refit_batch` stage 1 (:957-989), whose XLA
// programs materialize the (nrho, K, R) weights and the rotated products
// (nrho, R, S) x (p + 2) and reduce them with batched GEMMs.
//
// What bounds it on the H100: operations.  At the headline (nrho = 11,
// K = 64, R = 1010, S = 512, p = 1) it reads Gt once (45 MB, 0.014 ms) and
// does 2 nrho K R S (p + 2) = 2.2 GFLOP of reductions (0.03 ms at the 67
// TFLOP/s f32/f64 peak).
//
// Design: the sums are a product of two matrices per rho point, the
// weights w (K x R) against the rotated products P (R x columns), and
// three kernels split the work by what each sum depends on:
//
// 1. `weights_kernel`, a block per (32 grid points, rho, block of rows),
//    lanes over the grid points: the weights, written once to a scratch
//    buffer (rho, R, K) with k the fastest axis, and sum log d a row block
//    (a row's load is a round trip, so the rows are spread over many
//    small blocks).
// 2. `gemm_kernel`, every other sum as a register-tiled product
//    out[rho, column, k] = sum_r w[k, r] P[r, column], in three column
//    sets of one launch: the genotype's (variant, g W_j | g^2), p + 1 a
//    variant, formed once per rho for every gene; each gene's one column
//    (variant, g y); and the sums no variant enters (W_i W_j once per
//    rho, each gene's W_j y and y^2).  A 128-thread block computes 64 grid
//    points x 128 columns (all K = 64 grid points in one pass, so each
//    rotated row is read once per column tile), each thread an 8 x 8
//    micro-tile with four-wide shared-memory loads, neighbouring lanes on
//    neighbouring words: one load for four FMAs.  Row chunks of 8 are
//    double-buffered: the weights arrive by cp.async, and the next
//    chunk's factors are loaded into registers while the current chunk is
//    reduced, then multiplied in f64 and rounded as they are stored.  The
//    rows are split over up to 4 blocks when the tiles alone would not
//    give the 132 SMs ~4 blocks each; each split writes its own partial
//    sums, added in a fixed order by the epilogue (the result does not
//    depend on the schedule).  The f32 instantiation is plain FP32 FMA:
//    TF32 keeps 10 mantissa bits, and the bracket needs the lml to 1e-5
//    relative.  The f64 instantiation (hybrid localization off) runs the
//    same tile on the FP64 pipes.
// 3. `epilogue_kernel`, a warp per (gene, rho, variant), lanes over the
//    grid points: each lane assembles its (p+1)^2 system from the shared
//    and per-variant sums (k is the fastest axis of every scratch buffer,
//    so these reads are coalesced), solves it by ridge Cholesky and forms
//    the lml; the warp takes the argmax over k by shuffles, the first
//    maximum on ties, and lane 0 writes the bracket.  For p + 1 <= 8 the
//    system lives in registers; up to p + 1 = 33 each lane's lower
//    triangle lives in dynamic shared memory (a block is one warp; lane l
//    owns every 32nd word, so the lanes never share a bank).
//
// The scratch (weights, sums) is sized by crm_delta_grid_workspace and
// allocated by the caller; the gene axis runs in chunks of genes that keep
// it under 128 MiB (CRM_GRID_CHUNK_BYTES, which the emulated tests lower to
// reach the chunked path).  Only the brackets reach the caller.
//
// Per-gene rho (the gene-batched association refit, cellregmap_tpu/
// engine.py:1070-1098): each gene refits its variants at its own null's
// best rho only.  The rotated [W | G] then holds the tile's distinct best
// rho ("slots", nrho = m of them), and `slot[gene]` names the one each
// gene runs: its epilogue runs at that slot alone (the product forms its
// sums at every slot of the tile, usually one or two).  The brackets keep
// their (genes, S, m) layout and only the gene's slot column is written,
// where the converge kernel reads it (k_best = slot).
//
// The float32 context (the screen's, engine.py:460-532 on an f32 context)
// takes its operands in f32 and an entry of its own, crm_delta_grid_f32:
// two launches a gene chunk, sums_f32_kernel (the weights and the sums in
// one kernel, the sums split-TF32 products on the tensor cores, tf32mma.cuh)
// and the epilogue above on its scratch (the float working type).  Its
// REML brackets (the interaction's) are the f32-rounded grid logits,
// widened exactly (the reference's `linspace(lo, hi, n_grid).astype(ctx
// dtype)`, :528); its ML brackets (the association refit's) keep the f64
// logits, as its `linspace(lo, hi, n_grid)` (:986-989) does.  Its bound at
// the screen batch (11 rho, 64 points, R = 1000, S = 1024, p = 1) is
// operations: 3 x 4.3e9 TF32 flop, 0.026 ms (0.065 ms for the same sums
// by FP32 FMA).
#include <cuda_runtime.h>
#include <cfloat>
#include <cstdint>

#include "async_copy.cuh"
#include "tf32mma.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int NT = 256;         // threads of a weights block
constexpr int TK = 64;          // grid points of a GEMM tile
constexpr int TC = 128;         // columns of a GEMM tile
constexpr int MK = 8, MC = 8;   // a thread's micro-tile: points x columns
constexpr int GT = (TK / MK) * (TC / MC);  // threads of a GEMM block
constexpr int GR = 8;           // rows of a GEMM chunk
constexpr int EPI_WARPS = 4;    // variants of a register-epilogue block
#ifndef CRM_GRID_CHUNK_BYTES
#define CRM_GRID_CHUNK_BYTES (128ll << 20)
#endif
constexpr int64_t CAP = CRM_GRID_CHUNK_BYTES;  // scratch of a gene chunk

template <class T> struct Lim;
template <> struct Lim<float> {
  static constexpr float eps = FLT_EPSILON, tiny = FLT_MIN;
};
template <> struct Lim<double> {
  static constexpr double eps = DBL_EPSILON, tiny = DBL_MIN;
};

__host__ __device__ inline int64_t round_up(int64_t a, int64_t b) {
  return (a + b - 1) / b * b;
}

// The scratch buffers, in elements of T, each 64-element aligned (RS is
// the product's split of the rows, each split writing its own partial
// sums, which the epilogue adds in a fixed order):
//   w    (nrho, Rp, Kp)                the weights
//   ld   (RB, nrho, Kp)                sum log d over each block of rows
//   shs  (RS, nrho, Csh, Kp)           sum w W_i W_j (j <= i), then each
//                                      gene's sum w W_j y and sum w y^2
//   geno (RS, nrho, Cg, Kp)            sum w g W_j, sum w g^2 per variant
//   gy   (RS, nrho, Cy, Kp)            each gene's sum w g y per variant
struct Layout {
  int64_t Kp, Rp, ntri, p1, Cg, Gc, Cy, Csh, RS, RB;
  int64_t w, ld, shs, geno, gy, total;
};

Layout layout(int nrho, int R, int K, int p, int nS, int genes,
              int64_t tsize) {
  Layout L;
  L.Kp = round_up(K, TK);
  L.Rp = round_up(R, GR);
  L.ntri = (int64_t)p * (p + 1) / 2;
  L.p1 = p + 1;
  L.Cg = round_up((int64_t)nS * L.p1, TC);
  const int64_t per_gene = nrho * L.Kp * (nS + 2 * L.p1) * tsize;
  int64_t gc = CAP / (per_gene > 0 ? per_gene : 1);
  L.Gc = gc < 1 ? 1 : (gc > genes ? genes : gc);
  L.Cy = round_up(L.Gc * nS, TC);
  L.Csh = round_up(L.ntri, TC) + round_up(L.Gc * L.p1, TC);
  // split the rows until the product has ~4 blocks an SM (132 SMs)
  const int64_t blocks =
      (L.Cg + L.Cy + L.Csh) / TC * (L.Kp / TK) * nrho;
  int64_t rs = (4 * 132 + blocks - 1) / blocks;
  rs = rs > 4 ? 4 : rs;
  L.RS = rs > L.Rp / GR ? L.Rp / GR : rs;
  // the weights kernel's row blocks: ~64 rows a block
  L.RB = (L.Rp + 63) / 64 > 16 ? 16 : (L.Rp + 63) / 64;
  L.w = 0;
  L.ld = L.w + round_up(nrho * L.Rp * L.Kp, 64);
  L.shs = L.ld + round_up(L.RB * nrho * L.Kp, 64);
  L.geno = L.shs + round_up(L.RS * nrho * L.Csh * L.Kp, 64);
  L.gy = L.geno + round_up(L.RS * nrho * L.Cg * L.Kp, 64);
  L.total = L.gy + round_up(L.RS * nrho * L.Cy * L.Kp, 64);
  return L;
}

// torch.linspace's value at index k (its two-sided formula)
__device__ double logit_at(double lo, double hi, int K, int k) {
  if (K == 1) return lo;
  const double step = (hi - lo) / (double)(K - 1);
  return k < K / 2 ? lo + step * (double)k
                   : hi - step * (double)(K - 1 - k);
}

__device__ double sigmoid(double x) { return 1.0 / (1.0 + exp(-x)); }

// ---------------------------------------------------------------------------
// 1. the weights and sum log d
// ---------------------------------------------------------------------------
// Block (32 grid points, rho o, block of rows): lane l takes grid point k,
// the warps the block's rows in turn; the weights are written with k the
// fastest axis (coalesced), zero past K and R, and each row block's sum
// log d on its own (the epilogue adds them in a fixed order).  Many small
// blocks: each row's load is a round trip, so the rows are spread wide.
template <class T, class TO>
__global__ void __launch_bounds__(NT)
weights_kernel(const TO* __restrict__ Sv, T* __restrict__ wbuf,
               T* __restrict__ ldbuf, double lo, double hi, int K, int Kp,
               int R, int Rp) {
  constexpr int NW = NT / 32;
  __shared__ T red[NW][32];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int k = blockIdx.x * 32 + lane, o = blockIdx.y;
  const int rb = blockIdx.z, nrb = gridDim.z;
  const int r0 = (int)((int64_t)rb * Rp / nrb);
  const int r1 = (int)((int64_t)(rb + 1) * Rp / nrb);
  const TO* So = Sv + (int64_t)o * R;
  T* wo = wbuf + (int64_t)o * Rp * Kp;
  const bool live = k < K;
  const T dk = live ? (T)sigmoid(logit_at(lo, hi, K, k)) : T(1);
  T acc = T(0);
  for (int r = r0 + warp; r < r1; r += NW) {
    T w = T(0);
    if (live && r < R) {
      const T d = (T(1) - dk) * (T)So[r] + dk;
      w = T(1) / d;
      acc += log(d);
    }
    wo[(int64_t)r * Kp + k] = w;
  }
  red[warp][lane] = acc;
  __syncthreads();
  if (warp == 0) {
    T v = T(0);
    for (int w = 0; w < NW; ++w) v += red[w][lane];
    ldbuf[((int64_t)rb * gridDim.y + o) * Kp + k] = v;
  }
}

// ---------------------------------------------------------------------------
// 2. the sums as a product: out[z, o, c, k] = sum_{r in split z} w[o, r, k]
//    P[o, r, c]
// ---------------------------------------------------------------------------
// A product column's two factors, each a pointer into the rotated rows
// (stride p + nS) or into a phenotype (stride 1):
//   mode 0 (geno): c = s (p + 1) + j, P = g_s W_j (j < p) or g_s^2;
//   mode 1 (gy):   c = gl nS + s, P = g_s y_{g0 + gl};
//   mode 2 (shs):  c < nww, P = W_i W_j (tri index c, none past ntri);
//                  then per gene gl of the chunk, P = W_j y (j < p) or
//                  y^2 at c = nww + gl (p + 1) + j.
template <class TO>
struct Factor {
  const TO *a, *b;
  int sa, sb;
  bool live;
};

template <class TO>
__device__ Factor<TO> column(const TO* WGo, const TO* yt, int mode, int c,
                             int ncols, int R, int p, int nS, int nrho, int o,
                             int g0, int nww) {
  const int ps = p + nS, p1 = p + 1;
  Factor<TO> f{WGo, WGo, ps, ps, c < ncols};
  if (!f.live) return f;
  if (mode == 0) {
    const int s = c / p1, j = c - s * p1;
    f.a = WGo + p + s;
    f.b = j < p ? WGo + j : f.a;
  } else if (mode == 1) {
    const int gl = c / nS, s = c - gl * nS;
    f.a = WGo + p + s;
    f.b = yt + ((int64_t)(g0 + gl) * nrho + o) * R;
    f.sb = 1;
  } else {
    const int ntri = p * p1 / 2;
    if (c < nww) {
      f.live = c < ntri;
      int i = 0;
      while ((i + 1) * (i + 2) / 2 <= c) ++i;
      f.a = WGo + i;
      f.b = WGo + (c - i * (i + 1) / 2);
    } else {
      const int gl = (c - nww) / p1, j = (c - nww) - gl * p1;
      const TO* y = yt + ((int64_t)(g0 + gl) * nrho + o) * R;
      f.b = y;
      f.sb = 1;
      if (j < p) {
        f.a = WGo + j;
      } else {
        f.a = y;
        f.sa = 1;
      }
    }
  }
  return f;
}

// One launch for the three column sets: blockIdx.x < ntg tiles the
// genotype's columns (mode 0), the next nty the chunk's g y (mode 1), the
// rest the shared sums (mode 2); blockIdx.z = o RS + split.
template <class T, class TO>
__global__ void __launch_bounds__(GT)
gemm_kernel(const TO* __restrict__ WGt, const TO* __restrict__ yt,
            const T* __restrict__ wbuf, T* __restrict__ geno,
            T* __restrict__ gy, T* __restrict__ shs, int Kp, int nrho, int R,
            int Rp, int p, int nS, int ntg, int nty, int Cg, int ncols_gy,
            int Cy, int ncols_sh, int Csh, int nww, int RS, int g0) {
  __align__(16) __shared__ T wt[2][GR][TK];
  __align__(16) __shared__ T pt[2][GR][TC];
  const int tid = threadIdx.x;
  const int bx = blockIdx.x;
  const int mode = bx < ntg ? 0 : (bx < ntg + nty ? 1 : 2);
  const int ct = mode == 0 ? bx : (mode == 1 ? bx - ntg : bx - ntg - nty);
  const int ncols = mode == 0 ? nS * (p + 1) : (mode == 1 ? ncols_gy
                                                          : ncols_sh);
  const int Cpad = mode == 0 ? Cg : (mode == 1 ? Cy : Csh);
  T* out = mode == 0 ? geno : (mode == 1 ? gy : shs);
  const int kt = blockIdx.y;
  const int o = blockIdx.z / RS, z = blockIdx.z - o * RS;
  const int c0 = ct * TC, k0 = kt * TK;
  const int nch = Rp / GR;
  const int ch0 = (int)((int64_t)z * nch / RS);
  const int ch1 = (int)((int64_t)(z + 1) * nch / RS);
  const TO* WGo = WGt + (int64_t)o * R * (p + nS);
  const T* wsrc = wbuf + (int64_t)o * Rp * Kp + k0;
  // this thread's micro-tile: grid points MK tk.. and two groups of four
  // columns, 4 tc.. and TC / 2 + 4 tc.. (neighbouring lanes read
  // neighbouring words: no bank conflicts)
  const int tk = tid / (TC / MC), tc = tid % (TC / MC);
  // its share of a chunk's product tile: row pr, columns PQ pc..
  constexpr int PQ = GR * TC / GT;
  const int pr = tid / (TC / PQ), pc = (tid % (TC / PQ)) * PQ;
  Factor<TO> fc[PQ];
#pragma unroll
  for (int q = 0; q < PQ; ++q)
    fc[q] = column(WGo, yt, mode, c0 + pc + q, ncols, R, p, nS, nrho, o, g0,
                   nww);
  constexpr int VEC = 16 / sizeof(T);          // elements a cp.async
  constexpr int NCP = GR * TK / VEC / GT;      // cp.asyncs a thread
  auto issue_w = [&](int buf, int r0) {
#pragma unroll
    for (int t = 0; t < NCP; ++t) {
      const int idx = tid + t * GT;
      const int rr = idx / (TK / VEC), kk = (idx % (TK / VEC)) * VEC;
      cp_async16(&wt[buf][rr][kk], wsrc + (int64_t)(r0 + rr) * Kp + kk);
    }
    cp_async_commit();
  };
  // the factors of the chunk's products, loaded a chunk ahead
  auto fetch = [&](int r0, double (&fa)[PQ], double (&fb)[PQ]) {
    const int64_t r = r0 + pr;
#pragma unroll
    for (int q = 0; q < PQ; ++q) {
      const bool ok = fc[q].live && r < R;
      fa[q] = ok ? (double)fc[q].a[r * fc[q].sa] : 0.0;
      fb[q] = ok ? (double)fc[q].b[r * fc[q].sb] : 0.0;
    }
  };
  auto put = [&](int buf, const double (&fa)[PQ], const double (&fb)[PQ]) {
#pragma unroll
    for (int q0 = 0; q0 < PQ; q0 += 4) {
      T v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) v[q] = (T)(fa[q0 + q] * fb[q0 + q]);
      store4(&pt[buf][pr][pc + q0], v);
    }
  };

  T acc[MK][MC];
#pragma unroll
  for (int a = 0; a < MK; ++a)
#pragma unroll
    for (int b = 0; b < MC; ++b) acc[a][b] = T(0);

  double fa[PQ], fb[PQ];
  issue_w(0, ch0 * GR);
  fetch(ch0 * GR, fa, fb);
  put(0, fa, fb);
  cp_async_wait_all();
  __syncthreads();
  for (int ch = ch0; ch < ch1; ++ch) {
    const int cur = (ch - ch0) & 1;
    const bool more = ch + 1 < ch1;
    if (more) {  // the next chunk in flight while this one is reduced
      issue_w(cur ^ 1, (ch + 1) * GR);
      fetch((ch + 1) * GR, fa, fb);
    }
#pragma unroll
    for (int rr = 0; rr < GR; ++rr) {
      T wv[MK], pv[MC];
#pragma unroll
      for (int a = 0; a < MK; a += 4)
        load4(&wt[cur][rr][tk * MK + a], *reinterpret_cast<T(*)[4]>(wv + a));
#pragma unroll
      for (int b = 0; b < MC; b += 4)  // column groups TC / 2 apart
        load4(&pt[cur][rr][(b / 4) * (TC / 2) + tc * 4],
              *reinterpret_cast<T(*)[4]>(pv + b));
#pragma unroll
      for (int a = 0; a < MK; ++a)
#pragma unroll
        for (int b = 0; b < MC; ++b) acc[a][b] += wv[a] * pv[b];
    }
    if (more) {
      put(cur ^ 1, fa, fb);
      cp_async_wait_all();
    }
    __syncthreads();
  }
  T* oo = out + ((int64_t)z * nrho + o) * Cpad * Kp;
#pragma unroll
  for (int b = 0; b < MC; ++b)
#pragma unroll
    for (int a = 0; a < MK; a += 4) {
      T v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) v[q] = acc[a + q][b];
      const int c = c0 + (b / 4) * (TC / 2) + tc * 4 + b % 4;
      store4(&oo[(int64_t)c * Kp + k0 + tk * MK + a], v);
    }
}

// ---------------------------------------------------------------------------
// 3. the epilogue: solve, lml, argmax over k, the bracket
// ---------------------------------------------------------------------------
// Loops over the small dimension: unrolled to the compile-time LIM for the
// register instantiation (the arrays are then indexed statically and live
// in registers), plain loops for the shared-memory one.
#define EPI_FOR(i, lo, hi)                                            \
  for (int i = (UNROLL ? 0 : (lo)); i < (UNROLL ? LIM : (hi)); ++i) \
    if (!UNROLL || (i >= (lo) && i < (hi)))

__device__ __forceinline__ int tri(int i, int j) {
  return i * (i + 1) / 2 + j;
}

// max(x, floor) that keeps a NaN, as jnp.maximum and torch.clamp do (fmax
// drops it: a failed factorization's NaN residual would become the floor,
// a huge finite lml that wins the argmax)
template <class T>
__device__ __forceinline__ T floor_keep_nan(T x, T floor) {
  return x < floor ? floor : x;
}

// The lml of one (variant, grid point) from its assembled system: A the
// lower triangle (element e at A[e * st]), b and z (at [i * st]) of p1
// entries; A is factored in place.
template <class T, int LIM, bool UNROLL, bool REML>
__device__ T solve_lml(T* A, T* b, T* z, int st, int p1, T q, T logdet_d,
                       T ld_xx, int n) {
  // ridge Cholesky (ops/linalg.py unrolled_chol_factor), in place
  T dmax = A[0];
  EPI_FOR(i, 1, p1) dmax = fmax(dmax, A[tri(i, i) * st]);
  const T ridge = (T)1e-12 * fmax(dmax, T(1));
  EPI_FOR(i, 0, p1) {
    EPI_FOR(j, 0, i + 1) {
      T v = A[tri(i, j) * st];
      if (i == j) v += ridge;
      EPI_FOR(l, 0, j) v -= A[tri(i, l) * st] * A[tri(j, l) * st];
      A[tri(i, j) * st] = i == j ? sqrt(v) : v / A[tri(j, j) * st];
    }
  }
  EPI_FOR(i, 0, p1) {
    T v = b[i * st];
    EPI_FOR(l, 0, i) v -= A[tri(i, l) * st] * z[l * st];
    z[i * st] = v / A[tri(i, i) * st];
  }
  for (int i = (UNROLL ? LIM : p1) - 1; i >= 0; --i) {
    if (i >= p1) continue;
    T v = z[i * st];
    EPI_FOR(l, i + 1, p1) v -= A[tri(l, i) * st] * z[l * st];
    z[i * st] = v / A[tri(i, i) * st];
  }
  T rss = q;
  EPI_FOR(i, 0, p1) rss -= b[i * st] * z[i * st];
  const T two_pi = (T)6.283185307179586;
  bool collapsed;
  T lml;
  if (REML) {
    // engine.py:500: a relative noise floor
    collapsed = rss <= T(128) * Lim<T>::eps * q;
    rss = floor_keep_nan(rss, Lim<T>::tiny);
    T logdet_a = T(0);
    EPI_FOR(i, 0, p1) logdet_a += log(A[tri(i, i) * st]);
    logdet_a *= T(2);
    const T nu = (T)(n - p1);
    lml = T(-0.5) * (nu * log(two_pi * rss / nu) + logdet_d + logdet_a -
                     ld_xx + nu);
  } else {
    // engine.py:978: only an absolute floor
    collapsed = rss <= T(8) * Lim<T>::tiny;
    rss = floor_keep_nan(rss, Lim<T>::tiny);
    const T nn = (T)n;
    lml = T(-0.5) * (nn * log(two_pi * rss / nn) + logdet_d + nn);
  }
  return (collapsed || !isfinite(lml)) ? T(-INFINITY) : lml;
}

// A warp per (gene, rho, variant), lanes over the grid points.  LIM > 0:
// the systems in registers (p + 1 <= LIM), EPI_WARPS warps a block; LIM
// == 0: each lane's system in dynamic shared memory, one warp a block.
template <class T, class TO, int LIM, bool REML>
__global__ void __launch_bounds__(LIM > 0 ? 32 * EPI_WARPS : 32)
epilogue_kernel(const T* __restrict__ ldb, const T* __restrict__ shs,
                const T* __restrict__ geno, const T* __restrict__ gy,
                const TO* __restrict__ CWW, const TO* __restrict__ CWy,
                const TO* __restrict__ Cyy, const TO* __restrict__ CWg,
                const TO* __restrict__ Cgy, const TO* __restrict__ Cgg,
                const TO* __restrict__ ld_xx,
                const int64_t* __restrict__ slot, double* __restrict__ br_lo,
                double* __restrict__ br_hi, double lo, double hi, int K,
                int Kp, int n, int nrho, int R, int p, int nS, int Csh,
                int Cg, int Cy, int RS, int RB, int g0) {
  constexpr bool UNROLL = LIM > 0;
  extern __shared__ __align__(16) unsigned char epi_dyn[];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int s = UNROLL ? blockIdx.x * EPI_WARPS + warp : blockIdx.x;
  if (s >= nS) return;  // whole warps: no block-wide barrier below
  const int gl = blockIdx.z, g = g0 + gl;
  const int o = slot ? (int)slot[g] : (int)blockIdx.y;
  const int p1 = p + 1, ntri = p * p1 / 2;
  // the row splits' partial sums, added in a fixed order
  const T* sw = shs + (int64_t)o * Csh * Kp;
  const T* sg = sw + (round_up(ntri, TC) + (int64_t)gl * p1) * Kp;
  const T* ge = geno + ((int64_t)o * Cg + (int64_t)s * p1) * Kp;
  const T* gyv = gy + ((int64_t)o * Cy + (int64_t)gl * nS + s) * Kp;
  const int64_t zsh = (int64_t)nrho * Csh * Kp, zg = (int64_t)nrho * Cg * Kp,
                zy = (int64_t)nrho * Cy * Kp;
  auto sum = [&](const T* b, int64_t zs, int64_t at, int nz) {
    T v = b[at];
    for (int z = 1; z < nz; ++z) v += b[z * zs + at];
    return v;
  };
  const T cyy = (T)Cyy[g], cgy = (T)Cgy[(int64_t)g * nS + s];
  const T cgg = (T)Cgg[s];
  const T ldx = REML ? (T)ld_xx[s] : T(0);

  constexpr int NA = UNROLL ? LIM * (LIM + 1) / 2 : 1;
  constexpr int NB = UNROLL ? LIM : 1;
  T A_reg[NA], b_reg[NB], z_reg[NB];
  T *A, *b, *z;
  int st;
  if constexpr (UNROLL) {
    A = A_reg;
    b = b_reg;
    z = z_reg;
    st = 1;
  } else {  // lane-interleaved: word e of lane l at [e * 32 + l]
    T* base = reinterpret_cast<T*>(epi_dyn) + lane;
    A = base;
    b = base + 32 * (p1 * (p1 + 1) / 2);
    z = b + 32 * p1;
    st = 32;
  }

  T best = -INFINITY;
  int kbest = K;
  for (int k = lane; k < K; k += 32) {
    const T dk = (T)sigmoid(logit_at(lo, hi, K, k));
    const T ic = T(1) / dk;
    // rows i < p: the shared W sums; row p: the variant's g sums
    EPI_FOR(i, 0, p1) {
      EPI_FOR(j, 0, i + 1) {
        T v;
        if (i < p)
          v = sum(sw, zsh, (int64_t)tri(i, j) * Kp + k, RS) +
              (T)CWW[i * p + j] * ic;
        else if (j < p)
          v = sum(ge, zg, (int64_t)j * Kp + k, RS) +
              (T)CWg[(int64_t)j * nS + s] * ic;
        else
          v = sum(ge, zg, (int64_t)p * Kp + k, RS) + cgg * ic;
        A[tri(i, j) * st] = v;
      }
      b[i * st] = i < p ? sum(sg, zsh, (int64_t)i * Kp + k, RS) +
                              (T)CWy[(int64_t)g * p + i] * ic
                        : sum(gyv, zy, k, RS) + cgy * ic;
    }
    const T q = sum(sg, zsh, (int64_t)p * Kp + k, RS) + cyy * ic;
    const T logdet_d = sum(ldb, (int64_t)nrho * Kp, (int64_t)o * Kp + k,
                           RB) +
                       (T)(n - R) * log(dk);
    const T lml = solve_lml<T, (LIM > 0 ? LIM : 1), UNROLL, REML>(
        A, b, z, st, p1, q, logdet_d, ldx, n);
    if (lml > best) {  // k rises along a lane: the first maximum stays
      best = lml;
      kbest = k;
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    const T ob = __shfl_xor_sync(FULL, best, off);
    const int ok = __shfl_xor_sync(FULL, kbest, off);
    if (ob > best || (ob == best && ok < kbest)) {
      best = ob;
      kbest = ok;
    }
  }
  if (lane == 0) {
    // no finite grid point: the full bracket (engine.py:521-532)
    const bool bad = !(best > -INFINITY);
    const int64_t at = ((int64_t)g * nS + s) * nrho + o;
    // the interaction's (REML) grid logits in the context's type TO,
    // widened exactly; the association refit's (ML) in f64 (:986-989)
    const double blo = bad ? lo : logit_at(lo, hi, K, max(kbest - 1, 0));
    const double bhi = bad ? hi : logit_at(lo, hi, K, min(kbest + 1, K - 1));
    br_lo[at] = REML ? (double)(TO)blo : blo;
    br_hi[at] = REML ? (double)(TO)bhi : bhi;
  }
}

template <class TO>
struct Args {
  const TO *Sv, *WGt, *yt, *CWW, *CWy, *Cyy, *CWg, *Cgy, *Cgg, *ld_xx;
  const int64_t* slot;
  double *br_lo, *br_hi;
  double lo, hi;
  int K, n, nrho, R, p, nS, genes;
  bool reml;
};

template <class T, class TO, int LIM, bool REML>
int launch_epilogue(const Args<TO>& a, const Layout& L, T* base, int g0,
                    int gc, cudaStream_t stream) {
  const int p1 = a.p + 1;
  const dim3 grid(LIM > 0 ? (a.nS + EPI_WARPS - 1) / EPI_WARPS : a.nS,
                  a.slot ? 1 : a.nrho, gc);
  size_t dyn = 0;
  auto kernel = epilogue_kernel<T, TO, LIM, REML>;
  if (LIM == 0) {
    dyn = sizeof(T) * 32 * (size_t)(p1 * (p1 + 1) / 2 + 2 * p1);
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
    if (e != cudaSuccess) return (int)e;
  }
  const int threads = LIM > 0 ? 32 * EPI_WARPS : 32;
  kernel<<<grid, threads, dyn, stream>>>(
      base + L.ld, base + L.shs, base + L.geno, base + L.gy, a.CWW, a.CWy,
      a.Cyy, a.CWg, a.Cgy, a.Cgg, a.ld_xx, a.slot, a.br_lo, a.br_hi, a.lo,
      a.hi, a.K, (int)L.Kp, a.n, a.nrho, a.R, a.p, a.nS, (int)L.Csh,
      (int)L.Cg, (int)L.Cy, (int)L.RS, (int)L.RB, g0);
  return (int)cudaGetLastError();
}

template <class T, class TO, bool REML>
int epilogue(const Args<TO>& a, const Layout& L, T* base, int g0, int gc,
             cudaStream_t stream) {
  const int p1 = a.p + 1;
  if (p1 <= 2)
    return launch_epilogue<T, TO, 2, REML>(a, L, base, g0, gc, stream);
  if (p1 <= 4)
    return launch_epilogue<T, TO, 4, REML>(a, L, base, g0, gc, stream);
  if (p1 <= 8)
    return launch_epilogue<T, TO, 8, REML>(a, L, base, g0, gc, stream);
  return launch_epilogue<T, TO, 0, REML>(a, L, base, g0, gc, stream);
}

template <class T, class TO>
int run(const Args<TO>& a, void* work, cudaStream_t stream) {
  const Layout L = layout(a.nrho, a.R, a.K, a.p, a.nS, a.genes, sizeof(T));
  T* base = static_cast<T*>(work);
  auto wk = weights_kernel<T, TO>;
  const dim3 wgrid((unsigned)(L.Kp / 32), a.nrho, (unsigned)L.RB);
  wk<<<wgrid, NT, 0, stream>>>(a.Sv, base + L.w, base + L.ld, a.lo, a.hi,
                               a.K, (int)L.Kp, a.R, (int)L.Rp);
  int err = (int)cudaGetLastError();
  if (err) return err;
  auto gk = gemm_kernel<T, TO>;
  for (int g0 = 0; g0 < a.genes; g0 += (int)L.Gc) {
    const int gc = (int)(a.genes - g0 < L.Gc ? a.genes - g0 : L.Gc);
    // the genotype's columns and the W W sums once (first chunk), each
    // chunk's g y and its genes' W y, y^2
    const int ntg = g0 == 0 ? (int)(L.Cg / TC) : 0;
    const int nty = (int)(round_up((int64_t)gc * a.nS, TC) / TC);
    const int nww = g0 == 0 ? (int)round_up(L.ntri, TC) : 0;
    const int nsh = nww + gc * (a.p + 1);
    const dim3 ggrid((unsigned)(ntg + nty + round_up(nsh, TC) / TC),
                     (unsigned)(L.Kp / TK), (unsigned)(a.nrho * L.RS));
    // a later chunk's columns start after the W W sums, which the first
    // chunk writes
    T* shs = base + L.shs + (g0 == 0 ? 0 : round_up(L.ntri, TC) * L.Kp);
    gk<<<ggrid, GT, 0, stream>>>(
        a.WGt, a.yt, base + L.w, base + L.geno, base + L.gy, shs,
        (int)L.Kp, a.nrho, a.R, (int)L.Rp, a.p, a.nS, ntg, nty, (int)L.Cg,
        gc * a.nS, (int)L.Cy, nsh, (int)L.Csh, nww, (int)L.RS, g0);
    if ((err = (int)cudaGetLastError())) return err;
    err = a.reml ? epilogue<T, TO, true>(a, L, base, g0, gc, stream)
                 : epilogue<T, TO, false>(a, L, base, g0, gc, stream);
    if (err) return err;
  }
  return 0;
}

// ---------------------------------------------------------------------------
// The float32 context: the weights and the sums in one kernel, split TF32
// ---------------------------------------------------------------------------
// out[z, o, column, k] = sum_{r in split z} w[o, k, r] P[o, r, column], a
// block a (tile of up to 128 columns, 64 grid points, rho o and split z),
// four warps of 64 points x 32 columns each (4 x 4 m16n8k8 tiles):
// * 32-row chunks of the rotated rows arrive in a ring of 3 by 16-byte
//   cp.async copies: of WGt's row the W columns and the tile's variants
//   (each a 16-byte aligned span covering it, read at the row's offset
//   into it), each of the tile's genes' y over the chunk's rows, and S;
// * the block makes the next chunk's weights w = 1 / ((1 - delta_k) S_or
//   + delta_k) from S and the grid's logits, a quarter before each 8-row
//   step of this chunk's sums, splits each into (hi, lo) once and keeps
//   them in a double-buffered tile;
// * each warp forms its columns' products (g W_j, g^2, g y, W_i W_j, W_j
//   y, y^2: the f32 product, which is the f64 product of the f32 factors
//   rounded to f32) straight into its B fragments, split once (each product
//   is used by one warp), and reduces over the rows with tf32x3_tiles, a
//   fresh partial a step;
// * the blocks of tile 0 (first gene chunk) add sum log d over their rows.
// The columns of a tile: the genotype's (first chunk only) flat over (s, j)
// as the epilogue reads them; the g y of one gene and up to 128 variants,
// or of up to F_NYG genes and all nS < 128 variants; the shared sums W_i W_j
// (first chunk, tile 0) then up to F_NYG genes' (W_j y, y^2).
// Each split z writes its own partial sums, added in a fixed order by the
// epilogue (the result does not depend on the schedule).
constexpr int F_THREADS = 128;
constexpr int F_TK = 64;                 // grid points a block
constexpr int F_TC = 128;                // columns a block
constexpr int F_RC = 32;                 // rows a chunk
constexpr int F_STAGES = 3;
constexpr int F_FRESH = 1;               // 8-row steps a partial
constexpr double F_ROWS_A_BYTE = 5e-6;   // layout32's split cost
constexpr int F_NYG = 16;                // genes of a g y or shared tile
constexpr int F_MAXP = 15;               // p of the f32 entry (p + 1 <= 16)
constexpr int F_WSEG = 20;               // >= p + 3, a multiple of 4
constexpr int F_GSEG = 132;              // >= 128 + 3 variants
constexpr int F_RW = F_WSEG + F_GSEG;    // floats a staged row
constexpr int F_YLD = F_RC + 4;          // floats a staged y (or S) run
constexpr int F_RAW = F_RC * F_RW + (F_NYG + 1) * F_YLD;   // a stage
constexpr int F_WLD2 = F_TK + 4;         // (hi, lo) pairs a weight row
constexpr int F_SMEM = 4 * (F_STAGES * F_RAW + 2 * 2 * F_RC * F_WLD2 +
                            F_TC + 2 * F_TK);

// A launch's tiles (the genotype's on the first gene chunk, then g y, then
// shared) and the genes a g y or shared tile takes
struct Tiling32 {
  int ntg, nty, nsh;
  int per;       // g y tiles a gene where nS >= F_TC, else 0
  int gy;        // genes a g y tile where nS < F_TC
  int gs0, gs;   // genes of the first shared tile, of the others
};

__host__ __device__ inline Tiling32 tiling32(int p, int nS, int gc,
                                             bool first) {
  const int p1 = p + 1, ntri = p * p1 / 2;
  const auto least = [](int a, int b) { return a < b ? a : b; };
  Tiling32 L;
  L.ntg = first ? (nS * p1 + F_TC - 1) / F_TC : 0;
  L.per = nS >= F_TC ? (nS + F_TC - 1) / F_TC : 0;
  L.gy = nS >= F_TC ? 1 : least(F_TC / nS, F_NYG);
  L.nty = L.per ? gc * L.per : (gc + L.gy - 1) / L.gy;
  L.gs = least(F_TC / p1, F_NYG);
  L.gs0 = first ? least((F_TC - ntri) / p1, F_NYG) : L.gs;
  L.nsh = gc > L.gs0 ? 1 + (gc - L.gs0 + L.gs - 1) / L.gs : 1;
  return L;
}

// the columns of one tile (every thread decodes the same tile)
struct Tile32 {
  int mode;        // 0 the genotype's, 1 g y, 2 shared
  int s_lo, nvar;  // the staged variants
  int g_lo, ng;    // the staged genes (chunk-local)
  int nww;         // mode 2: the W_i W_j columns it leads with
  int c0, nv;      // mode 0: its first flat column; mode 1: variants a gene
};

__device__ Tile32 tile32(int bx, const Tiling32& L, int p, int nS, int gc,
                         bool first) {
  const int p1 = p + 1, ntri = p * p1 / 2;
  Tile32 T{0, 0, 0, 0, 0, 0, 0, 0};
  if (bx < L.ntg) {
    T.mode = 0;
    T.c0 = bx * F_TC;
    const int c1 = min(nS * p1, T.c0 + F_TC);
    T.s_lo = T.c0 / p1;
    T.nvar = (c1 - 1) / p1 + 1 - T.s_lo;
  } else if (bx < L.ntg + L.nty) {
    const int t = bx - L.ntg;
    T.mode = 1;
    if (L.per) {
      T.g_lo = t / L.per;
      T.ng = 1;
      T.s_lo = (t % L.per) * F_TC;
      T.nvar = min(F_TC, nS - T.s_lo);
    } else {
      T.g_lo = t * L.gy;
      T.ng = min(L.gy, gc - T.g_lo);
      T.nvar = nS;
    }
    T.nv = T.nvar;
  } else {
    const int t = bx - L.ntg - L.nty;
    T.mode = 2;
    T.nww = first && t == 0 ? ntri : 0;
    T.g_lo = t == 0 ? 0 : L.gs0 + (t - 1) * L.gs;
    T.ng = max(0, min(t == 0 ? L.gs0 : L.gs, gc - T.g_lo));
  }
  return T;
}

// A factor of a product column: where its value lies in a staged chunk.
// kind 0: W_j (idx j), 1: g of the tile's variant idx, 2: y of the tile's
// gene (idx its run's offset in the y buffer), 3: none (a dead column)
struct Fac {
  int kind, idx;
};

// (the address chosen first, so that the lanes of a warp, whose columns
// mix the kinds, load at once with no branch)
__device__ __forceinline__ float fac_value(Fac f, const float* row, int offW,
                                           int offG, const float* ys,
                                           int r) {
  const float* at = f.kind == 2 ? ys + f.idx + r
                                : row + f.idx + (f.kind == 0 ? offW
                                                 : F_WSEG + offG);
  const float v = *at;   // kind 3: a staged value, discarded
  return f.kind == 3 ? 0.0f : v;
}

__global__ void __launch_bounds__(F_THREADS, 2)
sums_f32_kernel(const float* __restrict__ Sv, const float* __restrict__ WGt,
                const float* __restrict__ yt, float* __restrict__ ldbuf,
                float* __restrict__ geno, float* __restrict__ gy,
                float* __restrict__ shs, double lo, double hi, int K, int Kp,
                int nrho, int R, int p, int nS, int Cg, int Cy, int Csh,
                int RS, int g0, int gc, int first) {
  extern __shared__ __align__(16) unsigned char sums32_dyn[];
  float* sm = reinterpret_cast<float*>(sums32_dyn);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int kt = blockIdx.y, k0 = kt * F_TK;
  const int o = blockIdx.z / RS, z = blockIdx.z - o * RS;
  const int ps = p + nS, p1 = p + 1, ntri = p * p1 / 2;
  const Tile32 T = tile32(blockIdx.x, tiling32(p, nS, gc, first != 0), p,
                          nS, gc, first != 0);
  const bool do_ld = first && blockIdx.x == 0;

  auto raw = [&](int b) { return sm + b * F_RAW; };           // rows
  auto raw_y = [&](int b) { return raw(b) + F_RC * F_RW; };   // genes' y
  auto raw_s = [&](int b) { return raw_y(b) + F_NYG * F_YLD; };
  float* wsplit = sm + F_STAGES * F_RAW;                      // 2 buffers
  int* outcol = reinterpret_cast<int*>(wsplit + 2 * 2 * F_RC * F_WLD2);
  float* ldred = reinterpret_cast<float*>(outcol + F_TC);

  const float* WGo = WGt + (int64_t)o * R * ps;
  const float* So = Sv + (int64_t)o * R;
  const int nch = (R + F_RC - 1) / F_RC;
  const int ch0 = (int)((int64_t)z * nch / RS);
  const int ch1 = (int)((int64_t)(z + 1) * nch / RS);

  // a 16-byte aligned span covering `cnt` floats from `src` into dst;
  // returns the offset of src in it (every vector holds one of the floats)
  auto span_of = [](const float* src) {
    return (int)((reinterpret_cast<uintptr_t>(src) >> 2) & 3);
  };
  auto y_run = [&](int gi) {
    return yt + ((int64_t)(g0 + T.g_lo + gi) * nrho + o) * R;
  };

  // the columns: this thread's four B-fragment columns' factors, and the
  // block's output column of each tile column (-1: none)
  auto decode = [&](int c, Fac& a, Fac& b) {
    a = Fac{3, 0};
    b = Fac{3, 0};
    int out = -1;
    if (T.mode == 0) {
      const int flat = T.c0 + c;
      if (flat < nS * p1) {
        const int sv = flat / p1, j = flat - sv * p1;
        a = Fac{1, sv - T.s_lo};
        b = j < p ? Fac{0, j} : a;
        out = flat;
      }
    } else if (T.mode == 1) {
      if (c < T.ng * T.nv) {
        const int gi = c / T.nv, sv = T.s_lo + c % T.nv;
        a = Fac{1, sv - T.s_lo};
        b = Fac{2, gi * F_YLD + span_of(y_run(gi))};
        out = (T.g_lo + gi) * nS + sv;
      }
    } else if (c < T.nww) {
      int i = 0;
      while ((i + 1) * (i + 2) / 2 <= c) ++i;
      a = Fac{0, i};
      b = Fac{0, c - i * (i + 1) / 2};
      out = c;
    } else if (c - T.nww < T.ng * p1) {
      const int gi = (c - T.nww) / p1, j = (c - T.nww) - gi * p1;
      const Fac y{2, gi * F_YLD + span_of(y_run(gi))};
      a = j < p ? Fac{0, j} : y;
      b = y;
      out = (F_TC * ((ntri + F_TC - 1) / F_TC)) + (T.g_lo + gi) * p1 + j;
    }
    return out;
  };
  Fac fa[4], fb[4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) decode(warp * 32 + nt * 8 + g, fa[nt], fb[nt]);
  {
    Fac a, b;
    outcol[tid] = decode(tid, a, b);   // F_THREADS == F_TC
  }

  // chunk ch into raw stage b
  auto load = [&](int b, int ch) {
    const int r0 = ch * F_RC, rows = min(F_RC, R - r0);
    float* rb = raw(b);
    const int vw = (p + 3 + 3) / 4, vg = (T.nvar + 3 + 3) / 4;
    for (int e = tid; e < rows * (vw + vg); e += F_THREADS) {
      const int r = e / (vw + vg), v = e - r * (vw + vg);
      const float* row = WGo + (int64_t)(r0 + r) * ps;
      const bool w = v < vw;
      const int cnt = w ? p : T.nvar;
      const float* src = w ? row : row + p + T.s_lo;
      const int vv = w ? v : v - vw;
      if (cnt > 0 && 4 * vv < span_of(src) + cnt)
        cp_async16(rb + r * F_RW + (w ? 0 : F_WSEG) + 4 * vv,
                   src - span_of(src) + 4 * vv);
    }
    const int vy = (rows + 3 + 3) / 4;
    for (int e = tid; e < (T.ng + 1) * vy; e += F_THREADS) {
      const int gi = e / vy, v = e - gi * vy;
      const float* src = (gi < T.ng ? y_run(gi) : So) + r0;
      if (4 * v < span_of(src) + rows)
        cp_async16((gi < T.ng ? raw_y(b) + gi * F_YLD : raw_s(b)) + 4 * v,
                   src - span_of(src) + 4 * v);
    }
  };

  // the grid point of this thread's weights and its delta
  const int kw = tid % F_TK, k = k0 + kw;
  const float dk = k < K ? (float)sigmoid(logit_at(lo, hi, K, k)) : 1.0f;
  const int offS = span_of(So);
  float ldacc = 0.0f;
  // chunk ch's weights (raw stage b) -> (hi, lo) pairs of buffer wb: rows
  // 8 quarter .. 8 quarter + 7, one quarter between each two 8-row steps
  // of the chunk before
  auto weights = [&](int b, int wb, int ch, int quarter) {
    const int r0 = ch * F_RC;
    const float* sv = raw_s(b) + offS;
    float* dst = wsplit + wb * 2 * F_RC * F_WLD2 + 2 * kw;
    for (int r = 8 * quarter + tid / F_TK; r < 8 * quarter + 8;
         r += F_THREADS / F_TK) {
      float w = 0.0f;
      if (r0 + r < R) {
        const float d = (1.0f - dk) * sv[r] + dk;
        w = rcp_f32(d);
        if (do_ld && k < K) ldacc += log(d);
      }
      float h, l;
      tf32_split(w, h, l);
      store_pair(dst + 2 * r * F_WLD2, h, l, true, true);
    }
  };

  float acc[4][4][4], part[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.0f;

  const int nloc = ch1 - ch0;
  const uintptr_t wq = (reinterpret_cast<uintptr_t>(WGo) >> 2) & 3;
  if (nloc > 0) load(0, ch0);
  cp_async_commit();
  if (nloc > 1) load(1, ch0 + 1);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  if (nloc > 0)
    for (int q = 0; q < 4; ++q) weights(0, 0, ch0, q);
  for (int i = 0; i < nloc; ++i) {
    cp_async_wait<0>();   // chunk i + 1 landed
    // chunk i + 1 seen by every thread, chunk i - 1's sums done
    __syncthreads();
    if (i + 2 < nloc) load((i + 2) % F_STAGES, ch0 + i + 2);
    cp_async_commit();
    const bool more = i + 1 < nloc;
    const int b = i % F_STAGES, r0 = (ch0 + i) * F_RC;
    const float* rows = raw(b);
    const float* ys = raw_y(b);
    const float* ws = wsplit + (i & 1) * 2 * F_RC * F_WLD2 + 2 * g;
    // the offsets of row r0's W and variants in their spans
    const int q0 = (int)((wq + (uint64_t)(r0) * ps) & 3);
    const int psq = ps & 3, sq = (p + T.s_lo) & 3;
    // the 8-row steps in order, not unrolled (fewer live registers), a
    // quarter of the next chunk's weights before each (their arithmetic
    // issues while the warp's products run); a fresh partial each F_FRESH
    // steps, then added to the sums
#pragma unroll 1
    for (int c8 = 0; c8 < F_RC; c8 += 8) {
      if (more)
        weights((i + 1) % F_STAGES, (i + 1) & 1, ch0 + i + 1, c8 / 8);
      float ah[4][4], al[4][4], bh[4][2], bl[4][2];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int ii = 0; ii < 4; ++ii)
          load_pair(ws + 2 * ((c8 + t + 4 * (ii >> 1)) * F_WLD2 + mt * 16 +
                              8 * (ii & 1)),
                    ah[mt][ii], al[mt][ii]);
#pragma unroll
      for (int ii = 0; ii < 2; ++ii) {
        const int r = c8 + t + 4 * ii;
        const int offW = (q0 + r * psq) & 3, offG = (offW + sq) & 3;
        const float* row = rows + r * F_RW;
        const bool live = r0 + r < R;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const float x = fac_value(fa[nt], row, offW, offG, ys, r) *
                          fac_value(fb[nt], row, offW, offG, ys, r);
          tf32_split(live ? x : 0.0f, bh[nt][ii], bl[nt][ii]);
        }
      }
      const int step = c8 / 8;
      tf32x3_tiles(part, ah, al, bh, bl, step % F_FRESH == 0);
      if (step % F_FRESH == F_FRESH - 1) tf32_flush(acc, part);
    }
  }
  cp_async_wait<0>();

  if (do_ld) {   // sum log d of the split's rows, its two halves in order
    ldred[(tid / F_TK) * F_TK + kw] = ldacc;
    __syncthreads();
    if (tid < F_TK)
      ldbuf[((int64_t)z * nrho + o) * Kp + k0 + tid] =
          ldred[tid] + ldred[F_TK + tid];
  }
  // d[i] of tile (mt, nt): grid point mt 16 + g + 8 (i >> 1), column
  // warp 32 + nt 8 + 2t + (i & 1)
  const int Cpad = T.mode == 0 ? Cg : (T.mode == 1 ? Cy : Csh);
  float* out = (T.mode == 0 ? geno : (T.mode == 1 ? gy : shs)) +
               ((int64_t)z * nrho + o) * Cpad * Kp + k0;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int oc = outcol[warp * 32 + nt * 8 + 2 * t + e];
      if (oc < 0) continue;
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          out[(int64_t)oc * Kp + mt * 16 + g + 8 * h] = acc[mt][nt][2 * h + e];
    }
}

// The float32 context's scratch, in floats, each 64-float aligned (RS the
// sums' split of the rows; the ld, shs, geno and gy buffers as Layout's,
// with RB = RS and no weights buffer)
Layout layout32(int nrho, int R, int K, int p, int nS, int genes) {
  Layout L;
  L.Kp = round_up(K, F_TK);
  L.Rp = round_up(R, F_RC);
  L.ntri = (int64_t)p * (p + 1) / 2;
  L.p1 = p + 1;
  L.Cg = round_up((int64_t)nS * L.p1, F_TC);
  const int64_t per_gene = nrho * L.Kp * (nS + 2 * L.p1) * 4;
  int64_t gc = CAP / (per_gene > 0 ? per_gene : 1);
  L.Gc = gc < 1 ? 1 : (gc > genes ? genes : gc);
  L.Cy = round_up(L.Gc * nS, F_TC);
  L.Csh = round_up(L.ntri, F_TC) + round_up(L.Gc * L.p1, F_TC);
  // split the rows over up to 8 blocks: the split count that takes the
  // least time on the card's 264 block slots (2 blocks an SM, 132 SMs),
  // in rows a block walks: whole waves of R / rs rows, and each split's
  // partial sums written and read back (F_ROWS_A_BYTE rows a byte: on an
  // H100 a block reduces ~5 rows in the time the card moves ~1 MB of them)
  const Tiling32 T = tiling32(p, nS, (int)L.Gc, true);
  const int64_t blocks = (int64_t)(T.ntg + T.nty + T.nsh) * (L.Kp / F_TK) *
                         nrho;
  const int64_t nch = L.Rp / F_RC;
  const double split_bytes = 2.0 * 4 * nrho * L.Kp *
                             (double)(L.Cg + L.Cy + L.Csh);
  double best = 1e300;
  L.RS = 1;
  for (int rs = 1; rs <= 8 && rs <= nch; ++rs) {
    const double cost = (double)((blocks * rs + 263) / 264) * R / rs +
                        F_ROWS_A_BYTE * rs * split_bytes;
    if (cost < best) {
      best = cost;
      L.RS = rs;
    }
  }
  // a gene chunk's scratch within CAP with its splits
  const int64_t per_split_gene = per_gene * L.RS;
  if (L.Gc > 1 && L.Gc * per_split_gene > CAP)
    L.Gc = CAP / per_split_gene < 1 ? 1 : CAP / per_split_gene;
  L.Cy = round_up(L.Gc * nS, F_TC);
  L.Csh = round_up(L.ntri, F_TC) + round_up(L.Gc * L.p1, F_TC);
  L.RB = L.RS;
  L.w = 0;
  L.ld = 0;
  L.shs = L.ld + round_up(L.RS * nrho * L.Kp, 64);
  L.geno = L.shs + round_up(L.RS * nrho * L.Csh * L.Kp, 64);
  L.gy = L.geno + round_up(L.RS * nrho * L.Cg * L.Kp, 64);
  L.total = L.gy + round_up(L.RS * nrho * L.Cy * L.Kp, 64);
  return L;
}

int run32(const Args<float>& a, void* work, cudaStream_t stream) {
  if (a.p < 1 || a.p > F_MAXP) return (int)cudaErrorInvalidValue;
  const Layout L = layout32(a.nrho, a.R, a.K, a.p, a.nS, a.genes);
  float* base = static_cast<float*>(work);
  auto sk = sums_f32_kernel;
  // the shared-memory limit, raised once a process
  static const int attr = (int)cudaFuncSetAttribute(
      sk, cudaFuncAttributeMaxDynamicSharedMemorySize, F_SMEM);
  if (attr) return attr;
  for (int g0 = 0; g0 < a.genes; g0 += (int)L.Gc) {
    const int gc = (int)(a.genes - g0 < L.Gc ? a.genes - g0 : L.Gc);
    const Tiling32 T = tiling32(a.p, a.nS, gc, g0 == 0);
    const dim3 grid((unsigned)(T.ntg + T.nty + T.nsh),
                    (unsigned)(L.Kp / F_TK), (unsigned)(a.nrho * L.RS));
    sk<<<grid, F_THREADS, F_SMEM, stream>>>(
        a.Sv, a.WGt, a.yt, base + L.ld, base + L.geno, base + L.gy,
        base + L.shs, a.lo, a.hi, a.K, (int)L.Kp, a.nrho, a.R, a.p, a.nS,
        (int)L.Cg, (int)L.Cy, (int)L.Csh, (int)L.RS, g0, gc,
        g0 == 0 ? 1 : 0);
    int err = (int)cudaGetLastError();
    if (err) return err;
    err = a.reml ? epilogue<float, float, true>(a, L, base, g0, gc, stream)
                 : epilogue<float, float, false>(a, L, base, g0, gc, stream);
    if (err) return err;
  }
  return 0;
}

}  // namespace

// Bytes of scratch a crm_delta_grid call with these sizes needs (nrho the
// rows of Sv: rho points, or slots).
extern "C" int64_t crm_delta_grid_workspace(int nrho, int R, int K, int p,
                                            int nS, int genes, int fast32) {
  const int64_t ts = fast32 ? sizeof(float) : sizeof(double);
  return layout(nrho, R, K, p, nS, genes, ts).total * ts;
}

// Sv (nrho, R), WGt (nrho, R, p + nS), yt (genes, nrho, R), CWW (p, p),
// CWy (genes, p), Cyy (genes,), CWg (p, nS), Cgy (genes, nS), Cgg (nS,),
// ld_xx (nS,) (REML only, else null) -> br_lo, br_hi (genes, nS, nrho).
// Row-major f64 on the card; the grid is K points of logit(delta) in
// [lo, hi]; fast32 selects the float working type; 1 <= p + 1 <= 33;
// genes <= 65535 (a single phenotype is genes = 1).  slot (genes,) int64
// in [0, nrho), or null: each gene's grid at its slot alone, writing only
// its (s, slot) brackets.  work: crm_delta_grid_workspace bytes on the
// card, 16-byte aligned.  Launches on `stream`; returns the first CUDA
// error of its launches, 0 if none.
extern "C" int crm_delta_grid(const double* Sv, const double* WGt,
                              const double* yt, const double* CWW,
                              const double* CWy, const double* Cyy,
                              const double* CWg, const double* Cgy,
                              const double* Cgg, const double* ld_xx,
                              const int64_t* slot, double* br_lo,
                              double* br_hi, void* work, double lo, double hi,
                              int K, int n, int nrho, int R, int p, int nS,
                              int genes, int fast32, int reml,
                              cudaStream_t stream) {
  const Args<double> a{Sv,   WGt,   yt,    CWW, CWy, Cyy, CWg,  Cgy,
                       Cgg,  ld_xx, slot,  br_lo, br_hi, lo, hi, K,
                       n,    nrho,  R,     p,   nS,  genes, reml != 0};
  return fast32 ? run<float, double>(a, work, stream)
                : run<double, double>(a, work, stream);
}

// Bytes of scratch a crm_delta_grid_f32 call with these sizes needs.
extern "C" int64_t crm_delta_grid_f32_workspace(int nrho, int R, int K,
                                                int p, int nS, int genes) {
  return layout32(nrho, R, K, p, nS, genes).total * (int64_t)sizeof(float);
}

// The float32 context: the operands of crm_delta_grid in f32 (the working
// type float; 1 <= p + 1 <= 16; the scratch crm_delta_grid_f32_workspace
// bytes) -> br_lo, br_hi (genes, nS, nrho) f64 holding the f32-rounded
// grid logits (REML) or the f64 logits (ML).  Two launches a gene chunk:
// sums_f32_kernel, then the epilogue.
extern "C" int crm_delta_grid_f32(const float* Sv, const float* WGt,
                                  const float* yt, const float* CWW,
                                  const float* CWy, const float* Cyy,
                                  const float* CWg, const float* Cgy,
                                  const float* Cgg, const float* ld_xx,
                                  const int64_t* slot, double* br_lo,
                                  double* br_hi, void* work, double lo,
                                  double hi, int K, int n, int nrho, int R,
                                  int p, int nS, int genes, int reml,
                                  cudaStream_t stream) {
  const Args<float> a{Sv,   WGt,   yt,    CWW, CWy, Cyy, CWg,  Cgy,
                      Cgg,  ld_xx, slot,  br_lo, br_hi, lo, hi, K,
                      n,    nrho,  R,     p,   nS,  genes, reml != 0};
  return run32(a, work, stream);
}
