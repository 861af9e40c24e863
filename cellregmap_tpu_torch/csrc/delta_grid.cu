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
// takes its operands in f32 (a template on the operand type TO; the
// products are formed from the widened values and rounded to T = float,
// which is the f32 product) and writes the interaction's (REML) brackets
// as the f32-rounded grid logits, widened exactly (the reference's
// `linspace(lo, hi, n_grid).astype(ctx dtype)`, :528); the association
// refit's (ML) keep the f64 logits, as its `linspace(lo, hi, n_grid)`
// (:986-989) does.
#include <cuda_runtime.h>
#include <cfloat>
#include <cstdint>

#include "async_copy.cuh"

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

// The float32 context: the operands of crm_delta_grid in f32 (the working
// type float; the scratch crm_delta_grid_workspace(..., fast32 = 1)
// bytes) -> br_lo, br_hi (genes, nS, nrho) f64 holding the f32-rounded grid
// logits.
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
  return run<float, float>(a, work, stream);
}
