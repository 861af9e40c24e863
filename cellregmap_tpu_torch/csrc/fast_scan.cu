// K8: the fast association scan's closed-form alternative lmls, f64 and
// f32, for sm_90a.
//
// At the null's fixed delta, with eigenvalues S_r, rotated covariates W_r
// (p columns), phenotype y_r and candidates G_rs (r < R), and the
// complements (CWW, cWy, cyy, CWG, cGy, cGG) (cellregmap_tpu/models/
// lmm.py:863-909 `fast_scan`):
//
//   d_r = (1 - delta) S_r + delta,  w_r = 1 / d_r,
//   A = sum_r w_r W_r W_r^T + CWW / delta,  b = sum_r w_r W_r y_r
//   + cWy / delta,  yy = sum_r w_r y_r^2 + cyy / delta,
//   U_s = sum_r w_r W_r G_rs + CWG_s / delta,  cgg_s = sum_r w_r G_rs^2
//   + cGG_s / delta,  cgy_s = sum_r w_r y_r G_rs + cGy_s / delta,
//   schur = cgg - U^T A^-1 U,  resid = cgy - b^T A^-1 U,
//   beta_g = resid / schur,  beta_W = A^-1 b - A^-1 U beta_g,
//   rss = max(yy - b^T A^-1 b - resid^2 / schur, tiny),
//   lml = -(n log(2 pi rss / n) + sum_r log d_r + (n - R) log delta + n) / 2,
//
// with A^-1 through the ridge Cholesky of `sym_pseudo_solve` (rcond 1e-12 *
// max(max|diag|, 1)).
//
// Replaces: cellregmap_tpu/engine.py `fast_scan_kernel` (:1132-1151) after
// its rotations, which XLA ran as a handful of (p, R) x (R, S) products and
// elementwise passes with a shared (p x p) solve, and its gene axis
// `fast_scan_multigene_kernel` (:1176-1206): many phenotypes against one
// covariance family, each gene at its own null's best rho and delta.  The
// rotated candidates depend on the rho alone, so they come once per
// distinct best rho of the tile (a "slot": S, Wt, CWW, Gt, CWG and cGG
// carry a leading slot axis), and each gene brings its delta, yt, cWy, cyy
// and cGy; the host orders the genes by slot.  A single phenotype is the
// gene axis with one gene and one slot.
//
// What bounds it on the H100: bytes, and then latency.  It reads the
// (R, S) rotated candidates once (4 MB at R = 1010, S = 512 in f64) and
// does ~2 (p + 2) flop per element: 1.2 us at 3.35 TB/s, so the card has
// to keep all of them in flight at once.  Design: two launches.
//
// * The sums (fs_sums_kernel): a block per (tile of VT variants, split of
//   the rows, slot, chunk of GC of the slot's genes), as many splits as
//   fill two blocks an SM (each split at least SPLIT_ROWS rows).  The
//   block stages its rows' per-gene weights w_r, y_r w_r and the row of W
//   in shared memory, RCH rows at a time; warp w takes the rows w, w + 8,
//   ... of a chunk, RPW of them at once (their loads in flight together),
//   lane l its VPL consecutive variants (one 16-byte load of a row where
//   the rows are aligned), so that one read of a G entry feeds every gene
//   of the chunk.  The eight warps' sums meet in shared memory and are
//   added in warp order; the block writes its split's p + 2 sums a
//   variant and gene to a scratch.  The first blocks of the grid, one per
//   gene, compute the variant-independent terms once: A, b, yy and
//   logdet D over every row (the rows staged TCH at a time, threads over
//   the sums and row groups, the groups added in order), then warp 0
//   factors A (ridge Cholesky) and A^-1 b; the block writes them to the
//   scratch.
// * The epilogue (fs_finish_kernel): a block per (32 variants, gene) adds
//   the splits in a fixed order (warp w the splits w, w + 8, ..., then the
//   warps in order), adds the complements and runs each variant's rank-1
//   update against the gene's factor, read from shared memory.
//
// So every sum is taken in an order that does not depend on the schedule.
//
// The float32 context (`fast_scan_kernel` on an f32 context): both
// kernels are templates on the operand type T; T = float (p <= 16)
// makes every sum, the Cholesky, the rank-1 update and the lml f32, as
// the reference computes them on f32 tensors, the null's delta rounded to
// f32 (`crm_fast_scan_f32`, `crm_fast_scan_genes_f32`).  The wide
// instantiation (16 < p <= 32) is f64's.
#include <cuda_runtime.h>
#include <algorithm>
#include <cfloat>
#include <cstdint>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int NT = 256;
constexpr int NWARP = NT / 32;
constexpr int WIDE_P = 32;
constexpr int RPW = 4;   // rows a warp has in flight
constexpr int RCH = 64;  // rows a sums block stages at once
// the least rows of a split: eight warps of RPW rows (the emulated tests
// build one with fewer, so that their small R takes several splits)
#ifndef CRM_FS_SPLIT_ROWS
#define CRM_FS_SPLIT_ROWS 32
#endif
constexpr int SPLIT_ROWS = CRM_FS_SPLIT_ROWS;
constexpr int TARGET_BLOCKS = 264;  // two sums blocks an SM of 132
constexpr int TERM_SMEM = 48 * 1024;  // staged rows of a terms block

template <int V> struct PC { static constexpr int value = V; };

// Loops over the covariates run to the compile-time PMAX, unrolled, and
// skip what lies outside [lo, hi), so the small arrays are indexed
// statically (in registers, also at PMAX = 32).
#define SMALL_FOR(i, lo, hi) \
  _Pragma("unroll") for (int i = 0; i < PMAX; ++i) \
    if (i >= (lo) && i < (hi))

// genes a sums block takes (their sums share each read of G), where a
// slot has more than one; one gene a block else (its registers)
__host__ __device__ constexpr int gene_chunk(int PMAX) {
  return PMAX <= 2 ? 4 : (PMAX <= 4 ? 2 : 1);
}

// sums blocks an SM (the launch bounds): two up to p = 4, at 128
// registers a thread
__host__ __device__ constexpr int sums_min_blocks(int PMAX) {
  return PMAX <= 4 ? 2 : 1;
}

// variants a lane takes: one 16-byte load a row, but one f64 variant from
// p = 5 on (its sums' registers)
template <class T, int PMAX>
__host__ __device__ constexpr int lane_variants() {
  return sizeof(T) == 4 || PMAX <= 4 ? 16 / (int)sizeof(T) : 1;
}

// words of a gene's terms: L (p x p), b, A^-1 b (p each), yy, logdet D
__host__ __device__ inline int gls_words(int p) { return p * p + 2 * p + 2; }

template <class T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

// max(x, tiny) that keeps a NaN, as torch.clamp and jnp.maximum do
__device__ __forceinline__ double clamp_tiny(double x) {
  return x < DBL_MIN ? DBL_MIN : x;
}
__device__ __forceinline__ float clamp_tiny(float x) {
  return x < FLT_MIN ? FLT_MIN : x;
}

// v[0 .. V) = row[s0 .. s0 + V), zero past S: one 16-byte load where the
// rows are aligned (vec) and the lane's variants lie inside
template <class T, int V>
__device__ __forceinline__ void load_row(const T* row, int s0, int S,
                                         bool vec, T (&v)[V]) {
#ifdef __CUDA_ARCH__
  if constexpr (V * sizeof(T) == 16) {
    if (vec && s0 + V <= S) {
      const uint4 raw = __ldg(reinterpret_cast<const uint4*>(row + s0));
      const T* t = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int u = 0; u < V; ++u) v[u] = t[u];
      return;
    }
  }
#endif
#pragma unroll
  for (int u = 0; u < V; ++u) v[u] = s0 + u < S ? row[s0 + u] : T(0);
}

// the slot of the gene at position i of the order (starts[k] <= i <
// starts[k + 1]; one slot when there is no order)
__device__ __forceinline__ int slot_of(const int* starts, int m, int i) {
  int lo = 0, hi = m;  // starts[lo] <= i < starts[hi]
  while (hi - lo > 1) {
    const int mid = (lo + hi) / 2;
    if (starts[mid] <= i) lo = mid;
    else hi = mid;
  }
  return lo;
}

// The operands of a launch.  Per slot: S (m, R), Wt (m, R, p), CWW
// (m, p, p), Gt (m, R, S), CWG (m, p, S), cGG (m, S); per gene: delta
// (null: delta_one for the one gene), yt (genes, R), cWy (genes, p), cyy
// (genes,), cGy (genes, S); order / starts null for one gene and slot.
template <class T>
struct FsArgs {
  const T *delta, *Sv, *Wt, *yt, *CWW, *cWy, *cyy, *Gt, *CWG, *cGy, *cGG;
  const int *order, *starts;
  T *lml, *bg, *bW, *scale;
  T *part, *terms;  // scratch: the splits' sums, the genes' terms
  T delta_one;
  int n, R, p, S, m, genes;
  int tiles, splits, rows, nchunk, tch;
  bool vec;
  __device__ int gene(int i) const { return order ? order[i] : 0; }
  __device__ T delta_of(int g) const { return delta ? delta[g] : delta_one; }
};

// ---------------------------------------------------------------------------
// The terms of the gene at position i of the order: A, b, yy over the rows
// TCH at a time (thread t the sums e = t mod NE, t + NT, ... of the rows
// rg, rg + RG, ... of a chunk), logdet D, the complements, then the ridge
// Cholesky of A (warp 0: lane 0 the pivot, the lanes the column below it)
// and A^-1 b (thread 0), written to terms[g].
// ---------------------------------------------------------------------------
constexpr int TERM_EPT = 3;  // sums a thread holds: NE <= 3 NT at p <= 32

template <class T>
__device__ void terms_block(const FsArgs<T>& a, int i, unsigned char* dyn) {
  const int tid = threadIdx.x, p = a.p, R = a.R, tch = a.tch;
  const int g = a.gene(i);
  const int sl = a.order ? slot_of(a.starts, a.m, i) : 0;
  const T dg = a.delta_of(g);
  const T* So = a.Sv + (int64_t)sl * R;
  const T* Wo = a.Wt + (int64_t)sl * R * p;
  const T* yo = a.yt + (int64_t)g * R;
  const int ntri = p * (p + 1) / 2, ne = ntri + p + 1;  // A lower, b, yy
  const int rg_n = ne >= NT ? 1 : NT / ne;
  const int e0 = tid % ne, rg = tid / ne;
  // w (tch) | y (tch) | W (p columns of tch + 1: a warp's threads read
  // different columns of one row, on different banks) | the row groups'
  // sums (NT) | the terms
  const int ld = tch + 1;
  T* sw = reinterpret_cast<T*>(dyn);
  T* sy = sw + tch;
  T* sx = sy + tch;
  T* red = sx + (int64_t)p * ld;
  T* gout = red + NT;
  __shared__ T wlog[NWARP];
  // the thread's sums: their operand columns (p: y; -1: yy's y y)
  int ca[TERM_EPT], cb[TERM_EPT];
  T acc[TERM_EPT];
#pragma unroll
  for (int t = 0; t < TERM_EPT; ++t) {
    const int e = rg_n > 1 ? (t == 0 ? e0 : ne) : tid + t * NT;
    acc[t] = T(0);
    ca[t] = -2;  // none
    if (e < ntri) {
      int ii = 0;
      while ((ii + 1) * (ii + 2) / 2 <= e) ++ii;
      ca[t] = ii;
      cb[t] = e - ii * (ii + 1) / 2;
    } else if (e < ntri + p) {
      ca[t] = e - ntri;
      cb[t] = p;
    } else if (e == ntri + p) {
      ca[t] = p;
      cb[t] = p;
    }
  }
  const bool grouped = rg < rg_n;
  T logd = T(0);
  for (int r0 = 0; r0 < R; r0 += tch) {
    const int rows = min(tch, R - r0);
    for (int rr = tid; rr < rows; rr += NT) {
      const T d = (T(1) - dg) * So[r0 + rr] + dg;
      sw[rr] = T(1) / d;
      sy[rr] = yo[r0 + rr];
      logd += log(d);
    }
    for (int e = tid; e < rows * p; e += NT) {
      const int rr = e / p, j = e - rr * p;
      sx[(int64_t)j * ld + rr] = Wo[(int64_t)(r0 + rr) * p + j];
    }
    __syncthreads();
    if (grouped) {
#pragma unroll
      for (int t = 0; t < TERM_EPT; ++t) {
        if (ca[t] < -1) continue;
        const T* xa = ca[t] < p ? sx + (int64_t)ca[t] * ld : sy;
        const T* xb = cb[t] < p ? sx + (int64_t)cb[t] * ld : sy;
        T s = acc[t];
        for (int rr = rg; rr < rows; rr += rg_n) s += xa[rr] * sw[rr] * xb[rr];
        acc[t] = s;
      }
    }
    __syncthreads();  // the next chunk overwrites the rows
  }
  // logdet D: the threads' sums over the warps' shuffle trees, then the
  // warps in order
  logd = warp_sum(logd);
  if (tid % 32 == 0) wlog[tid / 32] = logd;
  const T idg = T(1) / dg;
  if (rg_n > 1) {
    if (grouped) red[rg * ne + e0] = acc[0];
    __syncthreads();
    if (tid < ne) {
      T s = T(0);
      for (int k = 0; k < rg_n; ++k) s += red[k * ne + tid];
      acc[0] = s;
    }
  } else {
    __syncthreads();
  }
  T *L = gout, *b = L + p * p, *aib = b + p, *sc = aib + p;
#pragma unroll
  for (int t = 0; t < TERM_EPT; ++t) {
    const int e = rg_n > 1 ? (t == 0 ? tid : ne) : tid + t * NT;
    if (e >= ne || (rg_n > 1 && t > 0)) continue;
    if (ca[t] < p && cb[t] < p)
      L[ca[t] * p + cb[t]] =
          acc[t] + a.CWW[(int64_t)sl * p * p + ca[t] * p + cb[t]] * idg;
    else if (ca[t] < p)
      b[ca[t]] = acc[t] + a.cWy[(int64_t)g * p + ca[t]] * idg;
    else
      sc[0] = acc[t] + a.cyy[g] * idg;
  }
  if (tid == 0) {
    T s = T(0);
    for (int w = 0; w < NWARP; ++w) s += wlog[w];
    sc[1] = s + (T)(a.n - R) * log(dg);
  }
  __syncthreads();
  if (tid < 32) {
    T dmax = T(0);
    for (int k = 0; k < p; ++k) dmax = fmax(dmax, fabs(L[k * p + k]));
    const T ridge = T(1e-12) * fmax(dmax, T(1));
    for (int jj = 0; jj < p; ++jj) {
      if (tid == 0) {
        T dj = L[jj * p + jj] + ridge;
        for (int k = 0; k < jj; ++k) dj -= L[jj * p + k] * L[jj * p + k];
        L[jj * p + jj] = sqrt(dj);
      }
      __syncwarp();
      const T dj = L[jj * p + jj];
      for (int r = jj + 1 + tid; r < p; r += 32) {
        T v = L[r * p + jj];
        for (int k = 0; k < jj; ++k) v -= L[r * p + k] * L[jj * p + k];
        L[r * p + jj] = v / dj;
      }
      __syncwarp();
    }
    if (tid == 0) {  // A^-1 b
      for (int r = 0; r < p; ++r) {
        T t = b[r];
        for (int k = 0; k < r; ++k) t -= L[r * p + k] * aib[k];
        aib[r] = t / L[r * p + r];
      }
      for (int r = p - 1; r >= 0; --r) {
        T t = aib[r];
        for (int k = r + 1; k < p; ++k) t -= L[k * p + r] * aib[k];
        aib[r] = t / L[r * p + r];
      }
    }
  }
  __syncthreads();
  T* to = a.terms + (int64_t)g * gls_words(p);
  for (int e = tid; e < gls_words(p); e += NT) to[e] = gout[e];
}

// ---------------------------------------------------------------------------
// The sums of one (tile, split, slot, chunk of genes) block: each gene's
// U, cgg, cgy of its VT variants over the split's rows
// ---------------------------------------------------------------------------
template <class T, int PMAX, int GC>
__device__ void sums_block(const FsArgs<T>& a, int b, unsigned char* dyn) {
  constexpr int V = lane_variants<T, PMAX>();
  constexpr int VT = 32 * V;
  const int tile = b % a.tiles;
  b /= a.tiles;
  const int split = b % a.splits;
  b /= a.splits;
  const int zc = b % a.nchunk, sl = b / a.nchunk;
  const int c0 = (a.order ? a.starts[sl] : 0) + zc * GC;
  const int c1 = a.order ? a.starts[sl + 1] : 1;
  if (c0 >= c1) return;  // the slot has fewer chunks: the whole block
  const int ng = min(GC, c1 - c0);
  const int p = a.p, R = a.R, S = a.S, q = p + 2;
  const int r_lo = split * a.rows, r_hi = min(R, r_lo + a.rows);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int s0 = tile * VT + lane * V;
  const T* So = a.Sv + (int64_t)sl * R;
  const T* Wo = a.Wt + (int64_t)sl * R * p;
  const T* Go = a.Gt + (int64_t)sl * R * S;
  // staged rows: W (p x RCH), each gene's w and y w (GC x RCH each); then
  // the warps' sums (NWARP x GC x q x VT)
  T* sx = reinterpret_cast<T*>(dyn);
  T* sw = sx + p * RCH;
  T* syw = sw + GC * RCH;
  T* red = syw + GC * RCH;
  T U[GC][V][PMAX], cgg[GC][V], cgy[GC][V];
#pragma unroll
  for (int gi = 0; gi < GC; ++gi)
#pragma unroll
    for (int v = 0; v < V; ++v) {
      SMALL_FOR(j, 0, p) U[gi][v][j] = T(0);
      cgg[gi][v] = T(0);
      cgy[gi][v] = T(0);
    }
  for (int r0 = r_lo; r0 < r_hi; r0 += RCH) {
    const int rows = min(RCH, r_hi - r0);
    for (int e = threadIdx.x; e < GC * RCH; e += NT) {
      const int gi = e / RCH, rr = e - gi * RCH;
      T w = T(0), yw = T(0);
      if (gi < ng && rr < rows) {
        const int g = a.gene(c0 + gi);
        const T dg = a.delta_of(g);
        w = T(1) / ((T(1) - dg) * So[r0 + rr] + dg);
        yw = a.yt[(int64_t)g * R + r0 + rr] * w;
      }
      sw[e] = w;
      syw[e] = yw;
    }
    for (int e = threadIdx.x; e < rows * p; e += NT) {
      const int rr = e / p, j = e - rr * p;
      sx[j * RCH + rr] = Wo[(int64_t)(r0 + rr) * p + j];
    }
    __syncthreads();
    for (int rb = warp; rb < rows; rb += NWARP * RPW) {
      T gv[RPW][V];
#pragma unroll
      for (int u = 0; u < RPW; ++u) {
        const int rr = rb + u * NWARP;
        if (rr < rows)
          load_row<T, V>(Go + (int64_t)(r0 + rr) * S, s0, S, a.vec, gv[u]);
        else
#pragma unroll
          for (int v = 0; v < V; ++v) gv[u][v] = T(0);
      }
#pragma unroll
      for (int u = 0; u < RPW; ++u) {
        const int rr = min(rb + u * NWARP, rows - 1);  // past rows: g = 0
        T xr[PMAX];
        SMALL_FOR(j, 0, p) xr[j] = sx[j * RCH + rr];
#pragma unroll
        for (int gi = 0; gi < GC; ++gi) {
          if (gi >= ng) continue;
          const T w = sw[gi * RCH + rr], yw = syw[gi * RCH + rr];
#pragma unroll
          for (int v = 0; v < V; ++v) {
            const T g = gv[u][v];
            const T gw = g * w;
            SMALL_FOR(j, 0, p) U[gi][v][j] += xr[j] * gw;
            cgg[gi][v] += g * gw;
            cgy[gi][v] += g * yw;
          }
        }
      }
    }
    __syncthreads();  // the next chunk overwrites the staged rows
  }
  // the warps' sums, then added in warp order into the split's scratch
#pragma unroll
  for (int gi = 0; gi < GC; ++gi) {
    if (gi >= ng) continue;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      T* o = red + ((int64_t)(warp * GC + gi) * q) * VT + lane * V + v;
      SMALL_FOR(j, 0, p) o[j * VT] = U[gi][v][j];
      o[p * VT] = cgg[gi][v];
      o[(p + 1) * VT] = cgy[gi][v];
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < ng * q * VT; e += NT) {
    const int vv = e % VT, gj = e / VT;  // gj = gi q + j
    const int s = tile * VT + vv;
    if (s >= S) continue;
    T t = T(0);
    for (int w = 0; w < NWARP; ++w)
      t += red[((int64_t)w * GC * q + gj) * VT + vv];
    const int gi = gj / q, j = gj - gi * q;
    const int g = a.gene(c0 + gi);
    a.part[(((int64_t)g * a.splits + split) * q + j) * S + s] = t;
  }
}

template <class T, int PMAX, int GC>
__global__ void __launch_bounds__(NT, sums_min_blocks(PMAX))
fs_sums_kernel(const FsArgs<T> a) {
  extern __shared__ __align__(16) unsigned char fs_dyn[];
  const int b = blockIdx.x;
  if (b < a.genes)  // the first blocks: a gene's terms each
    terms_block<T>(a, b, fs_dyn);
  else
    sums_block<T, PMAX, GC>(a, b - a.genes, fs_dyn);
}

// ---------------------------------------------------------------------------
// The epilogue: a block per (32 variants, gene at position blockIdx.y)
// ---------------------------------------------------------------------------
// The wide instantiation's (p <= 32): a warp a variant, lane r holding row r
// of z = A^-1 U through the column-oriented substitutions (z_k made on
// lane k with its pivot's reciprocal, a division off the chain, then
// every later row updated at once), the dot products over the lanes.
// red: the warps' sums of the block's 32 variants (NWARP x q x 32)
template <class T>
__device__ void wide_epilogue(const FsArgs<T>& a, const T* gt, const T* red,
                              const T* CGo, int g, int sl, T idg) {
  const int p = a.p, S = a.S, q = p + 2;
  const int warp = threadIdx.x / 32, r = threadIdx.x % 32;
  const T *L = gt, *b = L + p * p, *aib = b + p, *sc = aib + p;
  const T inv = r < p ? T(1) / L[r * p + r] : T(0);
  for (int v = warp; v < 32; v += NWARP) {
    const int s = blockIdx.x * 32 + v;
    if (s >= S) return;  // and every later variant of the warp
    T u = T(0), cg = T(0), cy = T(0);
    for (int w = 0; w < NWARP; ++w) {
      if (r < p) u += red[(w * q + r) * 32 + v];
      cg += red[(w * q + p) * 32 + v];
      cy += red[(w * q + p + 1) * 32 + v];
    }
    if (r < p) u += CGo[(int64_t)r * S + s] * idg;
    cg += a.cGG[(int64_t)sl * S + s] * idg;
    cy += a.cGy[(int64_t)g * S + s] * idg;
    T t = u;
    for (int k = 0; k < p; ++k) {  // L y = U
      if (r == k) t *= inv;
      const T zk = __shfl_sync(FULL, t, k);
      if (r > k && r < p) t -= L[r * p + k] * zk;
    }
    for (int k = p - 1; k >= 0; --k) {  // L^T z = y
      if (r == k) t *= inv;
      const T zk = __shfl_sync(FULL, t, k);
      if (r < k) t -= L[k * p + r] * zk;
    }
    const bool row = r < p;
    const T uau = warp_sum(row ? u * t : T(0));
    const T bau = warp_sum(row ? b[r] * t : T(0));
    const T bab = warp_sum(row ? b[r] * aib[r] : T(0));
    const T schur = cg - uau;
    const T resid = cy - bau;
    const T beta_g = resid / schur;
    const int64_t gs = (int64_t)g * S + s;
    if (row) a.bW[gs * p + r] = aib[r] - t * beta_g;
    if (r == 0) {
      const T rss = clamp_tiny(sc[0] - bab - resid * resid / schur);
      const T scale = rss / (T)a.n;
      a.bg[gs] = beta_g;
      a.scale[gs] = scale;
      a.lml[gs] = T(-0.5) * ((T)a.n * log(T(6.283185307179586) * scale) +
                             sc[1] + (T)a.n);
    }
  }
}

template <class T, int PMAX>
__global__ void __launch_bounds__(NT) fs_finish_kernel(const FsArgs<T> a) {
  extern __shared__ __align__(16) unsigned char fs_dyn[];
  const int p = a.p, S = a.S, q = p + 2;
  const int i = blockIdx.y, g = a.gene(i);
  const int sl = a.order ? slot_of(a.starts, a.m, i) : 0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int s = blockIdx.x * 32 + lane;
  T* gt = reinterpret_cast<T*>(fs_dyn);  // the gene's terms
  T* red = gt + gls_words(p);            // the warps' sums (NWARP x q x 32)
  const T* tg = a.terms + (int64_t)g * gls_words(p);
  for (int e = threadIdx.x; e < gls_words(p); e += NT) gt[e] = tg[e];
  // warp w: the splits w, w + 8, ... in order (U, then cgg and cgy)
  T acc[PMAX], ag = T(0), ay = T(0);
  SMALL_FOR(j, 0, p) acc[j] = T(0);
  if (s < S) {
    const T* pg = a.part + (int64_t)g * a.splits * q * S + s;
    for (int sp = warp; sp < a.splits; sp += NWARP) {
      const T* ps = pg + (int64_t)sp * q * S;
      SMALL_FOR(j, 0, p) acc[j] += ps[(int64_t)j * S];
      ag += ps[(int64_t)p * S];
      ay += ps[(int64_t)(p + 1) * S];
    }
  }
  T* o = red + warp * q * 32 + lane;
  SMALL_FOR(j, 0, p) o[j * 32] = acc[j];
  o[p * 32] = ag;
  o[(p + 1) * 32] = ay;
  __syncthreads();
  const T dg = a.delta_of(g);
  const T idg = T(1) / dg;
  const T* CGo = a.CWG + (int64_t)sl * p * S;
  if constexpr (PMAX > 16) {
    // the wide epilogue: warp w the variants w, w + 8, ... of the block,
    // lane r row r of the factor (a serial solve a lane would take p^2
    // steps)
    wide_epilogue<T>(a, gt, red, CGo, g, sl, idg);
    return;
  }
  if (warp != 0 || s >= S) return;
  T U[PMAX], z[PMAX];
  SMALL_FOR(j, 0, p) {
    T v = T(0);
    for (int w = 0; w < NWARP; ++w) v += red[(w * q + j) * 32 + lane];
    U[j] = v + CGo[(int64_t)j * S + s] * idg;
  }
  T cg = T(0), cy = T(0);
  for (int w = 0; w < NWARP; ++w) {
    cg += red[(w * q + p) * 32 + lane];
    cy += red[(w * q + p + 1) * 32 + lane];
  }
  cg += a.cGG[(int64_t)sl * S + s] * idg;
  cy += a.cGy[(int64_t)g * S + s] * idg;
  const T *L = gt, *b = L + p * p, *aib = b + p, *sc = aib + p;
  // z = A^-1 U through the factor
  SMALL_FOR(r, 0, p) {
    T t = U[r];
    SMALL_FOR(k, 0, r) t -= L[r * p + k] * z[k];
    z[r] = t / L[r * p + r];
  }
  for (int r = PMAX - 1; r >= 0; --r) {
    if (r >= p) continue;
    T t = z[r];
    SMALL_FOR(k, r + 1, p) t -= L[k * p + r] * z[k];
    z[r] = t / L[r * p + r];
  }
  T uau = T(0), bau = T(0), bab = T(0);
  SMALL_FOR(r, 0, p) {
    uau += U[r] * z[r];
    bau += b[r] * z[r];
    bab += b[r] * aib[r];
  }
  const T schur = cg - uau;
  const T resid = cy - bau;
  const T beta_g = resid / schur;
  const int64_t gs = (int64_t)g * S + s;
  SMALL_FOR(r, 0, p) a.bW[gs * p + r] = aib[r] - z[r] * beta_g;
  const T rss = clamp_tiny(sc[0] - bab - resid * resid / schur);
  const T scale = rss / (T)a.n;
  a.bg[gs] = beta_g;
  a.scale[gs] = scale;
  a.lml[gs] = T(-0.5) * ((T)a.n * log(T(6.283185307179586) * scale) +
                         sc[1] + (T)a.n);
}

// The launch plan of a call: tiles of VT variants, splits of the rows
// (enough sums blocks for TARGET_BLOCKS, each split at least SPLIT_ROWS
// rows), rows a split, chunks of genes a slot, and the scratch's words
struct FsPlan {
  int tiles, splits, rows, nchunk, tch, smem_sums, smem_finish;
  int64_t words;
};

template <class T, int PMAX>
FsPlan fs_plan(int R, int p, int S, int genes, int m, int max_genes) {
  constexpr int VT = 32 * lane_variants<T, PMAX>();
  const int GC = max_genes > 1 ? gene_chunk(PMAX) : 1;
  FsPlan f;
  const int es = (int)sizeof(T), q = p + 2;
  f.tiles = (S + VT - 1) / VT;
  f.nchunk = (max_genes + GC - 1) / GC;
  const int64_t per_split = (int64_t)f.tiles * m * f.nchunk;
  const int64_t most = std::max(1, (R + SPLIT_ROWS - 1) / SPLIT_ROWS);
  const int want = (int)std::max<int64_t>(
      1, std::min(most, (TARGET_BLOCKS + per_split - 1) / per_split));
  f.rows = (R + want - 1) / want;
  f.splits = (R + f.rows - 1) / f.rows;
  const int sums = es * ((p + 2 * GC) * RCH + NWARP * GC * q * VT);
  // a terms block's rows a chunk: within TERM_SMEM, or the sums blocks'
  // memory where that is larger
  const int budget =
      std::max(TERM_SMEM, sums) - es * (p + NT + gls_words(p));
  f.tch = std::max(1, std::min((R + 31) / 32 * 32, budget / (es * (p + 2))));
  const int terms = es * ((p + 2) * f.tch + p + NT + gls_words(p));
  f.smem_sums = std::max(sums, terms);
  f.smem_finish = es * (gls_words(p) + NWARP * q * 32);
  f.words = (int64_t)genes * (f.splits * (int64_t)q * S + gls_words(p));
  return f;
}

template <class T, int PMAX>
int fs_launch(FsArgs<T> a, int max_genes, void* work, cudaStream_t stream) {
  const FsPlan f =
      fs_plan<T, PMAX>(a.R, a.p, a.S, a.genes, a.m, max_genes);
  a.tiles = f.tiles;
  a.splits = f.splits;
  a.rows = f.rows;
  a.nchunk = f.nchunk;
  a.tch = f.tch;
  a.terms = static_cast<T*>(work);
  a.part = a.terms + (int64_t)a.genes * gls_words(a.p);
  a.vec = a.S % lane_variants<T, PMAX>() == 0 &&
          reinterpret_cast<uintptr_t>(a.Gt) % 16 == 0;
  // a gene chunk where a slot has several genes, else one gene a block
  constexpr int GC = gene_chunk(PMAX);
  auto sums = max_genes > 1 ? fs_sums_kernel<T, PMAX, GC>
                            : fs_sums_kernel<T, PMAX, 1>;
  auto finish = fs_finish_kernel<T, PMAX>;
  int err = (int)cudaFuncSetAttribute(
      sums, cudaFuncAttributeMaxDynamicSharedMemorySize, f.smem_sums);
  if (err) return err;
  err = (int)cudaFuncSetAttribute(
      finish, cudaFuncAttributeMaxDynamicSharedMemorySize, f.smem_finish);
  if (err) return err;
  const int64_t blocks =
      a.genes + (int64_t)f.tiles * f.splits * a.m * f.nchunk;
  sums<<<(unsigned)blocks, NT, f.smem_sums, stream>>>(a);
  err = (int)cudaGetLastError();
  if (err) return err;
  const dim3 grid((unsigned)((a.S + 31) / 32), (unsigned)a.genes);
  finish<<<grid, NT, f.smem_finish, stream>>>(a);
  return (int)cudaGetLastError();
}

// the instantiation of p (f32: p <= 16)
template <class T, class F>
int by_width(int p, F f) {
  if (p <= 2) return f(PC<2>());
  if (p <= 4) return f(PC<4>());
  if constexpr (sizeof(T) == 4) {
    return f(PC<16>());
  } else {
    if (p <= 16) return f(PC<16>());
    return f(PC<WIDE_P>());
  }
}

template <class T>
int64_t fs_workspace(int R, int p, int S, int genes, int m, int max_genes) {
  int64_t words = 0;
  by_width<T>(p, [&](auto pm) {
    words = fs_plan<T, decltype(pm)::value>(R, p, S, genes, m, max_genes)
                .words;
    return 0;
  });
  return (int64_t)sizeof(T) * words;
}

template <class T>
int fs_call(FsArgs<T> a, int max_genes, void* work, cudaStream_t stream) {
  if (a.p < 1 || a.p > (sizeof(T) == 4 ? 16 : WIDE_P) || a.S < 1)
    return (int)cudaErrorInvalidValue;
  return by_width<T>(a.p, [&](auto pm) {
    return fs_launch<T, decltype(pm)::value>(a, max_genes, work, stream);
  });
}

template <class T>
FsArgs<T> fs_args(const T* delta, T delta_one, const T* Sv, const T* Wt,
                  const T* yt, const T* CWW, const T* cWy, const T* cyy,
                  const T* Gt, const T* CWG, const T* cGy, const T* cGG,
                  const int* order, const int* starts, T* lml, T* bg,
                  T* bW, T* scale, int n, int R, int p, int S, int m,
                  int genes) {
  FsArgs<T> a{};
  a.delta = delta;
  a.delta_one = delta_one;
  a.Sv = Sv;
  a.Wt = Wt;
  a.yt = yt;
  a.CWW = CWW;
  a.cWy = cWy;
  a.cyy = cyy;
  a.Gt = Gt;
  a.CWG = CWG;
  a.cGy = cGy;
  a.cGG = cGG;
  a.order = order;
  a.starts = starts;
  a.lml = lml;
  a.bg = bg;
  a.bW = bW;
  a.scale = scale;
  a.n = n;
  a.R = R;
  a.p = p;
  a.S = S;
  a.m = m;
  a.genes = genes;
  return a;
}

}  // namespace

// Bytes of scratch a call needs (the splits' sums and the genes' terms):
// a single phenotype is genes = m = max_genes = 1; f32 the float32
// context's entry points.
extern "C" int64_t crm_fast_scan_workspace(int R, int p, int S, int genes,
                                           int m, int max_genes, int f32) {
  return f32 ? fs_workspace<float>(R, p, S, genes, m, max_genes)
             : fs_workspace<double>(R, p, S, genes, m, max_genes);
}

// S (R,), Wt (R, p), yt (R,), CWW (p, p), cWy (p,), cyy (1,), Gt (R, S),
// CWG (p, S), cGy (S,), cGG (S,) -> lml, beta_g (S,), beta_W (S, p),
// scale (S,).  Row-major f64 on the card; 1 <= p <= 32; work:
// crm_fast_scan_workspace(R, p, S, 1, 1, 1, 0) bytes, 16-byte aligned.
// Launches on `stream`; returns cudaGetLastError().
extern "C" int crm_fast_scan(const double* Sv, const double* Wt,
                             const double* yt, const double* CWW,
                             const double* cWy, const double* cyy,
                             const double* Gt, const double* CWG,
                             const double* cGy, const double* cGG,
                             double* lml, double* beta_g, double* beta_W,
                             double* scale, void* work, double delta, int n,
                             int R, int p, int S, cudaStream_t stream) {
  return fs_call(fs_args<double>(nullptr, delta, Sv, Wt, yt, CWW, cWy, cyy,
                                 Gt, CWG, cGy, cGG, nullptr, nullptr, lml,
                                 beta_g, beta_W, scale, n, R, p, S, 1, 1),
                 1, work, stream);
}

// The gene axis.  Per slot (m distinct best rho): S (m, R), Wt (m, R, p),
// CWW (m, p, p), Gt (m, R, S), CWG (m, p, S), cGG (m, S); per gene: delta
// (genes,), yt (genes, R), cWy (genes, p), cyy (genes,), cGy (genes, S);
// order (genes,) int32, the genes ordered by slot, and starts (m + 1,)
// int32, slot k's genes being order[starts[k] .. starts[k + 1]);
// max_genes the most genes of a slot -> lml, beta_g, scale (genes, S),
// beta_W (genes, S, p).  Row-major f64 on the card; 1 <= p <= 32; work:
// crm_fast_scan_workspace bytes, 16-byte aligned.  Launches on `stream`;
// returns cudaGetLastError().
extern "C" int crm_fast_scan_genes(const double* delta, const double* Sv,
                                   const double* Wt, const double* yt,
                                   const double* CWW, const double* cWy,
                                   const double* cyy, const double* Gt,
                                   const double* CWG, const double* cGy,
                                   const double* cGG, const int* order,
                                   const int* starts, double* lml,
                                   double* beta_g, double* beta_W,
                                   double* scale, void* work, int n, int R,
                                   int p, int S, int m, int max_genes,
                                   int genes, cudaStream_t stream) {
  return fs_call(fs_args<double>(delta, 0.0, Sv, Wt, yt, CWW, cWy, cyy, Gt,
                                 CWG, cGy, cGG, order, starts, lml, beta_g,
                                 beta_W, scale, n, R, p, S, m, genes),
                 max_genes, work, stream);
}

// The float32 context: the operands and results of crm_fast_scan in f32
// (delta rounded to f32), 1 <= p <= 16.
extern "C" int crm_fast_scan_f32(const float* Sv, const float* Wt,
                                 const float* yt, const float* CWW,
                                 const float* cWy, const float* cyy,
                                 const float* Gt, const float* CWG,
                                 const float* cGy, const float* cGG,
                                 float* lml, float* beta_g, float* beta_W,
                                 float* scale, void* work, double delta,
                                 int n, int R, int p, int S,
                                 cudaStream_t stream) {
  return fs_call(fs_args<float>(nullptr, (float)delta, Sv, Wt, yt, CWW, cWy,
                                cyy, Gt, CWG, cGy, cGG, nullptr, nullptr,
                                lml, beta_g, beta_W, scale, n, R, p, S, 1,
                                1),
                 1, work, stream);
}

// The float32 context's gene axis: the operands and results of
// crm_fast_scan_genes in f32 (order and starts as there), 1 <= p <= 16.
extern "C" int crm_fast_scan_genes_f32(const float* delta, const float* Sv,
                                       const float* Wt, const float* yt,
                                       const float* CWW, const float* cWy,
                                       const float* cyy, const float* Gt,
                                       const float* CWG, const float* cGy,
                                       const float* cGG, const int* order,
                                       const int* starts, float* lml,
                                       float* beta_g, float* beta_W,
                                       float* scale, void* work, int n,
                                       int R, int p, int S, int m,
                                       int max_genes, int genes,
                                       cudaStream_t stream) {
  return fs_call(fs_args<float>(delta, 0.0f, Sv, Wt, yt, CWW, cWy, cyy, Gt,
                                CWG, cGy, cGG, order, starts, lml, beta_g,
                                beta_W, scale, n, R, p, S, m, genes),
                 max_genes, work, stream);
}
