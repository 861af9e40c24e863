// K5: per-variant score statistic, f64, for sm_90a.
//
// For variant s at its best rho k_s, with cov = v0 Sigma + v1 I expressed in
// the eigenbasis (eigenvalues Sb = S[k_s]) and omega = v0 Sb / (v1 + v0 Sb):
//
//   u^T K0^{-1} v = (u^T v - sum_r omega_r u_r v_r) / v1   for u, v in
//   the columns of [A | X | y], A = At[s] (R, C), X = [W_t, g_t] (R, p+1);
//   B   = (XKX + ridge)^{-1} [XKy | AKX^T]                 (p+1 Cholesky)
//   APy = AKy - AKX B[:, 0],   APA = AKA - AKX B[:, 1:]
//   Q   = 1/2 ||APy||^2,       Wmat = 1/4 (APA + APA^T)
//
// Replaces: cellregmap_tpu/engine.py `score_test_core` as vmapped by
// `interaction_batch`'s `per_snp` (davies branch), lines 234-265, 736-793.
//
// What bounds it on the H100: bytes.  Per variant it reads its (R, C)
// score factor and the R-long rows of its best rho (41 MB in all at the
// headline R=1010, C=10, S=512) and does ~2 R (C+p+2)^2 / 2 flop, a few
// flop per byte.
//
// Design: three launches from one entry point.
// * score_kslot_kernel: kslot[j, s], the best rho of slot j at variant s
//   (that of the first gene whose slot at s is j: the genes that share a
//   slot share their best rho, K4's slots, best_rho_rotate.cu), -1 where
//   no gene's slot is j.
// * score_gather_kernel: Gs[j, s, :] = the rotated genotype column of
//   each distinct (slot, variant) pair, WGt[k, :, p + s] (a column of the
//   (R, p + S) rows of its rho, one 32-byte sector for each value when
//   read where it lies), through 32 x 32 tiles of shared memory: the
//   reads run along the variants of one row (contiguous where the
//   neighbours share the rho), the writes along the rows, as K4's
//   transpose of T.
// * score_core_kernel: a block of 8 warps per variant s.  It holds the
//   genes' slots at s (GWIN genes at a time) and takes each used slot j
//   in turn, gb of its genes a pass (all of them for a single phenotype;
//   16 at the headline's widths).  A pass streams the rows of [A | W_t |
//   g_t], each of its genes' y_t and the eigenvalues through a
//   four-stage cp.async ring of 32-row chunks (A, g and y contiguous, W a
//   row of p), once for all the pass's genes, and makes each gene's omega
//   row by row in shared memory.  The omega-weighted Gram G = Z^T
//   diag(omega) Z of each gene's Z = [A | W_t | g_t | y_t] (m = C + p + 2
//   columns) is a sum of mma.sync m16n8k8 products on the FP64 tensor
//   cores (dmma.cuh): a tile is 16 columns by 8 columns of G, 8 rows
//   deep, the weights scaled into the A fragment as it is loaded (as the
//   wide K10's null_fit.cu does), tiles past m padded (their entries never
//   stored), only the tiles that hold the lower triangle.  A warp holds up
//   to MAXJ (gene, tile) jobs; with fewer jobs than warps the rows are
//   split over the warps too (8-row steps dealt round), and the partial
//   tiles are summed once, in shared memory, into each gene's full m x m
//   Gram (in the ring's place).  The algebra then runs a warp a gene, in
//   f64: the complement subtraction and 1/v1 scaling, a ridge (rcond
//   1e-12 * max(max|diag|, 1)) Cholesky of the (p+1)^2 system (lane 0 the
//   pivot, the lanes the column below it), the 1 + C triangular solves a
//   lane each, APA, Q and the symmetrised Wmat over the lanes.  Two
//   instantiations: MAXJ = 4 (m <= 80: up to 30 tiles a gene, 16 genes a
//   pass at the headline's m = 13, two blocks an SM) and MAXJ = 8 (m <=
//   98: 55 tiles, so C = 64 with 32 covariates).
//
// The float32 context (the screen's, engine.py:234-265 on an f32 context:
// the score factors, rotated rows and full-space Grams f32, v0 and v1 f64,
// so that the reference's type promotion runs the whole statistic in f64)
// takes the same kernels with f32 operands, each value widened to f64 as
// it is loaded (a template on the load type): the gathered genotype
// columns and the staged rows are f64 in shared memory, and the Gram runs
// on the FP64 tensor cores as above.
#include <cuda_runtime.h>
#include <cstdint>

#include "async_copy.cuh"
#include "dmma.cuh"

namespace {

constexpr int NW = 8;          // warps of a block
constexpr int NT = 32 * NW;    // threads of a block
constexpr int RC = 32;         // rows of a staged chunk (4 steps of 8)
constexpr int NSTAGE = 4;      // chunks of the ring (3 in flight)
constexpr int GBMAX = 16;      // genes of one pass
constexpr int GWIN = 256;      // genes whose slots a block holds at once
constexpr int MAXJ_NARROW = 4, MAXJ_WIDE = 8;  // (gene, tile) jobs a warp
constexpr int SMEM_MAX = 227 * 1024;

// the lower-triangle tiles of an m x m Gram: (16-column ti, 8-column tj)
// with 8 tj <= 16 ti + 15, both inside m
__host__ __device__ inline int n_tiles(int m) {
  const int nj = (m + 7) / 8;
  int n = 0;
  for (int ti = 0; 16 * ti < m; ++ti) n += min(2 * ti + 2, nj);
  return n;
}

__device__ inline void tile_of(int t, int m, int& ti, int& tj) {
  const int nj = (m + 7) / 8;
  ti = 0;
  for (;; ++ti) {
    const int c = min(2 * ti + 2, nj);
    if (t < c) break;
    t -= c;
  }
  tj = t;
}

// row stride of a staged chunk's [A | W | g] (m - 1 columns), 4 mod 16
// doubles: a fragment's lanes (g, t) at row t, column g then hit 16
// distinct banks in each half-warp
__host__ __device__ inline int ld_z(int m) {
  return (m - 1 + 11) / 16 * 16 + 4;
}

// doubles of one stage: [A | W | g] rows, each pass gene's y, the
// eigenvalues
__host__ __device__ inline int stage_words(int m, int gb) {
  return RC * ld_z(m) + gb * RC + RC;
}

// doubles of a warp's algebra: XKX (then its factor), [XKy | AKX^T],
// AKX, APy
__host__ __device__ inline int epi_words(int C, int p) {
  const int p1 = p + 1;
  return p1 * p1 + p1 * (C + 1) + C * p1 + C;
}

// the ring, and after the stream the pass's Grams, in the same place
__host__ __device__ inline int ring_words(int m, int gb) {
  const int ring = NSTAGE * stage_words(m, gb), gram = gb * m * m;
  return ring > gram ? ring : gram;
}

inline int smem_bytes(int C, int p, int gb) {
  const int m = C + p + 2;
  const int words = ring_words(m, gb) + gb * RC + 2 * gb +
                    (gb < NW ? gb : NW) * epi_words(C, p);
  return (int)sizeof(double) * words + (int)sizeof(int) * (gb + GWIN);
}

// kslot[j, s]: the best rho of the first gene whose slot at s is j (-1
// where no gene's is), a thread a variant
__global__ void score_kslot_kernel(const int64_t* __restrict__ k_best,
                                   const int64_t* __restrict__ slot,
                                   int64_t* __restrict__ kslot, int S,
                                   int genes, int nslots) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= S) return;
  for (int j = 0; j < nslots; ++j) kslot[(int64_t)j * S + s] = -1;
  for (int g = 0; g < genes; ++g) {
    int64_t* k = kslot + slot[(int64_t)g * S + s] * S + s;
    if (*k < 0) *k = k_best[(int64_t)g * S + s];
  }
}

// Gs[j, s, r] = WGt[kslot[j, s], r, p + s] where kslot[j, s] >= 0; a
// block a (32 variants, 32 rows, slot); an f32 WGt is widened as it is read
template <class TL>
__global__ void __launch_bounds__(256)
score_gather_kernel(const TL* __restrict__ WGt,
                    const int64_t* __restrict__ kslot,
                    double* __restrict__ Gs, int R, int p, int S) {
  __shared__ double tile[32][33];
  __shared__ int64_t ks[32];
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  const int s0 = blockIdx.x * 32, r0 = blockIdx.y * 32, j = blockIdx.z;
  if (ty == 0) ks[tx] = s0 + tx < S ? kslot[(int64_t)j * S + s0 + tx] : -1;
  __syncthreads();
  const int64_t ps = p + S;
  for (int i = ty; i < 32; i += 8) {
    const int r = r0 + i, s = s0 + tx;
    if (r < R && ks[tx] >= 0) tile[i][tx] = WGt[(ks[tx] * R + r) * ps + p + s];
  }
  __syncthreads();
  for (int i = ty; i < 32; i += 8) {
    const int s = s0 + i, r = r0 + tx;
    if (r < R && ks[i] >= 0) Gs[((int64_t)j * S + s) * R + r] = tile[tx][i];
  }
}

// one staged value of the load type TL, as f64: a cp.async for f64, a
// widening load for f32
template <class TL>
__device__ __forceinline__ void stage_value(double* d, const TL* src) {
  if constexpr (sizeof(TL) == 8)
    cp_async8(d, src);
  else
    *d = (double)*src;
}

template <int MAXJ, class TL>
__global__ void __launch_bounds__(NT, MAXJ == MAXJ_NARROW ? 2 : 1)
score_core_kernel(const TL* __restrict__ Sv, const TL* __restrict__ WGt,
                  const TL* __restrict__ yt, const TL* __restrict__ At,
                  const double* __restrict__ Gs,
                  const TL* __restrict__ WW, const TL* __restrict__ Wy,
                  const TL* __restrict__ Wg, const TL* __restrict__ gg,
                  const TL* __restrict__ gy, const TL* __restrict__ AW,
                  const TL* __restrict__ Ag, const TL* __restrict__ Ay,
                  const TL* __restrict__ AtA,
                  const int64_t* __restrict__ kslot,
                  const double* __restrict__ v0s,
                  const double* __restrict__ v1s,
                  const int64_t* __restrict__ slot, double* __restrict__ Qout,
                  double* __restrict__ Wout, int nrho, int R, int C, int p,
                  int S, int genes, int nslots, int gb) {
  extern __shared__ __align__(16) unsigned char score_dyn[];
  __shared__ int s_count, s_next;
  const int p1 = p + 1;
  const int m = C + p1 + 1;
  const int xo = C;       // first X column of [A | X | y]
  const int yo = C + p1;  // the y column
  const int ldz = ld_z(m), sw = stage_words(m, gb);
  double* ring = reinterpret_cast<double*>(score_dyn);
  double* gram = ring;                      // after the stream
  double* om = ring + ring_words(m, gb);    // [gb][RC]: each gene's omega
  double* vv = om + gb * RC;                // [gb][2]: v0, v1
  double* ws = vv + 2 * gb + (threadIdx.x / 32) * epi_words(C, p);
  int* glist = reinterpret_cast<int*>(vv + 2 * gb +
                                      (gb < NW ? gb : NW) * epi_words(C, p));
  int* gslot = glist + gb;  // [GWIN]: the window's genes' slots at s

  const int s = blockIdx.x;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane >> 2, tq = lane & 3;
  const int nT = n_tiles(m);
  const int ps = p + S;
  const int chunks = (R + RC - 1) / RC;
  for (int w0 = 0; w0 < genes; w0 += GWIN) {
    const int wn = min(GWIN, genes - w0);
    for (int e = tid; e < wn; e += NT)
      gslot[e] = (int)slot[(int64_t)(w0 + e) * S + s];
    __syncthreads();
    for (int j = 0; j < nslots; ++j) {
      const int64_t k = kslot[(int64_t)j * S + s];
      if (k < 0) continue;  // no gene's slot at s is j
      int cursor = 0;
      for (;;) {
        // the next pass: up to gb of the window's genes whose slot at s is j
        if (warp == 0) {
          int c = 0;
          if (lane == 0) s_next = wn;
          __syncwarp();
          for (int e0 = cursor; e0 < wn && c < gb; e0 += 32) {
            const int e = e0 + lane;
            const bool on = e < wn && gslot[e] == j;
            const unsigned mask = __ballot_sync(0xffffffffu, on);
            const int pos = c + __popc(mask & ((1u << lane) - 1u));
            if (on && pos < gb) glist[pos] = w0 + e;
            if (on && pos == gb - 1) s_next = e + 1;
            c += __popc(mask);
          }
          __syncwarp();
          if (lane == 0) s_count = c < gb ? c : gb;
        }
        __syncthreads();
        const int gc = s_count;
        cursor = s_next;
        __syncthreads();  // every thread has read them before warp 0's next
        if (gc == 0) break;  // scan (after a break, the next slot's) writes
        for (int e = tid; e < gc; e += NT) {
          const int64_t i = (int64_t)glist[e] * S + s;
          vv[2 * e] = v0s[i];
          vv[2 * e + 1] = v1s[i];
        }
        const TL* Sk = Sv + k * R;
        const TL* Wk = WGt + k * (int64_t)R * ps;
        const TL* Ak = At + ((int64_t)j * S + s) * R * C;
        const double* Gk = Gs + ((int64_t)j * S + s) * R;

        // this warp's jobs (pass gene gi, tile ti, tj) and its share of the
        // rows: 8-row steps q with q % rgn == rg
        const int jobs = gc * nT;
        const int rgn = jobs >= NW ? 1 : NW / jobs;
        int jn = 0, rg = 0;
        int jg[MAXJ], jti[MAXJ], jtj[MAXJ];
        // a fragment's sources: column offsets and strides in a stage
        int ao0[MAXJ], as0[MAXJ], ao1[MAXJ], as1[MAXJ], bo[MAXJ], bs[MAXJ];
        auto source = [&](int col, int gi, int& off, int& str) {
          if (col < m - 1) {
            off = col;
            str = ldz;
          } else if (col == m - 1) {
            off = RC * ldz + gi * RC;
            str = 1;
          } else {  // padding: any staged column (its entries are not stored)
            off = 0;
            str = ldz;
          }
        };
    #pragma unroll
        for (int t = 0; t < MAXJ; ++t) {
          int job = -1;
          if (rgn == 1) {
            job = warp + t * NW;
            if (job >= jobs) job = -1;
          } else if (t == 0 && warp < jobs * rgn) {
            job = warp % jobs;
            rg = warp / jobs;
          }
          if (job >= 0) ++jn;
          const int jj = job < 0 ? 0 : job;
          jg[t] = jj / nT;
          tile_of(jj - jg[t] * nT, m, jti[t], jtj[t]);
          source(16 * jti[t] + gq, jg[t], ao0[t], as0[t]);
          source(16 * jti[t] + gq + 8, jg[t], ao1[t], as1[t]);
          source(8 * jtj[t] + gq, jg[t], bo[t], bs[t]);
        }
        double acc[MAXJ][4];
    #pragma unroll
        for (int t = 0; t < MAXJ; ++t)
    #pragma unroll
          for (int i = 0; i < 4; ++i) acc[t][i] = 0.0;

        auto load = [&](int b, int chunk) {
          double* st = ring + b * sw;
          const int r0 = chunk * RC, rows = min(RC, R - r0);
          const int zc = m - 1;  // [A | W | g]
          for (int e = tid; e < RC * zc; e += NT) {
            const int rr = e / zc, c = e - rr * zc;
            double* d = st + rr * ldz + c;
            if (rr < rows) {
              const int64_t r = r0 + rr;
              if constexpr (sizeof(TL) == 8) {
                cp_async8(d, c < C       ? Ak + r * C + c
                             : c < C + p ? Wk + r * ps + (c - C)
                                         : Gk + r);
              } else if (c < C) {
                stage_value(d, Ak + r * C + c);
              } else if (c < C + p) {
                stage_value(d, Wk + r * ps + (c - C));
              } else {
                cp_async8(d, Gk + r);
              }
            } else {
              *d = 0.0;
            }
          }
          double* yc = st + RC * ldz;
          for (int e = tid; e < gc * RC; e += NT) {
            const int gi = e / RC, rr = e - gi * RC;
            if (rr < rows)
              stage_value(yc + e,
                          yt + ((int64_t)glist[gi] * nrho + k) * R + r0 + rr);
            else
              yc[e] = 0.0;
          }
          double* sc = yc + gb * RC;
          for (int rr = tid; rr < RC; rr += NT) {
            if (rr < rows)
              stage_value(sc + rr, Sk + r0 + rr);
            else
              sc[rr] = 0.0;
          }
        };

    #pragma unroll
        for (int c = 0; c < NSTAGE - 1; ++c) {
          if (c < chunks) load(c, c);
          cp_async_commit();
        }
        for (int c = 0; c < chunks; ++c) {
          cp_async_wait<NSTAGE - 2>();
          __syncthreads();  // chunk c landed; every warp is done with c - 1
          const int next = c + NSTAGE - 1;
          if (next < chunks) load(next % NSTAGE, next);
          cp_async_commit();
          const double* st = ring + (c % NSTAGE) * sw;
          const double* sc = st + RC * ldz + gb * RC;
          for (int e = tid; e < gc * RC; e += NT) {
            const int gi = e / RC, rr = e - gi * RC;
            const double sb = sc[rr], v0 = vv[2 * gi];
            om[e] = (v0 * sb) / (vv[2 * gi + 1] + v0 * sb);
          }
          __syncthreads();
    #pragma unroll
          for (int kk = 0; kk < RC / 8; ++kk) {
            if ((c * (RC / 8) + kk) % rgn != rg) continue;
            const int ra = 8 * kk + tq, rb = ra + 4;
    #pragma unroll
            for (int t = 0; t < MAXJ; ++t) {
              if (t >= jn) continue;
              const double w0 = om[jg[t] * RC + ra], w1 = om[jg[t] * RC + rb];
              double a[4], b[2];
              a[0] = st[ao0[t] + ra * as0[t]] * w0;  // A[g][t]
              a[1] = st[ao1[t] + ra * as1[t]] * w0;  // A[g + 8][t]
              a[2] = st[ao0[t] + rb * as0[t]] * w1;  // A[g][t + 4]
              a[3] = st[ao1[t] + rb * as1[t]] * w1;  // A[g + 8][t + 4]
              b[0] = st[bo[t] + ra * bs[t]];         // B[t][g]
              b[1] = st[bo[t] + rb * bs[t]];         // B[t + 4][g]
              dmma_m16n8k8(acc[t], a, b);
            }
          }
        }
        cp_async_wait<0>();

        // the Grams, full symmetric, at gram[gi][i * m + j]: the row groups'
        // partial tiles summed one group after another
        for (int rd = 0; rd < rgn; ++rd) {
          __syncthreads();  // the ring is free; the previous group is stored
          if (rg != rd) continue;
    #pragma unroll
          for (int t = 0; t < MAXJ; ++t) {
            if (t >= jn) continue;
            double* G = gram + jg[t] * m * m;
    #pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int row = 16 * jti[t] + gq + 8 * (i >> 1);
              const int col = 8 * jtj[t] + 2 * tq + (i & 1);
              if (row >= m || col > row) continue;
              double v = acc[t][i];
              if (rd > 0) v += G[row * m + col];
              G[row * m + col] = v;
              G[col * m + row] = v;
            }
          }
        }
        __syncthreads();

        // the algebra, a warp a gene
        for (int gi = warp; gi < gc; gi += NW) {
          const int g = glist[gi];
          const int64_t gs_ = (int64_t)g * S + s;
          double* Gm = gram + gi * m * m;
          double* sA = ws;              // [p1][p1]: XKX, then its factor
          double* sB = sA + p1 * p1;    // [p1][C + 1]: [XKy | AKX^T], solved
          double* sAKX = sB + p1 * (C + 1);  // [C][p1]
          double* sAPy = sAKX + C * p1;      // [C]
          const int nb = C + 1;
          const double v1 = vv[2 * gi + 1];
          const TL* Wyg = Wy + (int64_t)g * p;
          const TL* Ayg = Ay + (int64_t)g * C * S;
          // K0^{-1} forms: (full-space Gram - weighted eigenbasis Gram) / v1
          for (int idx = lane; idx < p1 * p1; idx += 32) {
            const int i = idx / p1, jj = idx - i * p1;
            double xx;
            if (i < p && jj < p) xx = WW[i * p + jj];
            else if (i < p) xx = Wg[(int64_t)i * S + s];
            else if (jj < p) xx = Wg[(int64_t)jj * S + s];
            else xx = gg[s];
            sA[i * p1 + jj] = (xx - Gm[(xo + i) * m + xo + jj]) / v1;
          }
          for (int i = lane; i < p1; i += 32) {
            const double xy = i < p ? Wyg[i] : gy[gs_];
            sB[i * nb] = (xy - Gm[(xo + i) * m + yo]) / v1;
          }
          for (int idx = lane; idx < C * p1; idx += 32) {
            const int c = idx / p1, i = idx - c * p1;
            const double ax = i < p ? AW[((int64_t)c * p + i) * S + s]
                                    : Ag[(int64_t)c * S + s];
            const double v = (ax - Gm[c * m + xo + i]) / v1;
            sAKX[c * p1 + i] = v;
            sB[i * nb + 1 + c] = v;
          }
          for (int c = lane; c < C; c += 32)
            sAPy[c] = (Ayg[(int64_t)c * S + s] - Gm[c * m + yo]) / v1;
          __syncwarp();

          // ridge + Cholesky of the (p+1)^2 system, lower factor in place:
          // lane 0 the diagonal, the lanes the column below it
          double dmax = 0.0;
          for (int i = 0; i < p1; ++i) dmax = fmax(dmax, fabs(sA[i * p1 + i]));
          const double ridge = 1e-12 * fmax(dmax, 1.0);
          __syncwarp();
          for (int i = lane; i < p1; i += 32) sA[i * p1 + i] += ridge;
          __syncwarp();
          for (int jj = 0; jj < p1; ++jj) {
            if (lane == 0) {
              double d = sA[jj * p1 + jj];
              for (int l = 0; l < jj; ++l)
                d -= sA[jj * p1 + l] * sA[jj * p1 + l];
              sA[jj * p1 + jj] = sqrt(d);
            }
            __syncwarp();
            const double d = sA[jj * p1 + jj];
            for (int i = jj + 1 + lane; i < p1; i += 32) {
              double v = sA[i * p1 + jj];
              for (int l = 0; l < jj; ++l)
                v -= sA[i * p1 + l] * sA[jj * p1 + l];
              sA[i * p1 + jj] = v / d;
            }
            __syncwarp();
          }

          // B = A^{-1} [XKy | AKX^T], one right-hand side a lane
          for (int t = lane; t < 1 + C; t += 32) {
            for (int i = 0; i < p1; ++i) {
              double v = sB[i * nb + t];
              for (int l = 0; l < i; ++l) v -= sA[i * p1 + l] * sB[l * nb + t];
              sB[i * nb + t] = v / sA[i * p1 + i];
            }
            for (int i = p1 - 1; i >= 0; --i) {
              double v = sB[i * nb + t];
              for (int l = i + 1; l < p1; ++l)
                v -= sA[l * p1 + i] * sB[l * nb + t];
              sB[i * nb + t] = v / sA[i * p1 + i];
            }
          }
          __syncwarp();

          // APA in place of the Gram's A block (each entry read and written by
          // one lane), APy in place of AKy
          for (int idx = lane; idx < C * C; idx += 32) {
            const int c = idx / C, d = idx - c * C;
            double v = (AtA[((int64_t)c * C + d) * S + s] - Gm[c * m + d]) / v1;
            for (int i = 0; i < p1; ++i)
              v -= sAKX[c * p1 + i] * sB[i * nb + 1 + d];
            Gm[c * m + d] = v;
          }
          for (int c = lane; c < C; c += 32) {
            double v = sAPy[c];
            for (int i = 0; i < p1; ++i) v -= sAKX[c * p1 + i] * sB[i * nb];
            sAPy[c] = v;
          }
          __syncwarp();
          double* Wo = Wout + gs_ * C * C;
          for (int idx = lane; idx < C * C; idx += 32) {
            const int c = idx / C, d = idx - c * C;
            Wo[idx] = 0.25 * (Gm[c * m + d] + Gm[d * m + c]);
          }
          if (lane == 0) {
            double q = 0.0;
            for (int c = 0; c < C; ++c) q += sAPy[c] * sAPy[c];
            Qout[gs_] = 0.5 * q;
          }
          __syncwarp();
        }
        __syncthreads();  // the pass's genes are done with glist and the Grams
      }
    }
    __syncthreads();  // every pass is done with the window's slots
  }
}

}  // namespace

// Genes of one pass of a score_core_kernel block, and its shared memory
inline int pass_genes(int C, int p, int genes, int maxj) {
  const int m = C + p + 2;
  int gb = NW * maxj / n_tiles(m);
  gb = gb < GBMAX ? gb : GBMAX;
  gb = gb < genes ? gb : genes;
  gb = gb > 1 ? gb : 1;
  while (gb > 1 && smem_bytes(C, p, gb) > SMEM_MAX) --gb;
  return gb;
}

// Shared by the genes: Sv (nrho, R), WGt (nrho, R, p+S), WW (p, p), Wg
// (p, S), gg (S,), AW (C, p, S), Ag (C, S), AtA (C, C, S), At (nslots, S,
// R, C) K4's slots.  Per gene: yt (genes, nrho, R), Wy (genes, p), gy
// (genes, S), Ay (genes, C, S), k_best (genes, S) int64, v0, v1 (genes,
// S), slot (genes, S) int64 in [0, nslots): K4's, so that the genes that
// share a slot at a variant share its best rho -> Q (genes, S), Wmat
// (genes, S, C, C).  work: nslots S (R + 1) doubles of scratch (the
// gathered genotype columns, then each (slot, variant)'s rho).  Row-major
// f64 on the card; C + p + 2 <= 98, p + 1 <= 33, genes and nslots <= 65535
// (a single phenotype is genes = 1).  Launches on `stream`; returns the
// first launch's CUDA error, 0 if none.
template <class TL>
int run(const TL* Sv, const TL* WGt, const TL* yt, const TL* At,
        const TL* WW, const TL* Wy, const TL* Wg, const TL* gg, const TL* gy,
        const TL* AW, const TL* Ag, const TL* Ay, const TL* AtA,
        const int64_t* k_best, const double* v0, const double* v1,
        const int64_t* slot, double* Q, double* Wmat, double* work, int nrho,
        int R, int C, int p, int S, int genes, int nslots,
        cudaStream_t stream) {
  double* Gs = work;
  int64_t* kslot = reinterpret_cast<int64_t*>(work + (int64_t)nslots * S * R);
  auto ks = score_kslot_kernel;
  ks<<<(unsigned)((S + 127) / 128), 128, 0, stream>>>(k_best, slot, kslot, S,
                                                      genes, nslots);
  int err = (int)cudaGetLastError();
  if (err) return err;
  const dim3 ggrid((unsigned)((S + 31) / 32), (unsigned)((R + 31) / 32),
                   (unsigned)nslots);
  auto gather = score_gather_kernel<TL>;
  gather<<<ggrid, 256, 0, stream>>>(WGt, kslot, Gs, R, p, S);
  if ((err = (int)cudaGetLastError())) return err;
  // the narrow instantiation where a gene's tiles fit 4 a warp
  const bool wide = n_tiles(C + p + 2) > NW * MAXJ_NARROW;
  auto kernel = wide ? score_core_kernel<MAXJ_WIDE, TL>
                     : score_core_kernel<MAXJ_NARROW, TL>;
  const int gb = pass_genes(C, p, genes, wide ? MAXJ_WIDE : MAXJ_NARROW);
  const int smem = smem_bytes(C, p, gb);
  err = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err) return err;
  kernel<<<(unsigned)S, NT, smem, stream>>>(Sv, WGt, yt, At, Gs, WW, Wy, Wg,
                                            gg, gy, AW, Ag, Ay, AtA, kslot,
                                            v0, v1, slot, Q, Wmat, nrho, R, C,
                                            p, S, genes, nslots, gb);
  return (int)cudaGetLastError();
}

extern "C" int crm_score_core(const double* Sv, const double* WGt,
                              const double* yt, const double* At,
                              const double* WW, const double* Wy,
                              const double* Wg, const double* gg,
                              const double* gy, const double* AW,
                              const double* Ag, const double* Ay,
                              const double* AtA, const int64_t* k_best,
                              const double* v0, const double* v1,
                              const int64_t* slot, double* Q, double* Wmat,
                              double* work, int nrho, int R, int C, int p,
                              int S, int genes, int nslots,
                              cudaStream_t stream) {
  return run<double>(Sv, WGt, yt, At, WW, Wy, Wg, gg, gy, AW, Ag, Ay, AtA,
                     k_best, v0, v1, slot, Q, Wmat, work, nrho, R, C, p, S,
                     genes, nslots, stream);
}

// The float32 context: the operands of crm_score_core in f32 (v0, v1 and
// the results f64, the scratch as there), each widened to f64 as it is
// loaded.
extern "C" int crm_score_core_f32(const float* Sv, const float* WGt,
                                  const float* yt, const float* At,
                                  const float* WW, const float* Wy,
                                  const float* Wg, const float* gg,
                                  const float* gy, const float* AW,
                                  const float* Ag, const float* Ay,
                                  const float* AtA, const int64_t* k_best,
                                  const double* v0, const double* v1,
                                  const int64_t* slot, double* Q,
                                  double* Wmat, double* work, int nrho,
                                  int R, int C, int p, int S, int genes,
                                  int nslots, cudaStream_t stream) {
  return run<float>(Sv, WGt, yt, At, WW, Wy, Wg, gg, gy, AW, Ag, Ay, AtA,
                    k_best, v0, v1, slot, Q, Wmat, work, nrho, R, C, p, S,
                    genes, nslots, stream);
}
