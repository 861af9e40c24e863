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
// engine.py:422-434), the weights and the small algebra run in T.
//
// Replaces: cellregmap_tpu/engine.py `interaction_batch` stage 1a
// (:460-532) and `association_refit_batch` stage 1 (:957-989), whose XLA
// programs materialize the (nrho, K, R) weights and the rotated products
// (nrho, R, S) x (p + 2) and reduce them with batched GEMMs.
//
// What bounds it on the H100: operations, barely.  At the headline
// (nrho = 11, K = 64, R = 1010, S = 512, p = 1) it reads Gt once (45 MB,
// 0.014 ms) and does 2 nrho K R S (p + 2) = 2.2 GFLOP of reductions
// (0.03 ms at the 67 TFLOP/s f32/f64 peak).
//
// Design: one 256-thread block per (tile of 32 variants, rho point, gene;
// the gene-batched scan runs every gene of a tile in one launch).  A
// lane owns one variant of the tile, a warp a set of grid points.  The
// block streams the rotated rows in chunks through shared memory: the
// per-variant products (g w_j, g^2, g y) formed from Gt on the fly
// (coalesced along s), the chunk's weights for the pass's grid points,
// and the snp-shared products (w_i w_j, w_j y, y^2).  Each thread
// accumulates its (variant, grid point) sums in registers; the shared
// sums of a grid point are accumulated once per block.  Then, in the
// epilogue, each thread solves its (p+1)^2 system and forms the lml, and
// warp 0 keeps a running argmax over the grid points in registers.  Only
// the brackets (S, nrho) are written: the weights, the products and the
// (S, nrho, K) lml grid never reach device memory.  Passes over the grid
// points re-read the tile's rows from L2.
//
// Per-gene rho (the gene-batched association refit, cellregmap_tpu/
// engine.py:1070-1098): each gene refits its variants at its own null's
// best rho only.  The rotated [W | G] then holds the tile's distinct best
// rho ("slots", nrho = m of them), and `slot[gene]` names the one each
// gene runs: the grid has one block row per gene instead of one per rho,
// so the work is genes x S at one rho, not x m.  The brackets keep their
// (genes, S, m) layout and only the gene's slot column is written, where
// the converge kernel reads it (k_best = slot).
#include <cuda_runtime.h>
#include <cfloat>
#include <cstdint>

namespace {

constexpr int NT = 256;  // threads per block
constexpr int ST = 32;   // variants per block: one per lane

template <class T> struct Lim;
template <> struct Lim<float> {
  static constexpr float eps = FLT_EPSILON, tiny = FLT_MIN;
};
template <> struct Lim<double> {
  static constexpr double eps = DBL_EPSILON, tiny = DBL_MIN;
};

// Loops over the small dimension run to the compile-time P1MAX and skip
// what lies outside [lo, hi): after unrolling, the accumulators and the
// (p+1)^2 algebra are indexed statically and can live in registers.
#define SMALL_FOR(i, lo, hi) \
  for (int i = 0; i < P1MAX; ++i) \
    if (i >= (lo) && i < (hi))

// compile-time shape of an instantiation for p + 1 <= P1MAX
template <class T, int P1MAX> struct Cfg {
  static constexpr int PMAX = P1MAX - 1;
  static constexpr int MAXM = P1MAX + 1;              // g w_j, g^2, g y
  static constexpr int NSH = PMAX * (PMAX + 1) / 2 + PMAX + 1;  // WW, Wy, yy
  static constexpr int KPT = P1MAX <= 4 ? 2 : 1;      // grid points a thread
  static constexpr int KP = (NT / ST) * KPT;          // grid points a pass
  static constexpr int RC = P1MAX <= 2 ? 32 : (P1MAX <= 4 ? 16 : 8);
  static constexpr int NISH = (KP * (NSH + 1) + NT - 1) / NT;
  static constexpr int RED = RC * MAXM * ST + KP * RC + RC * NSH;
  static constexpr int EPI = KP * (NSH + 1) + KP * ST;
  static constexpr int SMEM = RED > EPI ? RED : EPI;
};

// torch.linspace's value at index k (its two-sided formula)
__device__ double logit_at(double lo, double hi, int K, int k) {
  if (K == 1) return lo;
  const double step = (hi - lo) / (double)(K - 1);
  return k < K / 2 ? lo + step * (double)k
                   : hi - step * (double)(K - 1 - k);
}

__device__ double sigmoid(double x) { return 1.0 / (1.0 + exp(-x)); }

template <class T, int P1MAX, bool REML>
__global__ void __launch_bounds__(NT)
delta_grid_kernel(const double* __restrict__ Sv,
                  const double* __restrict__ WGt,
                  const double* __restrict__ yt,
                  const double* __restrict__ CWW,
                  const double* __restrict__ CWy,
                  const double* __restrict__ Cyy,
                  const double* __restrict__ CWg,
                  const double* __restrict__ Cgy,
                  const double* __restrict__ Cgg,
                  const double* __restrict__ ld_xx,
                  const int64_t* __restrict__ slot,
                  double* __restrict__ br_lo, double* __restrict__ br_hi,
                  double lo, double hi, int K, int n, int nrho, int R, int p,
                  int nS) {
  using C = Cfg<T, P1MAX>;
  __shared__ T smem[C::SMEM];
  // reduction phase
  T* prod = smem;                              // [RC][MAXM][ST]
  T* wts = prod + C::RC * C::MAXM * ST;        // [KP][RC]
  T* shc = wts + C::KP * C::RC;                // [RC][NSH]
  // epilogue phase (aliases the above)
  T* shsum = smem;                             // [KP][NSH + 1]
  T* lmlb = shsum + C::KP * (C::NSH + 1);      // [KP][ST]

  // the gene axis: the phenotype's operands and the brackets are offset by
  // gene, the genotype's are shared
  const int64_t gi = blockIdx.z;
  yt += gi * nrho * R;
  CWy += gi * p;
  Cyy += gi;
  Cgy += gi * nS;
  br_lo += gi * nS * nrho;
  br_hi += gi * nS * nrho;

  const int tid = threadIdx.x;
  const int lane = tid % ST;
  const int warp = tid / ST;
  // the rho point: the block row's, or the gene's own slot
  const int o = slot ? (int)slot[gi] : (int)blockIdx.y;
  const int s = blockIdx.x * ST + lane;
  const bool live = s < nS;
  const int p1 = p + 1;
  const int mp = p + 2;                        // per-variant columns
  const int ntri = p * (p + 1) / 2;
  const int nsh = ntri + p + 1;                // shared columns (+ logd)
  const int ps = p + nS;
  const double* So = Sv + (int64_t)o * R;
  const double* WGo = WGt + (int64_t)o * R * ps;
  const double* yo = yt + (int64_t)o * R;

  // running argmax over the grid (warp 0: one lane per variant)
  T best = -INFINITY;
  int kbest = 0;

  for (int k0 = 0; k0 < K; k0 += C::KP) {
    T acc[C::KPT][C::MAXM];
    T shr[C::NISH];
#pragma unroll
    for (int j = 0; j < C::KPT; ++j)
#pragma unroll
      for (int m = 0; m < C::MAXM; ++m) acc[j][m] = T(0);
#pragma unroll
    for (int t = 0; t < C::NISH; ++t) shr[t] = T(0);

    for (int r0 = 0; r0 < R; r0 += C::RC) {
      const int rows = min(C::RC, R - r0);
      // per-variant products of the chunk, f64 then rounded to T
      for (int idx = tid; idx < rows * ST; idx += NT) {
        const int rr = idx / ST, sl = idx - rr * ST;
        const int sv = blockIdx.x * ST + sl;
        const double* row = WGo + (int64_t)(r0 + rr) * ps;
        const double g = sv < nS ? row[p + sv] : 0.0;
        T* pr = prod + rr * C::MAXM * ST + sl;
        for (int j = 0; j < p; ++j) pr[j * ST] = (T)(g * row[j]);
        pr[p * ST] = (T)(g * g);
        pr[(p + 1) * ST] = (T)(g * yo[r0 + rr]);
      }
      // the pass's weights for the chunk's rows
      for (int idx = tid; idx < C::KP * C::RC; idx += NT) {
        const int kl = idx / C::RC, rr = idx - kl * C::RC;
        T w = T(0);
        if (k0 + kl < K && rr < rows) {
          const T dk = (T)sigmoid(logit_at(lo, hi, K, k0 + kl));
          const T d = (T(1) - dk) * (T)So[r0 + rr] + dk;
          w = T(1) / d;
        }
        wts[kl * C::RC + rr] = w;
      }
      // snp-shared products: W_i W_j (j <= i), W_j y, y^2
      for (int idx = tid; idx < rows * nsh; idx += NT) {
        const int rr = idx / nsh, c = idx - rr * nsh;
        const double* row = WGo + (int64_t)(r0 + rr) * ps;
        const double yv = yo[r0 + rr];
        double v;
        if (c < ntri) {
          int i = 0;
          while ((i + 1) * (i + 2) / 2 <= c) ++i;
          v = row[i] * row[c - i * (i + 1) / 2];
        } else if (c < ntri + p) {
          v = row[c - ntri] * yv;
        } else {
          v = yv * yv;
        }
        shc[rr * C::NSH + c] = (T)v;
      }
      __syncthreads();

#pragma unroll 4
      for (int rr = 0; rr < rows; ++rr) {
        const T* pr = prod + rr * C::MAXM * ST + lane;
#pragma unroll
        for (int j = 0; j < C::KPT; ++j) {
          const T w = wts[(warp + j * (NT / ST)) * C::RC + rr];
#pragma unroll
          for (int m = 0; m < C::MAXM; ++m)
            if (m < mp) acc[j][m] += w * pr[m * ST];
        }
      }
#pragma unroll
      for (int t = 0; t < C::NISH; ++t) {
        const int item = tid + t * NT;
        const int kl = item / (nsh + 1), c = item - kl * (nsh + 1);
        if (kl >= C::KP || k0 + kl >= K) continue;
        if (c < nsh) {
          for (int rr = 0; rr < rows; ++rr)
            shr[t] += wts[kl * C::RC + rr] * shc[rr * C::NSH + c];
        } else {  // log d, summed over the eigen rows
          const T dk = (T)sigmoid(logit_at(lo, hi, K, k0 + kl));
          for (int rr = 0; rr < rows; ++rr)
            shr[t] += log((T(1) - dk) * (T)So[r0 + rr] + dk);
        }
      }
      __syncthreads();
    }

    // shared sums of the pass's grid points, then each thread's epilogue
#pragma unroll
    for (int t = 0; t < C::NISH; ++t) {
      const int item = tid + t * NT;
      if (item < C::KP * (nsh + 1)) {
        const int kl = item / (nsh + 1), c = item - kl * (nsh + 1);
        shsum[kl * (C::NSH + 1) + c] = shr[t];
      }
    }
    __syncthreads();

#pragma unroll
    for (int j = 0; j < C::KPT; ++j) {
      const int kl = warp + j * (NT / ST);
      const int k = k0 + kl;
      T lml = -INFINITY;
      if (k < K && live) {
        const T dk = (T)sigmoid(logit_at(lo, hi, K, k));
        const T ic = T(1) / dk;
        const T* sh = shsum + kl * (C::NSH + 1);
        T A[P1MAX][P1MAX], b[P1MAX];
        // rows i < p: the shared W sums; row p: the variant's g sums
        // (acc[j] = [g w_0 .. g w_{p-1}, g^2, g y])
        SMALL_FOR(i, 0, p1) {
          SMALL_FOR(jj, 0, i + 1) {
            if (i < p)
              A[i][jj] = sh[i * (i + 1) / 2 + jj] + (T)CWW[i * p + jj] * ic;
            else if (jj < p)
              A[i][jj] = acc[j][jj] + (T)CWg[(int64_t)jj * nS + s] * ic;
            else
              A[i][jj] = acc[j][jj] + (T)Cgg[s] * ic;
          }
          b[i] = i < p ? sh[ntri + i] + (T)CWy[i] * ic
                       : acc[j][i + 1] + (T)Cgy[s] * ic;
        }
        const T q = sh[ntri + p] + (T)Cyy[0] * ic;
        const T logdet_d = sh[nsh] + (T)(n - R) * log(dk);

        // ridge Cholesky (ops/linalg.py unrolled_chol_factor), in place
        T dmax = A[0][0];
        SMALL_FOR(i, 1, p1) dmax = fmax(dmax, A[i][i]);
        const T ridge = (T)1e-12 * fmax(dmax, T(1));
        SMALL_FOR(i, 0, p1) {
          SMALL_FOR(jj, 0, i + 1) {
            T v = A[i][jj];
            if (i == jj) v += ridge;
            SMALL_FOR(l, 0, jj) v -= A[i][l] * A[jj][l];
            A[i][jj] = i == jj ? sqrt(v) : v / A[jj][jj];
          }
        }
        T z[P1MAX];
        SMALL_FOR(i, 0, p1) {
          T v = b[i];
          SMALL_FOR(l, 0, i) v -= A[i][l] * z[l];
          z[i] = v / A[i][i];
        }
        for (int i = P1MAX - 1; i >= 0; --i) {
          if (i >= p1) continue;
          T v = z[i];
          SMALL_FOR(l, i + 1, p1) v -= A[l][i] * z[l];
          z[i] = v / A[i][i];
        }
        T rss = q;
        SMALL_FOR(i, 0, p1) rss -= b[i] * z[i];
        const T two_pi = (T)6.283185307179586;
        bool collapsed;
        if (REML) {
          // engine.py:500: a relative noise floor
          collapsed = rss <= T(128) * Lim<T>::eps * q;
          rss = fmax(rss, Lim<T>::tiny);
          T logdet_a = T(0);
          SMALL_FOR(i, 0, p1) logdet_a += log(A[i][i]);
          logdet_a *= T(2);
          const T nu = (T)(n - p1);
          lml = T(-0.5) * (nu * log(two_pi * rss / nu) + logdet_d + logdet_a -
                           (T)ld_xx[s] + nu);
        } else {
          // engine.py:978: only an absolute floor
          collapsed = rss <= T(8) * Lim<T>::tiny;
          rss = fmax(rss, Lim<T>::tiny);
          const T nn = (T)n;
          lml = T(-0.5) * (nn * log(two_pi * rss / nn) + logdet_d + nn);
        }
        if (collapsed || !isfinite(lml)) lml = -INFINITY;
      }
      lmlb[kl * ST + lane] = lml;
    }
    __syncthreads();
    if (warp == 0) {
      for (int kl = 0; kl < C::KP && k0 + kl < K; ++kl) {
        const T v = lmlb[kl * ST + lane];
        if (v > best) {  // the first maximum wins, as argmax's
          best = v;
          kbest = k0 + kl;
        }
      }
    }
    __syncthreads();
  }

  if (warp == 0 && live) {
    // no finite grid point: the full bracket (engine.py:521-532)
    const bool bad = !(best > -INFINITY);
    br_lo[(int64_t)s * nrho + o] =
        bad ? lo : logit_at(lo, hi, K, max(kbest - 1, 0));
    br_hi[(int64_t)s * nrho + o] =
        bad ? hi : logit_at(lo, hi, K, min(kbest + 1, K - 1));
  }
}

template <class T, int P1MAX>
void launch_p(bool reml, dim3 grid, cudaStream_t stream, const double* Sv,
              const double* WGt, const double* yt, const double* CWW,
              const double* CWy, const double* Cyy, const double* CWg,
              const double* Cgy, const double* Cgg, const double* ld_xx,
              const int64_t* slot, double* br_lo, double* br_hi, double lo,
              double hi, int K, int n, int nrho, int R, int p, int nS) {
  auto kernel = reml ? delta_grid_kernel<T, P1MAX, true>
                     : delta_grid_kernel<T, P1MAX, false>;
  kernel<<<grid, NT, 0, stream>>>(Sv, WGt, yt, CWW, CWy, Cyy, CWg, Cgy, Cgg,
                                  ld_xx, slot, br_lo, br_hi, lo, hi, K, n,
                                  nrho, R, p, nS);
}

template <class T>
void launch_t(bool reml, dim3 grid, cudaStream_t stream, const double* Sv,
              const double* WGt, const double* yt, const double* CWW,
              const double* CWy, const double* Cyy, const double* CWg,
              const double* Cgy, const double* Cgg, const double* ld_xx,
              const int64_t* slot, double* br_lo, double* br_hi, double lo,
              double hi, int K, int n, int nrho, int R, int p, int nS) {
  if (p + 1 <= 2)
    launch_p<T, 2>(reml, grid, stream, Sv, WGt, yt, CWW, CWy, Cyy, CWg, Cgy,
                   Cgg, ld_xx, slot, br_lo, br_hi, lo, hi, K, n, nrho, R, p,
                   nS);
  else if (p + 1 <= 4)
    launch_p<T, 4>(reml, grid, stream, Sv, WGt, yt, CWW, CWy, Cyy, CWg, Cgy,
                   Cgg, ld_xx, slot, br_lo, br_hi, lo, hi, K, n, nrho, R, p,
                   nS);
  else
    launch_p<T, 16>(reml, grid, stream, Sv, WGt, yt, CWW, CWy, Cyy, CWg, Cgy,
                    Cgg, ld_xx, slot, br_lo, br_hi, lo, hi, K, n, nrho, R, p,
                   nS);
}

}  // namespace

// Sv (nrho, R), WGt (nrho, R, p + nS), yt (genes, nrho, R), CWW (p, p),
// CWy (genes, p), Cyy (genes,), CWg (p, nS), Cgy (genes, nS), Cgg (nS,),
// ld_xx (nS,) (REML only, else null) -> br_lo, br_hi (genes, nS, nrho).
// Row-major f64 on the card; the grid is K points of logit(delta) in
// [lo, hi]; fast32 selects the float working type; 1 <= p + 1 <= 16; one
// block row per gene (genes <= 65535; a single phenotype is genes = 1).
// slot (genes,) int64 in [0, nrho), or null: each gene's grid at its slot
// alone, writing only its (s, slot) brackets.  Launches on `stream`;
// returns cudaGetLastError().
extern "C" int crm_delta_grid(const double* Sv, const double* WGt,
                              const double* yt, const double* CWW,
                              const double* CWy, const double* Cyy,
                              const double* CWg, const double* Cgy,
                              const double* Cgg, const double* ld_xx,
                              const int64_t* slot, double* br_lo,
                              double* br_hi, double lo, double hi, int K,
                              int n, int nrho, int R, int p, int nS,
                              int genes, int fast32, int reml,
                              cudaStream_t stream) {
  const dim3 grid((nS + ST - 1) / ST, slot ? 1 : nrho, genes);
  if (fast32)
    launch_t<float>(reml != 0, grid, stream, Sv, WGt, yt, CWW, CWy, Cyy, CWg,
                    Cgy, Cgg, ld_xx, slot, br_lo, br_hi, lo, hi, K, n, nrho,
                    R, p, nS);
  else
    launch_t<double>(reml != 0, grid, stream, Sv, WGt, yt, CWW, CWy, Cyy, CWg,
                     Cgy, Cgg, ld_xx, slot, br_lo, br_hi, lo, hi, K, n, nrho,
                     R, p, nS);
  return (int)cudaGetLastError();
}
