// Hopper's FP64 tensor cores: the warp-wide f64 products of
// mma.sync.aligned.*.row.col.f64.f64.f64.f64, D += A B.  nvcc takes m8n8k4
// and the m16n8k4/k8/k16 shapes for sm_90a; the kernels use m16n8k8,
// which reaches the card's FP64 tensor-core rate with four warps a block
// where m8n8k4 stops at half of it (scripts/dmma_probe.cu, PERF.md).
//
// Fragments, with g = lane >> 2 and t = lane & 3 (the PTX ISA's layout):
//   m8n8k4:  a     A[g][t]          b     B[t][g]
//            d[i]  D[g][2t + i]                          (i < 2)
//   m16n8k8: a[i]  A[g + 8 (i & 1)][t + 4 (i >> 1)]      (i < 4)
//            b[i]  B[t + 4 i][g]                         (i < 2)
//            d[i]  D[g + 8 (i >> 1)][2t + (i & 1)]       (i < 4)
//
// On the card (__CUDA_ARCH__ defined) each is one PTX instruction (nvcc's
// host pass sees an empty body).  The portable body beside it is what a
// host compiler sees (the tests' emulator, a coroutine a CUDA thread):
// every lane puts its own fragment registers in a per-warp exchange
// buffer, the warp meets at __syncwarp, and each lane reads the A rows and
// B columns that its d entries need by the same layout, so a kernel whose
// fragment indexing is wrong fails the emulated tests.  (The buffer takes the place of 32
// __shfl_sync calls a product, which the emulator cannot afford.)  Two
// buffers alternate: a lane writes one only after the whole warp has met
// once more, so every lane has finished reading it.
#pragma once

#ifndef __CUDACC__  // a host compiler, not nvcc's host pass
namespace dmma_portable {
constexpr int MAX_WARPS = 32;   // of a block
template <int NA, int NB>
struct Exchange {
  double a[2][MAX_WARPS][32][NA];
  double b[2][MAX_WARPS][32][NB];
};
template <int NA, int NB>
inline Exchange<NA, NB> exchange;
inline int phase[MAX_WARPS * 32];   // each lane's, by threadIdx.x

// lane's fragments into the warp's buffer; returns the buffer's half
template <int NA, int NB>
inline int deposit(const double* a, const double* b) {
  Exchange<NA, NB>& x = exchange<NA, NB>;
  const int h = phase[threadIdx.x];
  phase[threadIdx.x] ^= 1;
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int i = 0; i < NA; ++i) x.a[h][w][lane][i] = a[i];
  for (int i = 0; i < NB; ++i) x.b[h][w][lane][i] = b[i];
  __syncwarp();
  return h;
}
}  // namespace dmma_portable
#endif

// d[0..1] += A (8 x 4) B (4 x 8)
__device__ __forceinline__ void dmma_m8n8k4(double (&d)[2], double a,
                                            double b) {
#ifdef __CUDA_ARCH__
  asm volatile(
      "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0,%1}, {%2}, {%3}, "
      "{%0,%1};\n"
      : "+d"(d[0]), "+d"(d[1])
      : "d"(a), "d"(b));
#elif !defined(__CUDACC__)
  using namespace dmma_portable;
  const int h = deposit<1, 1>(&a, &b);
  const Exchange<1, 1>& x = exchange<1, 1>;
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  for (int i = 0; i < 2; ++i) {
    const int col = 2 * t + i;
    double v = d[i];
    for (int k = 0; k < 4; ++k)  // A[g][k] at lane 4g + k, B[k][col] at 4col + k
      v += x.a[h][w][4 * g + k][0] * x.b[h][w][4 * col + k][0];
    d[i] = v;
  }
#endif
}

// d[0..3] += A (16 x 8) B (8 x 8)
__device__ __forceinline__ void dmma_m16n8k8(double (&d)[4],
                                             const double (&a)[4],
                                             const double (&b)[2]) {
#ifdef __CUDA_ARCH__
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
#elif !defined(__CUDACC__)
  using namespace dmma_portable;
  const int h = deposit<4, 2>(a, b);
  const Exchange<4, 2>& x = exchange<4, 2>;
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  for (int i = 0; i < 4; ++i) {
    const int row = g + 8 * (i >> 1), col = 2 * t + (i & 1);
    double v = d[i];
    for (int k = 0; k < 8; ++k) {
      // A[row][k]: lane 4 (row & 7) + (k & 3), register (row >> 3) + 2 (k >> 2)
      // B[k][col]: lane 4 col + (k & 3), register k >> 2
      v += x.a[h][w][4 * (row & 7) + (k & 3)][(row >> 3) + 2 * (k >> 2)] *
           x.b[h][w][4 * col + (k & 3)][k >> 2];
    }
    d[i] = v;
  }
#endif
}
