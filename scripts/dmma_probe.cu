// Probe of the FP64 tensor-core products (mma.sync ... .f64) on the card:
// which shapes nvcc takes for sm_90a, whether their fragments follow the
// layout csrc/dmma.cuh assumes (a product of seeded 8- or 16-row operands
// against the host's), and their throughput (8 independent products a
// warp in a loop; 528 blocks of 4, 8 and 16 warps).  One shape a build:
//
//   for s in 0 1 2 3; do   # m8n8k4, m16n8k4, m16n8k8, m16n8k16
//     nvcc -gencode arch=compute_90a,code=sm_90a -O3 -DSHAPE=$s \
//          -o /tmp/dmma_probe_$s scripts/dmma_probe.cu && /tmp/dmma_probe_$s
//   done
#include <cstdio>
#include <cstdlib>
#include <cmath>
#include <cuda_runtime.h>
#ifndef SHAPE
#define SHAPE 0
#endif
// 0: m8n8k4  1: m16n8k4  2: m16n8k8  3: m16n8k16
#if SHAPE == 0
constexpr int MM = 8, NN = 8, KK = 4, NA = 1, NB = 1, NC = 2;
#elif SHAPE == 1
constexpr int MM = 16, NN = 8, KK = 4, NA = 2, NB = 1, NC = 4;
#elif SHAPE == 2
constexpr int MM = 16, NN = 8, KK = 8, NA = 4, NB = 2, NC = 4;
#else
constexpr int MM = 16, NN = 8, KK = 16, NA = 8, NB = 4, NC = 4;
#endif
__device__ __forceinline__ void mma(double (&d)[NC], const double (&a)[NA], const double (&b)[NB]) {
#if SHAPE == 0
  asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0,%1}, {%2}, {%3}, {%0,%1};\n"
      : "+d"(d[0]), "+d"(d[1]) : "d"(a[0]), "d"(b[0]));
#elif SHAPE == 1
  asm volatile("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3]) : "d"(a[0]), "d"(a[1]), "d"(b[0]));
#elif SHAPE == 2
  asm volatile("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3]) : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
#else
  asm volatile("mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5,%6,%7,%8,%9,%10,%11}, {%12,%13,%14,%15}, {%0,%1,%2,%3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3]) : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]), "d"(a[6]), "d"(a[7]), "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
#endif
}
// assumed layouts (g = lane >> 2, t = lane & 3)
__device__ int a_row(int i, int g) { return MM == 8 ? g : g + 8 * (i & 1); }
__device__ int a_col(int i, int t) { return MM == 8 ? t : t + 4 * (i >> 1); }
__device__ int b_k(int i, int t) { return t + 4 * i; }
__device__ int c_row(int i, int g) { return g + 8 * (i >> 1); }
__device__ int c_col(int i, int t) { return 2 * t + (i & 1); }
__global__ void layout_kernel(const double* A, const double* B, double* D) {
  const int lane = threadIdx.x, g = lane >> 2, t = lane & 3;
  double a[NA], b[NB], d[NC];
  for (int i = 0; i < NA; ++i) a[i] = A[a_row(i, g) * KK + a_col(i, t)];
  for (int i = 0; i < NB; ++i) b[i] = B[b_k(i, t) * NN + g];
  for (int i = 0; i < NC; ++i) d[i] = 0;
  mma(d, a, b);
  for (int i = 0; i < NC; ++i) D[c_row(i, g) * NN + c_col(i, t)] = d[i];
}
__global__ void tput_kernel(double* out, int iters) {
  double a[NA], b[NB], d[8][NC];
  for (int i = 0; i < NA; ++i) a[i] = threadIdx.x * 1e-3 + i;
  for (int i = 0; i < NB; ++i) b[i] = 1e-3 * i;
  for (int j = 0; j < 8; ++j) for (int i = 0; i < NC; ++i) d[j][i] = 0;
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int j = 0; j < 8; ++j) mma(d[j], a, b);
  double s = 0;
  for (int j = 0; j < 8; ++j) for (int i = 0; i < NC; ++i) s += d[j][i];
  if (s == 12345.678) out[0] = s;
}
int main() {
  double hA[MM * KK], hB[KK * NN], hD[MM * NN];
  srand(1);
  for (auto& v : hA) v = rand() / (double)RAND_MAX - 0.5;
  for (auto& v : hB) v = rand() / (double)RAND_MAX - 0.5;
  double *A, *B, *D;
  cudaMalloc(&A, sizeof hA); cudaMalloc(&B, sizeof hB); cudaMalloc(&D, sizeof hD);
  cudaMemcpy(A, hA, sizeof hA, cudaMemcpyHostToDevice);
  cudaMemcpy(B, hB, sizeof hB, cudaMemcpyHostToDevice);
  cudaMemset(D, 0xff, sizeof hD);
  layout_kernel<<<1, 32>>>(A, B, D);
  cudaMemcpy(hD, D, sizeof hD, cudaMemcpyDeviceToHost);
  double err = 0;
  for (int m = 0; m < MM; ++m) for (int n = 0; n < NN; ++n) {
    double r = 0; for (int k = 0; k < KK; ++k) r += hA[m * KK + k] * hB[k * NN + n];
    err = fmax(err, fabs(r - hD[m * NN + n]));
  }
  printf("shape m%dn%dk%d: layout max err %.3e (%s)\n", MM, NN, KK, err, err < 1e-12 ? "ok" : "WRONG");
  for (int warps : {4, 8, 16}) {
    const int iters = 4096, blocks = 132 * 4;
    cudaEvent_t e0, e1; cudaEventCreate(&e0); cudaEventCreate(&e1);
    tput_kernel<<<blocks, 32 * warps>>>(D, 16);
    cudaEventRecord(e0);
    tput_kernel<<<blocks, 32 * warps>>>(D, iters);
    cudaEventRecord(e1); cudaEventSynchronize(e1);
    float ms; cudaEventElapsedTime(&ms, e0, e1);
    double flops = 2.0 * MM * NN * KK * 8.0 * iters * blocks * warps;
    printf("  %d warps/block x %d blocks: %.3f ms, %.2f TFLOP/s\n", warps, blocks, ms, flops / ms / 1e9);
  }
  printf("cuda error: %s\n", cudaGetErrorString(cudaGetLastError()));
  return 0;
}
