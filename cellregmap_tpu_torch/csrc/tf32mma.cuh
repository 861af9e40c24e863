// Hopper's TF32 tensor cores, split three ways for f32 accuracy.
//
// mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32, D += A B with A and
// B in TF32 (an f32 with 10 mantissa bits) and f32 sums.  One TF32 pass
// keeps ~3 decimal digits; the split form keeps the product to about f32
// accuracy: x = hi + lo, hi = tf32(x), lo = tf32(x - hi) (x - hi is exact
// in f32), and
//
//   a b ~ a_hi b_hi + a_hi b_lo + a_lo b_hi,
//
// the dropped a_lo b_lo and the rounding of lo each below ~2^-22 |a b|.
// Three products on the 495 TFLOP/s TF32 rate cost less than one on the 67
// TFLOP/s FP32 pipes.
//
// Fragments, with g = lane >> 2 and t = lane & 3 (the PTX ISA's layout for
// .tf32 m16n8k8, the same as dmma.cuh's m16n8k8):
//   a[i]  A[g + 8 (i & 1)][t + 4 (i >> 1)]      (i < 4)
//   b[i]  B[t + 4 i][g]                         (i < 2)
//   d[i]  D[g + 8 (i >> 1)][2t + (i & 1)]       (i < 4)
//
// On the card (__CUDA_ARCH__ defined) the product is one PTX instruction.
// The portable body beside it is what a host compiler sees (the tests'
// emulator): the product through a per-warp exchange as in dmma.cuh, each
// lane reading the A rows and B columns its d entries need by the layout
// above, the operands' low 13 bits dropped (as the tensor core reads
// them), the eight products and the sum exact, rounded once to f32.  The
// rounding to TF32 is the same integer arithmetic on both.
#pragma once
#include <cstdint>
#include <cstring>

__device__ __forceinline__ uint32_t f32_bits(float x) {
#ifdef __CUDA_ARCH__
  return __float_as_uint(x);
#else
  uint32_t u;
  std::memcpy(&u, &x, 4);
  return u;
#endif
}

__device__ __forceinline__ float bits_f32(uint32_t u) {
#ifdef __CUDA_ARCH__
  return __uint_as_float(u);
#else
  float x;
  std::memcpy(&x, &u, 4);
  return x;
#endif
}

// x rounded to TF32 (10 mantissa bits, nearest, ties away from zero), as
// the bits of an f32 whose low 13 bits are zero: half an ulp added to the
// magnitude's bits, then cut (a carry into the exponent rounds up).  The
// same integer arithmetic on the card and in the emulator; on the card it
// equals cvt.rna.tf32.f32 for every finite x below the largest TF32 value
// plus half an ulp (scripts/tf32_probe.cu, 2^24 patterns), where this
// rounds to inf.  Inf stays inf; a NaN stays a NaN, or becomes inf when
// its payload lies in the low 13 bits alone (its pair's lo, x - inf, is
// then NaN, so a product with it is still NaN).
__device__ __forceinline__ uint32_t tf32_bits(float x) {
  return (f32_bits(x) + 0x1000u) & 0xffffe000u;
}

// 1 / x for a positive normal f32: the hardware's estimate and one Newton
// step (within an ulp or so; the split-TF32 products it feeds hold each
// term to a few units of f32 rounding anyway).  The emulator divides.
__device__ __forceinline__ float rcp_f32(float x) {
#ifdef __CUDA_ARCH__
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return fmaf(r, fmaf(-x, r, 1.0f), r);
#else
  return 1.0f / x;
#endif
}

// x as hi + lo, each a TF32 value: hi = tf32(x), lo = tf32(x - hi)
__device__ __forceinline__ void tf32_split(float x, float& hi, float& lo) {
  hi = bits_f32(tf32_bits(x));
  lo = bits_f32(tf32_bits(x - hi));
}

// (a, b) = p[0..1], p 8-byte aligned (a split value's (hi, lo) pair)
__device__ __forceinline__ void load_pair(const float* p, float& a,
                                          float& b) {
#ifdef __CUDA_ARCH__
  const float2 v = *reinterpret_cast<const float2*>(p);
  a = v.x;
  b = v.y;
#else
  a = p[0];
  b = p[1];
#endif
}

// p[0] = a and, where `both`, p[1] = b: one 8-byte store where `paired`
// (p then 8-byte aligned)
__device__ __forceinline__ void store_pair(float* p, float a, float b,
                                           bool both, bool paired) {
#ifdef __CUDA_ARCH__
  if (both && paired) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
    return;
  }
#endif
  p[0] = a;
  if (both) p[1] = b;
}

#ifndef __CUDACC__  // a host compiler, not nvcc's host pass
namespace tf32_portable {
constexpr int MAX_WARPS = 32;   // of a block
struct Exchange {
  float a[2][MAX_WARPS][32][4];
  float b[2][MAX_WARPS][32][2];
};
inline Exchange exchange;
inline int phase[MAX_WARPS * 32];   // each lane's, by threadIdx.x
inline double operand(float x) {    // the tensor core's TF32 reading of x
  uint32_t u;
  std::memcpy(&u, &x, 4);
  u &= 0xffffe000u;
  std::memcpy(&x, &u, 4);
  return (double)x;
}
}  // namespace tf32_portable
#endif

// d[0..3] += A (16 x 8) B (8 x 8), A and B TF32 values held as f32
__device__ __forceinline__ void tf32_m16n8k8(float (&d)[4],
                                             const float (&a)[4],
                                             const float (&b)[2]) {
#ifdef __CUDA_ARCH__
  // not volatile: no side effect, so the compiler may interleave the
  // products of independent tiles (in order, a product that waits on the
  // one before it would stall the warp for the tensor pipe's latency)
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(__float_as_uint(a[0])), "r"(__float_as_uint(a[1])),
        "r"(__float_as_uint(a[2])), "r"(__float_as_uint(a[3])),
        "r"(__float_as_uint(b[0])), "r"(__float_as_uint(b[1])));
#elif !defined(__CUDACC__)
  using namespace tf32_portable;
  Exchange& x = exchange;
  const int h = phase[threadIdx.x];
  phase[threadIdx.x] ^= 1;
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int i = 0; i < 4; ++i) x.a[h][w][lane][i] = a[i];
  for (int i = 0; i < 2; ++i) x.b[h][w][lane][i] = b[i];
  __syncwarp();
  const int g = lane >> 2, t = lane & 3;
  for (int i = 0; i < 4; ++i) {
    const int row = g + 8 * (i >> 1), col = 2 * t + (i & 1);
    double v = d[i];
    for (int k = 0; k < 8; ++k) {
      // A[row][k]: lane 4 (row & 7) + (k & 3), register (row >> 3) + 2 (k >> 2)
      // B[k][col]: lane 4 col + (k & 3), register k >> 2
      v += operand(x.a[h][w][4 * (row & 7) + (k & 3)][(row >> 3) + 2 * (k >> 2)]) *
           operand(x.b[h][w][4 * col + (k & 3)][k >> 2]);
    }
    d[i] = (float)v;
  }
#endif
}

// d = A (16 x 8) B (8 x 8): the product on zero sums (the C operands a
// zero the compiler keeps once, no per-tile zeroing)
__device__ __forceinline__ void tf32_m16n8k8_zero(float (&d)[4],
                                                  const float (&a)[4],
                                                  const float (&b)[2]) {
#ifdef __CUDA_ARCH__
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%10,%11,%12,%13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(__float_as_uint(a[0])), "r"(__float_as_uint(a[1])),
        "r"(__float_as_uint(a[2])), "r"(__float_as_uint(a[3])),
        "r"(__float_as_uint(b[0])), "r"(__float_as_uint(b[1])), "f"(0.0f),
        "f"(0.0f), "f"(0.0f), "f"(0.0f));
#else
  for (int i = 0; i < 4; ++i) d[i] = 0.0f;
  tf32_m16n8k8(d, a, b);
#endif
}

// part[m][n] (+)= A_m B_n in split TF32 over an MT x NT block of m16n8k8
// tiles (A_m's fragments ah, al; B_n's bh, bl): each pass over every tile
// before the next, so that no product waits on the one before it, the two
// small products first, then hi hi.  `fresh`: the partials start from
// zero.  The caller adds the partials of a few steps to its f32 sums with
// IEEE adds (tf32_flush): the tensor core's own sums round toward zero,
// and a long chain of them on one accumulator drifts (scripts/tf32_probe.cu
// measures it).
template <int MT, int NT>
__device__ __forceinline__ void tf32x3_tiles(float (&part)[MT][NT][4],
                                             const float (&ah)[MT][4],
                                             const float (&al)[MT][4],
                                             const float (&bh)[NT][2],
                                             const float (&bl)[NT][2],
                                             bool fresh) {
  if (fresh) {
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int n = 0; n < NT; ++n) tf32_m16n8k8_zero(part[m][n], al[m], bh[n]);
  } else {
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int n = 0; n < NT; ++n) tf32_m16n8k8(part[m][n], al[m], bh[n]);
  }
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n) tf32_m16n8k8(part[m][n], ah[m], bl[n]);
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n) tf32_m16n8k8(part[m][n], ah[m], bh[n]);
}

// acc += part, an IEEE f32 add an entry
template <int MT, int NT>
__device__ __forceinline__ void tf32_flush(float (&acc)[MT][NT][4],
                                           const float (&part)[MT][NT][4]) {
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][n][i] += part[m][n][i];
}
