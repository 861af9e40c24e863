// Small device helpers shared by the kernels: asynchronous global ->
// shared copies (cp.async), four-wide shared-memory loads and stores, and
// branch-free f64 reciprocals and reciprocal square roots.
//
// On the card (__CUDA_ARCH__ defined) each helper is one PTX instruction
// or one vector access.  The portable body beside it is what a host
// compiler sees: a plain copy, so that the kernels' indexing can be run
// and tested without the card (a synchronous copy needs no commit or wait).
#pragma once
#include <cstring>

// 16 bytes from global to shared memory, both 16-byte aligned
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
#ifdef __CUDA_ARCH__
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
#else
  std::memcpy(smem, gmem, 16);
#endif
}

// 8 bytes from global to shared memory, both 8-byte aligned
__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
#ifdef __CUDA_ARCH__
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(gmem));
#else
  std::memcpy(smem, gmem, 8);
#endif
}

// 4 bytes from global to shared memory, both 4-byte aligned
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
#ifdef __CUDA_ARCH__
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
#else
  std::memcpy(smem, gmem, 4);
#endif
}

// close the group of copies issued since the last commit
__device__ __forceinline__ void cp_async_commit() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;\n" ::);
#endif
}

// wait until every committed group of this thread has landed (the block
// still needs a barrier before other threads read the data)
__device__ __forceinline__ void cp_async_wait_all() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_group 0;\n" ::);
#endif
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
#endif
}

// v[0..3] = p[0..3], p aligned to 4 elements
template <class T>
__device__ __forceinline__ void load4(const T* p, T (&v)[4]) {
#ifdef __CUDA_ARCH__
  if constexpr (sizeof(T) == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else {
    const double2 a = *reinterpret_cast<const double2*>(p);
    const double2 b = *reinterpret_cast<const double2*>(p + 2);
    v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
  }
#else
  for (int i = 0; i < 4; ++i) v[i] = p[i];
#endif
}

// p[0..3] = v[0..3], p aligned to 4 elements
template <class T>
__device__ __forceinline__ void store4(T* p, const T (&v)[4]) {
#ifdef __CUDA_ARCH__
  if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
    *reinterpret_cast<double2*>(p + 2) = make_double2(v[2], v[3]);
  }
#else
  for (int i = 0; i < 4; ++i) p[i] = v[i];
#endif
}

// 1 / x and 1 / sqrt(x) for a positive normal x with no branch: the
// hardware's f64 estimate, then two Newton steps (~1 ulp).  The library's
// division and square root check for special cases and branch to a slow
// path, which keeps neighbouring operations from overlapping with them.
__device__ __forceinline__ double rcp_nr(double x) {
#ifdef __CUDA_ARCH__
  double r;
  asm("rcp.approx.ftz.f64 %0, %1;" : "=d"(r) : "d"(x));
#else
  double r = (double)(1.0f / (float)x);
#endif
  r = fma(r, fma(-x, r, 1.0), r);
  return fma(r, fma(-x, r, 1.0), r);
}

__device__ __forceinline__ double rsqrt_nr(double x) {
#ifdef __CUDA_ARCH__
  double y;
  asm("rsqrt.approx.ftz.f64 %0, %1;" : "=d"(y) : "d"(x));
#else
  double y = (double)(1.0f / __builtin_sqrtf((float)x));
#endif
  const double h = 0.5 * x;
  y = y * fma(-h * y, y, 1.5);
  return y * fma(-h * y, y, 1.5);
}
