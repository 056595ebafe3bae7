// Arithmetic shared by the CKE edge-flux kernels (K3, K11, K12, K13).
//
// The flux of edge e at level k is
//     s1 = sum_i c1[e,i] * T[cells[e,i], k],   s3 = sum_i c3[e,i] * T[cells[e,i], k]
//     flx = (ntf * advMask) * (s1 + (C * s3) * sgn),   sgn = +1 where ntf >= 0, else -1
// with T the masked tracer table and C = coef3rdOrder.  The plain versions
// compute every term as a product, then a sum, in slot order.  The helpers
// below round each operation on its own (__fmul_rn / __fadd_rn and their
// double forms), which nvcc never contracts into an FMA, so a kernel that
// follows the plain version's order gives its bits exactly.

#pragma once

#include <cuda_runtime.h>

namespace cke {

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float fma(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fma(double a, double b, double c) { return __fma_rn(a, b, c); }

// Fortran sign(1, x): +1 for x >= 0 (-0 included), -1 otherwise.
template <typename T>
__device__ __forceinline__ T sign1(T x) { return x >= T(0) ? T(1) : T(-1); }

// (ntfm) * (s1 + (C * s3) * sgn), ntfm = ntf * advMask already formed.
template <typename T>
__device__ __forceinline__ T finish_m(T s1, T s3, T ntfm, T sgn, T coef3) {
  return mul(ntfm, add(s1, mul(mul(coef3, s3), sgn)));
}

template <typename T>
__device__ __forceinline__ T finish(T s1, T s3, T ntf, T advm, T coef3) {
  return finish_m(s1, s3, mul(ntf, advm), sign1(ntf), coef3);
}

// A cell index outside [0, ncells) is clamped, as XLA's gather clamps, so a
// bad index never reads outside the table.  The wrappers document the range.
__device__ __forceinline__ int clamp_cell(int c, int ncells) {
  return min(max(c, 0), ncells - 1);
}

}  // namespace cke
