// Arithmetic shared by the biharmonic kernels (K1, K14/K19, K15-K18): one
// element's 16x16 operator applied to the 16 GLL values of one column,
// exact ("highest") or as bf16x3, in the one order their plain versions
// (operator.apply_operator) are held to.
//
// bf16x3 splits the operator and the column into bf16 hi/lo parts and sums
// the three f32 accumulations as (hi.v_hi + hi.v_lo) + lo.v_hi; each
// bf16 x bf16 product is exact in f32.  The operator sits in shared memory
// as one plane (exact, or the hi part) with the lo plane `lo_off` values
// further on, read as warp-wide broadcasts.

#pragma once

#include <cuda_bf16.h>

namespace bih {

constexpr int NP = 4;
constexpr int NPTS = NP * NP;

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Rows FIRST, FIRST+STRIDE, ... (N of them) of op.v.
template <typename T, bool X3, int FIRST = 0, int STRIDE = 1, int N = NPTS>
__device__ __forceinline__ void op_rows(const T* __restrict__ op, int lo_off,
                                        const T v[NPTS], T o[N]) {
  if constexpr (X3) {
    float qh[NPTS], ql[NPTS];
#pragma unroll
    for (int p = 0; p < NPTS; ++p) {
      qh[p] = bf16_round(v[p]);
      ql[p] = bf16_round(v[p] - qh[p]);
    }
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const int r = FIRST + k * STRIDE;
      float hh = 0.f, hl = 0.f, lh = 0.f;
#pragma unroll
      for (int p = 0; p < NPTS; ++p) {
        hh = fmaf(op[r * NPTS + p], qh[p], hh);
        hl = fmaf(op[r * NPTS + p], ql[p], hl);
        lh = fmaf(op[lo_off + r * NPTS + p], qh[p], lh);
      }
      o[k] = (hh + hl) + lh;
    }
  } else {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const int r = FIRST + k * STRIDE;
      T acc = T(0);
#pragma unroll
      for (int p = 0; p < NPTS; ++p) acc = fma(op[r * NPTS + p], v[p], acc);
      o[k] = acc;
    }
  }
}

// v <- op.v
template <typename T, bool X3>
__device__ __forceinline__ void apply(const T* op, int lo_off, T v[NPTS]) {
  // keep the operator's shared loads at their use: without this fence the
  // compiler hoists all 256 (or 512) of them out of a step loop and spills
  asm volatile("" ::: "memory");
  T o[NPTS];
  op_rows<T, X3>(op, lo_off, v, o);
#pragma unroll
  for (int p = 0; p < NPTS; ++p) v[p] = o[p];
}

// Stage operator entry l at plane0[i]: as it is, or (X3) its bf16 hi part
// there and its lo part at plane0[lo_off + i].
template <typename T, bool X3>
__device__ __forceinline__ void stage(T* plane0, int lo_off, int i, T l) {
  if constexpr (X3) {
    const T hi = bf16_round(l);
    plane0[i] = hi;
    plane0[lo_off + i] = bf16_round(l - hi);
  } else {
    plane0[i] = l;
  }
}

}  // namespace bih
