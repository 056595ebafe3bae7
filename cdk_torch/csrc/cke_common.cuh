// Arithmetic shared by the CKE edge-flux kernels (K3, K11, K12, K13), and
// the row gather K3 and K13 share.
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

#include <cstdint>

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

// ---- the row gather of K3 and K13 ---------------------------------------
//
// Both read the masked table cell-major, (C, K), one (edge, slot) row of
// levels at a time.  A thread owns one (edge, level group) pair: W levels,
// one 16-byte vector of T, so a row of nvert levels is ceil(nvert / W)
// groups on consecutive threads, and a block's threads run over the pairs of
// a tile of edges with no idle lane but the tile's last.  Where nvert is a
// multiple of W (and the rows 16-byte aligned) a group is one vector load;
// otherwise its levels are loaded one by one, those past nvert as zeros that
// no store uses.  An edge's clamped cells and its coefficients sit in shared
// memory, loaded once per tile; SLOTS row loads are issued before the
// in-order accumulation of any of them (volatile, so a load never runs
// ahead of the test that guards it).  Five in flight, not ten: ten took
// 84-86 registers a thread and ran K3 at 0.29 ms at production f32 where
// five (56) ran it at 0.19 in the same blocks (H100 80GB HBM3, 700 W;
// scripts/torch_cke_gather_variants.py): more resident warps cover the
// latency better than one thread's loads.  The table is read with an L2
// evict_last policy, so the once-touched streams (slot arrays, edge fields,
// output: read and written evict-first) do not push it out of L2.

template <typename T>
struct alignas(16) Pack {
  static constexpr int W = 16 / sizeof(T);
  T v[W];
};

// the slot rows a thread has in flight before it accumulates them
constexpr int SLOTS = 5;

__device__ __forceinline__ uint64_t keep_policy() {
  uint64_t pol;
  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(pol));
  return pol;
}

__device__ __forceinline__ Pack<float> ld_keep(const float* a, uint64_t pol) {
  Pack<float> p;
  asm volatile("ld.global.nc.L2::cache_hint.v4.f32 {%0, %1, %2, %3}, [%4], %5;"
      : "=f"(p.v[0]), "=f"(p.v[1]), "=f"(p.v[2]), "=f"(p.v[3])
      : "l"(a), "l"(pol));
  return p;
}

__device__ __forceinline__ Pack<double> ld_keep(const double* a, uint64_t pol) {
  Pack<double> p;
  asm volatile("ld.global.nc.L2::cache_hint.v2.f64 {%0, %1}, [%2], %3;"
      : "=d"(p.v[0]), "=d"(p.v[1])
      : "l"(a), "l"(pol));
  return p;
}

__device__ __forceinline__ float ld_keep1(const float* a, uint64_t pol) {
  float v;
  asm volatile("ld.global.nc.L2::cache_hint.f32 %0, [%1], %2;" : "=f"(v) : "l"(a), "l"(pol));
  return v;
}

__device__ __forceinline__ double ld_keep1(const double* a, uint64_t pol) {
  double v;
  asm volatile("ld.global.nc.L2::cache_hint.f64 %0, [%1], %2;" : "=d"(v) : "l"(a), "l"(pol));
  return v;
}

// 16-byte reads and writes of the once-touched edge fields, evict-first
__device__ __forceinline__ Pack<float> ld_stream(const float* a) {
  const float4 x = __ldcs(reinterpret_cast<const float4*>(a));
  return {{x.x, x.y, x.z, x.w}};
}

__device__ __forceinline__ Pack<double> ld_stream(const double* a) {
  const double2 x = __ldcs(reinterpret_cast<const double2*>(a));
  return {{x.x, x.y}};
}

__device__ __forceinline__ void st_stream(float* a, const Pack<float>& p) {
  __stcs(reinterpret_cast<float4*>(a), make_float4(p.v[0], p.v[1], p.v[2], p.v[3]));
}

__device__ __forceinline__ void st_stream(double* a, const Pack<double>& p) {
  __stcs(reinterpret_cast<double2*>(a), make_double2(p.v[0], p.v[1]));
}

// An edge's slot data in shared memory, edge-major: slot i of the tile's
// edge el at [el * nadv + i].
template <typename T>
struct Slots {
  T* c1;
  T* c3;
  int* cell;  // clamped

  // carved from `base`, for a tile of `tile` edges
  __device__ Slots(unsigned char* base, int tile, int nadv)
      : c1(reinterpret_cast<T*>(base)), c3(c1 + tile * nadv),
        cell(reinterpret_cast<int*>(c3 + tile * nadv)) {}

  static __host__ __device__ size_t bytes(int tile, int nadv) {
    return static_cast<size_t>(tile) * nadv * (2 * sizeof(T) + sizeof(int));
  }
};

// s1 and s3 of levels k0 .. k0+W-1 of one edge, from the table tab (C, K):
// slot order i = 0..nadv-1, a product, then a sum, from zero.  `cell`, `c1`
// and `c3` point at the edge's first slot.
template <typename T, bool VEC>
__device__ __forceinline__ void gather_levels(const T* __restrict__ tab, int nvert, int k0,
                                              const int* cell, const T* c1, const T* c3,
                                              int nadv, uint64_t pol, Pack<T>& s1,
                                              Pack<T>& s3) {
  constexpr int W = Pack<T>::W;
#pragma unroll
  for (int w = 0; w < W; ++w) s1.v[w] = s3.v[w] = T(0);
  for (int i0 = 0; i0 < nadv; i0 += SLOTS) {
    Pack<T> g[SLOTS];
#pragma unroll
    for (int j = 0; j < SLOTS; ++j) {
      if (i0 + j < nadv) {
        const T* row = tab + static_cast<size_t>(cell[i0 + j]) * nvert + k0;
        if (VEC) {
          g[j] = ld_keep(row, pol);
        } else {
#pragma unroll
          for (int w = 0; w < W; ++w) g[j].v[w] = k0 + w < nvert ? ld_keep1(row + w, pol) : T(0);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < SLOTS; ++j) {
      if (i0 + j < nadv) {
        const T a1 = c1[i0 + j], a3 = c3[i0 + j];
#pragma unroll
        for (int w = 0; w < W; ++w) {
          s1.v[w] = add(s1.v[w], mul(a1, g[j].v[w]));
          s3.v[w] = add(s3.v[w], mul(a3, g[j].v[w]));
        }
      }
    }
  }
}

// Whether p is 16-byte aligned (the vector path's loads and stores).
inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace cke
