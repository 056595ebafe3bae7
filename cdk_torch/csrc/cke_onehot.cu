// K12: the CKE edge flux as the one-hot connectivity product, computed over
// the cells each edge names and nothing else.
//
// Replaces cdk_tpu/kernels/cke/pallas_onehot.py::_kernel (variants
// pallas_onehot and pallas_onehot_bf16).  The TPU kernel walks a grid of
// (edge block, cell block), builds the one-hot weights W1 and W3 of shape
// (EB, CB) by nadv compare-and-select passes, multiplies [W1; W3] by the
// (CB, K) block of the masked tracer T on the MXU and carries the sum in VMEM
// from one cell block to the next:
//     S1[e, k] = sum_c W1[e, c] * T[c, k],   W1[e, c] = the sum, in slot order,
//                                             of the c1 of edge e's slots naming c
// (S3 and W3 the same with c3), then flx = (ntf * advMask) * (S1 + coef3 * S3 * sgn).
//
// Bound on this card: the bytes.  ntf, advMask and the output, E * K values
// each, move once through device memory (10.4 us at the shipped 25600 x 2800
// x 100 f32); T (C * K) is read once per slot from L2, E * A * K values (102 MB
// shipped).  Of the dense product's 2 * E * C * K multiply-adds only E * A * K
// have a nonzero weight: the earlier form of this kernel ran all of them, one
// shared-memory broadcast of W per two FMAs, and took 2 ms where one
// torch.matmul of the prebuilt [A1; A3] takes less.
//
// Design: one warp per edge, the levels across the lanes (k = lane + 32 j, KPL
// levels a lane per pass), so each read of a T row is coalesced, as in K3.  The
// warp first merges its edge's A slots into their distinct cells, in per-warp
// shared memory: a slot owns its cell if no earlier slot names it, the owner
// adds the c1 (c3) of every slot naming its cell in slot order starting from
// 0, and writes the cell and both weights at its rank among the distinct cells
// (ascending cell order).  Then every lane accumulates acc = fma(w, T[c, k],
// acc) over that list.  The dense product adds the same FMAs in the same
// ascending cell order, with fma(0, T[c, k], acc) = acc for every other cell,
// so the result equals it (up to the sign of a zero sum).  A cell index outside
// [0, ncells) names no column of the product and adds nothing.  The bf16 form
// rounds each merged weight and each T value to bf16 and accumulates in f32 (a
// bf16 x bf16 product is exact in f32): the TPU's default-precision MXU pass.
// One warp per edge keeps the merge within the warp (__syncwarp, no block
// barrier); a block holds eight edges.

#include <cuda_bf16.h>

#include "cke_common.cuh"

namespace {

constexpr int WARPS = 8;  // edges per block, one warp each
constexpr int KPL = 4;    // levels a lane accumulates per pass: 128 levels

template <typename T>
__device__ __forceinline__ T to_bf16(T v) {
  return static_cast<T>(__bfloat162float(__float2bfloat16_rn(static_cast<float>(v))));
}

// Shared memory one warp uses: the slots' weights and the merged list's (4 T
// arrays), then the slots' cells, the list's cells and the owner flags.
template <typename T>
__host__ __device__ inline size_t warp_bytes(int nadv) {
  return (static_cast<size_t>(nadv) * (4 * sizeof(T) + 3 * sizeof(int)) + 15) / 16 * 16;
}

template <typename T, bool BF16>
__global__ void __launch_bounds__(WARPS * 32)
cke_onehot_kernel(const int* __restrict__ cells, const T* __restrict__ c1,
                  const T* __restrict__ c3, const T* __restrict__ t,
                  const T* __restrict__ ntf, const T* __restrict__ advm,
                  T* __restrict__ out, int nedges, int ncells, int nadv, int nvert,
                  T coef3) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long e = static_cast<long long>(blockIdx.x) * WARPS + warp;
  if (e >= nedges) return;
  unsigned char* base = smem_raw + warp * warp_bytes<T>(nadv);
  T* s1 = reinterpret_cast<T*>(base);  // slot weights
  T* s3 = s1 + nadv;
  T* m1 = s3 + nadv;                   // merged weights, by rank
  T* m3 = m1 + nadv;
  int* sc = reinterpret_cast<int*>(m3 + nadv);  // slot cells
  int* mc = sc + nadv;                          // merged cells, ascending
  int* own = mc + nadv;                         // 1 where a slot owns its cell

  const size_t es = static_cast<size_t>(e) * nadv;
  for (int i = lane; i < nadv; i += 32) {
    sc[i] = cells[es + i];
    s1[i] = c1[es + i];
    s3[i] = c3[es + i];
  }
  __syncwarp();
  for (int i = lane; i < nadv; i += 32) {
    const int c = sc[i];
    int first = c >= 0 && c < ncells;
    for (int j = 0; j < i && first; ++j) first = sc[j] != c;
    own[i] = first;
  }
  __syncwarp();
  int nd = 0;  // distinct cells
  for (int j = 0; j < nadv; ++j) nd += own[j];
  for (int i = lane; i < nadv; i += 32) {
    if (!own[i]) continue;
    const int c = sc[i];
    int rank = 0;
    T w1 = T(0), w3 = T(0);
    for (int j = 0; j < nadv; ++j) {
      const int cj = sc[j];
      rank += own[j] && cj < c;
      if (cj == c) {
        w1 = cke::add(w1, s1[j]);
        w3 = cke::add(w3, s3[j]);
      }
    }
    if constexpr (BF16) {
      w1 = to_bf16(w1);
      w3 = to_bf16(w3);
    }
    mc[rank] = c;
    m1[rank] = w1;
    m3[rank] = w3;
  }
  __syncwarp();

  for (int kb = 0; kb < nvert; kb += 32 * KPL) {
    T acc1[KPL], acc3[KPL];
#pragma unroll
    for (int j = 0; j < KPL; ++j) acc1[j] = acc3[j] = T(0);
    for (int r = 0; r < nd; ++r) {
      const T* row = t + static_cast<size_t>(mc[r]) * nvert + kb + lane;
      const T a = m1[r], b = m3[r];
#pragma unroll
      for (int j = 0; j < KPL; ++j) {
        if (kb + lane + 32 * j < nvert) {
          T v = __ldg(row + 32 * j);
          if constexpr (BF16) v = to_bf16(v);
          acc1[j] = cke::fma(a, v, acc1[j]);
          acc3[j] = cke::fma(b, v, acc3[j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < KPL; ++j) {
      const int k = kb + lane + 32 * j;
      if (k < nvert) {
        const size_t o = static_cast<size_t>(e) * nvert + k;
        out[o] = cke::finish(acc1[j], acc3[j], ntf[o], advm[o], coef3);
      }
    }
  }
}

template <typename T, bool BF16>
int launch(const void* cells, const void* c1, const void* c3, const void* t,
           const void* ntf, const void* advm, void* out, int nedges, int ncells,
           int nadv, int nvert, double coef3, void* stream) {
  const size_t bytes = WARPS * warp_bytes<T>(nadv);
  auto kernel = cke_onehot_kernel<T, BF16>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = static_cast<unsigned>((nedges + WARPS - 1) / WARPS);
  kernel<<<blocks, WARPS * 32, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(cells), static_cast<const T*>(c1),
      static_cast<const T*>(c3), static_cast<const T*>(t),
      static_cast<const T*>(ntf), static_cast<const T*>(advm),
      static_cast<T*>(out), nedges, ncells, nadv, nvert, static_cast<T>(coef3));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// cells (E,A) int32; c1, c3 (E,A); t = tracer*mask (C,K); ntf, advm and out
// (E,K); all contiguous on one device.  bf16 != 0 rounds the weights and the
// table to bf16 (f32 only).  Returns cudaGetLastError() after the launch.
int cdk_cke_onehot_f32(const void* cells, const void* c1, const void* c3, const void* t,
                       const void* ntf, const void* advm, void* out, int nedges,
                       int ncells, int nadv, int nvert, double coef3, int bf16,
                       void* stream) {
  return bf16 ? launch<float, true>(cells, c1, c3, t, ntf, advm, out, nedges, ncells,
                                    nadv, nvert, coef3, stream)
              : launch<float, false>(cells, c1, c3, t, ntf, advm, out, nedges, ncells,
                                     nadv, nvert, coef3, stream);
}

int cdk_cke_onehot_f64(const void* cells, const void* c1, const void* c3, const void* t,
                       const void* ntf, const void* advm, void* out, int nedges,
                       int ncells, int nadv, int nvert, double coef3, void* stream) {
  return launch<double, false>(cells, c1, c3, t, ntf, advm, out, nedges, ncells, nadv,
                               nvert, coef3, stream);
}

}  // extern "C"
