// K12: the CKE edge flux as a one-hot connectivity product, the one-hot
// weights built on chip per (edge tile, cell block).
//
// Replaces cdk_tpu/kernels/cke/pallas_onehot.py::_kernel (variants
// pallas_onehot and pallas_onehot_bf16).  The TPU kernel walks a grid of
// (edge block, cell block), builds W1 and W3 of shape (EB, CB) by nadv
// compare-and-select passes over the block, multiplies [W1; W3] by the
// (CB, K) block of the masked tracer on the MXU and carries the sum in VMEM
// scratch from one cell block to the next.  Here one block owns an edge tile
// for all cell blocks (the loop inside the block replaces the sequential grid
// axis), and the weights are built by a scatter: each edge's owner thread adds
// its nadv coefficients, in slot order, into the tile's rows, which gives the
// same weights as the compare passes, duplicates included, at O(E*A) instead
// of O(E*C*A) work.  Ragged nedges, ncells and nvert are masked, not padded
// by the caller.
//
// Design: a block of 32 x 8 threads owns EB = 64 edges and KT = 32 levels.
// Per cell block of CB = 32 cells it stages the masked tracer block (CB, KT)
// and the weights W1, W3 (EB, CB) in shared memory; each thread then keeps
// 8 edges x 2 sums for its level in registers and accumulates
// acc += W[e, c] * T[c, k] over the block's cells in cell order, as FMAs.
// The sums run in cell order, not slot order, so the result is held to the
// family gate, not bitwise.  The bf16 form rounds W and T to bf16 and
// accumulates in f32 (a bf16 x bf16 product is exact in f32): the TPU's
// default-precision MXU pass.
//
// Bound: the dense product, 2 * E * C * K multiply-adds (28.7 G at the shipped
// 25600 x 2800 x 100), issued from shared memory: one broadcast load of W per
// two FMAs.  Almost all of the weights are zero; this kernel computes the
// one-hot product as the TPU did, not the gather (K3 is the gather).

#include <cuda_bf16.h>

#include "cke_common.cuh"

namespace {

constexpr int EB = 64;   // edges per block
constexpr int KT = 32;   // levels per block (threadIdx.x)
constexpr int TY = 8;    // threadIdx.y
constexpr int EPT = EB / TY;  // edges per thread
constexpr int CB = 32;   // cells per shared-memory block

template <typename T>
__device__ __forceinline__ T to_bf16(T v) {
  return static_cast<T>(__bfloat162float(__float2bfloat16_rn(static_cast<float>(v))));
}

template <typename T, bool BF16>
__global__ void __launch_bounds__(KT * TY)
cke_onehot_kernel(const int* __restrict__ cells, const T* __restrict__ c1,
                  const T* __restrict__ c3, const T* __restrict__ t,
                  const T* __restrict__ ntf, const T* __restrict__ advm,
                  T* __restrict__ out, int nedges, int ncells, int nadv, int nvert,
                  T coef3) {
  __shared__ T ts[CB][KT];
  __shared__ T w1[EB][CB];
  __shared__ T w3[EB][CB];
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * KT + tx;
  const long long e0 = static_cast<long long>(blockIdx.x) * EB;
  const int k0 = blockIdx.y * KT;
  T acc1[EPT], acc3[EPT];
#pragma unroll
  for (int j = 0; j < EPT; ++j) acc1[j] = acc3[j] = T(0);

  for (int base = 0; base < ncells; base += CB) {
    // the masked tracer block; cells and levels past the table are zero
    for (int i = tid; i < CB * KT; i += KT * TY) {
      const int c = base + i / KT, k = k0 + i % KT;
      T v = (c < ncells && k < nvert) ? t[static_cast<size_t>(c) * nvert + k] : T(0);
      if constexpr (BF16) v = to_bf16(v);
      ts[i / KT][i % KT] = v;
    }
    for (int i = tid; i < EB * CB; i += KT * TY) {
      w1[i / CB][i % CB] = T(0);
      w3[i / CB][i % CB] = T(0);
    }
    __syncthreads();
    // one-hot weights: edge tid's slots that fall in this cell block, in order
    if (tid < EB && e0 + tid < nedges) {
      const long long e = e0 + tid;
      for (int i = 0; i < nadv; ++i) {
        const int c = cells[e * nadv + i] - base;
        if (c >= 0 && c < CB) {
          w1[tid][c] = cke::add(w1[tid][c], c1[e * nadv + i]);
          w3[tid][c] = cke::add(w3[tid][c], c3[e * nadv + i]);
        }
      }
      if constexpr (BF16) {
        // round the finished weights; only the slots' entries can be off
        // the bf16 grid (zeros are on it, and rounding twice is rounding once)
        for (int i = 0; i < nadv; ++i) {
          const int c = cells[e * nadv + i] - base;
          if (c >= 0 && c < CB) {
            w1[tid][c] = to_bf16(w1[tid][c]);
            w3[tid][c] = to_bf16(w3[tid][c]);
          }
        }
      }
    }
    __syncthreads();
    for (int c = 0; c < CB; ++c) {
      const T tv = ts[c][tx];
#pragma unroll
      for (int j = 0; j < EPT; ++j) {
        acc1[j] = cke::fma(w1[ty + TY * j][c], tv, acc1[j]);
        acc3[j] = cke::fma(w3[ty + TY * j][c], tv, acc3[j]);
      }
    }
    __syncthreads();
  }

  const int k = k0 + tx;
  if (k >= nvert) return;
#pragma unroll
  for (int j = 0; j < EPT; ++j) {
    const long long e = e0 + ty + TY * j;
    if (e < nedges) {
      const size_t o = static_cast<size_t>(e) * nvert + k;
      out[o] = cke::finish(acc1[j], acc3[j], ntf[o], advm[o], coef3);
    }
  }
}

template <typename T, bool BF16>
int launch(const void* cells, const void* c1, const void* c3, const void* t,
           const void* ntf, const void* advm, void* out, int nedges, int ncells,
           int nadv, int nvert, double coef3, void* stream) {
  const dim3 grid((nedges + EB - 1) / EB, (nvert + KT - 1) / KT);
  cke_onehot_kernel<T, BF16><<<grid, dim3(KT, TY), 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(cells), static_cast<const T*>(c1),
      static_cast<const T*>(c3), static_cast<const T*>(t),
      static_cast<const T*>(ntf), static_cast<const T*>(advm),
      static_cast<T*>(out), nedges, ncells, nadv, nvert, static_cast<T>(coef3));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// cells (E,A) int32 in [0, C); c1, c3 (E,A); t = tracer*mask (C,K); ntf, advm
// and out (E,K); all contiguous on one device.  bf16 != 0 rounds the weights
// and the table to bf16 (f32 only).  Returns cudaGetLastError() after the
// launch.
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
