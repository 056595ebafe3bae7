// K1: n chained applications q <- L[e] q of each element's 16x16 weak-Laplacian
// operator, with the state resident on chip across all n steps.
//
// Replaces cdk_tpu/kernels/biharmonic/pallas_bd8.py::_resident_kernel (via
// apply_bd8_resident).  The TPU kernel groups eight elements into one (128,128)
// block-diagonal tile to fill its matrix unit; here each element's operator is
// used as it is.
//
// Design: one block per (element, tile of up to 128 columns).  The block stages
// L[e] (and, for bf16x3, its hi/lo bf16 split, made once per block) in shared
// memory; each thread owns one column of q and keeps its 16 values in registers
// for the whole run, so q is read once and written once per run whatever n is.
// The load takes either layout (the flag NATURAL, chosen by the wrapper from
// the input's shape): the lane layout (e, 16, ncol), a point's row of ncol
// columns at a time (a warp reads 128 contiguous bytes a point), or the
// state's own (e, q, k, i, j), where column c = q*nlev + k of element e is
// the 16 contiguous values at (e*ncol + c)*16, so a block's tile is one
// contiguous span (8 KB at f32).  The block copies that span into shared
// memory with cp.async in 16-byte pieces, consecutive threads consecutive
// pieces, while it stages L, a column a row at a padded stride
// (bih::col_stride), and each thread reads its column from there as 16-byte
// loads.  So the loops read the state where it lies and no copy turns it
// first.  (Each thread reading its 64 bytes straight from device memory,
// four 16-byte loads whose warp instructions each touch 16 lines, ran 3.8 %
// slower than the lane load at the benchmark cells' size on an H100; the
// staged copy 0.3 %.)  The output stays in the lane layout whatever the input:
// the caller's view (`from_lane_layout`) turns it back at no cost, and the
// other kernels that chain it (K5's steps) take that layout.
// A step is 256 FMAs per column ("highest", f32 or f64) or 768 (bf16x3: three
// products of bf16-valued operands accumulated in f32, L_hi*q_hi + L_hi*q_lo +
// L_lo*q_hi, as the TPU kernel computes them).  L is read from shared memory as a
// warp-wide broadcast.
//
// Bound: once q is resident the kernel is bound by FMA issue (and the shared-
// memory operand reads that feed it); device memory matters only at the two ends
// of a run.  The tensor-core form (mma on bf16 hi/lo pairs) is the next step.

#include <cuda_runtime.h>

#include "biharmonic_common.cuh"

namespace {

using bih::NPTS;
constexpr int MAX_TILE = 128;

template <typename T, bool X3, bool NATURAL>
__global__ void __launch_bounds__(MAX_TILE)
bd8_resident_kernel(const T* __restrict__ L, const T* __restrict__ q,
                    T* __restrict__ out, int ncol, int nsteps) {
  constexpr int LO = NPTS * NPTS;
  constexpr int QS = bih::col_stride<T>();
  __shared__ __align__(16) T Ls[(X3 ? 2 : 1) * LO];
  __shared__ __align__(16) T Qs[NATURAL ? MAX_TILE * QS : 1];
  const size_t e = blockIdx.x;
  if constexpr (NATURAL) {
    // the tile's columns, one contiguous span, staged while L is
    const int c0 = blockIdx.y * blockDim.x;
    bih::stage_columns(Qs, QS, q + (e * ncol + c0) * NPTS, blockDim.x, ncol - c0,
                       threadIdx.x, blockDim.x);
    bih::cp_async_commit();
  }
  for (int i = threadIdx.x; i < LO; i += blockDim.x)
    bih::stage<T, X3>(Ls, LO, i, L[e * LO + i]);
  if constexpr (NATURAL) bih::cp_async_wait();
  __syncthreads();
  const int c = blockIdx.y * blockDim.x + threadIdx.x;
  if (c >= ncol) return;  // ragged last column tile

  T v[NPTS];
  if constexpr (NATURAL) {
    bih::load_column(Qs + threadIdx.x * QS, v);
  } else {
    const T* qe = q + e * NPTS * ncol + c;
#pragma unroll
    for (int p = 0; p < NPTS; ++p) v[p] = qe[(size_t)p * ncol];
  }

  // L is re-read from shared memory each step (bih::apply's fence)
  for (int s = 0; s < nsteps; ++s) bih::apply<T, X3>(Ls, LO, v);

  T* oe = out + e * NPTS * ncol + c;
#pragma unroll
  for (int p = 0; p < NPTS; ++p) oe[(size_t)p * ncol] = v[p];
}

dim3 grid_of(int nelemd, int ncol, int* threads) {
  // one warp-multiple column tile, at most MAX_TILE wide
  int t = ((ncol + 31) / 32) * 32;
  *threads = t < MAX_TILE ? t : MAX_TILE;
  return dim3(nelemd, (ncol + *threads - 1) / *threads);
}

}  // namespace

extern "C" {

// L (nelemd,16,16), out (nelemd,16,ncol), q (nelemd,16,ncol) or, with
// natural, the state's own (nelemd,q,k,4,4) with ncol = q*k, 16-byte aligned;
// all contiguous on one device.  x3 selects the bf16x3 product.  Returns
// cudaGetLastError() after the launch.
int cdk_bd8_resident_f32(const void* L, const void* q, void* out, int nelemd,
                         int ncol, int nsteps, int x3, int natural, void* stream) {
  int threads;
  const dim3 grid = grid_of(nelemd, ncol, &threads);
  auto kern = x3 ? (natural ? bd8_resident_kernel<float, true, true>
                            : bd8_resident_kernel<float, true, false>)
                 : (natural ? bd8_resident_kernel<float, false, true>
                            : bd8_resident_kernel<float, false, false>);
  kern<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(L), static_cast<const float*>(q),
      static_cast<float*>(out), ncol, nsteps);
  return static_cast<int>(cudaGetLastError());
}

int cdk_bd8_resident_f64(const void* L, const void* q, void* out, int nelemd,
                         int ncol, int nsteps, int natural, void* stream) {
  int threads;
  const dim3 grid = grid_of(nelemd, ncol, &threads);
  auto kern = natural ? bd8_resident_kernel<double, false, true>
                      : bd8_resident_kernel<double, false, false>;
  kern<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(L), static_cast<const double*>(q),
      static_cast<double*>(out), ncol, nsteps);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
