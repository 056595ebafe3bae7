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
// A step is 256 FMAs per column ("highest", f32 or f64) or 768 (bf16x3: three
// products of bf16-valued operands accumulated in f32, L_hi*q_hi + L_hi*q_lo +
// L_lo*q_hi, as the TPU kernel computes them).  L is read from shared memory as a
// warp-wide broadcast.
//
// Bound: once q is resident the kernel is bound by FMA issue (and the shared-
// memory operand reads that feed it); device memory matters only at the two ends
// of a run.  The tensor-core form (mma on bf16 hi/lo pairs) is the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int NPTS = 16;
constexpr int MAX_TILE = 128;

template <typename T>
__global__ void __launch_bounds__(MAX_TILE)
bd8_resident_kernel(const T* __restrict__ L, const T* __restrict__ q,
                    T* __restrict__ out, int ncol, int nsteps) {
  __shared__ __align__(16) T Ls[NPTS * NPTS];
  const size_t e = blockIdx.x;
  for (int i = threadIdx.x; i < NPTS * NPTS; i += blockDim.x)
    Ls[i] = L[e * NPTS * NPTS + i];
  __syncthreads();
  const int c = blockIdx.y * blockDim.x + threadIdx.x;
  if (c >= ncol) return;  // ragged last column tile

  const T* qe = q + e * NPTS * ncol + c;
  T v[NPTS];
#pragma unroll
  for (int p = 0; p < NPTS; ++p) v[p] = qe[(size_t)p * ncol];

  for (int s = 0; s < nsteps; ++s) {
    // re-read L each step: without this fence the compiler hoists all 256
    // shared loads out of the step loop and spills them from registers
    asm volatile("" ::: "memory");
    T w[NPTS];
#pragma unroll
    for (int o = 0; o < NPTS; ++o) {
      T acc = T(0);
#pragma unroll
      for (int p = 0; p < NPTS; ++p) acc = fma(Ls[o * NPTS + p], v[p], acc);
      w[o] = acc;
    }
#pragma unroll
    for (int o = 0; o < NPTS; ++o) v[o] = w[o];
  }

  T* oe = out + e * NPTS * ncol + c;
#pragma unroll
  for (int p = 0; p < NPTS; ++p) oe[(size_t)p * ncol] = v[p];
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__global__ void __launch_bounds__(MAX_TILE)
bd8_resident_x3_kernel(const float* __restrict__ L, const float* __restrict__ q,
                       float* __restrict__ out, int ncol, int nsteps) {
  __shared__ __align__(16) float Lhi[NPTS * NPTS];
  __shared__ __align__(16) float Llo[NPTS * NPTS];
  const size_t e = blockIdx.x;
  for (int i = threadIdx.x; i < NPTS * NPTS; i += blockDim.x) {
    const float l = L[e * NPTS * NPTS + i];
    const float hi = bf16_round(l);
    Lhi[i] = hi;
    Llo[i] = bf16_round(l - hi);
  }
  __syncthreads();
  const int c = blockIdx.y * blockDim.x + threadIdx.x;
  if (c >= ncol) return;

  const float* qe = q + e * NPTS * ncol + c;
  float v[NPTS];
#pragma unroll
  for (int p = 0; p < NPTS; ++p) v[p] = qe[(size_t)p * ncol];

  for (int s = 0; s < nsteps; ++s) {
    asm volatile("" ::: "memory");  // as above: keep L's loads in the step
    float qh[NPTS], ql[NPTS];
#pragma unroll
    for (int p = 0; p < NPTS; ++p) {
      qh[p] = bf16_round(v[p]);
      ql[p] = bf16_round(v[p] - qh[p]);
    }
#pragma unroll
    for (int o = 0; o < NPTS; ++o) {
      // each bf16 x bf16 product is exact in f32; the three sums are
      // accumulated separately and added as the TPU kernel adds its dots
      float hh = 0.f, hl = 0.f, lh = 0.f;
#pragma unroll
      for (int p = 0; p < NPTS; ++p) {
        hh = fmaf(Lhi[o * NPTS + p], qh[p], hh);
        hl = fmaf(Lhi[o * NPTS + p], ql[p], hl);
        lh = fmaf(Llo[o * NPTS + p], qh[p], lh);
      }
      v[o] = (hh + hl) + lh;
    }
  }

  float* oe = out + e * NPTS * ncol + c;
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

// L (nelemd,16,16), q/out (nelemd,16,ncol), all contiguous on one device.
// x3 selects the bf16x3 product.  Returns cudaGetLastError() after the launch.
int cdk_bd8_resident_f32(const void* L, const void* q, void* out, int nelemd,
                         int ncol, int nsteps, int x3, void* stream) {
  int threads;
  const dim3 grid = grid_of(nelemd, ncol, &threads);
  auto st = static_cast<cudaStream_t>(stream);
  if (x3)
    bd8_resident_x3_kernel<<<grid, threads, 0, st>>>(
        static_cast<const float*>(L), static_cast<const float*>(q),
        static_cast<float*>(out), ncol, nsteps);
  else
    bd8_resident_kernel<float><<<grid, threads, 0, st>>>(
        static_cast<const float*>(L), static_cast<const float*>(q),
        static_cast<float*>(out), ncol, nsteps);
  return static_cast<int>(cudaGetLastError());
}

int cdk_bd8_resident_f64(const void* L, const void* q, void* out, int nelemd,
                         int ncol, int nsteps, void* stream) {
  int threads;
  const dim3 grid = grid_of(nelemd, ncol, &threads);
  bd8_resident_kernel<double><<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(L), static_cast<const double*>(q),
      static_cast<double*>(out), ncol, nsteps);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
