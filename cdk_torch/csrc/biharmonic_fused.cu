// K4: one weak Laplacian of every (element, column) as its stage chain —
// gradient (A1 = kron(Dvv^T, I), A2 = kron(I, Dvv^T)), the 2x2 metric and
// tensorVisc contractions, spheremp, weak divergence (B1 = kron(Dvv, I),
// B2 = kron(I, Dvv)) — with every intermediate in registers.
//
// Replaces cdk_tpu/kernels/biharmonic/pallas_fused.py::_kernel.  The TPU kernel
// runs the four stage products as 16x16 (or block-diagonal kron(I_B, A)) matrix-
// unit dots; here each row of a stage matrix has 4 nonzeros, so each output is
// 4 FMAs with Dvv itself.  The 12 skipped products are exact zeros, and the 4
// kept ones are summed in the order of the flattened input point (increasing i'
// for A1/B1, increasing j' for A2/B2), the order of a sequential 16-term dot.
// The elementwise stages use _rn intrinsics so nvcc does not contract a*b + c*d
// into an FMA: they round exactly as the plain version's separate tensor ops.
//
// "highest" (BF16 = false) is exact f32.  "default" (BF16 = true) rounds both
// operands of each stage product to bf16 and sums the exact products in f32: one
// bf16 pass, as the TPU's DEFAULT dot.
//
// Design: one block per (element, tile of up to 128 columns), one thread per
// column holding its 16 point values; the element's 9 x 16 fields and Dvv sit in
// shared memory and are read as warp-wide broadcasts.
//
// Bound: q is read once and written once, 2 * 4 B per point (498 MB at the
// production 5400 x 16 x 720); the chain is ~900 flops per element-column
// (~3.5 GFLOP at production), so device memory bounds it on this card.

#include <cuda_runtime.h>

#include "biharmonic_common.cuh"

namespace {

using bih::bf16_round;
using bih::NP;
using bih::NPTS;
constexpr int NFIELDS = 9;  // d00 d01 d10 d11 sp t00 t01 t10 t11, 16 points each
constexpr int MAX_TILE = 128;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }

template <bool BF16>
__global__ void __launch_bounds__(MAX_TILE)
biharmonic_fused_kernel(const float* __restrict__ dvv, const float* __restrict__ elem,
                        const float* __restrict__ q, float* __restrict__ out, int ncol,
                        float rr) {
  __shared__ float D[NPTS];  // D[i * NP + l] = Dvv(i, l)
  __shared__ float el[NFIELDS * NPTS];
  const size_t e = blockIdx.x;
  for (int i = threadIdx.x; i < NPTS; i += blockDim.x)
    D[i] = BF16 ? bf16_round(dvv[i]) : dvv[i];
  for (int i = threadIdx.x; i < NFIELDS * NPTS; i += blockDim.x)
    el[i] = elem[e * NFIELDS * NPTS + i];
  __syncthreads();
  const int c = blockIdx.y * blockDim.x + threadIdx.x;
  if (c >= ncol) return;  // ragged last column tile

  const float* qe = q + e * NPTS * ncol + c;
  float s[NPTS];
#pragma unroll
  for (int p = 0; p < NPTS; ++p) {
    s[p] = qe[(size_t)p * ncol];
    if (BF16) s[p] = bf16_round(s[p]);
  }

  // gradient: v1[i][j] = rr * sum_i' Dvv(i', i) s[i'][j]  (A1 row (i,j))
  //           v2[i][j] = rr * sum_j' Dvv(j', j) s[i][j']  (A2 row (i,j))
  float x[NPTS], y[NPTS];
#pragma unroll
  for (int i = 0; i < NP; ++i) {
#pragma unroll
    for (int j = 0; j < NP; ++j) {
      float a1 = 0.f, a2 = 0.f;
#pragma unroll
      for (int k = 0; k < NP; ++k) {
        a1 = fmaf(D[k * NP + i], s[k * NP + j], a1);
        a2 = fmaf(D[k * NP + j], s[i * NP + k], a2);
      }
      const int p = i * NP + j;
      const float v1 = mul(rr, a1), v2 = mul(rr, a2);
      const float d00 = el[0 * NPTS + p], d01 = el[1 * NPTS + p];
      const float d10 = el[2 * NPTS + p], d11 = el[3 * NPTS + p];
      const float sp = el[4 * NPTS + p];
      const float t00 = el[5 * NPTS + p], t01 = el[6 * NPTS + p];
      const float t10 = el[7 * NPTS + p], t11 = el[8 * NPTS + p];
      const float ds1 = add(mul(d00, v1), mul(d10, v2));
      const float ds2 = add(mul(d01, v1), mul(d11, v2));
      const float g1 = add(mul(ds1, t00), mul(ds2, t01));
      const float g2 = add(mul(ds1, t10), mul(ds2, t11));
      x[p] = mul(sp, add(mul(d00, g1), mul(d01, g2)));
      y[p] = mul(sp, add(mul(d10, g1), mul(d11, g2)));
      if (BF16) {
        x[p] = bf16_round(x[p]);
        y[p] = bf16_round(y[p]);
      }
    }
  }

  // weak divergence: out[m][n] = -rr * (sum_j Dvv(m, j) x[j][n]      (B1)
  //                                    + sum_j Dvv(n, j) y[m][j])    (B2)
  float* oe = out + e * NPTS * ncol + c;
  const float nrr = -rr;
#pragma unroll
  for (int m = 0; m < NP; ++m) {
#pragma unroll
    for (int n = 0; n < NP; ++n) {
      float b1 = 0.f, b2 = 0.f;
#pragma unroll
      for (int j = 0; j < NP; ++j) {
        b1 = fmaf(D[m * NP + j], x[j * NP + n], b1);
        b2 = fmaf(D[n * NP + j], y[m * NP + j], b2);
      }
      oe[(size_t)(m * NP + n) * ncol] = mul(nrr, add(b1, b2));
    }
  }
}

}  // namespace

extern "C" {

// dvv (4,4), elem (nelemd,9,16), q/out (nelemd,16,ncol), f32, contiguous on one
// device; bf16 selects the "default" (one bf16 pass) stage products.  Returns
// cudaGetLastError() after the launch.
int cdk_biharmonic_fused(const void* dvv, const void* elem, const void* q, void* out,
                         int nelemd, int ncol, float rrearth, int bf16, void* stream) {
  int t = ((ncol + 31) / 32) * 32;
  t = t < MAX_TILE ? t : MAX_TILE;
  const dim3 grid(nelemd, (ncol + t - 1) / t);
  auto st = static_cast<cudaStream_t>(stream);
  const auto* d = static_cast<const float*>(dvv);
  const auto* el = static_cast<const float*>(elem);
  const auto* qq = static_cast<const float*>(q);
  auto* o = static_cast<float*>(out);
  if (bf16)
    biharmonic_fused_kernel<true><<<grid, t, 0, st>>>(d, el, qq, o, ncol, rrearth);
  else
    biharmonic_fused_kernel<false><<<grid, t, 0, st>>>(d, el, qq, o, ncol, rrearth);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
