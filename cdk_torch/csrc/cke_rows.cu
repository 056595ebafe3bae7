// K3: the CKE edge flux by per-(edge, slot) row reads of the masked tracer
// table, accumulated in slot order.
//
// Replaces cdk_tpu/kernels/cke/pallas_rows.py::_kernel (variant pallas_rows),
// whose grid steps walk edge blocks with the table resident in VMEM and the
// connectivity in SMEM, reading one (1, K) row per (edge, slot).  Its 128-lane
// K padding and edge-block divisibility are not carried over: the kernel takes
// ragged nedges, ncells and nvert.
//
// Design: one warp per edge, lanes along the levels, so each slot's row read
// is one coalesced access of nvert contiguous values; a lane walks levels
// k = lane, lane+32, ...  Each lane sums its slots in order i = 0..nadv-1 with
// a product, then a sum (cke_common.cuh), the plain version's arithmetic, so
// the result is bitwise equal to it.
//
// Bound: the random row reads.  At the production shape the table is
// 28000 x 100 x 4 B = 11 MB and stays in the 50 MB L2; each edge reads nadv
// rows of it plus its own ntf, advMask and output rows from device memory.

#include "cke_common.cuh"

namespace {

constexpr int WARPS = 8;  // edges per block

template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
cke_rows_kernel(const int* __restrict__ cells, const T* __restrict__ c1,
                const T* __restrict__ c3, const T* __restrict__ t,
                const T* __restrict__ ntf, const T* __restrict__ advm,
                T* __restrict__ out, int nedges, int ncells, int nadv, int nvert,
                T coef3) {
  const long long e = static_cast<long long>(blockIdx.x) * WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (e >= nedges) return;
  const int* ce = cells + e * nadv;
  const T* c1e = c1 + e * nadv;
  const T* c3e = c3 + e * nadv;
  const size_t row = static_cast<size_t>(e) * nvert;
  for (int k = lane; k < nvert; k += 32) {
    T s1 = T(0), s3 = T(0);
    for (int i = 0; i < nadv; ++i) {
      const T g = t[static_cast<size_t>(cke::clamp_cell(ce[i], ncells)) * nvert + k];
      s1 = cke::add(s1, cke::mul(c1e[i], g));
      s3 = cke::add(s3, cke::mul(c3e[i], g));
    }
    out[row + k] = cke::finish(s1, s3, ntf[row + k], advm[row + k], coef3);
  }
}

template <typename T>
int launch(const void* cells, const void* c1, const void* c3, const void* t,
           const void* ntf, const void* advm, void* out, int nedges, int ncells,
           int nadv, int nvert, double coef3, void* stream) {
  const unsigned blocks = static_cast<unsigned>((nedges + WARPS - 1) / WARPS);
  cke_rows_kernel<T><<<blocks, WARPS * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(cells), static_cast<const T*>(c1),
      static_cast<const T*>(c3), static_cast<const T*>(t),
      static_cast<const T*>(ntf), static_cast<const T*>(advm),
      static_cast<T*>(out), nedges, ncells, nadv, nvert, static_cast<T>(coef3));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// cells (E,A) int32; c1, c3 (E,A); t = tracer*mask (C,K); ntf, advm and out
// (E,K); all contiguous on one device.  coef3 is a value of the working type.
// Returns cudaGetLastError() after the launch.
int cdk_cke_rows_f32(const void* cells, const void* c1, const void* c3, const void* t,
                     const void* ntf, const void* advm, void* out, int nedges,
                     int ncells, int nadv, int nvert, double coef3, void* stream) {
  return launch<float>(cells, c1, c3, t, ntf, advm, out, nedges, ncells, nadv, nvert,
                       coef3, stream);
}

int cdk_cke_rows_f64(const void* cells, const void* c1, const void* c3, const void* t,
                     const void* ntf, const void* advm, void* out, int nedges,
                     int ncells, int nadv, int nvert, double coef3, void* stream) {
  return launch<double>(cells, c1, c3, t, ntf, advm, out, nedges, ncells, nadv, nvert,
                        coef3, stream);
}

}  // extern "C"
