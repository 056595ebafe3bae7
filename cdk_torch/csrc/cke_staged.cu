// K11: the CKE edge flux consumed from pre-gathered slot rows.
//
// Replaces cdk_tpu/kernels/cke/staged.py::_consumer (variant staged_consume):
// the per-slot gathers run outside the kernel (XLA there, index_select into
// slices of one (A, E, K) buffer here), and the kernel reads each staged row
// once, keeping both sums in registers.  The TPU kernel's edge blocks and
// their divisibility are not carried over: the kernel takes ragged shapes.
//
// Design: one thread per output point (e, k), consecutive threads on
// consecutive k, so each slot's read of the staged buffer and the ntf,
// advMask and output accesses are coalesced.  Slots are summed in order with
// a product, then a sum (cke_common.cuh): bitwise the plain version.
//
// Bound: device-memory bandwidth.  It reads A*E*K staged values plus two
// (E, K) fields and writes one: at the shipped shape (A=10, E*K=2.56 M,
// f32) about 133 MB per call.

#include "cke_common.cuh"

namespace {

constexpr int THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(THREADS)
cke_staged_kernel(const T* __restrict__ staged, const T* __restrict__ c1,
                  const T* __restrict__ c3, const T* __restrict__ ntf,
                  const T* __restrict__ advm, T* __restrict__ out, long long npts,
                  int nadv, int nvert, T coef3) {
  const long long idx = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (idx >= npts) return;
  const long long e = idx / nvert;
  T s1 = T(0), s3 = T(0);
  for (int i = 0; i < nadv; ++i) {
    const T g = staged[static_cast<size_t>(i) * npts + idx];
    s1 = cke::add(s1, cke::mul(c1[e * nadv + i], g));
    s3 = cke::add(s3, cke::mul(c3[e * nadv + i], g));
  }
  out[idx] = cke::finish(s1, s3, ntf[idx], advm[idx], coef3);
}

template <typename T>
int launch(const void* staged, const void* c1, const void* c3, const void* ntf,
           const void* advm, void* out, int nedges, int nadv, int nvert, double coef3,
           void* stream) {
  const long long npts = static_cast<long long>(nedges) * nvert;
  const unsigned blocks = static_cast<unsigned>((npts + THREADS - 1) / THREADS);
  cke_staged_kernel<T><<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(staged), static_cast<const T*>(c1),
      static_cast<const T*>(c3), static_cast<const T*>(ntf),
      static_cast<const T*>(advm), static_cast<T*>(out), npts, nadv, nvert,
      static_cast<T>(coef3));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// staged (A,E,K): slot i's gathered masked tracer rows; c1, c3 (E,A); ntf,
// advm and out (E,K); all contiguous on one device.  Returns
// cudaGetLastError() after the launch.
int cdk_cke_staged_f32(const void* staged, const void* c1, const void* c3,
                       const void* ntf, const void* advm, void* out, int nedges,
                       int nadv, int nvert, double coef3, void* stream) {
  return launch<float>(staged, c1, c3, ntf, advm, out, nedges, nadv, nvert, coef3,
                       stream);
}

int cdk_cke_staged_f64(const void* staged, const void* c1, const void* c3,
                       const void* ntf, const void* advm, void* out, int nedges,
                       int nadv, int nvert, double coef3, void* stream) {
  return launch<double>(staged, c1, c3, ntf, advm, out, nedges, nadv, nvert, coef3,
                        stream);
}

}  // extern "C"
