// K13: the CKE edge flux on a transposed, level-major tracer table.
//
// Replaces cdk_tpu/kernels/cke/pallas_lanegather.py::_kernel (variant
// pallas_lanegather).  The TPU kernel puts cells on lanes: the masked table
// is transposed to (levels, cells) in 128-cell lane groups, each (edge block,
// slot) picks its cells by an intra-vreg lane gather per group and a select
// tree over the groups, and the output comes out level-major (K, E).  The lane
// groups and the select tree exist only because Mosaic gathers within one
// vreg; they are not carried over.  What is kept is the layout: table (K, C),
// slot arrays (A, E), edge factors and output (K, E), transposed back by the
// caller.
//
// Design: one thread per (k, e), edges on consecutive threads.  A warp reads
// 32 random cells of one level row per slot, and its slot-array, edge-factor
// and output accesses are coalesced along e.  This is the access pattern K3
// turns around (K3 puts levels on lanes and reads whole rows).  Slots are
// summed in order with a product, then a sum (cke_common.cuh), with the edge
// factors ntf*advMask and sgn formed by the caller as in the TPU kernel:
// bitwise the plain version, and bitwise K3.
//
// Bound: the scattered reads, one 32 B sector per gathered value, from a
// table that stays in L2 (11 MB at the production 28000 x 100 f32).

#include "cke_common.cuh"

namespace {

constexpr int THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(THREADS)
cke_lanegather_kernel(const int* __restrict__ cells_t, const T* __restrict__ c1t,
                      const T* __restrict__ c3t, const T* __restrict__ tm_t,
                      const T* __restrict__ ntfm_t, const T* __restrict__ sgn_t,
                      T* __restrict__ out_t, int nedges, int ncells, int nadv,
                      T coef3) {
  const int e = blockIdx.x * THREADS + threadIdx.x;
  if (e >= nedges) return;
  const int k = blockIdx.y;
  const T* row = tm_t + static_cast<size_t>(k) * ncells;
  T s1 = T(0), s3 = T(0);
  for (int i = 0; i < nadv; ++i) {
    const size_t si = static_cast<size_t>(i) * nedges + e;
    const T g = row[cke::clamp_cell(cells_t[si], ncells)];
    s1 = cke::add(s1, cke::mul(c1t[si], g));
    s3 = cke::add(s3, cke::mul(c3t[si], g));
  }
  const size_t o = static_cast<size_t>(k) * nedges + e;
  out_t[o] = cke::finish_m(s1, s3, ntfm_t[o], sgn_t[o], coef3);
}

template <typename T>
int launch(const void* cells_t, const void* c1t, const void* c3t, const void* tm_t,
           const void* ntfm_t, const void* sgn_t, void* out_t, int nedges, int ncells,
           int nadv, int nvert, double coef3, void* stream) {
  const dim3 grid((nedges + THREADS - 1) / THREADS, nvert);
  cke_lanegather_kernel<T><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(cells_t), static_cast<const T*>(c1t),
      static_cast<const T*>(c3t), static_cast<const T*>(tm_t),
      static_cast<const T*>(ntfm_t), static_cast<const T*>(sgn_t),
      static_cast<T*>(out_t), nedges, ncells, nadv, static_cast<T>(coef3));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// cells_t (A,E) int32; c1t, c3t (A,E); tm_t = (tracer*mask)^T (K,C); ntfm_t =
// (ntf*advMask)^T, sgn_t and out_t (K,E); all contiguous on one device;
// nvert <= 65535 (the grid's y extent).  Returns cudaGetLastError() after the
// launch.
int cdk_cke_lanegather_f32(const void* cells_t, const void* c1t, const void* c3t,
                           const void* tm_t, const void* ntfm_t, const void* sgn_t,
                           void* out_t, int nedges, int ncells, int nadv, int nvert,
                           double coef3, void* stream) {
  return launch<float>(cells_t, c1t, c3t, tm_t, ntfm_t, sgn_t, out_t, nedges, ncells,
                       nadv, nvert, coef3, stream);
}

int cdk_cke_lanegather_f64(const void* cells_t, const void* c1t, const void* c3t,
                           const void* tm_t, const void* ntfm_t, const void* sgn_t,
                           void* out_t, int nedges, int ncells, int nadv, int nvert,
                           double coef3, void* stream) {
  return launch<double>(cells_t, c1t, c3t, tm_t, ntfm_t, sgn_t, out_t, nedges, ncells,
                        nadv, nvert, coef3, stream);
}

}  // extern "C"
