// K3: the CKE edge flux by per-(edge, slot) row reads of the masked tracer
// table, accumulated in slot order.
//
// Replaces cdk_tpu/kernels/cke/pallas_rows.py::_kernel (variant pallas_rows),
// whose grid steps walk edge blocks with the table resident in VMEM and the
// connectivity in SMEM, reading one (1, K) row per (edge, slot).  Its 128-lane
// K padding and edge-block divisibility are not carried over: the kernel takes
// ragged nedges, ncells and nvert.
//
// Bound on this card: each input read once and the output written once,
// 349 MB at the production 256000 edges x 28000 cells x 100 levels x 10 slots
// in f32, 0.104 ms at 3.35 TB/s.  What a gather can approach is higher: the
// E * A rows of K values it reads from the table, 1.02 GB at production, come
// from L2 (the 11.2 MB table stays there), so L2's read rate sets the floor.
//
// Design (cke_common.cuh's gather): a block owns a tile of edges; its threads
// run over the tile's (edge, level group) pairs, W levels a 16-byte vector of
// T, so a row is one contiguous run of vector loads (at nvert = 100 in f32 a
// block of 128 threads covers five edges, 125 pairs).  The tile's cells
// (clamped) and coefficients are loaded once into shared memory, and a
// thread issues its edge's ntf and advMask vectors and five slot rows at a
// time before it accumulates them in slot order with a product, then a sum:
// bitwise the plain version.  The table is read with an L2 evict_last policy; the slot
// arrays, ntf, advMask and the output stream evict-first.  A ragged nvert
// (not a multiple of W) reads and writes its levels one by one.
//
// It also holds chip_smoke.py's probe of the card's L2 read rate, the rate
// the gathered rows are read at.

#include <algorithm>

#include "cke_common.cuh"

namespace {

constexpr int THREADS = 128;  // blocks of 64-256 threads measured; 128 fastest

template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS)
cke_rows_kernel(const int* __restrict__ cells, const T* __restrict__ c1,
                const T* __restrict__ c3, const T* __restrict__ t,
                const T* __restrict__ ntf, const T* __restrict__ advm,
                T* __restrict__ out, int nedges, int ncells, int nadv, int nvert,
                int tile, T coef3) {
  constexpr int W = cke::Pack<T>::W;
  extern __shared__ __align__(16) unsigned char smem[];
  const cke::Slots<T> slots(smem, tile, nadv);
  const long long e0 = static_cast<long long>(blockIdx.x) * tile;
  const int ne = static_cast<int>(min(static_cast<long long>(tile), nedges - e0));
  for (int q = threadIdx.x; q < ne * nadv; q += THREADS) {
    const size_t g = static_cast<size_t>(e0) * nadv + q;
    slots.cell[q] = cke::clamp_cell(__ldcs(cells + g), ncells);
    slots.c1[q] = __ldcs(c1 + g);
    slots.c3[q] = __ldcs(c3 + g);
  }
  __syncthreads();
  const int ngroups = (nvert + W - 1) / W;
  const uint64_t pol = cke::keep_policy();
  for (int p = threadIdx.x; p < ne * ngroups; p += THREADS) {
    const int el = p / ngroups;
    const int k0 = (p - el * ngroups) * W;
    const size_t o = static_cast<size_t>(e0 + el) * nvert + k0;
    cke::Pack<T> n, m, s1, s3;
    if (VEC) {
      n = cke::ld_stream(ntf + o);
      m = cke::ld_stream(advm + o);
    } else {
#pragma unroll
      for (int w = 0; w < W; ++w) {
        n.v[w] = k0 + w < nvert ? __ldcs(ntf + o + w) : T(0);
        m.v[w] = k0 + w < nvert ? __ldcs(advm + o + w) : T(0);
      }
    }
    const int s = el * nadv;
    cke::gather_levels<T, VEC>(t, nvert, k0, slots.cell + s, slots.c1 + s, slots.c3 + s,
                               nadv, pol, s1, s3);
    cke::Pack<T> r;
#pragma unroll
    for (int w = 0; w < W; ++w) r.v[w] = cke::finish(s1.v[w], s3.v[w], n.v[w], m.v[w], coef3);
    if (VEC) {
      cke::st_stream(out + o, r);
    } else {
#pragma unroll
      for (int w = 0; w < W; ++w) {
        if (k0 + w < nvert) __stcs(out + o + w, r.v[w]);
      }
    }
  }
}

template <typename T>
int launch(const void* cells, const void* c1, const void* c3, const void* t,
           const void* ntf, const void* advm, void* out, int nedges, int ncells,
           int nadv, int nvert, double coef3, void* stream) {
  constexpr int W = cke::Pack<T>::W;
  const bool vec = nvert % W == 0 && cke::aligned16(t) && cke::aligned16(ntf) &&
                   cke::aligned16(advm) && cke::aligned16(out);
  auto* kernel = vec ? &cke_rows_kernel<T, true> : &cke_rows_kernel<T, false>;
  // as many edges as one pass of the block's threads covers
  const int tile = std::max(1, THREADS / ((nvert + W - 1) / W));
  const size_t bytes = cke::Slots<T>::bytes(tile, nadv);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = static_cast<unsigned>((nedges + tile - 1) / tile);
  kernel<<<blocks, THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(cells), static_cast<const T*>(c1),
      static_cast<const T*>(c3), static_cast<const T*>(t), static_cast<const T*>(ntf),
      static_cast<const T*>(advm), static_cast<T*>(out), nedges, ncells, nadv, nvert,
      tile, static_cast<T>(coef3));
  return static_cast<int>(cudaGetLastError());
}

// The probe: every thread of PROBE_THREADS a block reads its float4s of buf
// (n4 of them, 16-byte aligned) through L2 only (ld.global.cg, so L1 never
// serves a repeat; volatile, so no repeat is dropped), reps times over, and
// writes one sum so the reads are kept.
constexpr int PROBE_THREADS = 256;

__global__ void __launch_bounds__(PROBE_THREADS)
l2_read_probe_kernel(const float4* __restrict__ buf, long long n4, int reps,
                     float* __restrict__ sink) {
  const long long stride = static_cast<long long>(gridDim.x) * PROBE_THREADS;
  const long long first = static_cast<long long>(blockIdx.x) * PROBE_THREADS + threadIdx.x;
  float acc = 0.f;
  for (int r = 0; r < reps; ++r) {
    for (long long i = first; i < n4; i += stride) {
      float4 v;
      asm volatile("ld.global.cg.v4.f32 {%0, %1, %2, %3}, [%4];"
                   : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
                   : "l"(buf + i));
      acc += v.x + v.y + v.z + v.w;
    }
  }
  sink[first] = acc;
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

// The L2 read-rate probe: buf holds n4 float4s (16-byte aligned), sink
// blocks * 256 floats.  Returns cudaGetLastError() after the launch.
int cdk_l2_read_probe(const void* buf, long long n4, int reps, int blocks, void* sink,
                      void* stream) {
  l2_read_probe_kernel<<<blocks, PROBE_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(buf), n4, reps, static_cast<float*>(sink));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
