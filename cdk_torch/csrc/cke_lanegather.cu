// K13: the CKE edge flux on a transposed, level-major tracer table.
//
// Replaces cdk_tpu/kernels/cke/pallas_lanegather.py::_kernel (variant
// pallas_lanegather).  The TPU kernel puts cells on lanes: the masked table
// is transposed to (levels, cells) in 128-cell lane groups, each (edge block,
// slot) picks its cells by an intra-vreg lane gather per group and a select
// tree over the groups, and the output comes out level-major (K, E).  The lane
// groups and the select tree exist only because Mosaic gathers within one
// vreg; they are not carried over.  What is kept is the interface: table
// (K, C), slot arrays (A, E), edge factors and output (K, E).
//
// Bound on this card: each input read once and the output written once,
// 349 MB at the production 256000 edges x 28000 cells x 100 levels x 10 slots
// in f32, 0.104 ms at 3.35 TB/s; as for K3, the 1.02 GB of gathered rows come
// from L2 and L2's read rate sets the floor a gather can approach.
//
// Design: two kernels, one entry point.
//  1. A tiled transpose of the (K, C) table into a cell-major (C, K) scratch
//     the wrapper allocates (11.2 MB read and written at production, and left
//     in L2 for the second kernel).
//  2. A block owns a tile of 128 bytes of edges (32 in f32, 16 in f64) across
//     all levels, in chunks of up to 64 levels.  It loads the tile's cells,
//     c1 and c3 once, so the slot arrays are read once and not once per
//     level, and gathers each (edge, level group) pair from the cell-major
//     rows with K3's core (cke_common.cuh): W levels a 16-byte vector, slot
//     order, a product, then a sum.  The pairs' s1 and s3 go to a shared
//     tile, edge-major with a row pitch of an odd number of vectors, and the
//     finish reads it back with the edges across the lanes (conflict-free
//     vector reads), so the ntfm and sgn reads and the output writes are
//     128-byte lines along e.  The edge factors ntf*advMask and sgn are formed
//     by the caller as in the TPU kernel: bitwise the plain version, and K3.

#include <algorithm>

#include "cke_common.cuh"

namespace {

// 160 threads and 64-level chunks ran fastest of 128-320 threads and 64 or
// 128 levels (at production 800 (edge, level group) pairs per tile)
constexpr int THREADS = 160;
constexpr int CHUNK = 64;  // levels a block's shared tile holds at a time

// (rows, cols) -> (cols, rows), 32 x 32 tiles through shared memory.
template <typename T>
__global__ void __launch_bounds__(256)
transpose_kernel(const T* __restrict__ in, T* __restrict__ out, int rows, int cols) {
  __shared__ T tile[32][33];
  const int c0 = blockIdx.x * 32, r0 = blockIdx.y * 32;
  for (int r = threadIdx.y; r < 32; r += 8) {
    const int row = r0 + r, col = c0 + threadIdx.x;
    if (row < rows && col < cols) tile[r][threadIdx.x] = in[static_cast<size_t>(row) * cols + col];
  }
  __syncthreads();
  for (int c = threadIdx.y; c < 32; c += 8) {
    const int col = c0 + c, row = r0 + threadIdx.x;
    if (col < cols && row < rows) out[static_cast<size_t>(col) * rows + row] = tile[threadIdx.x][c];
  }
}

// The shared tile's row pitch in values: an odd number of W-vectors, at
// least `groups` of them.
template <typename T>
__host__ __device__ inline int pitch(int groups) {
  return cke::Pack<T>::W * (groups | 1);
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS)
cke_lanegather_kernel(const int* __restrict__ cells_t, const T* __restrict__ c1t,
                      const T* __restrict__ c3t, const T* __restrict__ tab,
                      const T* __restrict__ ntfm_t, const T* __restrict__ sgn_t,
                      T* __restrict__ out_t, int nedges, int ncells, int nadv, int nvert,
                      int kp, T coef3) {
  constexpr int W = cke::Pack<T>::W;
  constexpr int TILE = 128 / sizeof(T);  // edges a block owns
  extern __shared__ __align__(16) unsigned char smem[];
  T* sum1 = reinterpret_cast<T*>(smem);  // [TILE][kp]
  T* sum3 = sum1 + TILE * kp;
  const cke::Slots<T> slots(reinterpret_cast<unsigned char*>(sum3 + TILE * kp), TILE, nadv);
  const int e0 = blockIdx.x * TILE;
  const int ne = min(TILE, nedges - e0);
  for (int q = threadIdx.x; q < TILE * nadv; q += THREADS) {
    const int i = q / TILE, el = q - i * TILE;
    if (el < ne) {
      const size_t g = static_cast<size_t>(i) * nedges + e0 + el;
      slots.cell[el * nadv + i] = cke::clamp_cell(__ldcs(cells_t + g), ncells);
      slots.c1[el * nadv + i] = __ldcs(c1t + g);
      slots.c3[el * nadv + i] = __ldcs(c3t + g);
    }
  }
  __syncthreads();
  const uint64_t pol = cke::keep_policy();
  for (int kc = 0; kc < nvert; kc += CHUNK) {
    const int groups = (min(CHUNK, nvert - kc) + W - 1) / W;
    // gather: pairs (edge el, group v), v fastest, so a row is a run of lanes
    for (int p = threadIdx.x; p < ne * groups; p += THREADS) {
      const int el = p / groups, v = p - el * groups;
      cke::Pack<T> s1, s3;
      const int s = el * nadv;
      cke::gather_levels<T, VEC>(tab, nvert, kc + v * W, slots.cell + s, slots.c1 + s,
                                 slots.c3 + s, nadv, pol, s1, s3);
      *reinterpret_cast<cke::Pack<T>*>(sum1 + el * kp + v * W) = s1;
      *reinterpret_cast<cke::Pack<T>*>(sum3 + el * kp + v * W) = s3;
    }
    __syncthreads();
    // finish: (group v, edge el), el fastest, so a warp's accesses of the
    // (K, E) arrays are runs along e
    for (int q = threadIdx.x; q < TILE * groups; q += THREADS) {
      const int v = q / TILE, el = q - v * TILE;
      if (el >= ne) continue;
      const cke::Pack<T> s1 = *reinterpret_cast<const cke::Pack<T>*>(sum1 + el * kp + v * W);
      const cke::Pack<T> s3 = *reinterpret_cast<const cke::Pack<T>*>(sum3 + el * kp + v * W);
#pragma unroll
      for (int w = 0; w < W; ++w) {
        const int k = kc + v * W + w;
        if (k < nvert) {
          const size_t o = static_cast<size_t>(k) * nedges + e0 + el;
          __stcs(out_t + o,
                 cke::finish_m(s1.v[w], s3.v[w], __ldcs(ntfm_t + o), __ldcs(sgn_t + o), coef3));
        }
      }
    }
    __syncthreads();
  }
}

template <typename T>
int launch(const void* cells_t, const void* c1t, const void* c3t, const void* tm_t,
           const void* ntfm_t, const void* sgn_t, void* tab, void* out_t, int nedges,
           int ncells, int nadv, int nvert, double coef3, void* stream) {
  constexpr int W = cke::Pack<T>::W;
  constexpr int TILE = 128 / sizeof(T);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 tgrid((ncells + 31) / 32, (nvert + 31) / 32);
  transpose_kernel<T><<<tgrid, dim3(32, 8), 0, s>>>(static_cast<const T*>(tm_t),
                                                    static_cast<T*>(tab), nvert, ncells);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec = nvert % W == 0 && cke::aligned16(tab);
  auto* kernel = vec ? &cke_lanegather_kernel<T, true> : &cke_lanegather_kernel<T, false>;
  const int kp = pitch<T>((std::min(CHUNK, nvert) + W - 1) / W);
  const size_t bytes = 2 * sizeof(T) * TILE * kp + cke::Slots<T>::bytes(TILE, nadv);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = static_cast<unsigned>((nedges + TILE - 1) / TILE);
  kernel<<<blocks, THREADS, bytes, s>>>(
      static_cast<const int*>(cells_t), static_cast<const T*>(c1t),
      static_cast<const T*>(c3t), static_cast<const T*>(tab),
      static_cast<const T*>(ntfm_t), static_cast<const T*>(sgn_t), static_cast<T*>(out_t),
      nedges, ncells, nadv, nvert, kp, static_cast<T>(coef3));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// cells_t (A,E) int32; c1t, c3t (A,E); tm_t = (tracer*mask)^T (K,C); ntfm_t =
// (ntf*advMask)^T, sgn_t and out_t (K,E); tab, scratch for the cell-major
// table (C,K); all contiguous on one device; ceil(nvert / 32) <= 65535 (the
// transpose grid's y extent).  Returns cudaGetLastError() after the launches.
int cdk_cke_lanegather_f32(const void* cells_t, const void* c1t, const void* c3t,
                           const void* tm_t, const void* ntfm_t, const void* sgn_t,
                           void* tab, void* out_t, int nedges, int ncells, int nadv,
                           int nvert, double coef3, void* stream) {
  return launch<float>(cells_t, c1t, c3t, tm_t, ntfm_t, sgn_t, tab, out_t, nedges, ncells,
                       nadv, nvert, coef3, stream);
}

int cdk_cke_lanegather_f64(const void* cells_t, const void* c1t, const void* c3t,
                           const void* tm_t, const void* ntfm_t, const void* sgn_t,
                           void* tab, void* out_t, int nedges, int ncells, int nadv,
                           int nvert, double coef3, void* stream) {
  return launch<double>(cells_t, c1t, c3t, tm_t, ntfm_t, sgn_t, tab, out_t, nedges, ncells,
                        nadv, nvert, coef3, stream);
}

}  // extern "C"
