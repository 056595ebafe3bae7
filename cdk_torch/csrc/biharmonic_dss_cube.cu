// K26: one step of the cubed-sphere DSS biharmonic chain: each element's
// boundary points assembled over HOMME's cube (its own unassembled value plus
// its sharers', in the assembly map's slot order), scaled by the inverse
// assembled mass W, and the element's operator (A², or A in the last step)
// applied, bf16x3 on the tensor cores:
//
//     out[e] = op[e] . (W[e] * dss_cube(t)[e])
//
// Replaces no TPU kernel: the JAX package's DSS families assemble over a ring
// or a torus only (cdk_tpu/kernels/biharmonic/dss2d.py:1-23 calls the torus a
// stand-in for the cube).  The map (kernels/biharmonic/cube.py) lists, for
// each of an element's 12 boundary points, up to 3 other sharers as rows
// e'*16 + p' of the (e, 16, ncol) lane-layout field, padded with -1: one
// across an edge, three at a vertex inside a face, two at the 8 cube corners.
//
// Design: a warp owns one element and a chunk of CHUNK columns, as groups of
// bih::tc's m-tiles; a block is WARPS elements of one chunk, and the grid
// runs a block's chunks together (chunks fastest), so each row of an element
// is read whole and in order, and the elements that share its boundary
// points within its face (1 and ne elements away) run in the same wave and
// find those rows in L2.  The results are stored streaming (evict first), so
// they do not push the state out of L2.  (On an H100 at the benchmark cells'
// size, 5,400 elements of 2,880 columns: 0.742 ms a step, 80 % of the bytes
// bound; every element of a 64-column chunk before the next chunk, with
// plain stores, took 0.940 ms.)  The product's columns are its m-tiles'
// rows in any order, so lane (g, t) takes V consecutive columns of a group (V = 4 where ncol is a multiple of 4: one
// 16-byte load a row, rows g and g+8 of two m-tiles; else V = 1, columns g
// and g + 8 of one m-tile) of its four points 2t, 2t+1, 8+2t, 9+2t.  Of those
// four, point q = t is an element corner, two are inside an edge and one is
// interior, so every lane reads five sharers' rows: the corner's three map
// slots and each edge point's one (a conforming quadrilateral mesh shares an
// edge point with one other element; a corner's padded slot reads its own
// row and adds nothing).  The loads take no branch, so a group's 9 rows are
// in flight together; the sums are taken in slot order, times W, into the
// m-tiles' fragments and through bih::tc::apply.  The operator's fragment is
// loaded once a warp.  One pass of the state in and out a step: bound by
// device memory (995 MB a pass at the benchmark cells' size), with the
// sharers' 20 values for every 16 an element owns read from L2.

#include <cuda_runtime.h>

#include "biharmonic_common.cuh"

namespace {

using bih::NPTS;
using bih::tc::MCOLS;
constexpr int WARPS = 4;    // elements a block, a warp each
constexpr int CHUNK = 128;  // columns a warp takes
constexpr int NB = 12;      // boundary points of an element
constexpr int SHARERS = 3;  // most other sharers of one point
constexpr int NSRC = SHARERS + 2;  // sharers' rows a lane reads

// the map's slot of point p (row-major boundary order), or -1 inside
__constant__ int SLOT[NPTS] = {0, 1, 2, 3, 4, -1, -1, 5, 6, -1, -1, 7, 8, 9, 10, 11};

// V consecutive values of a row from column c (zeros where c >= ncol; with
// V = 4, ncol and the row 16-byte aligned, so all four or none)
template <int V>
__device__ __forceinline__ void load_cols(const float* __restrict__ row, int c, int ncol,
                                          float v[V]) {
  if constexpr (V == 4) {
    const float4 x = c < ncol ? *reinterpret_cast<const float4*>(row + c)
                              : make_float4(0.f, 0.f, 0.f, 0.f);
    v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
  } else {
    v[0] = c < ncol ? row[c] : 0.f;
  }
}

template <int V>
__device__ __forceinline__ void store_cols(float* __restrict__ row, int c, int ncol,
                                           const float v[V]) {
  if (c >= ncol) return;
  if constexpr (V == 4)
    __stcs(reinterpret_cast<float4*>(row + c), make_float4(v[0], v[1], v[2], v[3]));
  else
    row[c] = v[0];
}

template <int V>
__global__ void __launch_bounds__(32 * WARPS)
dss_cube_kernel(const float* __restrict__ op, const int* __restrict__ amap,
                const float* __restrict__ w, const float* __restrict__ t,
                float* __restrict__ out, int nelem, int ncol) {
  // a group: the columns the warp's lanes take in one round; with V = 4,
  // lane g's columns 4g..4g+3 are rows g, g+8 of m-tile 0, then of m-tile 1
  constexpr int GCOLS = V == 4 ? 2 * MCOLS : MCOLS;
  constexpr int NC = V == 4 ? 4 : 2;  // columns a lane holds of a group
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  const int e = blockIdx.y * WARPS + (threadIdx.x >> 5);
  if (e >= nelem) return;  // no barrier below: a warp runs alone
  const int c0 = blockIdx.x * CHUNK;
  const bih::tc::Op A = bih::tc::load_op(op + static_cast<size_t>(e) * NPTS * NPTS);
  // this lane's points: q = tq is a corner, qe0 and qe1 inside edges
  const int qe0 = (tq == 0 || tq == 3) ? 1 : 0, qe1 = 3 - qe0;
  const float* own[4];
  float* dst[4];
  float wq[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int p = bih::tc::pt(tq, q);
    own[q] = t + (static_cast<size_t>(e) * NPTS + p) * ncol;
    dst[q] = out + (static_cast<size_t>(e) * NPTS + p) * ncol;
    wq[q] = w[e * NPTS + p];
  }
  // the sharers' rows in slot order, and the point each adds to (4: none)
  const float* src[NSRC];
  int to[NSRC];
#pragma unroll
  for (int n = 0; n < NSRC; ++n) {
    const int q = n < SHARERS ? tq : (n == SHARERS ? qe0 : qe1);
    const int k = n < SHARERS ? n : 0;
    const int r = amap[(e * NB + SLOT[bih::tc::pt(tq, q)]) * SHARERS + k];
    src[n] = r >= 0 ? t + static_cast<size_t>(r) * ncol : own[q];
    to[n] = r >= 0 ? q : 4;
  }
#pragma unroll
  for (int cb = c0; cb < c0 + CHUNK; cb += GCOLS) {
    if (cb >= ncol) break;
    // lane g's first column of the group
    const int c = V == 4 ? cb + 4 * g : cb + g;
    float v[4][NC], s[NSRC][NC];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      load_cols<V>(own[q], c, ncol, v[q]);
      if constexpr (V == 1) load_cols<1>(own[q], c + 8, ncol, v[q] + 1);
    }
#pragma unroll
    for (int n = 0; n < NSRC; ++n) {
      load_cols<V>(src[n], c, ncol, s[n]);
      if constexpr (V == 1) load_cols<1>(src[n], c + 8, ncol, s[n] + 1);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int j = 0; j < NC; ++j) {
#pragma unroll
        for (int n = 0; n < NSRC; ++n) v[q][j] += to[n] == q ? s[n][j] : 0.f;
        v[q][j] *= wq[q];
      }
    // each m-tile of the group: x[r * 4 + q] is point q of its row g + 8r
#pragma unroll
    for (int mt = 0; mt < NC / 2; ++mt) {
      float x[8];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        x[q] = v[q][2 * mt];
        x[4 + q] = v[q][2 * mt + 1];
      }
      bih::tc::apply(A, x);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        v[q][2 * mt] = x[q];
        v[q][2 * mt + 1] = x[4 + q];
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      store_cols<V>(dst[q], c, ncol, v[q]);
      if constexpr (V == 1) store_cols<1>(dst[q], c + 8, ncol, v[q] + 1);
    }
  }
}

}  // namespace

extern "C" {

// op (nelem,16,16), amap (nelem,12,3) int32, w (nelem,16), t and out
// (nelem,16,ncol), float32, contiguous on one device; out must not overlap t.
// Returns cudaGetLastError() after the launch.
int cdk_dss_cube_f32(const void* op, const void* amap, const void* w, const void* t,
                     void* out, int nelem, int ncol, void* stream) {
  const dim3 grid((ncol + CHUNK - 1) / CHUNK, (nelem + WARPS - 1) / WARPS);
  // 16-byte rows where ncol is a multiple of 4 (the tensors start 16-byte
  // aligned, as PyTorch allocates them)
  const bool vec = ncol % 4 == 0 && reinterpret_cast<uintptr_t>(t) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  auto kern = vec ? dss_cube_kernel<4> : dss_cube_kernel<1>;
  kern<<<grid, 32 * WARPS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(op), static_cast<const int*>(amap),
      static_cast<const float*>(w), static_cast<const float*>(t),
      static_cast<float*>(out), nelem, ncol);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
