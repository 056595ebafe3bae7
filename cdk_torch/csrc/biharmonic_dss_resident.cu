// K14: nsteps chained ring-DSS biharmonic steps (apply -> DSS -> apply) for
// every element, in one launch, with the state resident on chip.  (K19, the
// same chain over the 2-D torus, is biharmonic_dss2d_resident.cu.)
//
// Replaces cdk_tpu/kernels/biharmonic/pallas_dss_resident.py::
// _dss_resident_kernel (single-chip caller apply_dss_resident; the
// window-fed dist callers apply_dss_resident_windowed and
// apply_dss_resident_windowed_split).  The TPU kernel keeps a window of
// centre groups plus halo groups in VMEM, each 8-element group one
// (128,128) block-diagonal tile, and runs the assembly as masked sublane
// shifts; here each element's operator is used as it is and the neighbour
// index is explicit.
//
// Windows: columns (q, k) are independent and the DSS couples only
// neighbouring elements of the same column.  One block owns a window of
// elements and one tile of 32 columns for the whole launch: B + 2h
// consecutive elements (indices wrap mod nelemd, so a small ring may appear
// in the window more than once).  Window-fed (a shard of a decomposed ring)
// the elements are the shard's owned block with an exchanged strip of
// `strip` >= h elements on each side, three arrays read in place of one
// wrapped index, and the operators and inverse mass those of the extended
// block; an element past the strips loads as zero (it lies more than h from
// every owned element), and only owned elements are stored.  With the
// shard's own ends as strips (one shard) the windows, and so the results,
// are bit for bit those of the ring.  Each step uses up one halo unit per
// side (the window's edge elements assemble with zeros), so the centre
// stays exact while nsteps <= h; the host sets h = nsteps.  Each assembly
// exchanges only the boundary points through shared memory.  With
// `precomposed` the d-carry chain A.D.(A^2.D)^(n-1).A runs n+1
// applications per launch instead of 2n.
//
// Two kernels on those windows:
//  - dss_ring_x3_kernel, the bf16x3 forms (K14 _x3 and _sq_x3, the ring and
//    its window-fed mode): one warp per window element, 32 columns per warp
//    (two m-tiles), the applications on the tensor cores (bih::tc,
//    biharmonic_common.cuh), the operator's hi/lo B fragments in registers
//    (A, then A^2 for the middle of a precomposed chain, then A again, each
//    loaded when it is needed), the field read in fragment order (8
//    consecutive columns x 4 points per read).  The blocks are persistent,
//    one per SM (1024 threads at <= 64 registers), each warp copying its
//    element's rows of the next (window, column tile) into its own stage
//    with cp.async while it computes this one.  Shared memory holds those
//    stages and the side buffers of the assembly, double-buffered so each
//    step takes one barrier, not two.
//  - dss_resident_kernel, the exact f32 and f64 forms: thread (x, y) holds
//    the 16 GLL values of window element y, column x; the window's operators
//    and inverse mass sit in shared memory and are read as warp-wide
//    broadcasts (LDS.128), as in K1.
//
// Bound: device memory is touched once per launch (read the window, write
// the centre), ~0.15 ms at production f32 whatever the depth; the
// operations are 256 FMAs per application per column (exact), or three
// bf16 products on the tensor cores plus ~80 f32 operations for the splits
// and sums (bf16x3), times the window's (B+2h)/B overcompute.  The exact
// kernel is bound by FMA issue and its shared-memory operand reads; the
// bf16x3 kernel by the f32 work around the products and the per-step
// barrier of a one-block-per-SM launch, about 0.11 ms per step at
// production, so a deeper launch pays off until the window's overcompute
// grows (6 steps: B = 20 of 32).

#include <cuda_runtime.h>

#include "biharmonic_common.cuh"

namespace {

using bih::NP;
using bih::NPTS;
constexpr int TILE = 32;        // columns per block (one warp)
constexpr int MAX_WINDOW = 32;  // window elements at TILE columns

// The window: W consecutive ring elements from b0 = blockIdx.x*center -
// halo (mod n).  strip > 0: the window-fed ring, n owned elements between
// strips of `strip` elements (the element index then counts in the extended
// block).
struct Window {
  int n, halo, center, nwin, strip;
};

// The exact forms.  L, L2 (n,16,16); w (n,16) inverse assembled mass in
// lane order; q/out (n,16,ncol).  Window-fed: L, L2, w (n+2*strip, ...) of
// the extended block, hl/hr (strip,16,ncol) and q/out (n,16,ncol).  Block
// (TILE, W).
template <typename T, bool SQ>
__global__ void __launch_bounds__(TILE * MAX_WINDOW)
dss_resident_kernel(const T* __restrict__ L, const T* __restrict__ L2,
                    const T* __restrict__ w, const T* __restrict__ hl,
                    const T* __restrict__ q, const T* __restrict__ hr,
                    T* __restrict__ out, int ncol, int nsteps, Window g) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tc = TILE;
  const int W = blockDim.y;
  const int rj = W;
  const int plane_len = W * NPTS * NPTS;
  T* ops = reinterpret_cast<T*>(smem);     // [SQ?2:1][W][256]
  T* ws = ops + (SQ ? 2 : 1) * plane_len;  // [W][16]
  T* side0 = ws + W * NPTS;                // [W][NP][tc] j = 0
  T* side3 = side0 + W * NP * tc;          // [W][NP][tc] j = np-1

  const int bj = blockIdx.x;
  const int b0 = bj * g.center - g.halo;
  auto wrap = [](int i, int n) {
    i %= n;
    return i < 0 ? i + n : i;
  };
  const bool fed = g.strip > 0;
  const int n_ext = g.n + 2 * g.strip;
  auto elem = [&](int y) { return fed ? b0 + y + g.strip : wrap(b0 + y, g.n); };
  auto inside = [&](int e) { return !fed || (e >= 0 && e < n_ext); };
  const int tid = threadIdx.y * tc + threadIdx.x;
  for (int i = tid; i < plane_len; i += W * tc) {
    const int ei = elem(i / (NPTS * NPTS));
    const size_t src = (size_t)ei * NPTS * NPTS + i % (NPTS * NPTS);
    const bool in = inside(ei);
    bih::stage<T, false>(ops, plane_len, i, in ? L[src] : T(0));
    if constexpr (SQ) bih::stage<T, false>(ops + plane_len, plane_len, i, in ? L2[src] : T(0));
  }
  for (int i = tid; i < W * NPTS; i += W * tc) {
    const int ei = elem(i / NPTS);
    ws[i] = inside(ei) ? w[(size_t)ei * NPTS + i % NPTS] : T(0);
  }
  __syncthreads();

  const int x = threadIdx.x, y = threadIdx.y;
  const int cj = y;
  const int c = blockIdx.y * tc + x;
  const bool live = c < ncol;  // ragged last column tile: zeros, no store
  const int el = elem(y);
  // the field's source: q, or window-fed the strip or owned block holding
  // extended element el; se counts in that array
  const T* src = q;
  int se = el;
  if (fed) {
    if (el < g.strip) {
      src = hl;
    } else if (el < g.strip + g.n) {
      se = el - g.strip;
    } else {
      src = hr;
      se = el - g.strip - g.n;
    }
  }
  const bool load = live && inside(el);
  const size_t e = static_cast<size_t>(fed ? el - g.strip : el);  // in q/out
  T v[NPTS];
#pragma unroll
  for (int p = 0; p < NPTS; ++p)
    v[p] = load ? src[((size_t)se * NPTS + p) * ncol + c] : T(0);

  const T* A = ops + y * NPTS * NPTS;
  const T* A2 = A + plane_len;
  const T* wy = ws + y * NPTS;

  // the j=0 points gain the left neighbour's j=np-1 points, the j=np-1
  // points the right neighbour's j=0 points
  const bool has_l = cj > 0, has_r = cj < rj - 1;
  const int yl = cj > 0 ? y - 1 : y + rj - 1;
  const int yr = cj < rj - 1 ? y + 1 : y - rj + 1;
  // d = DSS(s) * w, as dss_ring_lane
  auto assemble = [&]() {
    bih::exchange<T, 0, NP - 1, NP>(v, side0, side3, x, y, tc, yl, has_l, yr, has_r);
#pragma unroll
    for (int p = 0; p < NPTS; ++p) v[p] *= wy[p];
  };

  if constexpr (SQ) {
    if (nsteps > 0) {
      bih::apply<T, false>(A, plane_len, v);
      assemble();
      for (int s = 1; s < nsteps; ++s) {
        bih::apply<T, false>(A2, plane_len, v);
        assemble();
      }
      bih::apply<T, false>(A, plane_len, v);
    }
  } else {
    for (int s = 0; s < nsteps; ++s) {
      bih::apply<T, false>(A, plane_len, v);
      assemble();
      bih::apply<T, false>(A, plane_len, v);
    }
  }

  // (window-fed, b0 + cj is the owned index)
  const bool centre_j = cj >= g.halo && cj < g.halo + g.center && b0 + cj < g.n;
  if (live && centre_j) {
#pragma unroll
    for (int p = 0; p < NPTS; ++p) out[(e * NPTS + p) * ncol + c] = v[p];
  }
}

// A side buffer row (one boundary point of one element) holds TILE columns
// and 8 spare values, so the lanes of one store or read hit distinct banks;
// a stage row (one point of one element) TILE columns and 4 spare values, so
// the fragment-order reads of one warp hit distinct banks.
constexpr int SIDE_STRIDE = TILE + 8;
constexpr int STAGE_STRIDE = TILE + 4;

// Shared memory of dss_ring_x3_kernel, in floats: the stage
// [W][NPTS][STAGE_STRIDE] (warp y's rows are its own) and the side buffers
// [buffer][side][W][NP][SIDE_STRIDE] (side 0 the j = 0 points, side 1 the
// j = np-1 points, which starts 16 values on, half the banks away).
__host__ __device__ constexpr int x3_side_len(int W) { return W * NP * SIDE_STRIDE + 16; }
__host__ __device__ constexpr int x3_smem_floats(int W) {
  return W * NPTS * STAGE_STRIDE + 4 * x3_side_len(W);
}

// The ring's bf16x3 forms on the tensor cores.  Block (TILE, W): warp y owns
// window element y and TILE columns of a tile as two m-tiles.  Persistent:
// block b takes tiles b, b + gridDim.x, ... of (window bj, column tile ct),
// ct fastest; each warp copies its element's rows of the next tile into its
// own stage rows (cp.async) while it computes this one.  Arguments as
// dss_resident_kernel's.
template <bool SQ>
__global__ void __launch_bounds__(TILE * MAX_WINDOW, 1)
dss_ring_x3_kernel(const float* __restrict__ L, const float* __restrict__ L2,
                   const float* __restrict__ w, const float* __restrict__ hl,
                   const float* __restrict__ q, const float* __restrict__ hr,
                   float* __restrict__ out, int ncol, int nsteps, Window g) {
  using bih::tc::pt;
  constexpr int MT = TILE / bih::tc::MCOLS;
  extern __shared__ __align__(16) float smem_x3[];
  const int W = blockDim.y, y = threadIdx.y, lane = threadIdx.x;
  const int gq = lane >> 2, t = lane & 3;
  float* stage = smem_x3 + y * NPTS * STAGE_STRIDE;
  float* xch = smem_x3 + W * NPTS * STAGE_STRIDE;
  const int side_len = x3_side_len(W);
  const int ctiles = (ncol + TILE - 1) / TILE;
  const int ntiles = g.nwin * ctiles;
  const bool fed = g.strip > 0;

  // window element y of window bj: its index (extended, window-fed), whether
  // it lies inside the strips, and the array and index holding its field
  struct Elem {
    int el, se;
    bool inside;
    const float* src;
  };
  auto elem = [&](int bj) {
    Elem e;
    e.el = bj * g.center - g.halo + y;
    if (fed) {
      e.el += g.strip;
    } else {
      e.el %= g.n;
      if (e.el < 0) e.el += g.n;
    }
    e.inside = !fed || (e.el >= 0 && e.el < g.n + 2 * g.strip);
    e.src = q;
    e.se = e.el;
    if (fed) {
      if (e.el < g.strip) {
        e.src = hl;
      } else if (e.el < g.strip + g.n) {
        e.se = e.el - g.strip;
      } else {
        e.src = hr;
        e.se = e.el - g.strip - g.n;
      }
    }
    return e;
  };
  // this lane's column of each of the element's 16 rows of `tile`
  auto prefetch = [&](int tile) {
    if (tile >= ntiles) return;
    const Elem e = elem(tile / ctiles);
    const int c = (tile % ctiles) * TILE + lane;
    const bool ok = e.inside && c < ncol;
#pragma unroll
    for (int p = 0; p < NPTS; ++p)
      bih::cp_async<4>(stage + p * STAGE_STRIDE + lane,
                       ok ? e.src + ((size_t)e.se * NPTS + p) * ncol + c : q, ok);
    bih::cp_async_commit();
  };

  // d = DSS(s) * w, the j pass through the side buffers
  const bool has_l = y > 0, has_r = y < W - 1;
  int buf = 0;
  float x[MT][8], wv[4];
  auto assemble = [&]() {
    float* side = xch + 2 * buf * side_len;
#pragma unroll
    for (int m = 0; m < MT; ++m)
      bih::tc::put_jside(x[m], side + (t & 1) * side_len + y * NP * SIDE_STRIDE,
                         SIDE_STRIDE, 16 * m + gq);
    __syncthreads();  // the other buffer serves the next step
    // j = 0 points gain the left element's j = np-1 points, j = np-1 points
    // the right element's j = 0 points
    if ((t & 1) ? has_r : has_l) {
      const float* nb = side + (1 - (t & 1)) * side_len
                        + ((t & 1) ? y + 1 : y - 1) * NP * SIDE_STRIDE;
#pragma unroll
      for (int m = 0; m < MT; ++m) bih::tc::add_jside(x[m], nb, SIDE_STRIDE, 16 * m + gq);
    }
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int k = 0; k < 8; ++k) x[m][k] *= wv[k & 3];
    buf ^= 1;
  };
  auto apply = [&](const bih::tc::Op& op) {
#pragma unroll
    for (int m = 0; m < MT; ++m) bih::tc::apply(op, x[m]);
  };

  prefetch(blockIdx.x);
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int bj = tile / ctiles;
    const Elem e = elem(bj);
    bih::cp_async_wait();
    __syncwarp();
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int k = 0; k < 8; ++k)
        x[m][k] = stage[pt(t, k & 3) * STAGE_STRIDE + 16 * m + 8 * (k >> 2) + gq];
    __syncwarp();  // every lane has read the stage before it is refilled
    prefetch(tile + gridDim.x);

    const float* A = e.inside ? L + (size_t)e.el * NPTS * NPTS : nullptr;
#pragma unroll
    for (int k = 0; k < 4; ++k) wv[k] = e.inside ? w[(size_t)e.el * NPTS + pt(t, k)] : 0.f;
    bih::tc::Op op = bih::tc::load_op(A);
    if constexpr (SQ) {
      if (nsteps > 0) {
        apply(op);
        assemble();
        if (nsteps > 1) {
          op = bih::tc::load_op(e.inside ? L2 + (size_t)e.el * NPTS * NPTS : nullptr);
          for (int s = 1; s < nsteps; ++s) {
            apply(op);
            assemble();
          }
          op = bih::tc::load_op(A);
        }
        apply(op);
      }
    } else {
      for (int s = 0; s < nsteps; ++s) {
        apply(op);
        assemble();
        apply(op);
      }
    }

    // (window-fed, b0 + y is the owned index)
    const int b0 = bj * g.center - g.halo;
    if (y >= g.halo && y < g.halo + g.center && b0 + y < g.n) {
      const size_t eo = static_cast<size_t>(fed ? e.el - g.strip : e.el);
      const int c0 = (tile % ctiles) * TILE + gq;
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int c = c0 + bih::tc::MCOLS * m + 8 * (k >> 2);
          if (c < ncol) out[(eo * NPTS + pt(t, k & 3)) * ncol + c] = x[m][k];
        }
    }
  }
}

// Window sizes: MAX_WINDOW elements at TILE columns.  Window-fed (strip >
// 0) n counts the owned elements and the windows are the ring's of that
// size.
template <typename T, bool X3, bool SQ>
int launch(const void* L, const void* L2, const void* w, const void* hl,
           const void* q, const void* hr, void* out, int nelemd, int strip,
           int ncol, int nsteps, void* stream) {
  const int h = nsteps;
  if (nsteps < 0 || nelemd < 1 || ncol < 1 || strip < 0
      || (strip > 0 && (h > strip || !hl || !hr)) || 2 * h + 1 > MAX_WINDOW)
    return static_cast<int>(cudaErrorInvalidValue);
  const int center = MAX_WINDOW - 2 * h < nelemd ? MAX_WINDOW - 2 * h : nelemd;
  const Window g{nelemd, h, center, (nelemd + center - 1) / center, strip};
  const int W = center + 2 * h;
  const dim3 grid(g.nwin, (ncol + TILE - 1) / TILE);
  if constexpr (X3) {
    const size_t smem = sizeof(float) * x3_smem_floats(W);
    auto kern = dss_ring_x3_kernel<SQ>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    // persistent: as many blocks as are resident at once (one per SM for a
    // 32-element window: 1024 threads at <= 64 registers)
    int dev, sms, per_sm;
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, TILE * W, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long ntiles = (long)grid.x * grid.y, cap = (long)sms * per_sm;
    kern<<<static_cast<unsigned>(ntiles < cap ? ntiles : cap), dim3(TILE, W), smem,
           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(L), static_cast<const float*>(L2),
        static_cast<const float*>(w), static_cast<const float*>(hl),
        static_cast<const float*>(q), static_cast<const float*>(hr),
        static_cast<float*>(out), ncol, nsteps, g);
    return static_cast<int>(cudaGetLastError());
  } else {
    const size_t smem = sizeof(T) * ((SQ ? 2 : 1) * W * NPTS * NPTS + W * NPTS
                                     + 2 * W * NP * TILE);
    auto kern = dss_resident_kernel<T, SQ>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    kern<<<grid, dim3(TILE, W), smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(L), static_cast<const T*>(L2),
        static_cast<const T*>(w), static_cast<const T*>(hl),
        static_cast<const T*>(q), static_cast<const T*>(hr), static_cast<T*>(out),
        ncol, nsteps, g);
    return static_cast<int>(cudaGetLastError());
  }
}

template <typename T, bool X3>
int dispatch(const void* L, const void* L2, const void* w, const void* hl,
             const void* q, const void* hr, void* out, int nelemd, int strip,
             int ncol, int nsteps, int sq, void* stream) {
  return sq ? launch<T, X3, true>(L, L2, w, hl, q, hr, out, nelemd, strip, ncol, nsteps,
                                  stream)
            : launch<T, X3, false>(L, L2, w, hl, q, hr, out, nelemd, strip, ncol, nsteps,
                                   stream);
}

}  // namespace

extern "C" {

// L, L2 (nelemd,16,16) (L2 = L@L, read only with sq), w (nelemd,16),
// q/out (nelemd,16,ncol), contiguous on one device; nsteps <= 15.  x3
// selects bf16x3 products, sq the precomposed d-carry chain.  Returns
// cudaGetLastError() after the launch.
int cdk_dss_resident_f32(const void* L, const void* L2, const void* w,
                         const void* q, void* out, int nelemd, int ncol,
                         int nsteps, int x3, int sq, void* stream) {
  return x3 ? dispatch<float, true>(L, L2, w, nullptr, q, nullptr, out, nelemd, 0,
                                    ncol, nsteps, sq, stream)
            : dispatch<float, false>(L, L2, w, nullptr, q, nullptr, out, nelemd, 0,
                                     ncol, nsteps, sq, stream);
}

int cdk_dss_resident_f64(const void* L, const void* L2, const void* w,
                         const void* q, void* out, int nelemd, int ncol,
                         int nsteps, int sq, void* stream) {
  return dispatch<double, false>(L, L2, w, nullptr, q, nullptr, out, nelemd, 0,
                                 ncol, nsteps, sq, stream);
}

// The window-fed ring (a shard of a decomposed ring): q/out (e_own,16,ncol)
// the owned block, hl/hr (strip,16,ncol) the exchanged strips on its left
// and right, L, L2 (e_own+2*strip,16,16) and w (e_own+2*strip,16) those of
// the extended block [hl | q | hr]; 1 <= strip, nsteps <= strip and
// nsteps <= 15.  hl, q and hr may be views into one extended array.
int cdk_dss_resident_window_f32(const void* L, const void* L2, const void* w,
                                const void* hl, const void* q, const void* hr,
                                void* out, int e_own, int strip, int ncol,
                                int nsteps, int x3, int sq, void* stream) {
  if (strip < 1) return static_cast<int>(cudaErrorInvalidValue);
  return x3 ? dispatch<float, true>(L, L2, w, hl, q, hr, out, e_own, strip, ncol,
                                    nsteps, sq, stream)
            : dispatch<float, false>(L, L2, w, hl, q, hr, out, e_own, strip, ncol,
                                     nsteps, sq, stream);
}

int cdk_dss_resident_window_f64(const void* L, const void* L2, const void* w,
                                const void* hl, const void* q, const void* hr,
                                void* out, int e_own, int strip, int ncol,
                                int nsteps, int sq, void* stream) {
  if (strip < 1) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch<double, false>(L, L2, w, hl, q, hr, out, e_own, strip, ncol,
                                 nsteps, sq, stream);
}

}  // extern "C"
