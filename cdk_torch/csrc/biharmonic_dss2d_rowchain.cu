// K15-K18: the t-carry rowchain of the torus-DSS biharmonic.
//
//     t_0     = jpass(A q)                         bridge_in   (K15)
//     t_{m+1} = jpass(F(ipass(t_m) w))             step        (K16, K18)
//     q_N     = A(ipass(t_{N-1}) w)                bridge_out  (K17)
//
// with F = A.A, or one application of the precomposed A^2.  Replaces
// cdk_tpu/kernels/biharmonic/pallas_dss2d_resident.py::
// _rowchain_bridge_in_kernel, _rowchain_step_kernel,
// _rowchain_bridge_out_kernel and _rowchain_stepk_blocked_kernel, and in
// the padded mode the dist entry points _rowchain_calls.step_t_padded,
// .bridge_out_padded (through _padded_call) and .stepk_padded_factory.  The
// elements form an (ex, ey) torus, e = a*ey + b, in the lane layout
// (e, 16, ncol) with p = 4i + j.  jpass: element (a,b)'s j=0 points gain
// (a,b-1 mod ey)'s j=np-1 points and its j=np-1 points gain (a,b+1)'s j=0
// points.  ipass (of the j-summed field, so corners collect all four
// sharers): i=0 points gain (a-1 mod ex, b)'s i=np-1 points, i=np-1 points
// gain (a+1, b)'s i=0 points.  The TPU kernels keep whole element rows in
// VMEM and shift by 13 and 12 sublane rows; here the neighbour indices are
// explicit.
//
// Padded mode (pad = p >= 1): a shard of a row-decomposed torus with ex owned
// rows.  The t input holds ex + 2p rows, owned row a at a + p and p rows
// exchanged from each neighbour shard outside them; the operators and w hold
// ex + 2p - 2 rows (the innermost p - 1 exchanged too).  Step s of a launch
// computes the rows s+1 .. ex+2p-s-2 of the padded array, one fewer on each
// side per step; their i-neighbours are the rows beside them, with no wrap
// (the torus wraps through the exchange).  The last step's rows are the
// owned ones; `out` holds them at their padded rows (out_pad: the shape of
// t, whose other rows are scratch: earlier steps of a deeper launch write
// some) or as ex rows.  A row of out or tmp is read only after a step of
// the launch wrote it.  j stays mod ey in the row.
//
// Design: one thread per (element, column).  A production element row is
// 72 x 16 = 1152 values per column, so rows for a useful column tile (and
// the k halo rows per side the TPU's temporal blocking keeps) do not fit
// in 227 KB of shared memory.  Instead each thread RECOMPUTES the four
// boundary values it needs from each j-neighbour (the neighbour's ipass and
// F, and only the four output rows of the last application), which needs no
// exchange between threads and no barrier: the step reads the t rows of
// (a,b), (a,b+-1) and their i-neighbours' boundary rows (L1/L2 hits within
// a block of 8 elements of one row) and writes t'.  The operators of the
// block's elements and their two neighbours, split once per block into bf16
// hi/lo planes for bf16x3, and the inverse mass sit in shared memory and are
// read as warp-wide broadcasts.  Depth k (K18): k chained steps in one
// persistent cooperative launch, the grid synchronised between steps and t
// ping-ponged between `out` and a scratch buffer; each step is the same
// arithmetic as a depth-1 launch, so the result equals k depth-1 launches
// bit for bit.  On this card the depth saves launches, not device-memory
// round trips.
//
// Bound: at production the step streams t in and t' out (2 x 249 MB at f32)
// and issues 512 + 2 x 320 FMAs per column per element (A.A form; 256 +
// 2 x 64 with A^2; x3 three times as many).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "biharmonic_common.cuh"

namespace {

using bih::NP;
using bih::NPTS;
constexpr int TILE = 32;   // columns per block (one warp)
constexpr int ELEMS = 8;   // elements of one element row per block
constexpr int SLOTS = ELEMS + 2;
constexpr int THREADS = TILE * ELEMS;

enum Mode { BRIDGE_IN = 0, STEP = 1, BRIDGE_OUT = 2 };

// pad = 0: the whole (ex, ey) torus, rows mod ex; pad > 0: the padded mode
struct Torus {
  int ex, ey, ncol, pad, out_pad;
};

// the j = 0 points (p = 0, 4, 8, 12) and the j = np-1 points (3, 7, 11, 15)
template <typename T, bool X3>
__device__ __forceinline__ void rows_j0(const T* op, int lo_off, const T v[NPTS], T o[NP]) {
  bih::op_rows<T, X3, 0, NP, NP>(op, lo_off, v, o);
}

template <typename T, bool X3>
__device__ __forceinline__ void rows_j3(const T* op, int lo_off, const T v[NPTS], T o[NP]) {
  bih::op_rows<T, X3, NP - 1, NP, NP>(op, lo_off, v, o);
}

template <typename T>
__device__ __forceinline__ void load(const T* f, size_t e, int ncol,
                                     int c, T v[NPTS]) {
#pragma unroll
  for (int p = 0; p < NPTS; ++p) v[p] = f[(e * NPTS + p) * ncol + c];
}

// d = ipass(t)[a,b] * w: t's i=0 points gain the up row's i=np-1 points,
// its i=np-1 points the down row's i=0 points.  a is t's row (padded in the
// padded mode, where the neighbour rows are a -+ 1).
template <typename T>
__device__ __forceinline__ void ipass_w(const T* t, const T* wslot,
                                        int a, int b, int c, Torus g, T d[NPTS]) {
  int au = a - 1, ad = a + 1;
  if (g.pad == 0) {
    if (a == 0) au = g.ex - 1;
    if (a == g.ex - 1) ad = 0;
  }
  const size_t e = (size_t)a * g.ey + b;
  const size_t eu = (size_t)au * g.ey + b;
  const size_t ed = (size_t)ad * g.ey + b;
  load(t, e, g.ncol, c, d);
#pragma unroll
  for (int j = 0; j < NP; ++j) {
    d[j] += t[(eu * NPTS + NPTS - NP + j) * g.ncol + c];
    d[NPTS - NP + j] += t[(ed * NPTS + j) * g.ncol + c];
  }
#pragma unroll
  for (int p = 0; p < NPTS; ++p) d[p] *= wslot[p];
}

// One output element (a,b), column c, of the chosen mode: a is its row in
// src, ad in dst.  ops: SLOTS operators (slot s = element (a, b0-1+s mod
// ey)), lo plane at +lo_off; ws: SLOTS inverse masses; sl/sc/sr: the
// left/own/right slots.
template <typename T, bool X3, bool SQ, int MODE>
__device__ __forceinline__ void item(const T* ops, int lo_off, const T* ws,
                                     const T* src, T* dst, int a, int ad,
                                     int b, int c, int sl, int sc, int sr,
                                     Torus g) {
  const int bl = b == 0 ? g.ey - 1 : b - 1;
  const int br = b == g.ey - 1 ? 0 : b + 1;
  const T* opl = ops + sl * NPTS * NPTS;
  const T* opc = ops + sc * NPTS * NPTS;
  const T* opr = ops + sr * NPTS * NPTS;
  T u[NPTS], x[NPTS], ul[NP], ur[NP];
  if constexpr (MODE == BRIDGE_OUT) {
    ipass_w(src, ws + sc * NPTS, a, b, c, g, u);
    bih::apply<T, X3>(opc, lo_off, u);
  } else {
    if constexpr (MODE == BRIDGE_IN) {
      load(src, (size_t)a * g.ey + b, g.ncol, c, u);
      bih::apply<T, X3>(opc, lo_off, u);
      load(src, (size_t)a * g.ey + bl, g.ncol, c, x);
      rows_j3<T, X3>(opl, lo_off, x, ul);
      load(src, (size_t)a * g.ey + br, g.ncol, c, x);
      rows_j0<T, X3>(opr, lo_off, x, ur);
    } else {
      ipass_w(src, ws + sc * NPTS, a, b, c, g, u);
      if constexpr (!SQ) bih::apply<T, X3>(opc, lo_off, u);
      bih::apply<T, X3>(opc, lo_off, u);
      ipass_w(src, ws + sl * NPTS, a, bl, c, g, x);
      if constexpr (!SQ) bih::apply<T, X3>(opl, lo_off, x);
      rows_j3<T, X3>(opl, lo_off, x, ul);
      ipass_w(src, ws + sr * NPTS, a, br, c, g, x);
      if constexpr (!SQ) bih::apply<T, X3>(opr, lo_off, x);
      rows_j0<T, X3>(opr, lo_off, x, ur);
    }
    // jpass
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      u[i * NP] += ul[i];
      u[i * NP + NP - 1] += ur[i];
    }
  }
  const size_t e = (size_t)ad * g.ey + b;
#pragma unroll
  for (int p = 0; p < NPTS; ++p) dst[(e * NPTS + p) * g.ncol + c] = u[p];
}

// op (ex*ey,16,16): A, or A^2 for a precomposed step; w (ex*ey,16);
// in/out/tmp (ex*ey,16,ncol); in the padded mode the row counts above.  A
// grid-stride loop over tiles of (element row a, ELEMS elements from b0,
// TILE columns); nsteps > 1 only under a cooperative launch.  A deep launch reads, in later steps, the out and tmp
// it writes, so no pointer into them is __restrict__: a non-coherent load
// could return a line cached before the grid sync.
template <typename T, bool X3, bool SQ, int MODE>
__global__ void __launch_bounds__(THREADS)
rowchain_kernel(const T* __restrict__ op, const T* __restrict__ w,
                const T* __restrict__ in, T* out, T* tmp,
                Torus g, int nsteps) {
  constexpr int PLANES = X3 ? 2 : 1;
  constexpr int LO = SLOTS * NPTS * NPTS;
  __shared__ __align__(16) T ops[PLANES * LO];
  __shared__ T ws[SLOTS * NPTS];
  const int chunks = (g.ey + ELEMS - 1) / ELEMS;
  const int ctiles = (g.ncol + TILE - 1) / TILE;
  const int tid = threadIdx.y * TILE + threadIdx.x;

  for (int s = 0; s < nsteps; ++s) {
    // step s writes `out` when nsteps-1-s is even, else tmp; it reads what
    // step s-1 wrote (the input for s = 0)
    T* dst = (nsteps - 1 - s) % 2 == 0 ? out : tmp;
    const T* src = s == 0 ? in : (dst == out ? tmp : out);
    // the rows this step computes: all ex, or (padded) r0 .. r0+rows-1 of the
    // padded array; the operators' row is one less there, and dst's is
    // p less where dst is an unpadded out
    const int rows = g.pad ? g.ex + 2 * (g.pad - 1 - s) : g.ex;
    const int r0 = g.pad ? s + 1 : 0;
    const int op_off = g.pad ? 1 : 0;
    const int dst_off = (dst == out && !g.out_pad) ? g.pad : 0;
    const long ntiles = (long)rows * chunks * ctiles;
    for (long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
      const int ct = static_cast<int>(tile % ctiles);
      const long rest = tile / ctiles;
      const int b0 = static_cast<int>(rest % chunks) * ELEMS;
      const int a = r0 + static_cast<int>(rest / chunks);
      const size_t aop = static_cast<size_t>(a - op_off);
      __syncthreads();  // the previous tile is done with ops and ws
      for (int i = tid; i < LO; i += THREADS) {
        int bs = (b0 - 1 + i / (NPTS * NPTS)) % g.ey;
        if (bs < 0) bs += g.ey;
        const T l = op[(aop * g.ey + bs) * NPTS * NPTS + i % (NPTS * NPTS)];
        bih::stage<T, X3>(ops, LO, i, l);
      }
      if constexpr (MODE != BRIDGE_IN) {
        for (int i = tid; i < SLOTS * NPTS; i += THREADS) {
          int bs = (b0 - 1 + i / NPTS) % g.ey;
          if (bs < 0) bs += g.ey;
          ws[i] = w[(aop * g.ey + bs) * NPTS + i % NPTS];
        }
      }
      __syncthreads();
      const int b = b0 + threadIdx.y;
      const int c = ct * TILE + threadIdx.x;
      if (b < g.ey && c < g.ncol)
        item<T, X3, SQ, MODE>(ops, LO, ws, src, dst, a, a - dst_off, b, c,
                              threadIdx.y, threadIdx.y + 1, threadIdx.y + 2, g);
    }
    if (s + 1 < nsteps) cooperative_groups::this_grid().sync();
  }
}

template <typename T, bool X3, bool SQ, int MODE>
int launch(const void* op, const void* w, const void* in, void* out, void* tmp,
           int ex, int ey, int ncol, int nsteps, int pad, int out_pad,
           void* stream) {
  if (ex < 1 || ey < 1 || ncol < 1 || nsteps < 1 || (MODE != STEP && nsteps != 1)
      || (nsteps > 1 && tmp == nullptr) || pad < 0
      || (pad > 0 && (MODE == BRIDGE_IN || pad != nsteps || (nsteps > 1 && !out_pad))))
    return static_cast<int>(cudaErrorInvalidValue);
  const Torus g{ex, ey, ncol, pad, pad > 0 && out_pad};
  // the first step's rows: the most tiles of any step
  const long ntiles = (long)(pad ? ex + 2 * pad - 2 : ex) * ((ey + ELEMS - 1) / ELEMS)
                      * ((ncol + TILE - 1) / TILE);
  auto kern = rowchain_kernel<T, X3, SQ, MODE>;
  const T* op_ = static_cast<const T*>(op);
  const T* w_ = static_cast<const T*>(w);
  const T* in_ = static_cast<const T*>(in);
  T* out_ = static_cast<T*>(out);
  T* tmp_ = static_cast<T*>(tmp);
  auto st = static_cast<cudaStream_t>(stream);
  if (nsteps == 1) {
    kern<<<static_cast<unsigned>(ntiles), dim3(TILE, ELEMS), 0, st>>>(
        op_, w_, in_, out_, tmp_, g, nsteps);
    return static_cast<int>(cudaGetLastError());
  }
  // persistent cooperative grid: every block resident at once
  int dev, sms, per_sm;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, THREADS, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long cap = (long)sms * per_sm;
  const unsigned blocks = static_cast<unsigned>(ntiles < cap ? ntiles : cap);
  void* args[] = {&op_, &w_, &in_, &out_, &tmp_, const_cast<Torus*>(&g), &nsteps};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kern), dim3(blocks),
                                    dim3(TILE, ELEMS), args, 0, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool X3>
int dispatch(int mode, int sq, const void* op, const void* w, const void* in,
             void* out, void* tmp, int ex, int ey, int ncol, int nsteps,
             int pad, int out_pad, void* stream) {
  switch (mode) {
    case BRIDGE_IN:
      return launch<T, X3, false, BRIDGE_IN>(op, w, in, out, tmp, ex, ey, ncol, nsteps,
                                             pad, out_pad, stream);
    case BRIDGE_OUT:
      return launch<T, X3, false, BRIDGE_OUT>(op, w, in, out, tmp, ex, ey, ncol, nsteps,
                                              pad, out_pad, stream);
    case STEP:
      return sq ? launch<T, X3, true, STEP>(op, w, in, out, tmp, ex, ey, ncol, nsteps,
                                            pad, out_pad, stream)
                : launch<T, X3, false, STEP>(op, w, in, out, tmp, ex, ey, ncol, nsteps,
                                             pad, out_pad, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// mode 0 bridge_in (op = A, in = q), 1 step (op = A, or A^2 with sq; in = t;
// nsteps chained steps, tmp a scratch field when nsteps > 1), 2 bridge_out
// (op = A, in = t).  op (ex*ey,16,16), w (ex*ey,16) (bridge_in reads no w;
// it may be null), in/out/tmp
// (ex*ey,16,ncol), contiguous on one device; in never aliases out or tmp.
// pad > 0 (step and bridge_out, pad == nsteps) is the padded mode on ex
// owned rows: in and tmp ((ex+2*pad)*ey,16,ncol), op and w
// ((ex+2*pad-2)*ey, ...), out ((ex+2*pad)*ey,16,ncol) with out_pad (needed
// when nsteps > 1), else (ex*ey,16,ncol).  Returns the launch's CUDA error
// code.
int cdk_rowchain_f32(int mode, const void* op, const void* w, const void* in,
                     void* out, void* tmp, int ex, int ey, int ncol,
                     int nsteps, int pad, int out_pad, int x3, int sq,
                     void* stream) {
  return x3 ? dispatch<float, true>(mode, sq, op, w, in, out, tmp, ex, ey, ncol, nsteps,
                                    pad, out_pad, stream)
            : dispatch<float, false>(mode, sq, op, w, in, out, tmp, ex, ey, ncol, nsteps,
                                     pad, out_pad, stream);
}

int cdk_rowchain_f64(int mode, const void* op, const void* w, const void* in,
                     void* out, void* tmp, int ex, int ey, int ncol,
                     int nsteps, int pad, int out_pad, int sq, void* stream) {
  return dispatch<double, false>(mode, sq, op, w, in, out, tmp, ex, ey, ncol,
                                 nsteps, pad, out_pad, stream);
}

}  // extern "C"
