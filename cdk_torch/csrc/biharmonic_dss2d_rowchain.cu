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
// One kernel, step_kernel, in three modes: the step (K16, K18, K16p, K18p)
// and the two bridges (K15; K17 and its padded K17p).  A tile is TILE
// columns of ELEMS + 2 consecutive elements of one element row, a warp
// each.  In the step and bridge_in the ELEMS inner warps own their elements
// and the two outer ones are their halo (warp y takes element b0 - 1 + y mod
// ey): each warp computes its own element in full (the step ipass(t).w and
// F, reading t once; bridge_in A q), writes its j = 0 and j = np-1 output
// points to shared memory and, after one barrier, the owned warps add their
// neighbours' points and store.  bridge_out reads the i-neighbours' boundary
// rows as the step does, applies A once and stores, with no exchange and no
// barrier, so each of its warps owns its element (warp y takes b0 + y).
// Tiles at f32: 24 owned, so a production row of 72 is three tiles (the
// step's F on 26 elements for 24 owned, 1.08x); bridge_out 24 in bf16x3 and
// 18 exact (ELEMS 22 and 16: at 24 warps its FMA chain spills); f64 8
// (bridge_out 10).  The small tori of the tests (ey < ELEMS + 2) put one
// element in a tile more than once; each copy computes the same values and
// only the owned one is stored.  The blocks are persistent, one per SM (26
// warps at <= 72 registers for the step), and each warp copies what it
// needs of its next tile (its rows of the input, the two i-neighbours'
// boundary rows where the mode has an ipass, its operator and inverse mass)
// into its own part of shared memory with cp.async while it computes this
// one; the side buffers are double-buffered, so a tile takes one barrier.
// The bf16x3 forms run on the tensor cores (bih::tc: the warp's 32 columns
// as two m-tiles, the operator's hi/lo B fragments in registers, the input
// read in fragment order).  The exact and f64 forms keep one thread per
// column and the FMA chain in its order (bit for bit the plain version), the
// operator read from the warp's copy as 16-byte broadcasts.  Depth k (K18):
// k chained steps in one cooperative launch, the grid synchronised between
// steps and t ping-ponged between `out` and a scratch buffer; each step is
// the same arithmetic as a depth-1 launch, so the result equals k depth-1
// launches bit for bit.  The padded bridge_out (K17p) takes its
// i-neighbours from the pad rows through pass_of, with the arithmetic of
// K17, so with the torus's own rows as the pad it equals K17 bit for bit.
//
// Layouts.  The step and bridge_out, padded or not, read t in the lane layout
// (e, 16, ncol), p = 4i + j: a stage row is one point of the warp's 32
// columns, and the i-neighbours' boundary rows are copied a point at a time.
// bridge_in reads q so or, with NAT (the wrapper's choice, from the input's
// shape), in the state's own (e, q, k, i, j) layout, where column c = q*nlev +
// k of an element is its 16 points together: a warp's tile of 32 columns is
// one contiguous 2 KB span (4 KB at f64), which the warp copies with cp.async
// in 16-byte pieces into its stage as it lies, a stage row a column at a
// padded stride (nat_stride), and turns there as it reads it, the exact and
// f64 forms a column a thread, the bf16x3 form in fragment order; the halo
// warps copy their elements the same way.  So the HOMME loop reads the state
// where it lies, and no copy turns it first.  Every output, t_0 included,
// stays in the lane layout: the step and bridge_out carry t and read it a
// point's row at a time, and bridge_out's q is turned back by a view.
//
// Bound: at production each launch streams its input in and its output out
// (2 x 249 MB at f32 and the preset's qsize 10, 0.149 ms at 3.35 TB/s; four
// times that at qsize 40); the operations, 256 FMAs per
// column per element and application (bf16x3: three tensor-core products
// plus ~80 f32 operations for the splits and sums), take less.  Every step
// makes one pass through device memory, so depth k saves launches, not
// passes: a depth-4 launch cannot go under ~0.6 ms without blocking steps in
// time (not done: a row is 4.6 KB per column, and k halo rows per side of a
// useful tile do not fit in 227 KB).  What holds a tile back now: one block
// per SM, so its barrier and the end of its copies stall the whole SM, and
// the i-neighbours' rows add half again to the bytes a step or bridge_out
// tile reads (from L2).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "biharmonic_common.cuh"

namespace {

using bih::NP;
using bih::NPTS;
constexpr int TILE = 32;  // columns per block (one warp)

enum Mode { BRIDGE_IN = 0, STEP = 1, BRIDGE_OUT = 2 };

// pad = 0: the whole (ex, ey) torus, rows mod ex; pad > 0: the padded mode
struct Torus {
  int ex, ey, ncol, pad, out_pad;
};

__device__ __forceinline__ int wrap(int i, int n) {
  i %= n;
  return i < 0 ? i + n : i;
}

// the row above and below t's row a (padded: the rows beside, no wrap)
__device__ __forceinline__ void ineighbours(int a, const Torus& g, int& au, int& ad) {
  au = a - 1;
  ad = a + 1;
  if (g.pad == 0) {
    if (a == 0) au = g.ex - 1;
    if (a == g.ex - 1) ad = 0;
  }
}

// The rows step s of an nsteps launch computes (all ex, or padded r0 ..
// r0+rows-1), where it reads and writes, and the operators' and dst's row
// offsets (the operators' row is one less in the padded mode, and dst's p
// less where dst is an unpadded out).
template <typename T>
struct Pass {
  const T* src;
  T* dst;
  int rows, r0, op_off, dst_off;
};

template <typename T>
__device__ __forceinline__ Pass<T> pass_of(int s, int nsteps, const T* in, T* out,
                                           T* tmp, const Torus& g) {
  // step s writes `out` when nsteps-1-s is even, else tmp; it reads what
  // step s-1 wrote (the input for s = 0)
  Pass<T> p;
  p.dst = (nsteps - 1 - s) % 2 == 0 ? out : tmp;
  p.src = s == 0 ? in : (p.dst == out ? tmp : out);
  p.rows = g.pad ? g.ex + 2 * (g.pad - 1 - s) : g.ex;
  p.r0 = g.pad ? s + 1 : 0;
  p.op_off = g.pad ? 1 : 0;
  p.dst_off = (p.dst == out && !g.out_pad) ? g.pad : 0;
  return p;
}

// ---- the step and the bridges: one warp per element of a row tile -------

// The tile of each mode is ELEMS + 2 warps.  The step and bridge_in
// exchange j boundary points, so a tile of ELEMS owned elements carries one
// halo element on each side: 24 at f32 (a production row of 72 is three
// tiles, F on 26 elements for 24 owned), 8 at f64, whose stages would not
// fit in shared memory at 24.  bridge_out exchanges none, and each of its
// warps owns its element, 72 = 3 x 24 at f32 bf16x3 (ELEMS 22: 768 threads
// at <= 80 registers), 72 = 4 x 18 at exact f32 (ELEMS 16: 576 threads at
// <= 112 registers; its FMA chain spills at 80), 10 at f64.
template <typename T, bool X3, int MODE>
constexpr int step_elems() {
  return sizeof(T) == 8 ? 8 : MODE != BRIDGE_OUT ? 24 : X3 ? 22 : 16;
}
template <int MODE, int ELEMS>
__host__ __device__ constexpr int owned_elems() {
  return MODE == BRIDGE_OUT ? ELEMS + 2 : ELEMS;
}
// a side buffer row (one boundary point of one slot) of the bf16x3 step:
// TILE columns and 8 spare values, so one store or read hits distinct banks;
// a stage row TILE columns and 4 spare values, so the fragment-order reads
// of one warp hit distinct banks
constexpr int X3_STRIDE = TILE + 8;
constexpr int STAGE_STRIDE = TILE + 4;
// a warp's stage: its element's 16 points, then the row above's i = np-1
// points and the row below's i = 0 points (ipass), then two buffers of the
// element's operator (256 values) and inverse mass (16)
constexpr int STAGE_ROWS = NPTS + 2 * NP;
constexpr int OP_BUF = NPTS * NPTS + NPTS;
constexpr int WARP_STAGE = STAGE_ROWS * STAGE_STRIDE + 2 * OP_BUF;
// bridge_in from the state's own layout stages its tile as it lies, a row of
// the stage a column (its 16 points) and spare values, so a warp's reads hit
// distinct banks: the exact and f64 forms bih::col_stride (each thread its
// column as 16-byte reads), bf16x3 24 (the fragment's point pairs as 8-byte
// reads, a half warp's sixteen over all 32 banks)
template <typename T, bool X3>
__host__ __device__ constexpr int nat_stride() {
  return X3 ? 24 : bih::col_stride<T>();
}

// Shared memory of the step, in values of T: the warps' stages [SLOTS]
// [WARP_STAGE] (warp y's is its own), then, where the mode has a j
// exchange, the side buffers [2][side][SLOTS][NP][stride] (side 0 the j = 0
// points, side 1 the j = np-1 points; the bf16x3 form starts side 1 16
// values on, half the banks away).
template <typename T, bool X3, int ELEMS, int MODE>
struct StepSmem {
  static constexpr int SLOTS = ELEMS + 2;
  static constexpr int STRIDE = X3 ? X3_STRIDE : TILE;
  static constexpr int SIDE = SLOTS * NP * STRIDE + (X3 ? 16 : 0);
  static constexpr size_t BYTES =
      sizeof(T) * (SLOTS * WARP_STAGE + (MODE == BRIDGE_OUT ? 0 : 4 * SIDE));
};

// op (ex*ey,16,16): A, or A^2 for a precomposed step; w (ex*ey,16) (bridge_in
// reads none); in/out/tmp (ex*ey,16,ncol); in the padded mode the row counts
// above.  MODE: STEP t' = jpass(F(ipass(t).w)), BRIDGE_IN t = jpass(A q),
// BRIDGE_OUT q = A(ipass(t).w).  Persistent: block b takes tiles b, b +
// gridDim.x, ... of (element row a, owned_elems elements from b0, TILE
// columns), ct fastest, and each warp copies what it needs of the next tile
// of the step (its rows of in, the i-neighbours' boundary rows where the
// mode has an ipass, its operator and inverse mass) into its own stage
// (cp.async) while it computes this one, so a tile takes one barrier (the j
// exchange, through double-buffered side buffers) or, in bridge_out, none;
// nsteps > 1 only for the step, under a cooperative launch.  A deep launch
// reads, in later steps, the out and tmp it writes, so no pointer into them
// is __restrict__, and no copy reaches across the grid sync.  NAT (bridge_in
// only): in is the state's own (e, q, k, i, j) layout, a tile's TILE columns
// of one element one contiguous span, staged as it lies at nat_stride.
template <typename T, bool X3, bool SQ, int ELEMS, int MODE, bool NAT = false>
__global__ void __launch_bounds__(TILE * (ELEMS + 2))
step_kernel(const T* __restrict__ op, const T* __restrict__ w,
            const T* __restrict__ in, T* out, T* tmp, Torus g, int nsteps) {
  using S = StepSmem<T, X3, ELEMS, MODE>;
  constexpr int NS = nat_stride<T, X3>();
  static_assert(!NAT || (MODE == BRIDGE_IN && TILE * NS <= STAGE_ROWS * STAGE_STRIDE),
                "the natural stage is bridge_in's and fits in the warp's stage rows");
  constexpr int OWN = owned_elems<MODE, ELEMS>();
  constexpr int FIRST = MODE == BRIDGE_OUT ? 0 : 1;  // the first owned slot
  constexpr bool IPASS = MODE != BRIDGE_IN;  // i-neighbours' rows, times w
  constexpr bool JPASS = MODE != BRIDGE_OUT;  // the j exchange
  constexpr int APPLIES = MODE == STEP && !SQ ? 2 : 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int y = threadIdx.y, lane = threadIdx.x;
  T* stage = smem + y * WARP_STAGE;
  T* opbuf = stage + STAGE_ROWS * STAGE_STRIDE;  // [2][OP_BUF]
  T* sides = smem + S::SLOTS * WARP_STAGE;
  const int chunks = (g.ey + OWN - 1) / OWN;
  const int ctiles = (g.ncol + TILE - 1) / TILE;
  int buf = 0;  // the side buffers and operator buffer this tile uses

  for (int s = 0; s < nsteps; ++s) {
    const Pass<T> ps = pass_of(s, nsteps, in, out, tmp, g);
    const long ntiles = (long)ps.rows * chunks * ctiles;
    // the tile's coordinates: column tile, first owned element, in's row
    auto coords = [&](long tile, int& ct, int& b0, int& a) {
      ct = static_cast<int>(tile % ctiles);
      const long rest = tile / ctiles;
      b0 = static_cast<int>(rest % chunks) * OWN;
      a = ps.r0 + static_cast<int>(rest / chunks);
    };
    // warp y's stage for `tile`: this lane's column of its rows of in, and
    // its operator and inverse mass into operator buffer `into`
    auto prefetch = [&](long tile, int into) {
      if (tile >= ntiles) return;
      int ct, b0, a;
      coords(tile, ct, b0, a);
      const int b = wrap(b0 - FIRST + y, g.ey);
      const int c = ct * TILE + lane;
      const bool live = c < g.ncol;
      const int cc = live ? c : 0;
      if constexpr (NAT) {
        // the tile's columns of element (a, b): one contiguous span
        bih::stage_columns(stage, NS,
                           ps.src + (((size_t)a * g.ey + b) * g.ncol + ct * TILE) * NPTS,
                           TILE, g.ncol - ct * TILE, lane, TILE);
      } else {
        const T* own = ps.src + ((size_t)a * g.ey + b) * NPTS * g.ncol + cc;
#pragma unroll
        for (int p = 0; p < NPTS; ++p)
          bih::cp_async<sizeof(T)>(stage + p * STAGE_STRIDE + lane,
                                   own + (size_t)p * g.ncol, live);
      }
      if constexpr (IPASS) {
        int au, ad;
        ineighbours(a, g, au, ad);
        const T* up = ps.src + ((size_t)au * g.ey + b) * NPTS * g.ncol + cc;
        const T* down = ps.src + ((size_t)ad * g.ey + b) * NPTS * g.ncol + cc;
#pragma unroll
        for (int j = 0; j < NP; ++j) {
          bih::cp_async<sizeof(T)>(stage + (NPTS + j) * STAGE_STRIDE + lane,
                                   up + (size_t)(NPTS - NP + j) * g.ncol, live);
          bih::cp_async<sizeof(T)>(stage + (NPTS + NP + j) * STAGE_STRIDE + lane,
                                   down + (size_t)j * g.ncol, live);
        }
      }
      // the operator and inverse mass as 16-byte pieces
      const size_t eo = (size_t)(a - ps.op_off) * g.ey + b;
      constexpr int PER16 = 16 / sizeof(T);
      T* ob = opbuf + into * OP_BUF;
      for (int i = lane * PER16; i < NPTS * NPTS; i += TILE * PER16)
        bih::cp_async16(ob + i, op + eo * NPTS * NPTS + i);
      if (IPASS && lane * PER16 < NPTS)
        bih::cp_async16(ob + NPTS * NPTS + lane * PER16, w + eo * NPTS + lane * PER16);
      bih::cp_async_commit();
    };

    prefetch(blockIdx.x, buf);
    for (long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
      int ct, b0, a;
      coords(tile, ct, b0, a);
      const int n_own = g.ey - b0 < OWN ? g.ey - b0 : OWN;
      const int b = wrap(b0 - FIRST + y, g.ey);
      // with the j exchange slots 1..n_own are owned and 0 and n_own + 1
      // their outer neighbours; without it slots 0..n_own-1 are owned
      const bool owned = y >= FIRST && y < FIRST + n_own;
      const bool need = JPASS ? y <= n_own + 1 : owned;
      const size_t ed = (size_t)(a - ps.dst_off) * g.ey + b;  // in dst
      T* side = sides + buf * 2 * S::SIDE;
      const T* opc = opbuf + buf * OP_BUF;  // this tile's operator, then w
      const T* wc = opc + NPTS * NPTS;
      bih::cp_async_wait();
      __syncwarp();
      if constexpr (X3) {
        // lane (gq, t): points pt(t, k) of columns c0 + 16m + 8r (k = 4r+q)
        using bih::tc::pt;
        constexpr int MT = TILE / bih::tc::MCOLS;
        const int gq = lane >> 2, t = lane & 3;
        float x[MT][8];
        if constexpr (NAT) {
          // the points pt(t, q) of column 16m + 8r + gq: pairs 2t + 8h, 2t
          // + 8h + 1 (q = 2h, 2h + 1) as 8-byte reads from its stage row
#pragma unroll
          for (int m = 0; m < MT; ++m)
#pragma unroll
            for (int r = 0; r < 2; ++r)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const float2 v = *reinterpret_cast<const float2*>(
                    stage + (16 * m + 8 * r + gq) * NS + 2 * t + 8 * h);
                x[m][4 * r + 2 * h] = v.x;
                x[m][4 * r + 2 * h + 1] = v.y;
              }
        } else {
          // d = ipass(t) * w: lanes t < 2 hold i = 0 points (q = 0, 1) and add
          // the row above's i = np-1 points; t >= 2 hold i = np-1 points (q =
          // 2, 3) and add the row below's i = 0 points
#pragma unroll
          for (int m = 0; m < MT; ++m)
#pragma unroll
            for (int k = 0; k < 8; ++k) {
              const int p = pt(t, k & 3), col = 16 * m + 8 * (k >> 2) + gq;
              float v = stage[p * STAGE_STRIDE + col];
              if constexpr (IPASS) {
                if ((t < 2) == ((k & 3) < 2))
                  v += stage[(t < 2 ? NPTS + p : NPTS + NP + p - (NPTS - NP)) * STAGE_STRIDE
                             + col];
                v *= wc[p];
              }
              x[m][k] = v;
            }
        }
        const bih::tc::Op F = bih::tc::load_op(opc);
        __syncwarp();  // every lane has read the stage before it is refilled
        prefetch(tile + gridDim.x, buf ^ 1);
        if (need) {
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            if constexpr (APPLIES == 2) bih::tc::apply(F, x[m]);
            bih::tc::apply(F, x[m]);
            if constexpr (JPASS)
              bih::tc::put_jside(x[m], side + (t & 1) * S::SIDE + y * NP * S::STRIDE,
                                 S::STRIDE, 16 * m + gq);
          }
        }
        if constexpr (JPASS) __syncthreads();  // the other buffer serves the next tile
        if (owned) {
          const int c0 = ct * TILE + gq;
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            if constexpr (JPASS) {
              // jpass: j = 0 points gain the left slot's j = np-1 points, j =
              // np-1 points the right slot's j = 0 points
              const T* nb = side + (1 - (t & 1)) * S::SIDE
                            + ((t & 1) ? y + 1 : y - 1) * NP * S::STRIDE;
              bih::tc::add_jside(x[m], nb, S::STRIDE, 16 * m + gq);
            }
#pragma unroll
            for (int k = 0; k < 8; ++k) {
              const int c = c0 + bih::tc::MCOLS * m + 8 * (k >> 2);
              if (c < g.ncol) ps.dst[(ed * NPTS + pt(t, k & 3)) * g.ncol + c] = x[m][k];
            }
          }
        }
      } else {
        // d = ipass(t) * w: the i = 0 points gain the row above's, then the
        // i = np-1 points the row below's, as the plain version sums
        T u[NPTS];
        if constexpr (NAT) {
          bih::load_column(stage + lane * NS, u);
        } else {
#pragma unroll
          for (int p = 0; p < NPTS; ++p) u[p] = stage[p * STAGE_STRIDE + lane];
        }
        if constexpr (IPASS) {
#pragma unroll
          for (int j = 0; j < NP; ++j) {
            u[j] += stage[(NPTS + j) * STAGE_STRIDE + lane];
            u[NPTS - NP + j] += stage[(NPTS + NP + j) * STAGE_STRIDE + lane];
          }
        }
        __syncwarp();  // every lane has read the stage before it is refilled
        prefetch(tile + gridDim.x, buf ^ 1);
        const int c = ct * TILE + lane;
        const bool live = c < g.ncol;
        if (need) {
          if constexpr (IPASS) {
#pragma unroll
            for (int p = 0; p < NPTS; ++p) u[p] *= wc[p];
          }
          // F: A twice, or A^2 once; a loop, not unrolled (unrolled, the
          // two applications of the A.A form spill or run short of registers)
#pragma unroll 1
          for (int r = 0; r < APPLIES; ++r) bih::apply<T, false>(opc, 0, u);
          if constexpr (JPASS) {
#pragma unroll
            for (int i = 0; i < NP; ++i) {
              side[(y * NP + i) * TILE + lane] = u[i * NP];
              side[S::SIDE + (y * NP + i) * TILE + lane] = u[i * NP + NP - 1];
            }
          }
        }
        if constexpr (JPASS) __syncthreads();  // the other buffer serves the next tile
        if (owned && live) {
          if constexpr (JPASS) {
#pragma unroll
            for (int i = 0; i < NP; ++i) {
              u[i * NP] += side[S::SIDE + ((y - 1) * NP + i) * TILE + lane];
              u[i * NP + NP - 1] += side[((y + 1) * NP + i) * TILE + lane];
            }
          }
#pragma unroll
          for (int p = 0; p < NPTS; ++p) ps.dst[(ed * NPTS + p) * g.ncol + c] = u[p];
        }
      }
      buf ^= 1;
    }
    if (s + 1 < nsteps) cooperative_groups::this_grid().sync();
  }
}

template <typename T, bool X3, bool SQ, int ELEMS, int MODE, bool NAT = false>
int launch_step(const T* op, const T* w, const T* in, T* out, T* tmp, Torus g,
                int nsteps, cudaStream_t st) {
  auto kern = step_kernel<T, X3, SQ, ELEMS, MODE, NAT>;
  constexpr size_t smem = StepSmem<T, X3, ELEMS, MODE>::BYTES;
  constexpr int THREADS = TILE * (ELEMS + 2);
  constexpr int OWN = owned_elems<MODE, ELEMS>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  // persistent: as many blocks as are resident at once (every block
  // resident is also what the cooperative launch of a deep step needs)
  int dev, sms, per_sm;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, THREADS, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // the first step's rows: the most tiles of any step
  const long ntiles = (long)(g.pad ? g.ex + 2 * g.pad - 2 : g.ex)
                      * ((g.ey + OWN - 1) / OWN) * ((g.ncol + TILE - 1) / TILE);
  const long cap = (long)sms * per_sm;
  const unsigned blocks = static_cast<unsigned>(ntiles < cap ? ntiles : cap);
  if (nsteps == 1) {
    kern<<<blocks, dim3(TILE, ELEMS + 2), smem, st>>>(op, w, in, out, tmp, g, nsteps);
    return static_cast<int>(cudaGetLastError());
  }
  void* args[] = {&op, &w, &in, &out, &tmp, &g, &nsteps};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kern), dim3(blocks),
                                    dim3(TILE, ELEMS + 2), args, smem, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool X3>
int dispatch(int mode, int sq, const void* op, const void* w, const void* in,
             void* out, void* tmp, int ex, int ey, int ncol, int nsteps,
             int pad, int out_pad, int natural, void* stream) {
  if (ex < 1 || ey < 1 || ncol < 1 || nsteps < 1 || (mode != STEP && nsteps != 1)
      || (nsteps > 1 && tmp == nullptr) || pad < 0
      || (pad > 0 && (mode == BRIDGE_IN || pad != nsteps || (nsteps > 1 && !out_pad)))
      || (natural && mode != BRIDGE_IN))
    return static_cast<int>(cudaErrorInvalidValue);
  const Torus g{ex, ey, ncol, pad, pad > 0 && out_pad};
  const T* op_ = static_cast<const T*>(op);
  const T* w_ = static_cast<const T*>(w);
  const T* in_ = static_cast<const T*>(in);
  T* out_ = static_cast<T*>(out);
  T* tmp_ = static_cast<T*>(tmp);
  auto st = static_cast<cudaStream_t>(stream);
  constexpr int E = step_elems<T, X3, STEP>();
  switch (mode) {
    case STEP:
      return sq ? launch_step<T, X3, true, E, STEP>(op_, w_, in_, out_, tmp_, g, nsteps, st)
                : launch_step<T, X3, false, E, STEP>(op_, w_, in_, out_, tmp_, g, nsteps, st);
    case BRIDGE_IN:
      return natural
                 ? launch_step<T, X3, false, E, BRIDGE_IN, true>(op_, w_, in_, out_, tmp_, g,
                                                                 1, st)
                 : launch_step<T, X3, false, E, BRIDGE_IN>(op_, w_, in_, out_, tmp_, g, 1, st);
    case BRIDGE_OUT:
      return launch_step<T, X3, false, step_elems<T, X3, BRIDGE_OUT>(), BRIDGE_OUT>(
          op_, w_, in_, out_, tmp_, g, 1, st);
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
// when nsteps > 1), else (ex*ey,16,ncol).  natural (bridge_in only): in is
// the state's own (ex*ey,q,k,4,4) with ncol = q*k, 16-byte aligned.  Returns
// the launch's CUDA error code.
int cdk_rowchain_f32(int mode, const void* op, const void* w, const void* in,
                     void* out, void* tmp, int ex, int ey, int ncol,
                     int nsteps, int pad, int out_pad, int natural, int x3,
                     int sq, void* stream) {
  return x3 ? dispatch<float, true>(mode, sq, op, w, in, out, tmp, ex, ey, ncol, nsteps,
                                    pad, out_pad, natural, stream)
            : dispatch<float, false>(mode, sq, op, w, in, out, tmp, ex, ey, ncol, nsteps,
                                     pad, out_pad, natural, stream);
}

int cdk_rowchain_f64(int mode, const void* op, const void* w, const void* in,
                     void* out, void* tmp, int ex, int ey, int ncol,
                     int nsteps, int pad, int out_pad, int natural, int sq,
                     void* stream) {
  return dispatch<double, false>(mode, sq, op, w, in, out, tmp, ex, ey, ncol,
                                 nsteps, pad, out_pad, natural, stream);
}

}  // extern "C"
