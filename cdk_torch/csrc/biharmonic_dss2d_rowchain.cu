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
// Two kernels.  sweep_kernel is the step (K16, K18, K16p, K18p); step_kernel
// the two bridges (K15; K17 and its padded K17p).
//
// The step: a row sweep.  A block owns one j-chunk of a row (ELEMS
// elements, 24 at f32 and 8 at f64, and a halo element on each side: a
// production row of 72 is three chunks, F on 26 elements for 24 owned,
// 1.08x; the halo's bytes come mostly from L2, where the neighbour chunk's
// block, walking beside it, has just read them) and walks down a range of
// (column tile, row) units, TILE = 32 columns a tile, row by row: a band is
// the range's run of rows in one column tile.  Row a's ipass needs row a-1's
// i = np-1 points and row a+1's i = 0 points; the block holds both, the raw
// i = np-1 points of the row it just read (the carry, in shared memory) and
// row a+1 as the next stage it has loaded for its own turn, so a t value is
// read from device memory once a step.  Only the two rows just outside a
// band come in as quarters (their 4 boundary points).  One producer warp
// keeps the loads in flight: each slot's TILE x 16 box of t by TMA
// (cp.async.bulk.tensor through a 3-D map (ncol, 16, e); in the bf16x3 form
// the 128-byte rows land with the 128-byte swizzle, so the fragment-order
// reads hit distinct banks) into a ring of RING row stages (3 at f32, 4 at
// f64), each slot's operator and inverse mass by cp.async.bulk into a ring
// of two operator stages, completion on mbarriers; a row's t stage goes out
// a row ahead of the row above's operator stage, so no load waits on a
// compute.  Thirteen consumer warps (five at f64) of two slots each wait on
// those barriers only: a row takes two named barriers among them (the j
// exchange, in place in the stage, and its write-back) and none that stops
// the producer.  Each consumer computes its slots' ipass(t).w and F one slot
// at a time (bf16x3 on the tensor cores, bih::tc, every address a per-lane
// base and an immediate; exact and f64 a thread a column, the FMA chain in
// its order, bit for bit the plain version), writes the result into the
// slot, adds its neighbours' j points, and hands the owned slots to bulk
// tensor stores (cp.async.bulk.tensor, shared to global), waiting only for
// them to read the slots before it frees the stage.  Where the field's rows
// are not 16-byte multiples (ncol * sizeof(T) % 16 != 0, off the cells'
// shapes) no map can describe them: the producer's lanes copy the same
// boxes with cp.async into the same layout, completing on the same
// barriers, and the consumers store with scalar stores.  Work order: the
// j-chunks' blocks walk side by side; the (column tile, row) units of a
// step go to `groups` of them, each group first whole column tiles (tile j
// * groups + group, so at a time the groups sweep adjacent column tiles down
// the same rows), then its share of the rest cut into equal contiguous
// ranges; groups = the SMs over the chunks, but no range under BAND rows:
// at the cells' size 132 blocks, 44 groups of 153 or 154 rows (two whole
// tiles of 75 and three or four rows of the last two), so the tail is under
// one row in 153 and the quarters add ~1 % to the bytes read.  Depth k
// (K18): k chained steps in one cooperative launch, the grid synchronised
// between steps and t ping-ponged between `out` and a scratch buffer; each
// step is the same arithmetic as a depth-1 launch, so the result equals k
// depth-1 launches bit for bit.  The padded mode walks the step's rows with
// no wrap.
//
// The bridges: a tile is TILE columns of ELEMS + 2 consecutive elements of
// one element row, a warp each.  In bridge_in the ELEMS inner warps own
// their elements and the two outer ones are their halo (warp y takes element
// b0 - 1 + y mod ey): each warp computes A q of its element, writes its j = 0
// and j = np-1 output points to shared memory and, after one barrier, the
// owned warps add their neighbours' points and store.  bridge_out reads the
// i-neighbours' boundary rows, applies A once and stores, with no exchange
// and no barrier, so each of its warps owns its element (warp y takes b0 +
// y).  Tiles at f32: bridge_in 24 owned (a production row of 72 is three
// tiles); bridge_out 24 in bf16x3 and 18 exact (ELEMS 22 and 16: at 24 warps
// its FMA chain spills); f64 8 (bridge_out 10).  The small tori of the tests
// (ey < ELEMS + 2) put one element in a tile more than once; each copy
// computes the same values and only the owned one is stored.  The blocks are
// persistent, one per SM, and each warp copies what it needs of its next
// tile (its rows of the input, the two i-neighbours' boundary rows in
// bridge_out, its operator and inverse mass) into its own part of shared
// memory with cp.async while it computes this one; the side buffers are
// double-buffered, so a tile takes one barrier.  The bf16x3 forms run on the
// tensor cores (the warp's 32 columns as two m-tiles, the operator's hi/lo B
// fragments in registers, the input read in fragment order); the exact and
// f64 forms keep one thread per column, the operator read from the warp's
// copy as 16-byte broadcasts.  The padded bridge_out (K17p) takes its
// i-neighbours from the pad rows through pass_of, with the arithmetic of
// K17, so with the torus's own rows as the pad it equals K17 bit for bit.
//
// Layouts.  The step and bridge_out, padded or not, read t in the lane layout
// (e, 16, ncol), p = 4i + j: a stage row is one point of TILE columns.
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
// (2 x 995 MB at f32 and the cells' qsize 40, 0.594 ms at 3.35 TB/s; a
// plain copy of the same bytes takes 0.66-0.69 ms on the H100); the
// operations, 256 FMAs per column per element and application (bf16x3:
// three tensor-core products plus ~80 f32 operations for the splits and
// sums), take less.  Every step makes one pass through device memory, so
// depth k saves launches, not passes: a depth-4 launch cannot go under four
// passes without blocking steps in time (not done: a row stage is 52 KB of a
// 32-column tile at f32, and a k-step wavefront needs k + 1 of them plus the
// quarters at each level, which do not fit in 227 KB at a useful tile).
// What holds the sweep back now: the consumers' row, about 10,000 cycles
// against the ~8,000 of its bytes at the copy's rate, whose compute, j
// exchange and handing off of the stores run in turn, behind two barriers,
// while one or two stages load (the ring's depth is what the operator
// stages and the carries leave of 227 KB).

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

#include "biharmonic_common.cuh"

namespace {

using bih::NP;
using bih::NPTS;
constexpr int TILE = 32;  // columns per tile (one warp)

enum Mode { BRIDGE_IN = 0, STEP = 1, BRIDGE_OUT = 2 };

// pad = 0: the whole (ex, ey) torus, rows mod ex; pad > 0: the padded mode
struct Torus {
  int ex, ey, ncol, pad, out_pad;
};

__host__ __device__ __forceinline__ int wrap(int i, int n) {
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

// Elements a warp's tile of each mode holds besides its two halo or spare
// warps: the step's and bridge_in's j-chunks carry one halo element on each
// side, 24 owned at f32 (a production row of 72 is three chunks, 1.08x), 8
// at f64, whose stages would not fit in shared memory at 24.  bridge_out
// exchanges none, and each of its warps owns its element, 72 = 3 x 24 at
// f32 bf16x3 (ELEMS 22: 768 threads at <= 80 registers), 72 = 4 x 18 at
// exact f32 (ELEMS 16: 576 threads at <= 112 registers; its FMA chain spills
// at 80), 10 at f64.
template <typename T, bool X3, int MODE>
constexpr int step_elems() {
  return sizeof(T) == 8 ? 8 : MODE != BRIDGE_OUT ? 24 : X3 ? 22 : 16;
}

// ---- the bridges: one warp per element of a row tile ----------------------

template <int MODE, int ELEMS>
__host__ __device__ constexpr int owned_elems() {
  return MODE == BRIDGE_OUT ? ELEMS + 2 : ELEMS;
}
// a side buffer row (one boundary point of one slot) of the bf16x3 bridge_in:
// TILE columns and 8 spare values, so one store or read hits distinct banks;
// a stage row TILE columns and 4 spare values, so the fragment-order reads
// of one warp hit distinct banks
constexpr int X3_STRIDE = TILE + 8;
constexpr int STAGE_STRIDE = TILE + 4;
// a warp's stage: its element's 16 points, then the row above's i = np-1
// points and the row below's i = 0 points (bridge_out's ipass), then two
// buffers of the element's operator (256 values) and inverse mass (16)
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

// Shared memory of a bridge, in values of T: the warps' stages [SLOTS]
// [WARP_STAGE] (warp y's is its own), then, in bridge_in, the side buffers
// [2][side][SLOTS][NP][stride] (side 0 the j = 0 points, side 1 the j = np-1
// points; the bf16x3 form starts side 1 16 values on, half the banks away).
template <typename T, bool X3, int ELEMS, int MODE>
struct StepSmem {
  static constexpr int SLOTS = ELEMS + 2;
  static constexpr int STRIDE = X3 ? X3_STRIDE : TILE;
  static constexpr int SIDE = SLOTS * NP * STRIDE + (X3 ? 16 : 0);
  static constexpr size_t BYTES =
      sizeof(T) * (SLOTS * WARP_STAGE + (MODE == BRIDGE_OUT ? 0 : 4 * SIDE));
};

// op (ex*ey,16,16): A; w (ex*ey,16) (bridge_in reads none); in/out
// (ex*ey,16,ncol); in the padded mode the row counts above.  MODE: BRIDGE_IN
// t = jpass(A q), BRIDGE_OUT q = A(ipass(t).w).  Persistent: block b takes
// tiles b, b + gridDim.x, ... of (element row a, owned_elems elements from
// b0, TILE columns), ct fastest, and each warp copies what it needs of the
// next tile (its rows of in, the i-neighbours' boundary rows in bridge_out,
// its operator and inverse mass) into its own stage (cp.async) while it
// computes this one, so a tile takes one barrier (bridge_in's j exchange,
// through double-buffered side buffers) or, in bridge_out, none.  NAT
// (bridge_in only): in is the state's own (e, q, k, i, j) layout, a tile's
// TILE columns of one element one contiguous span, staged as it lies at
// nat_stride.
template <typename T, bool X3, int ELEMS, int MODE, bool NAT = false>
__global__ void __launch_bounds__(TILE * (ELEMS + 2))
step_kernel(const T* __restrict__ op, const T* __restrict__ w,
            const T* __restrict__ in, T* out, Torus g) {
  using S = StepSmem<T, X3, ELEMS, MODE>;
  constexpr int NS = nat_stride<T, X3>();
  static_assert(!NAT || (MODE == BRIDGE_IN && TILE * NS <= STAGE_ROWS * STAGE_STRIDE),
                "the natural stage is bridge_in's and fits in the warp's stage rows");
  constexpr int OWN = owned_elems<MODE, ELEMS>();
  constexpr int FIRST = MODE == BRIDGE_OUT ? 0 : 1;  // the first owned slot
  constexpr bool IPASS = MODE == BRIDGE_OUT;  // i-neighbours' rows, times w
  constexpr bool JPASS = MODE == BRIDGE_IN;  // the j exchange
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int y = threadIdx.y, lane = threadIdx.x;
  T* stage = smem + y * WARP_STAGE;
  T* opbuf = stage + STAGE_ROWS * STAGE_STRIDE;  // [2][OP_BUF]
  T* sides = smem + S::SLOTS * WARP_STAGE;
  const int chunks = (g.ey + OWN - 1) / OWN;
  const int ctiles = (g.ncol + TILE - 1) / TILE;
  int buf = 0;  // the side buffers and operator buffer this tile uses

  const Pass<T> ps = pass_of(0, 1, in, out, out, g);
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
        bih::apply<T, false>(opc, 0, u);
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
}

template <typename T, bool X3, int ELEMS, int MODE, bool NAT = false>
int launch_bridge(const T* op, const T* w, const T* in, T* out, Torus g, cudaStream_t st) {
  auto kern = step_kernel<T, X3, ELEMS, MODE, NAT>;
  constexpr size_t smem = StepSmem<T, X3, ELEMS, MODE>::BYTES;
  constexpr int THREADS = TILE * (ELEMS + 2);
  constexpr int OWN = owned_elems<MODE, ELEMS>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  // persistent: as many blocks as are resident at once
  int dev, sms, per_sm;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, THREADS, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long ntiles = (long)g.ex * ((g.ey + OWN - 1) / OWN) * ((g.ncol + TILE - 1) / TILE);
  const long cap = (long)sms * per_sm;
  const unsigned blocks = static_cast<unsigned>(ntiles < cap ? ntiles : cap);
  kern<<<blocks, dim3(TILE, ELEMS + 2), smem, st>>>(op, w, in, out, g);
  return static_cast<int>(cudaGetLastError());
}

// ---- the step: a row sweep, a producer warp and consumer warps ----------

// the fewest rows a block's range of a step covers, where the step has them
constexpr int BAND = 16;

// The sweep's geometry for values of T: the j-chunk (ELEMS owned and SLOTS
// with the halo, two to a consumer warp), a slot of a t stage (TILE columns of
// the element's 16 points, 2 KB at f32; in the bf16x3 form 128-byte rows
// with the 128-byte swizzle), a slot of an operator stage (A or A^2, then w), a
// slot's carry (the raw i = np-1 points of the row it read last, laid out as
// the first NP rows of a t slot), and the ring depths: two operator stages
// and as many t stages as the rest of the 227 KB holds, up to four (three at
// f32, four at f64).
template <typename T>
struct Sweep {
  static constexpr int ELEMS = step_elems<T, false, STEP>();
  static constexpr int SLOTS = ELEMS + 2;
  // slots a consumer warp: a warp a slot leaves 72 registers a thread at
  // f32, under what a consumer needs (both forms spill there), so two
  static constexpr int SPW = 2;
  static constexpr int WARPS = SLOTS / SPW;     // consumer warps, and a producer
  static_assert(SLOTS % SPW == 0, "whole warps");
  static constexpr int THREADS = TILE * (WARPS + 1);
  static constexpr int SLOT = NPTS * TILE;
  static constexpr int OPS = NPTS * NPTS + NPTS;
  static constexpr int OP_RING = 2;
  static constexpr size_t T_STAGE = sizeof(T) * SLOTS * SLOT;
  static constexpr size_t OP_STAGE = sizeof(T) * SLOTS * OPS;
  static constexpr size_t CARRY = sizeof(T) * SLOTS * NP * TILE;
  static constexpr size_t BARS = 256;     // the mbarriers
  static constexpr size_t ALIGN = 1024;   // the swizzle's span, for the ring's start
  static constexpr int FIT = (232448 - ALIGN - BARS - CARRY - OP_RING * OP_STAGE) / T_STAGE;
  static constexpr int RING = FIT < 4 ? FIT : 4;
  static_assert(RING >= 3, "a row, its next and one more in flight");
  static constexpr size_t BYTES = ALIGN + RING * T_STAGE + OP_RING * OP_STAGE + CARRY + BARS;
};

// value (p, col) of a t slot: with SWZ (the bf16x3 form, whose fragment-order
// reads would otherwise take four lanes to a bank) the 16-byte piece col / 4
// of row p lies at piece col / 4 ^ p % 8 (the 128-byte swizzle, as TMA
// writes it); else as it is (a thread a column reads distinct banks)
template <bool SWZ>
__device__ __forceinline__ int at(int p, int col) {
  return SWZ ? p * TILE + ((((col >> 2) ^ p) & 7) << 2) + (col & 3) : p * TILE + col;
}

// the t maps of in, out and tmp (index 0, 1, 2): an element's 16 points of
// TILE columns, and its 4 points of one i row
struct alignas(64) Maps {
  CUtensorMap rows[3], quarter[3];
};

__device__ __forceinline__ unsigned sh(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void bar_init(uint64_t* b, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(sh(b)), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(sh(b)) : "memory");
}
// arrive, and expect `bytes` more of the copies that complete on b
__device__ __forceinline__ void bar_expect(uint64_t* b, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(sh(b)),
               "r"(bytes)
               : "memory");
}
// until the phase of parity `parity` of b has completed
__device__ __forceinline__ void bar_wait(uint64_t* b, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(sh(b)), "r"(parity)
        : "memory");
  } while (!done);
}
// the box of `map` at (column c, point p, element e) into dst, completing on b
__device__ __forceinline__ void tma_box(void* dst, const CUtensorMap* map, int c, int p, int e,
                                        uint64_t* b) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(sh(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(p), "r"(e), "r"(sh(b))
      : "memory");
}
// `bytes` (a multiple of 16; both ends 16-byte aligned) from src into dst,
// completing on b
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          uint64_t* b) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(sh(dst)),
      "l"(src), "r"(bytes), "r"(sh(b))
      : "memory");
}
// the box of `map` at (column c, point p, element e) from src, in this
// thread's bulk group; the group's commit and waits
__device__ __forceinline__ void tma_store(const CUtensorMap* map, const void* src, int c, int p,
                                          int e) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(sh(src)), "r"(c), "r"(p), "r"(e)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// this thread's bulk stores have read their sources
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// ... and written their destinations
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// b's phase also waits for this thread's cp.async copies so far
__device__ __forceinline__ void cp_async_arrive(uint64_t* b) {
  asm volatile("cp.async.mbarrier.arrive.shared::cta.b64 [%0];\n" ::"r"(sh(b)) : "memory");
}
// the consumer warps' barrier (the producer never waits at it)
__device__ __forceinline__ void consumers_sync(int threads) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(threads) : "memory");
}

// op (e,16,16): A, or A^2 with SQ; w (e,16); in/out/tmp (e,16,ncol), in the
// padded mode the row counts above.  t' = jpass(F(ipass(t).w)), nsteps
// chained steps (a cooperative launch where nsteps > 1).  Item (group,
// chunk) goes to block item mod gridDim.x.  A group's bands: the column
// tiles j * groups + group, each whole (so the groups' blocks walk adjacent
// column tiles down the same rows side by side), then its share of the
// remaining column tiles' (column tile, row) units, cut into `groups` equal
// contiguous ranges.  Warps 0 .. WARPS-1 consume, warp c the slots c + WARPS
// * i (i < SPW), slot y holding element b0 - 1 + y mod ey; warp WARPS
// produces.  The producer and the consumers walk the same items, bands and
// rows, and count the stages they start or take (nt, no), whose slot and
// phase follow from the count; the producer starts a row's t stage before
// the row above's operator stage, so no t stage waits on an operator stage
// that the row before it frees.  tma: the rows of in, out and tmp are
// 16-byte multiples and start 16-byte aligned, so maps describe them and the
// stores are 16 bytes wide; else the producer copies with cp.async and the
// stores are scalar.  A deep launch reads, in later steps, the out and tmp
// it writes, so no pointer into them is __restrict__.
template <typename T, bool X3, bool SQ>
__global__ void __launch_bounds__(Sweep<T>::THREADS, 1)
sweep_kernel(const T* __restrict__ op, const T* __restrict__ w, const T* in, T* out, T* tmp,
             Torus g, int nsteps, int groups, int tma, const __grid_constant__ Maps maps) {
  using S = Sweep<T>;
  constexpr int OWN = S::ELEMS, SPW = S::SPW;
  constexpr int APPLIES = SQ ? 1 : 2;
  constexpr int MT = TILE / bih::tc::MCOLS;
  constexpr int CONSUMERS = TILE * S::WARPS;
  constexpr bool SWZ = X3;  // the bf16x3 form's slots take the 128-byte swizzle
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw + ((S::ALIGN - (sh(smem_raw) & (S::ALIGN - 1)))
                                             & (S::ALIGN - 1)));
  T* opring = ring + S::RING * S::SLOTS * S::SLOT;
  T* carries = opring + S::OP_RING * S::SLOTS * S::OPS;  // [SLOTS][NP][TILE]
  uint64_t* full = reinterpret_cast<uint64_t*>(carries + S::SLOTS * NP * TILE);
  uint64_t* empty = full + S::RING;
  uint64_t* opfull = empty + S::RING;
  uint64_t* opempty = opfull + S::OP_RING;
  const int wp = threadIdx.y, lane = threadIdx.x;
  if (wp == 0 && lane == 0) {
    for (int i = 0; i < S::RING; ++i) {
      bar_init(full + i, 1);
      bar_init(empty + i, S::WARPS);
    }
    for (int i = 0; i < S::OP_RING; ++i) {
      bar_init(opfull + i, 1);
      bar_init(opempty + i, S::WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int chunks = (g.ey + OWN - 1) / OWN;
  const int ctiles = (g.ncol + TILE - 1) / TILE;
  const int whole = ctiles / groups;  // the column tiles each group walks whole
  unsigned nt = 0, no = 0;  // t and operator stages started (producer) or taken (consumers)

  for (int s = 0; s < nsteps; ++s) {
    const Pass<T> ps = pass_of(s, nsteps, in, out, tmp, g);
    const int src = ps.src == in ? 0 : ps.src == out ? 1 : 2;
    auto row_of = [&](int a) { return g.pad ? a : wrap(a, g.ex); };
    for (int item = blockIdx.x; item < groups * chunks; item += gridDim.x) {
      const int b0 = item % chunks * OWN, grp = item / chunks;
      const int n_own = g.ey - b0 < OWN ? g.ey - b0 : OWN;
      const int nslots = n_own + 2;

      // ---- the producer: the row above's quarter, the rows' t stages a row
      // ahead of their operator stages, the row below's quarter
      auto load_t = [&](int ct, int row, int p0, int npts) {
        const int slot = static_cast<int>(nt % S::RING);
        if (lane == 0) bar_wait(empty + slot, ((nt / S::RING) & 1) ^ 1);
        __syncwarp();
        T* dst = ring + slot * S::SLOTS * S::SLOT;
        const int c0 = ct * TILE;
        if (tma) {
          if (lane == 0) bar_expect(full + slot, nslots * npts * TILE * sizeof(T));
          __syncwarp();
          if (lane < nslots)
            tma_box(dst + lane * S::SLOT, npts == NPTS ? &maps.rows[src] : &maps.quarter[src],
                    c0, p0, row * g.ey + wrap(b0 - 1 + lane, g.ey), full + slot);
        } else {
          const bool live = c0 + lane < g.ncol;
          for (int z = 0; z < nslots; ++z) {
            const T* e = ps.src
                         + ((size_t)(row * g.ey + wrap(b0 - 1 + z, g.ey)) * NPTS + p0) * g.ncol
                         + (live ? c0 + lane : 0);
            for (int pp = 0; pp < npts; ++pp)
              bih::cp_async<sizeof(T)>(dst + z * S::SLOT + at<SWZ>(pp, lane),
                                       e + (size_t)pp * g.ncol, live);
          }
          cp_async_arrive(full + slot);
          __syncwarp();
          if (lane == 0) bar_arrive(full + slot);
        }
        ++nt;
      };
      auto load_ops = [&](int a) {
        const int slot = static_cast<int>(no % S::OP_RING);
        if (lane == 0) bar_wait(opempty + slot, ((no / S::OP_RING) & 1) ^ 1);
        __syncwarp();
        if (lane == 0) bar_expect(opfull + slot, nslots * S::OPS * sizeof(T));
        __syncwarp();
        if (lane < nslots) {
          const size_t eo = (size_t)(a - ps.op_off) * g.ey + wrap(b0 - 1 + lane, g.ey);
          T* d = opring + (slot * S::SLOTS + lane) * S::OPS;
          bulk_copy(d, op + eo * NPTS * NPTS, NPTS * NPTS * sizeof(T), opfull + slot);
          bulk_copy(d + NPTS * NPTS, w + eo * NPTS, NPTS * sizeof(T), opfull + slot);
        }
        ++no;
      };
      auto produce = [&](int ct, int a0, int n) {
        load_t(ct, row_of(a0 - 1), NPTS - NP, NP);
        load_t(ct, a0, 0, NPTS);
        for (int i = 0; i < n; ++i) {
          if (i + 1 < n)
            load_t(ct, a0 + i + 1, 0, NPTS);
          else
            load_t(ct, row_of(a0 + n), 0, NP);
          load_ops(a0 + i);
        }
      };

      // ---- the consumers: row a's d = ipass(t).w and F of each of the
      // warp's slots, in place, then the j exchange and the stores
      auto consume = [&](int ct, int a0, int n) {
        const int c0 = ct * TILE;
        // bf16x3: lane (gq, t) holds, at slot k = 4r + 2h + d of m-tile m,
        // point pt(t, 2h + d) = 2t + d + 8h of column 16m + 8r + gq, which
        // the swizzled slot keeps at z[2m + r][d] + 32d + 256h (z below); the
        // row 12 above, where t >= 2, at that less 128 + 16 (m = 0) or 112
        // (m = 1); the exchange's neighbour points at fixed offsets from z
        // too, so every address is a base and an immediate
        const int gq = lane >> 2, t = lane & 3;
        int z[4][2];
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int d = 0; d < 2; ++d)
            z[j][d] = 64 * t + 8 * (j ^ t) + 4 * ((gq >> 2) ^ d) + (gq & 3);
        {
          // the row above the band came as a quarter, its rows 0..3 holding
          // points 12..15: the carry
          const int slot = static_cast<int>(nt % S::RING);
          bar_wait(full + slot, (nt / S::RING) & 1);
#pragma unroll
          for (int i = 0; i < SPW; ++i) {
            const int y = wp + S::WARPS * i;
            const T* q = ring + (slot * S::SLOTS + y) * S::SLOT;
            T* carry = carries + y * NP * TILE;
            if (y < nslots) {
#pragma unroll
              for (int j = 0; j < NP; ++j) carry[at<SWZ>(j, lane)] = q[at<SWZ>(j, lane)];
            }
          }
          __syncwarp();
          if (lane == 0) bar_arrive(empty + slot);
          ++nt;
        }
        // a stage back to the producer, once this warp's writes to its slots
        // are done (and fenced for the copies that refill them)
        auto release = [&](int slot) {
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          __syncwarp();
          if (lane == 0) bar_arrive(empty + slot);
        };
        for (int row = 0; row < n; ++row) {
          const int a = a0 + row;
          const int sa = static_cast<int>(nt % S::RING);
          const int sn = static_cast<int>((nt + 1) % S::RING);
          const int so = static_cast<int>(no % S::OP_RING);
          bar_wait(full + sa, (nt / S::RING) & 1);
          bar_wait(full + sn, ((nt + 1) / S::RING) & 1);
          bar_wait(opfull + so, (no / S::OP_RING) & 1);
          // a slot at a time (interleaved, the two would spill)
#pragma unroll 1
          for (int i = 0; i < SPW; ++i) {
            const int y = wp + S::WARPS * i;
            if (y >= nslots) continue;
            T* cur = ring + (sa * S::SLOTS + y) * S::SLOT;
            const T* nxt = ring + (sn * S::SLOTS + y) * S::SLOT;
            const T* opc = opring + (so * S::SLOTS + y) * S::OPS;  // F, then w
            const T* wc = opc + NPTS * NPTS;
            T* carry = carries + y * NP * TILE;
            if constexpr (X3) {
              // lanes t < 2 hold the i = 0 points (h = 0) and add the carry,
              // lanes t >= 2 the i = np-1 points (h = 1), which they leave as
              // the next row's carry, and add the next row's i = 0 points
              float x[MT][8];
#pragma unroll
              for (int m = 0; m < MT; ++m)
#pragma unroll
                for (int k = 0; k < 8; ++k) {
                  const int d = k & 1, h = (k >> 1) & 1, o = z[2 * m + (k >> 2)][d] + 32 * d;
                  x[m][k] = cur[o + 256 * h];
                  if (h == 0 && t < 2) x[m][k] += carry[o];
                }
              __syncwarp();  // every carry read before it is rewritten
#pragma unroll
              for (int m = 0; m < MT; ++m)
#pragma unroll
                for (int k = 0; k < 8; ++k) {
                  const int d = k & 1, h = (k >> 1) & 1;
                  if (h == 1 && t >= 2) {
                    const int o = z[2 * m + (k >> 2)][d] + 32 * d - 128 + (m ? 16 : -16);
                    carry[o] = x[m][k];
                    x[m][k] += nxt[o];
                  }
                  x[m][k] *= wc[2 * t + d + 8 * h];
                }
              const bih::tc::Op F = bih::tc::load_op(opc);
#pragma unroll
              for (int m = 0; m < MT; ++m) {
                if constexpr (APPLIES == 2) bih::tc::apply(F, x[m]);
                bih::tc::apply(F, x[m]);
              }
              __syncwarp();  // every lane has read the slot before it is overwritten
#pragma unroll
              for (int m = 0; m < MT; ++m)
#pragma unroll
                for (int k = 0; k < 8; ++k) {
                  const int d = k & 1, h = (k >> 1) & 1;
                  cur[z[2 * m + (k >> 2)][d] + 32 * d + 256 * h] = x[m][k];
                }
            } else {
              // a thread a column: the i = 0 points gain the carry, the i =
              // np-1 points, left as the next row's carry, the next row's i =
              // 0 points, as the plain version sums
              T u[NPTS];
#pragma unroll
              for (int p = 0; p < NPTS; ++p) u[p] = cur[p * TILE + lane];
#pragma unroll
              for (int j = 0; j < NP; ++j) {
                u[j] += carry[j * TILE + lane];
                carry[j * TILE + lane] = u[NPTS - NP + j];
                u[NPTS - NP + j] += nxt[j * TILE + lane];
              }
#pragma unroll
              for (int p = 0; p < NPTS; ++p) u[p] *= wc[p];
              // F: A twice, or A^2 once; a loop, not unrolled (unrolled, the
              // two applications of the A.A form spill or run short of
              // registers)
#pragma unroll 1
              for (int r = 0; r < APPLIES; ++r) bih::apply<T, false>(opc, 0, u);
#pragma unroll
              for (int p = 0; p < NPTS; ++p) cur[p * TILE + lane] = u[p];
            }
          }
          __syncwarp();
          if (lane == 0) bar_arrive(opempty + so);
          ++no;
          consumers_sync(CONSUMERS);  // every slot holds F of its element
          // jpass: j = 0 points gain the left slot's j = np-1 points, j = np-1
          // points the right slot's j = 0 points; owned slots are 1 .. n_own
          T js[SPW][2 * NP];  // the lane's j boundary points, summed
#pragma unroll
          for (int i = 0; i < SPW; ++i) {
            const int y = wp + S::WARPS * i;
            if (y < 1 || y > n_own) continue;
            const T* cur = ring + (sa * S::SLOTS + y) * S::SLOT;
            const T* left = cur - S::SLOT;
            const T* right = cur + S::SLOT;
            if constexpr (X3) {
              // lane (gq, t) holds j = 0 points at d = 0 where t is even, j =
              // np-1 points at d = 1 where t is odd (k = 4r + 2h + t % 2): the
              // left slot's point p + 3, or the right slot's p - 3
#pragma unroll
              for (int m = 0; m < MT; ++m)
#pragma unroll
                for (int r = 0; r < 2; ++r)
#pragma unroll
                  for (int h = 0; h < 2; ++h) {
                    const int z0 = z[2 * m + r][0], z1 = z[2 * m + r][1];
                    js[i][4 * m + 2 * r + h] =
                        (t & 1) ? cur[z1 + 32 + 256 * h] + right[z0 - 64 + 256 * h + (r ? 8 : -8)]
                                : cur[z0 + 256 * h] + left[z1 + 96 + 256 * h + (r ? -8 : 8)];
                  }
            } else {
#pragma unroll
              for (int i2 = 0; i2 < NP; ++i2) {
                js[i][i2] = cur[i2 * NP * TILE + lane] + left[(i2 * NP + NP - 1) * TILE + lane];
                js[i][NP + i2] =
                    cur[(i2 * NP + NP - 1) * TILE + lane] + right[i2 * NP * TILE + lane];
              }
            }
          }
          consumers_sync(CONSUMERS);  // every neighbour read before the write-back
          bool stored = false;  // this warp owns a slot the bulk stores take
#pragma unroll
          for (int i = 0; i < SPW; ++i) {
            const int y = wp + S::WARPS * i;
            if (y < 1 || y > n_own) continue;
            T* cur = ring + (sa * S::SLOTS + y) * S::SLOT;
            if constexpr (X3) {
#pragma unroll
              for (int m = 0; m < MT; ++m)
#pragma unroll
                for (int r = 0; r < 2; ++r)
#pragma unroll
                  for (int h = 0; h < 2; ++h)
                    cur[(t & 1) ? z[2 * m + r][1] + 32 + 256 * h : z[2 * m + r][0] + 256 * h] =
                        js[i][4 * m + 2 * r + h];
            } else {
#pragma unroll
              for (int i2 = 0; i2 < NP; ++i2) {
                cur[i2 * NP * TILE + lane] = js[i][i2];
                cur[(i2 * NP + NP - 1) * TILE + lane] = js[i][NP + i2];
              }
            }
            if (tma) {
              stored = true;  // by one bulk store, below
              continue;
            }
            __syncwarp();
            // the slot to dst by the lanes, V values of one point row a lane
            constexpr int V = 16 / sizeof(T), PIECES = TILE / V;
            T* d = ps.dst + ((size_t)(a - ps.dst_off) * g.ey + wrap(b0 - 1 + y, g.ey)) * NPTS
                                * g.ncol
                   + c0;
#pragma unroll
            for (int k = lane; k < NPTS * PIECES; k += TILE) {
              const int p = k / PIECES, c = k % PIECES * V;
              const T* sp = cur + at<SWZ>(p, c);
              T* gp = d + (size_t)p * g.ncol + c;
              for (int v = 0; v < V; ++v)
                if (c0 + c + v < g.ncol) gp[v] = sp[v];
            }
          }
          if (stored) {
            // each owned slot to dst by one bulk store: the warp waits only
            // for the stores to read the slots, not on device memory
            asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
            __syncwarp();
            if (lane == 0) {
#pragma unroll
              for (int i = 0; i < SPW; ++i) {
                const int y = wp + S::WARPS * i;
                if (y >= 1 && y <= n_own)
                  tma_store(&maps.rows[ps.dst == out ? 1 : 2],
                            ring + (sa * S::SLOTS + y) * S::SLOT, c0, 0,
                            (a - ps.dst_off) * g.ey + wrap(b0 - 1 + y, g.ey));
              }
              bulk_commit();
              bulk_wait_read();
            }
            __syncwarp();
            if (lane == 0) bar_arrive(empty + sa);
          } else {
            release(sa);
          }
          ++nt;
        }
        // the row below the band, the last row's next
        release(static_cast<int>(nt % S::RING));
        ++nt;
      };

      // the group's bands: whole column tiles, then its share of the rest:
      // the rc column tiles left, their rows cut into nb bands of about the
      // rows a group takes there, in (band, column tile, row) order, cut
      // into `groups` equal contiguous ranges (so there too the groups walk
      // adjacent column tiles down the same rows)
      auto walk = [&](auto&& band) {
        for (int j = 0; j < whole; ++j) band(j * groups + grp, ps.r0, ps.rows);
        const int rc = ctiles - whole * groups;
        if (rc == 0) return;
        const int nb = (groups + rc - 1) / rc < ps.rows ? (groups + rc - 1) / rc : ps.rows;
        const long rest = (long)rc * ps.rows;
        const long hi = (grp + 1) * rest / groups;
        for (long u = grp * rest / groups; u < hi;) {
          // u's band b: rows lo .. lo + len - 1, its units from rc * lo
          int b = static_cast<int>(u / rc * nb / ps.rows);
          while (b + 1 < nb && (long)rc * ((b + 1) * ps.rows / nb) <= u) ++b;
          while ((long)rc * (b * ps.rows / nb) > u) --b;
          const int lo = b * ps.rows / nb, len = (b + 1) * ps.rows / nb - lo;
          const long v = u - (long)rc * lo;
          const int k = static_cast<int>(v / len);
          const long end = hi < (long)rc * lo + (k + 1L) * len ? hi : (long)rc * lo + (k + 1L) * len;
          band(whole * groups + k, ps.r0 + lo + static_cast<int>(v % len),
               static_cast<int>(end - u));
          u = end;
        }
      };
      if (wp == S::WARPS)
        walk(produce);
      else
        walk(consume);
    }
    bulk_wait();  // this block's bulk stores written
    if (s + 1 < nsteps) {
      // this step's stores before the next step's copies read them
      asm volatile("fence.proxy.async.global;\n" ::: "memory");
      cooperative_groups::this_grid().sync();
      asm volatile("fence.proxy.async.global;\n" ::: "memory");
    }
  }
}

// cuTensorMapEncodeTiled, from libcuda by the runtime's entry-point lookup (no -lcuda)
using Encode = decltype(&cuTensorMapEncodeTiled);

Encode encoder() {
  static const Encode fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<Encode>(p)
               : nullptr;
  }();
  return fn;
}

// the (ncol, 16, elems) map of t at `base`, boxes of TILE columns of `points`
// points of one element, with the 128-byte swizzle or none
template <typename T>
bool encode(CUtensorMap* map, const T* base, size_t elems, int ncol, int points, bool swizzle) {
  const Encode fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(ncol), NPTS, elems};
  const cuuint64_t strides[2] = {ncol * sizeof(T), NPTS * ncol * sizeof(T)};
  const cuuint32_t box[3] = {TILE, static_cast<cuuint32_t>(points), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn(map, sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_FLOAT64,
            3, const_cast<T*>(base), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE)
         == CUDA_SUCCESS;
}

template <typename T, bool X3, bool SQ>
int launch_sweep(const T* op, const T* w, const T* in, T* out, T* tmp, Torus g, int nsteps,
                 cudaStream_t st) {
  using S = Sweep<T>;
  auto kern = sweep_kernel<T, X3, SQ>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(S::BYTES));
  // persistent: every block resident at once (what the cooperative launch of
  // a deep step needs)
  int dev, sms, per_sm;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, S::THREADS, S::BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  // the ranges: as many as the chunks' blocks fill the SMs with, but none
  // under BAND rows of the first step's (the most) units
  const long chunks = (g.ey + S::ELEMS - 1) / S::ELEMS;
  const long units = (long)((g.ncol + TILE - 1) / TILE) * (g.pad ? g.ex + 2 * g.pad - 2 : g.ex);
  const long cap = (long)sms * per_sm;
  long groups = units / BAND;
  if (groups > cap / chunks) groups = cap / chunks;
  if (groups < 1) groups = 1;
  const unsigned blocks = static_cast<unsigned>(groups * chunks < cap ? groups * chunks : cap);
  // in's and tmp's elements; out's (padded or not)
  const size_t elems = (size_t)(g.pad ? g.ex + 2 * g.pad : g.ex) * g.ey;
  const size_t out_elems = g.pad && !g.out_pad ? (size_t)g.ex * g.ey : elems;
  auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  int tma = (g.ncol * sizeof(T)) % 16 == 0 && aligned(in) && aligned(out) && aligned(tmp);
  Maps maps;
  std::memset(&maps, 0, sizeof(maps));
  if (tma) {
    const T* bufs[3] = {in, out, tmp};
    const size_t sizes[3] = {elems, out_elems, elems};
    for (int i = 0; i < (nsteps > 1 ? 3 : 2); ++i)
      if (!encode(&maps.rows[i], bufs[i], sizes[i], g.ncol, NPTS, X3)
          || !encode(&maps.quarter[i], bufs[i], sizes[i], g.ncol, NP, X3))
        return static_cast<int>(cudaErrorInvalidValue);
  }
  int groups_ = static_cast<int>(groups);
  const dim3 threads(TILE, S::WARPS + 1);
  if (nsteps == 1) {
    kern<<<blocks, threads, S::BYTES, st>>>(op, w, in, out, tmp, g, nsteps, groups_, tma, maps);
    return static_cast<int>(cudaGetLastError());
  }
  void* args[] = {&op, &w, &in, &out, &tmp, &g, &nsteps, &groups_, &tma, &maps};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kern), dim3(blocks), threads,
                                    args, S::BYTES, st);
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
  constexpr int E = step_elems<T, X3, BRIDGE_IN>();
  switch (mode) {
    case STEP:
      return sq ? launch_sweep<T, X3, true>(op_, w_, in_, out_, tmp_, g, nsteps, st)
                : launch_sweep<T, X3, false>(op_, w_, in_, out_, tmp_, g, nsteps, st);
    case BRIDGE_IN:
      return natural ? launch_bridge<T, X3, E, BRIDGE_IN, true>(op_, w_, in_, out_, g, st)
                     : launch_bridge<T, X3, E, BRIDGE_IN>(op_, w_, in_, out_, g, st);
    case BRIDGE_OUT:
      return launch_bridge<T, X3, step_elems<T, X3, BRIDGE_OUT>(), BRIDGE_OUT>(op_, w_, in_,
                                                                               out_, g, st);
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
