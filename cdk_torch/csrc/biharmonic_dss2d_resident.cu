// K19: nsteps chained torus-DSS biharmonic steps (apply -> 2-D DSS ->
// apply) for every element, in one launch, with the state resident on chip.
//
// Replaces cdk_tpu/kernels/biharmonic/pallas_dss2d_resident.py::
// _dss2d_resident_kernel (caller apply_dss2d_resident).  The TPU kernel
// keeps a window of whole element rows plus k halo rows in VMEM and runs the
// assembly as masked sublane shifts; here each element's operator is used
// as it is and the neighbour index is explicit.
//
// The elements form an (ex, ey) torus, e = a*ey + b, in the lane layout (e,
// 16, ncol) with p = 4i + j.  DSS: a j pass (element (a,b)'s j = 0 points
// gain (a,b-1 mod ey)'s j = np-1 points, its j = np-1 points (a,b+1)'s j = 0
// points), then an i pass of the j-summed field (i = 0 points gain (a-1,b)'s
// i = np-1 points, i = np-1 points (a+1,b)'s i = 0 points), so corners
// collect all four sharers; then times the inverse assembled mass w.
//
// Windows: columns (q, k) are independent and the DSS couples only
// neighbouring elements of one column.  A window is `rows` element rows
// a0 + r (mod ex) of `cols` elements b0 + c (mod ey) each: whole rows (cols
// = ey, so the j pass wraps inside the window and only the i pass consumes
// halo rows) where 2h+1 rows fit, else a rectangle with h halo elements on
// every side.  Each step uses up one halo unit per side (the window's edge
// elements assemble with zeros), so the centre stays exact while nsteps <=
// h; the host sets h = nsteps, and only centre elements are stored.  A torus
// smaller than the window puts an element in it more than once; each copy
// computes the same values.
//
// Two kernels on those windows:
//  - dss2d_x3_kernel, the bf16x3 form on the tensor cores (bih::tc,
//    biharmonic_common.cuh).  A block is up to 32 warps, and each warp holds
//    two window elements (windows of up to 64) over a 16-column tile, one
//    m-tile each, with the operator's hi/lo B fragments of its elements in
//    registers and their inverse masses in its part of shared memory.  The
//    window is whole rows where 2h+1 of them fit in 64 elements, else an 8 x
//    8 rectangle (h <= 3).  The blocks are persistent: block b takes a
//    contiguous run of (window, column tile) tiles, the column tile fastest,
//    so a warp loads its elements' fragments once per window, and each warp
//    copies its elements' rows of the next tile into its own stage
//    (cp.async) while it computes this one.  The j pass and the i pass each
//    go through their own side buffers (the boundary points only), so each
//    takes one barrier and the next pass never waits for a read of the last.
//  - dss2d_exact_kernel, the exact f32 and f64 forms: thread (x, y) holds the
//    16 GLL values of window element y, column x, and runs the FMA chain in
//    the plain version's order (bit for bit); the window's operators and
//    inverse mass sit in shared memory and are read as warp-wide broadcasts
//    (LDS.128), as in K1.  Whole rows at 32 columns where 2h+1 rows of ey
//    fit in 32 elements, else at 16 columns in 64, else an 8 x 8 rectangle
//    at 16 columns (h <= 3); one block a window and column tile.
//
// Bound: device memory is touched once per launch (read the field, write
// the centre), ~0.15 ms at production f32 whatever the depth; the
// operations are three bf16 products on the tensor cores per application
// plus ~80 f32 operations for the splits and sums, times the window's
// overcompute (rows*cols over the centre).  At production (75 x 72, ncol
// 720, one step a launch) no whole row fits: the 8 x 8 window computes 64
// elements for 36 (1.78x) and reads its 28 halo elements again from L2.

#include <cuda_runtime.h>

#include "biharmonic_common.cuh"

namespace {

using bih::NP;
using bih::NPTS;

// The windows: window index win = bi*nbj + bj, rows a0 + r (mod ex), a0 =
// bi*ci - h, each of `cols` elements b0 + c (mod ey), b0 = bj*cj - hj; the
// centre is rows h .. h+ci-1 and elements hj .. hj+cj-1 (whole rows: hj = 0,
// cj = cols = ey, nbj = 1), stored where a0 + r < ex and b0 + c < ey.
struct Geo {
  int ex, ey, ncol;
  int rows, cols, h, ci, hj, cj, nbj, nwin;
};

__device__ __forceinline__ int wrap(int i, int n) {
  i %= n;
  return i < 0 ? i + n : i;
}

// ---- bf16x3 on the tensor cores -------------------------------------------

// The bf16x3 kernel's layout.  A tile is TC columns.  A stage row (one point
// of one element) holds them and 4 spare values, so the fragment-order reads
// of one warp hit distinct banks; a side buffer row (one boundary point of
// one element) them and 8 spare values, so one store or read hits distinct
// banks, with side 1 of a pass 16 values on from side 0, half the banks away.
constexpr int X3_WARPS = 32;  // the most warps of a block
constexpr int TC = 16;
constexpr int STAGE_STRIDE = TC + 4;
constexpr int SIDE_STRIDE = TC + 8;
// a warp's stage: its two elements' 16 rows, then their inverse masses
constexpr int WARP_STAGE = 2 * NPTS * (STAGE_STRIDE + 1);
// side 0 / side 1 of one pass over `slots` window elements
__host__ __device__ constexpr int side_len(int slots) {
  return slots * NP * SIDE_STRIDE + 16;
}
// the warps' stages, then the j pass's two sides and the i pass's two
constexpr int x3_smem_floats(int warps) {
  return warps * WARP_STAGE + 4 * side_len(2 * warps);
}

// L (e,16,16); w (e,16) inverse assembled mass in lane order; q/out
// (e,16,ncol).  Block (32, warps): warp y holds window elements 2y and 2y+1,
// m-tile m element 2y+m (an element past the window's rows*cols is absent:
// zeros, no neighbour, no store).
__global__ void __launch_bounds__(32 * X3_WARPS, 1)
dss2d_x3_kernel(const float* __restrict__ L, const float* __restrict__ w,
                const float* __restrict__ q, float* __restrict__ out, int nsteps, Geo g) {
  using bih::tc::pt;
  extern __shared__ __align__(16) float smem_x3[];
  const int y = threadIdx.y, lane = threadIdx.x;
  const int gq = lane >> 2, t = lane & 3;
  const int W = g.rows * g.cols;
  float* stage = smem_x3 + y * WARP_STAGE;
  float* xch = smem_x3 + blockDim.y * WARP_STAGE;
  const int sl = side_len(2 * blockDim.y);
  float* jside = xch;          // the j pass: side 0, side 1
  float* iside = xch + 2 * sl;  // the i pass: side 0, side 1
  const int ctiles = (g.ncol + TC - 1) / TC;
  const long ntiles = (long)g.nwin * ctiles;
  // this block's run of tiles
  const int first = static_cast<int>(ntiles * blockIdx.x / gridDim.x);
  const int last = static_cast<int>(ntiles * (blockIdx.x + 1) / gridDim.x);

  // window element el of window win: its torus element
  auto elem = [&](int win, int el) {
    const int a0 = (win / g.nbj) * g.ci - g.h, b0 = (win % g.nbj) * g.cj - g.hj;
    return wrap(a0 + el / g.cols, g.ex) * g.ey + wrap(b0 + el % g.cols, g.ey);
  };
  // this warp's elements' rows of `tile` into its stage: lane l copies
  // column l % 16 of rows 2i + l/16 of each element
  auto prefetch = [&](int tile) {
    if (tile >= last) return;
    const int win = tile / ctiles;
    const int c0 = tile % ctiles * TC;
    const int c = lane & 15;
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int el = 2 * y + m;
      const bool present = el < W;
      const size_t e = present ? static_cast<size_t>(elem(win, el)) : 0;
#pragma unroll
      for (int i = 0; i < NPTS / 2; ++i) {
        const int p = 2 * i + (lane >> 4);
        const bool ok = present && c0 + c < g.ncol;
        bih::cp_async<4>(stage + (m * NPTS + p) * STAGE_STRIDE + c,
                         ok ? q + (e * NPTS + p) * g.ncol + c0 + c : q, ok);
      }
    }
    bih::cp_async_commit();
  };

  // the window element whose boundary points this lane's points gain, for
  // each of the warp's elements: in the j pass the left (j = 0 points, t
  // even) or right (j = np-1, t odd) element, whole rows wrapping; in the i
  // pass the one above (i = 0, t < 2) or below (i = np-1, t >= 2); -1 where
  // the window has none.  Both in one register: nbs = (j + 1) | (i + 1) << 8.
  const bool whole = g.hj == 0;
  int nbs[2];
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const int el = 2 * y + m, r = el / g.cols, c = el % g.cols;
    const bool present = el < W;
    int nj, ni;
    if (t & 1)
      nj = !present ? -1 : c < g.cols - 1 ? el + 1 : whole ? el - g.cols + 1 : -1;
    else
      nj = !present ? -1 : c > 0 ? el - 1 : whole ? el + g.cols - 1 : -1;
    if (t >> 1)
      ni = present && r < g.rows - 1 ? el + g.cols : -1;
    else
      ni = present && r > 0 ? el - g.cols : -1;
    nbs[m] = (nj + 1) | (ni + 1) << 8;
  }

  float x[2][8];
  bih::tc::Op op[2];
  float* wbuf = stage + 2 * NPTS * STAGE_STRIDE;  // [2][16]
  // d = DSS(s) * w: the j pass, then the i pass of the j-summed field
  auto assemble = [&]() {
#pragma unroll
    for (int m = 0; m < 2; ++m)
      bih::tc::put_jside(x[m], jside + (t & 1) * sl + (2 * y + m) * NP * SIDE_STRIDE,
                         SIDE_STRIDE, gq);
    __syncthreads();
    // j = 0 points gain the left element's j = np-1 points, j = np-1 points
    // the right element's j = 0 points
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int nb = (nbs[m] & 0xff) - 1;
      if (nb >= 0)
        bih::tc::add_jside(x[m], jside + (1 - (t & 1)) * sl + nb * NP * SIDE_STRIDE,
                           SIDE_STRIDE, gq);
      bih::tc::put_iside(x[m], iside + (t >> 1) * sl + (2 * y + m) * NP * SIDE_STRIDE,
                         SIDE_STRIDE, gq);
    }
    __syncthreads();
    // i = 0 points gain the row above's i = np-1 points, i = np-1 points the
    // row below's i = 0 points
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int nb = (nbs[m] >> 8) - 1;
      if (nb >= 0)
        bih::tc::add_iside(x[m], iside + (1 - (t >> 1)) * sl + nb * NP * SIDE_STRIDE,
                           SIDE_STRIDE, gq);
#pragma unroll
      for (int k = 0; k < 8; ++k) x[m][k] *= wbuf[m * NPTS + pt(t, k & 3)];
    }
  };
  auto apply = [&]() {
#pragma unroll
    for (int m = 0; m < 2; ++m) bih::tc::apply(op[m], x[m]);
  };

  int loaded = -1;  // the window whose fragments op and masses wbuf hold
  prefetch(first);
  for (int tile = first; tile < last; ++tile) {
    const int win = tile / ctiles;
    const int c0 = tile % ctiles * TC;
    if (win != loaded) {
      __syncwarp();  // every lane is done with the last window's wbuf
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const int el = 2 * y + m;
        const size_t e = el < W ? static_cast<size_t>(elem(win, el)) : 0;
        op[m] = bih::tc::load_op(el < W ? L + e * NPTS * NPTS : nullptr);
        if (lane < NPTS) wbuf[m * NPTS + lane] = el < W ? w[e * NPTS + lane] : 0.f;
      }
      loaded = win;
    }
    bih::cp_async_wait();
    __syncwarp();  // the stage, and wbuf where it was refilled
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int k = 0; k < 8; ++k)
        x[m][k] = stage[(m * NPTS + pt(t, k & 3)) * STAGE_STRIDE + 8 * (k >> 2) + gq];
    __syncwarp();  // every lane has read the stage before it is refilled
    prefetch(tile + 1);

    for (int s = 0; s < nsteps; ++s) {
      apply();
      assemble();
      apply();
    }

    const int a0 = (win / g.nbj) * g.ci - g.h, b0 = (win % g.nbj) * g.cj - g.hj;
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int el = 2 * y + m, r = el / g.cols, c = el % g.cols;
      if (el < W && r >= g.h && r < g.h + g.ci && a0 + r < g.ex && c >= g.hj
          && c < g.hj + g.cj && b0 + c < g.ey) {
        const size_t e = static_cast<size_t>(elem(win, el));
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int col = c0 + 8 * (k >> 2) + gq;
          if (col < g.ncol) out[(e * NPTS + pt(t, k & 3)) * g.ncol + col] = x[m][k];
        }
      }
    }
  }
}

// ---- the exact forms: one thread per column --------------------------------

// Block (tc, W): thread (x, y) holds window element y, column x of column
// tile blockIdx.y; blockIdx.x is the window.  smem: the window's operators
// [W][256], inverse masses [W][16], and the two sides [W][NP][tc] of an
// exchange.
template <typename T>
__global__ void __launch_bounds__(1024)
dss2d_exact_kernel(const T* __restrict__ L, const T* __restrict__ w,
                   const T* __restrict__ q, T* __restrict__ out, int nsteps, Geo g) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tc = blockDim.x, W = blockDim.y;
  T* ops = reinterpret_cast<T*>(smem);  // [W][256]
  T* ws = ops + W * NPTS * NPTS;       // [W][16]
  T* side0 = ws + W * NPTS;            // [W][NP][tc] j = 0 / i = 0
  T* side3 = side0 + W * NP * tc;      // [W][NP][tc] j = np-1 / i = np-1

  const int bi = blockIdx.x / g.nbj, bj = blockIdx.x % g.nbj;
  const int a0 = bi * g.ci - g.h, b0 = bj * g.cj - g.hj;
  auto elem = [&](int y) {
    return wrap(a0 + y / g.cols, g.ex) * g.ey + wrap(b0 + y % g.cols, g.ey);
  };
  const int tid = threadIdx.y * tc + threadIdx.x;
  for (int i = tid; i < W * NPTS * NPTS; i += W * tc)
    ops[i] = L[(size_t)elem(i / (NPTS * NPTS)) * NPTS * NPTS + i % (NPTS * NPTS)];
  for (int i = tid; i < W * NPTS; i += W * tc)
    ws[i] = w[(size_t)elem(i / NPTS) * NPTS + i % NPTS];
  __syncthreads();

  const int x = threadIdx.x, y = threadIdx.y;
  const int r = y / g.cols, cj = y % g.cols;
  const int c = blockIdx.y * tc + x;
  const bool live = c < g.ncol;  // ragged last column tile: zeros, no store
  const size_t e = static_cast<size_t>(elem(y));
  T v[NPTS];
#pragma unroll
  for (int p = 0; p < NPTS; ++p) v[p] = live ? q[(e * NPTS + p) * g.ncol + c] : T(0);

  const T* A = ops + y * NPTS * NPTS;
  const T* wy = ws + y * NPTS;
  // j pass: the j=0 points gain the left neighbour's j=np-1 points, the
  // j=np-1 points the right neighbour's j=0 points; whole rows wrap
  const bool whole = g.hj == 0;
  const bool has_l = cj > 0 || whole, has_r = cj < g.cols - 1 || whole;
  const int yl = cj > 0 ? y - 1 : y + g.cols - 1;
  const int yr = cj < g.cols - 1 ? y + 1 : y - g.cols + 1;
  // d = DSS(s) * w, as dss2d_lane
  auto assemble = [&]() {
    bih::exchange<T, 0, NP - 1, NP>(v, side0, side3, x, y, tc, yl, has_l, yr, has_r);
    // i pass of the j-summed field: the i=0 points gain the row above's
    // i=np-1 points, the i=np-1 points the row below's i=0 points
    bih::exchange<T, 0, NPTS - NP, 1>(v, side0, side3, x, y, tc, y - g.cols, r > 0,
                                      y + g.cols, r < g.rows - 1);
#pragma unroll
    for (int p = 0; p < NPTS; ++p) v[p] *= wy[p];
  };
  for (int s = 0; s < nsteps; ++s) {
    bih::apply<T, false>(A, 0, v);
    assemble();
    bih::apply<T, false>(A, 0, v);
  }

  if (live && r >= g.h && r < g.h + g.ci && a0 + r < g.ex && cj >= g.hj
      && cj < g.hj + g.cj && b0 + cj < g.ey) {
#pragma unroll
    for (int p = 0; p < NPTS; ++p) out[(e * NPTS + p) * g.ncol + c] = v[p];
  }
}

// ---- launchers ---------------------------------------------------------------

// Whole rows where 2h+1 of them fit in `fit` elements (the centre at most
// ex rows), else false.
bool whole_rows(Geo& g, int fit) {
  const int rows = fit / g.ey;
  if (rows < 2 * g.h + 1) return false;
  g.ci = rows - 2 * g.h < g.ex ? rows - 2 * g.h : g.ex;
  g.rows = g.ci + 2 * g.h;
  g.cols = g.cj = g.ey;
  g.hj = 0;
  g.nbj = 1;
  return true;
}

// An ri x rj rectangle with h halo elements on every side, else false.
bool rectangle(Geo& g, int ri, int rj) {
  if (2 * g.h + 1 > ri || 2 * g.h + 1 > rj) return false;
  g.ci = ri - 2 * g.h < g.ex ? ri - 2 * g.h : g.ex;
  g.cj = rj - 2 * g.h < g.ey ? rj - 2 * g.h : g.ey;
  g.rows = g.ci + 2 * g.h;
  g.cols = g.cj + 2 * g.h;
  g.hj = g.h;
  g.nbj = (g.ey + g.cj - 1) / g.cj;
  return true;
}

void count_windows(Geo& g) {
  g.nwin = (g.ex + g.ci - 1) / g.ci * g.nbj;
}

// The bf16x3 kernel's window: whole rows where 2h+1 of them fit in 64
// elements, else an 8 x 8 rectangle (h <= 3, else cudaErrorInvalidValue).
int launch_x3(const float* L, const float* w, const float* q, float* out, int nsteps, Geo g,
              cudaStream_t st) {
  if (!whole_rows(g, 2 * X3_WARPS) && !rectangle(g, 8, 8))
    return static_cast<int>(cudaErrorInvalidValue);
  count_windows(g);
  const int warps = (g.rows * g.cols + 1) / 2;
  const size_t smem = sizeof(float) * x3_smem_floats(warps);
  cudaError_t err = cudaFuncSetAttribute(
      dss2d_x3_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  // persistent: as many blocks as are resident at once, each a run of tiles
  int dev, sms, per_sm;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, dss2d_x3_kernel, 32 * warps,
                                                        smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long ntiles = (long)g.nwin * ((g.ncol + TC - 1) / TC);
  const long cap = (long)sms * per_sm;
  dss2d_x3_kernel<<<static_cast<unsigned>(ntiles < cap ? ntiles : cap), dim3(32, warps), smem,
                    st>>>(L, w, q, out, nsteps, g);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_exact(const T* L, const T* w, const T* q, T* out, int nsteps, Geo g,
                 cudaStream_t st) {
  int tc = 32;
  if (!whole_rows(g, 32)) {
    tc = 16;
    if (!whole_rows(g, 64) && !rectangle(g, 8, 8))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  count_windows(g);
  const int W = g.rows * g.cols;
  const size_t smem = sizeof(T) * (W * NPTS * NPTS + W * NPTS + 2 * W * NP * tc);
  auto kern = dss2d_exact_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<dim3(g.nwin, (g.ncol + tc - 1) / tc), dim3(tc, W), smem, st>>>(L, w, q, out,
                                                                      nsteps, g);
  return static_cast<int>(cudaGetLastError());
}

Geo torus(int ex, int ey, int ncol, int nsteps) {
  Geo g{};
  g.ex = ex;
  g.ey = ey;
  g.ncol = ncol;
  g.h = nsteps;
  return g;
}

bool valid(int ex, int ey, int ncol, int nsteps) {
  return ex >= 1 && ey >= 1 && ncol >= 1 && nsteps >= 0;
}

}  // namespace

extern "C" {

// L (ex*ey,16,16), w (ex*ey,16), q/out (ex*ey,16,ncol), contiguous on one
// device, q not aliasing out; nsteps steps on the (ex, ey) torus (nsteps <=
// 3, or more where 2*nsteps+1 rows of ey elements fit in 64).  x3 selects
// the bf16x3 products (on the tensor cores).  Returns the launch's CUDA
// error code.
int cdk_dss2d_resident_f32(const void* L, const void* w, const void* q, void* out,
                           int ex, int ey, int ncol, int nsteps, int x3, void* stream) {
  if (!valid(ex, ey, ncol, nsteps)) return static_cast<int>(cudaErrorInvalidValue);
  const Geo g = torus(ex, ey, ncol, nsteps);
  const auto L_ = static_cast<const float*>(L);
  const auto w_ = static_cast<const float*>(w);
  const auto q_ = static_cast<const float*>(q);
  const auto out_ = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  return x3 ? launch_x3(L_, w_, q_, out_, nsteps, g, st)
            : launch_exact<float>(L_, w_, q_, out_, nsteps, g, st);
}

int cdk_dss2d_resident_f64(const void* L, const void* w, const void* q, void* out,
                           int ex, int ey, int ncol, int nsteps, void* stream) {
  if (!valid(ex, ey, ncol, nsteps)) return static_cast<int>(cudaErrorInvalidValue);
  return launch_exact<double>(static_cast<const double*>(L), static_cast<const double*>(w),
                              static_cast<const double*>(q), static_cast<double*>(out),
                              nsteps, torus(ex, ey, ncol, nsteps),
                              static_cast<cudaStream_t>(stream));
}

}  // extern "C"
