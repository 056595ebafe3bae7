// The MPDATA x sweep: one warp per CRM slice (or a few warps sharing one)
// sweeps the slice's x rows in order, its 32 lanes across the levels, every
// stage of advect_scalar2D a fixed lag behind the rows it reads, in registers.
// It runs every MPDATA step kernel of the port: K2/K9 and K6/K7/K8
// (csrc/mpdata_resident.cu) and K20-K25 (csrc/mpdata_masked.cu).
//
// Rows are the collocated x grid: f row x, and u and w rows x with
// uuu[x] = pp(u[x]) f[x-1] - pn(u[x]) f[x] and www[x] = pp(w[x]) f[x](k-1) -
// pn(w[x]) f[x].  The resident step's u and w (the reference's rows, one to
// the left) are read one row up.  Lane l holds the L contiguous levels
// k = L l .. L l + L - 1 (L = 2 up to 64 levels, 4 up to 128, 8 up to 256);
// a neighbour at k-1 or k+1 is one warp shuffle.  Iteration p takes f, u and
// w row p, and each stage runs a fixed lag behind the rows it reads: uuu/www
// at p, the upwind f1 at p-1, uuu2 at p-1, www2 and the limiter ratios at
// p-2 (f's extrema at p-1, used one iteration later), uuu3/www3 at p-2 and
// the final f at p-3.  So a step uses no shared memory and no barrier; the
// next iteration's rows are loaded one iteration ahead, in flight while this
// one computes; the two flux column sums are each lane's running sums in x
// order.  Warps are independent, so the card holds as many slices at once as
// registers allow.  Every add, subtract, multiply and divide is an _rn
// intrinsic, so nvcc contracts nothing and f is rounded as the plain version
// rounds it; only the flux column sums run in another order than torch.sum.
//
// Modes (template parameters, each instantiation only what is launched):
//   HOIST   stage 4 in the hoisted order of make_invariants and
//           advect_hoisted (K2, K9) or of make_masked_invariants and
//           advect_masked_hoisted (K24, K25): coefA, acrossA, coefB and
//           acrossB are recomputed per point from u and w in registers, in
//           the plain version's order, which gives the hoisted values bitwise
//           without holding them anywhere.  Otherwise the staged order of
//           reference.advect_scalar2d (K6-K8, K20-K23).
//   MASKED  the masked-global step of advect_scalar2d_masked on a shard's
//           window of X columns: every stage over every row, a stage's
//           neighbour past the window's edge the stage's own edge row (the
//           clamp of _xl/_xr: row -1 is row 0, row X is row X-1), each
//           Fortran x range a test of the row's global index gi = gi0 + x,
//           uniform across the warp (a select, no divergence), and the flux
//           partial over the owned rows whose gi lies in [1, nx].  With
//           f_left set the window is the left strip, the owned block and the
//           right strip, the f pointer picked once per row, and only the
//           owned rows are written (K23, K25).
//   SPLIT   below FEW_SLICES slices one warp per slice leaves most of the card
//           idle, so a block of `chunks` warps shares one slice: each sweeps
//           its rows and three more each side, and writes its own; a later
//           step first copies the neighbours' three rows it reads (between
//           two block barriers), and the flux rows go to shared memory, where
//           the first warp sums them in x order, so the split changes no bit.
//   LANES   the staged step (one step, not MASKED) on K10's (x, z, s) layout,
//           where a slice's levels lie nslices apart: the rows come and go
//           through shared-memory tiles of a block's W slices side by side
//           (struct Lanes below); the stage chain is the same code.
//
// Several steps run in one launch (K2, K8, K9, K24, K25): f moves from its
// input to a window-sized buffer in the first step, and later steps sweep
// that buffer in place, each lane reading a row of its levels before it
// writes it, through loads at L2 (ld.global.cg): f_out where f_out is the
// whole window, and for K25, whose output is the owned block alone, a
// scratch window the wrapper allocates in device memory (`win`); its last
// step writes the owned rows to f_out.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int SWEEP_WARPS = 4;      // slices (warps) per block, one warp a slice
constexpr int MAX_CHUNKS = 8;       // warps a split slice may take
constexpr int MAX_LEVELS = 32 * 8;  // nzm the sweep takes (L <= 8)
// Below this many slices a slice is split among SPLIT_WARPS warps (fewer
// where its rows or shared memory do not allow it): at the shipped 48
// slices 8 warps a slice beat 1, 2 and 4 in every form, 1.1-1.4x faster than
// 4 for the multi-step launches (chip_smoke.py's few-slice phase).
constexpr int FEW_SLICES = 1024;
constexpr int SPLIT_WARPS = 8;
constexpr unsigned FULL = 0xffffffffu;
// The (x, z, s) sweep's block: LANES_WARPS warps, W = LANES_WARPS / chunks
// slices side by side; the tile rows (f, u and w rows) in shared memory at
// once; the finished f rows its ring holds (row r leaves at iteration r + 4,
// after rows r + 1 .. r + 4 may have gone in); the rows of a chunk's tiles
constexpr int LANES_WARPS = 8;
constexpr int LANES_TILES = 2;
constexpr int LANES_RING = 5;
constexpr int LANES_ROWS = 3 * LANES_TILES + LANES_RING;

// storage <-> compute conversions: the identity, or bf16 rounding
template <typename S, typename C>
struct Cvt {
  static __device__ __forceinline__ C ld(S x) { return x; }
  static __device__ __forceinline__ S st(C x) { return x; }
};
template <>
struct Cvt<__nv_bfloat16, float> {
  static __device__ __forceinline__ float ld(__nv_bfloat16 x) { return __bfloat162float(x); }
  static __device__ __forceinline__ __nv_bfloat16 st(float x) { return __float2bfloat16_rn(x); }
};

template <typename T>
__device__ __forceinline__ T pp(T y) { return fmax(T(0), y); }
template <typename T>
__device__ __forceinline__ T pn(T y) { return -fmin(T(0), y); }
template <typename T>
__device__ __forceinline__ T min3(T a, T b, T c) { return fmin(fmin(a, b), c); }

__device__ __forceinline__ float ad(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sb(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mu(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float dv(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double ad(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sb(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ double mu(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double dv(double a, double b) { return __ddiv_rn(a, b); }

// loads at L2 (ld.global.cg): coherent with the stores of the window buffer
// that a later step of the same launch reads back, and nothing a lane reads
// is reused in L1
__device__ __forceinline__ float ld_l2(const float* p) { return __ldcg(p); }
__device__ __forceinline__ double ld_l2(const double* p) { return __ldcg(p); }
__device__ __forceinline__ __nv_bfloat16 ld_l2(const __nv_bfloat16* p) {
  return __ushort_as_bfloat16(__ldcg(reinterpret_cast<const unsigned short*>(p)));
}

// One x row of a slice as a lane holds it: its L levels k = L * lane + i.
template <int L, typename C>
struct Lv {
  C v[L];
};

#define EACH(i) _Pragma("unroll") for (int i = 0; i < L; ++i)

// the row at level k-1; at k = 0 the level itself (the reference's kb clamp)
template <int L, typename C>
__device__ __forceinline__ Lv<L, C> below(const Lv<L, C>& x, int lane) {
  Lv<L, C> r;
  const C from = __shfl_up_sync(FULL, x.v[L - 1], 1);
  r.v[0] = lane == 0 ? x.v[0] : from;
#pragma unroll
  for (int i = 1; i < L; ++i) r.v[i] = x.v[i - 1];
  return r;
}

// the row at level k+1; at k = nzm-1 the level itself (kc), or with ZERO_TOP
// zero there (www(nz) = 0)
template <bool ZERO_TOP, int L, typename C>
__device__ __forceinline__ Lv<L, C> above(const Lv<L, C>& x, int k0, int nzm) {
  Lv<L, C> r;
  const C from = __shfl_down_sync(FULL, x.v[0], 1);
  EACH(i) {
    const C up = i + 1 < L ? x.v[i + 1 < L ? i + 1 : i] : from;
    r.v[i] = k0 + i + 1 < nzm ? up : (ZERO_TOP ? C(0) : x.v[i]);
  }
  return r;
}

template <int L, typename S, typename C>
__device__ __forceinline__ Lv<L, C> load_row(const S* row, int k0, int nzm) {
  Lv<L, C> r;
  EACH(i) {
    const int k = k0 + i;
    r.v[i] = k < nzm ? Cvt<S, C>::ld(ld_l2(row + k)) : C(0);
  }
  return r;
}

template <int L, typename S, typename C>
__device__ __forceinline__ void store_row(S* row, const Lv<L, C>& x, int k0, int nzm) {
  EACH(i) {
    if (k0 + i < nzm) row[k0 + i] = Cvt<S, C>::st(x.v[i]);
  }
}

// What one launch sweeps.  The resident step: f (S, rows = nx+6, nzm),
// u (S, nx+5, nzm), w (S, nx+4, nz), flux_in/flux_out (S, nz), gi0 = -2 and
// every row owned.  The masked step: the window f (S, rows = X, nzm), or
// with f_left/f_right (S, halo, nzm) the owned block f (S, X - 2 halo, nzm),
// u (S, X, nzm), w (S, X, nz), flux_out (S, nzm).  rho/adz (S, nzm), rhow
// (S, nz).
template <typename S>
struct Sweep {
  const S* f;
  const S* f_left;
  const S* f_right;
  const S* u;
  const S* w;
  const S* rho;
  const S* rhow;
  const S* adz;
  const S* flux_in;
  S* f_out;
  S* flux_out;
  S* win;
  int nslices, rows, nzm, nx, gi0, owned_lo, owned_hi, halo, nsteps, chunks;
};

// K10's (x, z, s) layout (LANES): element (x, k, s) of a field of `levels`
// levels lies at (x levels + k) nslices + s, so a slice's levels are nslices
// apart and a level's slices side by side.  A block holds W slices side by
// side, warp j of each chunk sweeping slice s0 + j, and each chunk's threads
// move its rows between device and shared memory as runs of W slices:
// thread t of the chunk copies slice t % W at levels t / W, t / W + 32, ...,
// one element a cp.async, so a warp's requests are W consecutive elements of
// each of 32 / W levels.  In shared memory a slice's levels lie at a pitch of
// P elements (lanes_pitch), where a warp reads its L levels a lane as
// vectors and the copies of a warp fall on distinct banks.  LANES_TILES
// buffers, each a tile row (iteration r's f row r and u and w row r - 1, the
// resident step's one-row offset), take turns: tile row p + LANES_TILES is
// put in flight while iteration p computes, one group of copies an
// iteration, and one barrier a row orders the copies and the reads.  The f
// rows the sweep finishes go to a ring of LANES_RING rows and leave it after
// the barrier four iterations on (row r is final at iteration r + 3), and
// the flux row at the end likewise, as runs of W slices.

// a tile's pitch: 32 L levels and a pad, a multiple of the lanes' vector
// width, that puts the copies of a warp (32 / W levels of W slices) on
// distinct banks
__host__ __device__ inline int lanes_pitch(int L, int W, int esize) {
  const int words = esize / 4, vec = L * esize < 16 ? L : 16 / esize;
  int pad = (32 / (W * words)) % (32 / words);
  if (pad < vec) pad = vec;
  return 32 * L + (pad + vec - 1) / vec * vec;
}

template <typename S, typename C>
__host__ inline size_t lanes_smem_bytes(int L, int chunks, int nflux) {
  const int W = LANES_WARPS / chunks;
  return static_cast<size_t>(chunks) * LANES_ROWS * W * lanes_pitch(L, W, sizeof(S)) *
             sizeof(S) +
         (chunks == 1 ? 0 : 2 * static_cast<size_t>(nflux) * W * 32 * L * sizeof(C));
}

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_elem(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d), "l"(src), "n"(N)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit_group() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// a lane's L consecutive levels in shared memory, as vectors of up to 16 bytes
template <int L, typename S>
__device__ __forceinline__ void lds_vec(S (&v)[L], const S* p) {
  if constexpr (sizeof(S) == 4 && L == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    v[0] = x.x;
    v[1] = x.y;
  } else if constexpr (sizeof(S) == 4) {
#pragma unroll
    for (int q = 0; q < L / 4; ++q) {
      const float4 x = reinterpret_cast<const float4*>(p)[q];
      v[4 * q] = x.x;
      v[4 * q + 1] = x.y;
      v[4 * q + 2] = x.z;
      v[4 * q + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int q = 0; q < L / 2; ++q) {
      const double2 x = reinterpret_cast<const double2*>(p)[q];
      v[2 * q] = x.x;
      v[2 * q + 1] = x.y;
    }
  }
}
template <int L, typename S>
__device__ __forceinline__ void sts_vec(S* p, const S (&v)[L]) {
  if constexpr (sizeof(S) == 4 && L == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else if constexpr (sizeof(S) == 4) {
#pragma unroll
    for (int q = 0; q < L / 4; ++q)
      reinterpret_cast<float4*>(p)[q] =
          make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
  } else {
#pragma unroll
    for (int q = 0; q < L / 2; ++q)
      reinterpret_cast<double2*>(p)[q] = make_double2(v[2 * q], v[2 * q + 1]);
  }
}

// One chunk's tiles of the (x, z, s) layout, from one warp's view.
template <typename S, typename C, int L>
struct Lanes {
  using Row = Lv<L, C>;
  S* buf;         // the chunk's tile rows: [LANES_TILES][f, u, w][W][P]
  S* ring;        // its finished rows: [LANES_RING][W][P]
  long long s0;   // the block's first slice
  int W, P, j, k0, live, cj, ck, bar, threads;

  __device__ void sync() const { bar_sync(bar, threads); }
  // this thread's copies of row x of a field of `levels` levels into dst
  __device__ void copy(S* dst, const S* src, long long ns, int x, int levels,
                       int nzm) const {
    if (cj >= live) return;
    const S* from = src + (static_cast<long long>(x) * levels + ck) * ns + s0 + cj;
    for (int k = ck; k < nzm; k += 32, from += 32 * ns)
      cp_async_elem<sizeof(S)>(dst + cj * P + k, from);
  }
  __device__ S* tile(int r, int field) const {
    return buf + ((r % LANES_TILES) * 3 + field) * W * P;
  }
  // a group of copies of tile row r up to row `last` (empty past it): f row
  // r, u and w row r - 1, where they exist
  __device__ void fetch(const Sweep<S>& a, int r, int last, int xu, int xw) const {
    const long long ns = a.nslices;
    if (r <= last) {
      if (r < a.rows) copy(tile(r, 0), a.f, ns, r, a.nzm, a.nzm);
      if (r >= 1 && r - 1 < xu) copy(tile(r, 1), a.u, ns, r - 1, a.nzm, a.nzm);
      if (r >= 1 && r - 1 < xw) copy(tile(r, 2), a.w, ns, r - 1, a.nzm + 1, a.nzm);
    }
    cp_async_commit_group();
  }
  // every group but the last `PENDING` has landed, in every thread
  template <int PENDING>
  __device__ void ready() const {
    cp_async_wait_group<PENDING>();
    sync();
  }
  // this warp's levels of a field (0 f, 1 u, 2 w) of tile row r
  __device__ Row row(const Sweep<S>& a, int r, int field) const {
    S v[L];
    lds_vec<L, S>(v, tile(r, field) + j * P + k0);
    Row x;
    EACH(i) x.v[i] = k0 + i < a.nzm ? Cvt<S, C>::ld(v[i]) : C(0);
    return x;
  }
  // rho, adz and rhow (tile row 0's buffer, before the first fetch)
  __device__ void levels(const Sweep<S>& a, Row (&lv)[3]) const {
    const long long ns = a.nslices;
    copy(tile(0, 0), a.rho, ns, 0, a.nzm, a.nzm);
    copy(tile(0, 1), a.adz, ns, 0, a.nzm, a.nzm);
    copy(tile(0, 2), a.rhow, ns, 0, a.nzm + 1, a.nzm);
    cp_async_commit_group();
    ready<0>();
    for (int q = 0; q < 3; ++q) lv[q] = row(a, 0, q);
    sync();
  }
  // f row r into the ring
  __device__ void put(const Sweep<S>&, int r, const Row& x) const {
    S v[L];
    EACH(i) v[i] = Cvt<S, C>::st(x.v[i]);
    sts_vec<L, S>(ring + ((r % LANES_RING) * W + j) * P + k0, v);
  }
  // the ring's row r to row x of dst (nzm levels a row), as runs of W slices
  __device__ void drain(int r, S* dst, long long ns, int x, int nzm) const {
    if (cj >= live) return;
    const S* from = ring + ((r % LANES_RING) * W + cj) * P;
    S* to = dst + (static_cast<long long>(x) * nzm + ck) * ns + s0 + cj;
    for (int k = ck; k < nzm; k += 32, to += 32 * ns) *to = from[k];
  }
  __device__ void flush(const Sweep<S>& a, int r) const {
    drain(r, a.f_out, a.nslices, r, a.nzm);
  }
  // flux(:, k < nzm) through the ring, once its f rows have left
  __device__ void store_flux(const Sweep<S>& a, const Row& x) const {
    sync();
    put(a, 0, x);
    sync();
    drain(0, a.flux_out, a.nslices, 0, a.nzm);
  }
};

// the flux rows: the owned rows whose gi lies in [1, nx]
__host__ __device__ inline int flux_lo(int gi0, int owned_lo) {
  return owned_lo > 1 - gi0 ? owned_lo : 1 - gi0;
}
__host__ __device__ inline int flux_rows(int gi0, int nx, int owned_lo, int owned_hi) {
  const int hi = owned_hi < nx + 1 - gi0 ? owned_hi : nx + 1 - gi0;
  const int n = hi - flux_lo(gi0, owned_lo);
  return n > 0 ? n : 0;
}

// the shared memory of a split slice: its two sets of flux rows and each
// warp's six halo rows
template <typename C>
__host__ inline size_t sweep_smem_bytes(int nflux, int L, int chunks) {
  return chunks == 1 ? 0 : (2 * (size_t)nflux + 6 * (size_t)chunks) * 32 * L * sizeof(C);
}

template <typename S, typename C, int L, bool SPLIT, bool HOIST, bool MASKED, bool LANES = false>
__global__ void __launch_bounds__(LANES ? 32 * LANES_WARPS
                                        : SPLIT ? 32 * MAX_CHUNKS : 32 * SWEEP_WARPS)
mpdata_sweep_kernel(const Sweep<S> a) {
  using V = Cvt<S, C>;
  using Row = Lv<L, C>;
  // a value as the storage type holds it
  auto rnd = [](C x) { return V::ld(V::st(x)); };
  const int chunks = SPLIT ? a.chunks : 1;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  // LANES: the block's W slices side by side, warp j of each chunk on slice j
  const int W = LANES ? LANES_WARPS / chunks : 1, j = LANES ? warp % W : 0;
  const int c = LANES ? warp / W : SPLIT ? warp : 0;  // the warp's chunk of its slice
  const long long s = LANES   ? static_cast<long long>(blockIdx.x) * W + j
                      : SPLIT ? static_cast<long long>(blockIdx.x)
                              : static_cast<long long>(blockIdx.x) * SWEEP_WARPS + warp;
  if (!LANES && s >= a.nslices) return;  // a LANES warp past the end sweeps, stores nothing
  const int nzm = a.nzm, nz = nzm + 1, rows = a.rows, nx = a.nx, gi0 = a.gi0;
  const int k0 = L * lane, NZP = 32 * L;
  // u and w: the masked step's rows are the window's; the resident step's
  // are the reference's, one row to the left
  const int uoff = MASKED ? 0 : 1, XU = MASKED ? rows : nx + 5, XW = MASKED ? rows : nx + 4;
  const S* us = a.u + s * XU * nzm;
  const S* ws = a.w + s * XW * nz;
  // f: step 0 reads the input (three pointers for a split window), a later
  // step the window buffer its predecessor wrote
  const bool three = MASKED && a.f_left != nullptr;
  const int halo = a.halo, block = rows - 2 * halo;
  const S* const fin = a.f + s * (three ? block : rows) * nzm;  // the window's or block's row 0
  const S* const fleft = a.f_left + s * halo * nzm;
  const S* const fright = a.f_right + s * halo * nzm;
  S* const fout = a.f_out + s * (three ? block : rows) * nzm;
  S* const wbuf = three ? a.win + s * rows * nzm : fout;
  auto input_row = [&](int r) -> const S* {
    if (!three) return fin + r * nzm;
    if (r < halo) return fleft + r * nzm;
    if (r < rows - halo) return fin + (r - halo) * nzm;
    return fright + (r - rows + halo) * nzm;
  };
  // where row r of a step's f goes: the window buffer, or for a split
  // window's last step (and a launch of no step) its owned row of f_out
  // (nullptr: not written)
  auto out_row = [&](int step, int r) -> S* {
    if (three && step >= a.nsteps - 1)
      return r >= halo && r < rows - halo ? fout + (r - halo) * nzm : nullptr;
    return wbuf + r * nzm;
  };
  auto in = [&](int x, int lo, int hi) { return gi0 + x >= lo && gi0 + x <= hi; };
  // this warp's share of the slice: it writes rows [own_lo, own_hi) (the
  // rows 3..rows-4 split evenly, the three edge rows each side with the end
  // chunks) and sweeps rows [p0, p1], three more each side, which every row
  // it writes needs; the masked step's last chunk runs three iterations past
  // the window's end, where each stage's row X is its row X-1
  const int R = rows - 6;
  const int q0 = 3 + R * c / chunks, q1 = 3 + R * (c + 1) / chunks;
  const int p0 = q0 - 3, p1 = MASKED && c == chunks - 1 ? rows + 2 : q1 + 2;
  const int own_lo = c == 0 ? 0 : q0, own_hi = c == chunks - 1 ? rows : q1;
  auto owned = [&](int r) { return r >= own_lo && r < own_hi; };
  const int flo = flux_lo(gi0, a.owned_lo), NF = flux_rows(gi0, nx, a.owned_lo, a.owned_hi);
  auto fluxed = [&](int r) { return r >= flo && r < flo + NF && owned(r); };
  // split slices: the flux rows in shared memory, summed in x order at the
  // end, and each warp's halo rows (3 left, 3 right), lane-private slots
  extern __shared__ __align__(16) unsigned char smem_raw[];
  C* fluxrow = reinterpret_cast<C*>(smem_raw);
  C* haloc = reinterpret_cast<C*>(smem_raw) + (2 * NF + warp * 6) * NZP;
  const int fstride = MASKED ? nzm : nz;
  // LANES: each chunk's tile rows and ring, then the split's flux rows
  Lanes<S, C, L> io{};
  if constexpr (LANES) {
    const long long s0 = static_cast<long long>(blockIdx.x) * W;
    const long long left = a.nslices - s0;
    const int P = lanes_pitch(L, W, sizeof(S)), tc = threadIdx.x - c * W * 32;
    S* mine = reinterpret_cast<S*>(smem_raw) + c * LANES_ROWS * W * P;
    io = Lanes<S, C, L>{mine, mine + 3 * LANES_TILES * W * P, s0, W, P, j, k0,
                        left < W ? static_cast<int>(left) : W, tc % W, tc / W, 1 + c, W * 32};
    fluxrow = reinterpret_cast<C*>(smem_raw + static_cast<size_t>(chunks) * LANES_ROWS * W *
                                                  P * sizeof(S));
  }

  if (!MASKED && lane == 0 && c == 0) {  // flux(:, nz)
    if constexpr (LANES) {
      if (s < a.nslices) a.flux_out[nzm * a.nslices + s] = a.flux_in[nzm * a.nslices + s];
    } else {
      a.flux_out[s * nz + nzm] = a.flux_in[s * nz + nzm];
    }
  }
  if (!LANES && a.nsteps == 0) {
    for (int j = own_lo; j < own_hi; ++j) {
      S* d = out_row(0, j);
      if (d != nullptr) store_row<L, S, C>(d, load_row<L, S, C>(input_row(j), k0, nzm), k0, nzm);
    }
    if (c == 0) {
      Row z;
      EACH(i) z.v[i] = C(0);
      store_row<L, S, C>(a.flux_out + s * fstride,
                         MASKED ? z : load_row<L, S, C>(a.flux_in + s * nz, k0, nzm), k0, nzm);
    }
    return;
  }

  // per-level fields, as the storage type holds them
  Row irho, iadz, dd, irhow, rho;
  Row lv[3];  // LANES: rho, adz, rhow from the tile
  if constexpr (LANES) io.levels(a, lv);
  EACH(i) {
    const int k = k0 + i;
    const bool inz = k < nzm;
    C r, ac, rw;
    if constexpr (LANES) {
      r = inz ? lv[0].v[i] : C(1);
      ac = inz ? lv[1].v[i] : C(1);
      rw = inz ? lv[2].v[i] : C(1);
    } else {
      r = inz ? V::ld(a.rho[s * nzm + k]) : C(1);
      ac = inz ? V::ld(a.adz[s * nzm + k]) : C(1);
      rw = inz ? V::ld(a.rhow[s * nz + k]) : C(1);
    }
    const int span = inz ? min(nzm - 1, k + 1) - max(0, k - 1) : 1;
    irho.v[i] = rnd(dv(C(1), r));
    iadz.v[i] = rnd(dv(C(1), ac));
    dd.v[i] = rnd(dv(dv(C(2), C(span)), ac));
    irhow.v[i] = rnd(dv(C(1), mu(rw, ac)));
    rho.v[i] = r;
  }

  Row fl1, fl2;  // the step's two flux column sums
  for (int step = 0; step < a.nsteps; ++step) {
    // a later step of a split slice reads the rows its neighbours write in
    // this step: each warp first copies the halo rows it does not own, once
    // every warp has finished the step before
    const bool split = !LANES && step > 0 && chunks > 1;
    if (split) {
      __syncthreads();
      for (int j = 0; j < 3; ++j) {
        const int lo = p0 + j, hi = own_hi + j;
        const Row left = lo < own_lo ? load_row<L, S, C>(wbuf + lo * nzm, k0, nzm) : Row{};
        const Row right =
            hi <= p1 && hi < rows ? load_row<L, S, C>(wbuf + hi * nzm, k0, nzm) : Row{};
        EACH(i) {
          haloc[j * NZP + k0 + i] = left.v[i];
          haloc[(3 + j) * NZP + k0 + i] = right.v[i];
        }
      }
      __syncthreads();
    }
    // a step's f rows: a split window's first step picks the pointer per
    // row, every other step reads one buffer
    const S* const src = step > 0 ? wbuf : fin;
    const bool pick = three && step == 0;
    auto load_f = [&](int r) {
      if (split && (r < own_lo || r >= own_hi)) {
        const C* h = haloc + (r < own_lo ? r - p0 : 3 + r - own_hi) * NZP;
        Row x;
        EACH(i) x.v[i] = h[k0 + i];
        return x;
      }
      return load_row<L, S, C>(pick ? input_row(r) : src + r * nzm, k0, nzm);
    };
    // rows by lag: f[p], f[p-1], f[p-2]; u, w rows p, p-1, p-2; uuu, www p
    // (a1, b1) and www p-1 (b2); f1 p-1, p-2, p-3 (g1, g2, g3) with their
    // k-1 and k+1 neighbours; uuu2 p-1, p-2 (U2a, U2b); the ratios at rows
    // p-2, p-3 (MXr, MXrP); uuu3, www3 p-2, p-3 (U3a/b, W3a/b); f's extrema
    // at row p-2 (mxfP); the k-1 / k+1 neighbours each later stage reuses
    Row fA{}, fB{}, fC{}, fkbB{}, u1{}, u2{}, u3{}, ukb3{}, w1{}, w2{}, w3{}, wkc3{};
    Row a1{}, b1{}, b2{}, g1{}, g2{}, g3{}, gkb1{}, gkb2{}, gkb3{}, gkc1{}, gkc2{};
    Row mxfP{}, mnfP{}, U2a{}, MXr{}, MNr{}, U3a{}, W3a{};
    EACH(i) fl1.v[i] = fl2.v[i] = C(0);
    Row nf, nu{}, nw{};
    if constexpr (LANES) {  // tile rows p0 .. p0 + LANES_TILES - 1 in flight, p0 read
      for (int r = p0; r < p0 + LANES_TILES; ++r) io.fetch(a, r, p1, XU, XW);
      io.template ready<LANES_TILES - 1>();
      nf = io.row(a, p0, 0);
      if (p0 - uoff >= 0) {
        nu = io.row(a, p0, 1);
        nw = io.row(a, p0, 2);
      }
    } else {
      nf = load_f(p0);
      if (p0 - uoff >= 0) {
        nu = load_row<L, S, C>(us + (p0 - uoff) * nzm, k0, nzm);
        nw = load_row<L, S, C>(ws + (p0 - uoff) * nz, k0, nzm);
      }
    }
    // the rows iteration p loads ahead, as running pointers (which nvcc
    // keeps in registers, where it recomputed base + row * stride)
    const S* fnext = src + (p0 + 1) * nzm;
    const S* unext = us + (p0 + 1 - uoff) * nzm;
    const S* wnext = ws + (p0 + 1 - uoff) * nz;
    for (int p = p0; p <= p1; ++p, fnext += nzm, unext += nzm, wnext += nz) {
      fC = fB;
      fB = fA;
      fA = MASKED && p >= rows ? fB : nf;  // f's row X is its row X-1
      u3 = u2;
      u2 = u1;
      u1 = nu;
      w3 = w2;
      w2 = w1;
      w1 = nw;
      if constexpr (LANES) {
        // tile row p + 1 has landed and every warp has read row p's buffer:
        // read p + 1 (nothing after the last row), send the ring's row p - 4
        // out, and put row p + LANES_TILES in flight in row p's buffer
        io.template ready<LANES_TILES - 2>();
        if (p < p1) {
          nf = io.row(a, p + 1, 0);
          if (p + 1 - uoff < XU) nu = io.row(a, p + 1, 1);
          if (p + 1 - uoff < XW) nw = io.row(a, p + 1, 2);
        }
        if (p >= 4 && owned(p - 4)) io.flush(a, p - 4);
        io.fetch(a, p + LANES_TILES, p1, XU, XW);
      } else {
        if (p < p1 && (!MASKED || p + 1 < rows))
          nf = split || pick ? load_f(p + 1) : load_row<L, S, C>(fnext, k0, nzm);
        if (p + 1 - uoff < XU) nu = load_row<L, S, C>(unext, k0, nzm);
        if (p + 1 - uoff < XW) nw = load_row<L, S, C>(wnext, k0, nzm);
      }
      if (MASKED && p == rows) u1 = u2;  // u's row X is its row X-1
      if (MASKED && p == 0) {            // f's and w's row -1 are their row 0
        fB = fA;
        w2 = w1;
      }

      // -- stage 2: uuu[p] from f rows p-1, p; www[p] from f row p
      const Row fkbA = below(fA, lane);
      const Row b3 = b2, a2 = a1;  // www[p-2], uuu[p-1]
      b2 = b1;
      EACH(i) {
        a1.v[i] = rnd(sb(mu(pp(u1.v[i]), fB.v[i]), mu(pn(u1.v[i]), fA.v[i])));
        b1.v[i] = rnd(sb(mu(pp(w1.v[i]), fkbA.v[i]), mu(pn(w1.v[i]), fA.v[i])));
      }
      if (MASKED && p == rows) a1 = a2;
      // -- stage 3: the upwind update f1[p-1] (gi in [-1, nx+2])
      const Row b2up = above<true>(b2, k0, nzm);
      g3 = g2;
      g2 = g1;
      EACH(i) {
        const C upd = mu(ad(sb(a1.v[i], a2.v[i]), mu(sb(b2up.v[i], b2.v[i]), iadz.v[i])),
                         irho.v[i]);
        g1.v[i] = rnd(sb(fB.v[i], upd));
      }
      if (MASKED) {
        if (!in(p - 1, -1, nx + 2)) g1 = fB;
        if (p - 1 == rows) g1 = g2;
      }
      gkb3 = gkb2;
      gkb2 = gkb1;
      gkb1 = below(g1, lane);
      gkc2 = gkc1;
      gkc1 = above<false>(g1, k0, nzm);
      if (MASKED && p == 1) {  // f1's row -1 is its row 0
        g2 = g1;
        gkb2 = gkb1;
        gkc2 = gkc1;
      }

      // -- stage 1: f's extrema at row p-1 (used at the next iteration)
      const Row fkcB = above<false>(fB, k0, nzm);
      Row mxfN, mnfN;
      EACH(i) {
        mxfN.v[i] = fmax(fmax(fmax(fC.v[i], fA.v[i]), fmax(fkbB.v[i], fkcB.v[i])), fB.v[i]);
        mnfN.v[i] = fmin(fmin(fmin(fC.v[i], fA.v[i]), fmin(fkbB.v[i], fkcB.v[i])), fB.v[i]);
      }

      // -- stage 4: uuu2[p-1] (f1 rows p-2, p-1; u row p-1; w rows p-2, p-1;
      // gi in [0, nx+2])
      const Row wkc2 = above<false>(w2, k0, nzm);
      const Row U2b = U2a;
      EACH(i) {
        const C au = u2.v[i], ir = irho.v[i];
        const C wsum = ad(ad(ad(w3.v[i], wkc3.v[i]), w2.v[i]), wkc2.v[i]);
        const C coef = mu(sb(fabs(au), mu(mu(au, au), ir)), C(0.5));
        if (HOIST) {  // coefA (f_i - f_ib) - acrossA (kc - kb)(f_ib + f_i)
          const C across = mu(mu(mu(mu(C(0.03125), au), wsum), dd.v[i]), ir);
          const C tc = ad(gkc2.v[i], gkc1.v[i]), tb = ad(gkb2.v[i], gkb1.v[i]);
          U2a.v[i] = rnd(sb(mu(coef, sb(g1.v[i], g2.v[i])), mu(across, sb(tc, tb))));
        } else {
          const C dz = mu(dd.v[i], sb(sb(ad(gkc2.v[i], gkc1.v[i]), gkb2.v[i]), gkb1.v[i]));
          const C across = mu(mu(mu(C(0.03125), au), wsum), dz);
          U2a.v[i] = rnd(sb(mu(coef, sb(g1.v[i], g2.v[i])), mu(across, ir)));
        }
      }
      if (MASKED) {
        if (!in(p - 1, 0, nx + 2)) U2a = a2;
        if (p - 1 == rows) U2a = U2b;
      }
      // www2[p-2] (f1 rows p-3..p-1; w row p-2; u rows p-2, p-1; gi in
      // [0, nx+1]), zero at k = 0
      const Row ukb2 = below(u2, lane);
      const bool w2in = !MASKED || in(p - 2, 0, nx + 1);
      Row W2;
      EACH(i) {
        const C bw = w3.v[i];
        const C usum = ad(ad(ad(ukb3.v[i], u3.v[i]), u2.v[i]), ukb2.v[i]);
        const C coef = mu(sb(fabs(bw), mu(mu(bw, bw), irhow.v[i])), C(0.5));
        C v;
        if (HOIST) {  // coefB (f_i - kb f_i) - acrossB (kb(dfc) + dfc)
          const C across = mu(mu(mu(C(0.03125), bw), usum), irho.v[i]);
          const C dfc = sb(g1.v[i], g3.v[i]), dfcb = sb(gkb1.v[i], gkb3.v[i]);
          v = rnd(sb(mu(coef, sb(g2.v[i], gkb2.v[i])), mu(across, ad(dfcb, dfc))));
        } else {
          const C dx = sb(sb(ad(gkb1.v[i], g1.v[i]), gkb3.v[i]), g3.v[i]);
          const C across = mu(mu(mu(C(0.03125), bw), usum), dx);
          v = rnd(sb(mu(coef, sb(g2.v[i], gkb2.v[i])), mu(across, irho.v[i])));
        }
        W2.v[i] = k0 + i == 0 ? C(0) : (w2in ? v : b3.v[i]);
      }

      // -- stage 5a/5b: f1's extrema at row p-2 folded with f's; the in/out
      // flux ratios there
      const Row W2kc = above<false>(W2, k0, nzm);
      Row MXrP = MXr, MNrP = MNr;
      EACH(i) {
        const C f1c = g2.v[i];
        const C mx = fmax(fmax(fmax(g3.v[i], g1.v[i]), fmax(gkb2.v[i], gkc2.v[i])),
                          fmax(f1c, mxfP.v[i]));
        const C mn = fmin(fmin(fmin(g3.v[i], g1.v[i]), fmin(gkb2.v[i], gkc2.v[i])),
                          fmin(f1c, mnfP.v[i]));
        const C ru = U2a.v[i], uc = U2b.v[i], wkc = W2kc.v[i], wc = W2.v[i];
        const C iz = iadz.v[i], rr = rho.v[i];
        MXr.v[i] = rnd(dv(mu(rr, sb(mx, f1c)),
                          ad(ad(ad(pn(ru), pp(uc)), mu(iz, ad(pn(wkc), pp(wc)))),
                             C(1.0e-10))));
        MNr.v[i] = rnd(dv(mu(rr, sb(f1c, mn)),
                          ad(ad(ad(pp(ru), pn(uc)), mu(iz, ad(pp(wkc), pn(wc)))),
                             C(1.0e-10))));
      }
      if (MASKED && p == 2) {  // the ratios' row -1 is their row 0
        MXrP = MXr;
        MNrP = MNr;
      }

      // -- stage 5c: the limited fluxes uuu3[p-2] (gi in [1, nx+1]) and
      // www3[p-2] (gi in [1, nx])
      const Row MXkb = below(MXr, lane), MNkb = below(MNr, lane);
      const Row U3b = U3a, W3b = W3a;
      EACH(i) {
        const C lu = U2b.v[i], lw = W2.v[i];
        U3a.v[i] = rnd(sb(mu(pp(lu), min3(C(1), MXr.v[i], MNrP.v[i])),
                          mu(pn(lu), min3(C(1), MXrP.v[i], MNr.v[i]))));
        W3a.v[i] = rnd(sb(mu(pp(lw), min3(C(1), MXr.v[i], MNkb.v[i])),
                          mu(pn(lw), min3(C(1), MXkb.v[i], MNr.v[i]))));
      }
      if (MASKED) {
        if (!in(p - 2, 1, nx + 1)) U3a = U2b;
        if (!in(p - 2, 1, nx)) W3a = W2;
        if (p - 2 == rows) U3a = U3b;
      }

      // -- stage 6: the final update of f row p-3 (gi in [1, nx]), with the
      // positive clip
      const Row W3up = above<true>(W3b, k0, nzm);
      Row fN;
      EACH(i) {
        const C upd = mu(ad(sb(U3a.v[i], U3b.v[i]), mu(sb(W3up.v[i], W3b.v[i]), iadz.v[i])),
                         irho.v[i]);
        fN.v[i] = rnd(fmax(C(0), sb(g3.v[i], upd)));
      }
      if (MASKED && !in(p - 3, 1, nx)) fN = g3;

      mxfP = mxfN;
      mnfP = mnfN;
      fkbB = fkbA;
      wkc3 = wkc2;
      ukb3 = ukb2;

      // flux sums over the flux rows of www and www3, in x order: a whole
      // slice's warp sums as it goes; a split slice's warps keep the rows
      // they own of the last step
      if (fluxed(p)) {
        if (chunks == 1) {
          EACH(i) fl1.v[i] = ad(fl1.v[i], b1.v[i]);
        } else if (step == a.nsteps - 1) {
          EACH(i) fluxrow[((p - flo) * W + j) * NZP + k0 + i] = b1.v[i];
        }
      }
      if (fluxed(p - 2)) {
        if (chunks == 1) {
          EACH(i) fl2.v[i] = ad(fl2.v[i], W3a.v[i]);
        } else if (step == a.nsteps - 1) {
          EACH(i) fluxrow[((NF + p - 2 - flo) * W + j) * NZP + k0 + i] = W3a.v[i];
        }
      }
      if (MASKED) {  // every row is the final update (or f1 outside its range)
        if (p >= 3 && owned(p - 3)) {
          S* d = out_row(step, p - 3);
          if (d != nullptr) store_row<L, S, C>(d, fN, k0, nzm);
        }
      } else {  // rows 0 and nx+5 pass through, 1, 2, nx+3 and nx+4 are f1,
                // 3..nx+2 the final update
        if constexpr (LANES) {
          if ((p == 0 || p == rows - 1) && owned(p)) io.put(a, p, fA);
          if ((p == 2 || p == 3 || p == nx + 4 || p == nx + 5) && owned(p - 1))
            io.put(a, p - 1, g1);
          if (p >= 6 && owned(p - 3)) io.put(a, p - 3, fN);
        } else {
          if ((p == 0 || p == rows - 1) && owned(p))
            store_row<L, S, C>(wbuf + p * nzm, fA, k0, nzm);
          if ((p == 2 || p == 3 || p == nx + 4 || p == nx + 5) && owned(p - 1))
            store_row<L, S, C>(wbuf + (p - 1) * nzm, g1, k0, nzm);
          if (p >= 6 && owned(p - 3)) store_row<L, S, C>(wbuf + (p - 3) * nzm, fN, k0, nzm);
        }
      }
    }
  }
  if constexpr (LANES) {  // the ring's last four rows
    io.sync();
    for (int r = p1 - 3 > 0 ? p1 - 3 : 0; r <= p1; ++r)
      if (owned(r)) io.flush(a, r);
  }
  if (chunks > 1) {  // the first warp of a split slice sums its flux rows
    __syncthreads();
    if (c != 0) return;
    EACH(i) fl1.v[i] = fl2.v[i] = C(0);
    for (int r = 0; r < NF; ++r) {
      EACH(i) {
        fl1.v[i] = ad(fl1.v[i], fluxrow[(r * W + j) * NZP + k0 + i]);
        fl2.v[i] = ad(fl2.v[i], fluxrow[((NF + r) * W + j) * NZP + k0 + i]);
      }
    }
  }
  // flux(:, k < nzm) = (the www sum) + (the www3 sum), each as S holds it
  if constexpr (LANES) {
    Row x;
    EACH(i) x.v[i] = ad(rnd(fl1.v[i]), rnd(fl2.v[i]));
    io.store_flux(a, x);
  } else {
    EACH(i) {
      if (k0 + i < nzm)
        a.flux_out[s * fstride + k0 + i] = V::st(ad(rnd(fl1.v[i]), rnd(fl2.v[i])));
    }
  }
}

// the shared memory a launch asks for
template <typename S, typename C, bool LANES>
__host__ inline size_t smem_bytes(int nflux, int L, int chunks) {
  return LANES ? lanes_smem_bytes<S, C>(L, chunks, nflux)
               : sweep_smem_bytes<C>(nflux, L, chunks);
}

template <typename S, typename C, int L, bool SPLIT, bool HOIST, bool MASKED, bool LANES>
int launch_sweep(const Sweep<S>& a, void* stream) {
  const size_t bytes = smem_bytes<S, C, LANES>(
      flux_rows(a.gi0, a.nx, a.owned_lo, a.owned_hi), L, a.chunks);
  auto kernel = mpdata_sweep_kernel<S, C, L, SPLIT, HOIST, MASKED, LANES>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  // slices a block: LANES_WARPS / chunks side by side, one split slice, or
  // SWEEP_WARPS whole ones
  const int per_block = LANES ? LANES_WARPS / a.chunks : SPLIT ? 1 : SWEEP_WARPS;
  const unsigned blocks = static_cast<unsigned>((a.nslices + per_block - 1) / per_block);
  kernel<<<blocks, LANES ? 32 * LANES_WARPS : SPLIT ? 32 * a.chunks : 32 * SWEEP_WARPS,
           bytes, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// One launch of the sweep.  warps > 0 gives each slice that many warps (1,
// or 2, 4 or 8 where its rows and shared memory allow, nzm <= 64); 0 picks:
// SPLIT_WARPS below FEW_SLICES slices where they fit, else one.  Returns a
// CUDA error code (cudaErrorInvalidValue for a geometry it does not take).
template <typename S, typename C, bool HOIST, bool MASKED, bool LANES = false>
int launch_mpdata_sweep(Sweep<S> a, int warps, void* stream) {
  if (a.nzm < 1 || a.nzm > MAX_LEVELS || a.rows < 1 || warps < 0 || warps > MAX_CHUNKS ||
      (warps & (warps - 1)) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int device = 0, optin = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  const int nflux = flux_rows(a.gi0, a.nx, a.owned_lo, a.owned_hi);
  auto fits = [&](int k) {  // k warps a slice, each writing 4 rows or more
    return a.nzm <= 64 && a.rows - 6 >= 4 * k &&
           smem_bytes<S, C, LANES>(nflux, 2, k) <= static_cast<size_t>(optin);
  };
  int chunks = warps;
  if (chunks == 0) {
    chunks = 1;
    while (chunks < SPLIT_WARPS && a.nslices * chunks < FEW_SLICES && fits(2 * chunks))
      chunks *= 2;
  } else if (chunks > 1 && !fits(chunks)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  a.chunks = chunks;
  if (chunks > 1) return launch_sweep<S, C, 2, true, HOIST, MASKED, LANES>(a, stream);
  if (a.nzm <= 64) return launch_sweep<S, C, 2, false, HOIST, MASKED, LANES>(a, stream);
  if (a.nzm <= 128) return launch_sweep<S, C, 4, false, HOIST, MASKED, LANES>(a, stream);
  return launch_sweep<S, C, 8, false, HOIST, MASKED, LANES>(a, stream);
}

}  // namespace
