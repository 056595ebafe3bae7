// n MPDATA advect_scalar2D steps in one kernel launch, in two forms:
//
//   hoisted: K2 and K9.  The step-invariant factors are computed once per
//     launch and the antidiffusive velocities from them.  Replaces
//     cdk_tpu/kernels/mpdata/pallas_xmajor.py::_kernel (via _run_xmajor) and
//     pallas_resident.py::_kernel_hoisted, whose stage math is
//     pallas_resident.py::make_invariants and advect_packed_hoisted.
//   staged: K6, K7 and K8.  Every step is the stage-exact
//     reference.advect_scalar2d: the antidiffusive velocities are computed from
//     u and w each step in the reference's operation order (_andiff, _across,
//     dd * (kc + kc - kb - kb)).  Replaces mpdata/pallas_fused.py::_kernel (one
//     step), pallas_packed.py::_kernel (one step; its bf16 form is the
//     __nv_bfloat16 storage type below) and pallas_resident.py::_kernel (n steps
//     in the kernel).
//
// The TPU kernels' vreg packings (16 slices per (8,128) tile or two slices per
// 128-lane row, 64-lane z segments, per-segment clamp masks, the kspan input) are
// not carried over: both forms take the canonical (S, X, Z) layout.  Values are
// stored as S and computed in C: S = C = float or double, or (staged only) S =
// bf16 with C = float, where every value a stage produces is rounded to bf16.
//
// Both forms read u, w and the per-level fields and write f and flux once per
// launch at least; at production (8192 slices, nx 32, nzm 57, f32) that is
// 289 MB, 86 us at 3.35 TB/s, and their arithmetic is under half of that.
//
// ---- The hoisted form (mpdata_hoisted_kernel) keeps the code it was ported
// with: one block of 256 threads per slice, the slice's f, the upwind state, the
// antidiffusive coefficients and the stage temporaries in dynamic shared memory
// ((12 nx + 50) nzm values, 195 KB at nx 32, nzm 57, f64; the wrapper refuses a
// slice beyond the card's per-block opt-in limit), each stage a loop of the
// block's threads over (x, z) points followed by __syncthreads(), the two flux
// column sums taken per level by one thread in x order.  nvcc contracts a*b + c
// into FMAs.  Its outputs stay those of the kernel K2 and K9 have run since they
// were ported; it is queued for the staged form's design in its own change.
//
// ---- The staged form (mpdata_sweep_kernel) is built for this card.  The
// block-per-slice design it replaces spent its time on three things: the
// slice's load and store ran serialised with its compute (no block overlapped
// them), six block barriers a step over a 67.5 KB shared-memory slice (3 blocks
// an SM), and the two serial 32-term flux column sums, each on 57 of 256 threads.
// Here one warp owns a slice and sweeps it along x, its 32 lanes across the
// levels: lane l holds the L contiguous levels k = L l .. L l + L - 1 (L = 2 up
// to 64 levels, 4 up to 128, 8 up to 256).  Iteration p takes row p of f and
// rows p-1 of u and w, and each stage runs a fixed lag behind the rows it reads:
// uuu/www at row p-1, the upwind f1 at p-1, uuu2 at p-2, www2 at p-3, the limiter
// ratios at f row p-2, uuu3/www3 at p-3 and the final f at p-3.  The few rows
// each stage still needs live in registers; a neighbour at k-1 or k+1 is one warp
// shuffle (the lane's own other levels need none).  So the step uses no shared
// memory and no barrier; the next iteration's rows are loaded one iteration
// ahead, so they are in flight while this one computes; and the flux column sums
// are each lane's running sums in x order, the order the old form used.  Warps
// are independent, so the card holds as many slices at once as registers allow.
// f moves from f_in to f_out in the first step; a later step of the same launch
// (K8) sweeps f_out in place, each lane reading a row of its levels before it
// writes it, through loads at L2.  With fewer than FEW_SLICES slices (the
// shipped 48) one warp per slice would leave most of the card idle, so a
// slice's interior rows are split among 2 or 4 warps of a block: each sweeps
// its rows and three more each side and writes its own, a later step first
// copies the neighbours' three rows it reads (a named barrier per slice before
// and after), and the flux rows go to shared memory, where the first warp sums
// them in x order, so the split changes no bit of f or flux.  Every add,
// subtract, multiply and divide
// is an _rn intrinsic, so nvcc contracts nothing and f is rounded as the plain
// version rounds it; only the flux column sums are taken in another order than
// torch.sum.
//
// Index conventions of the hoisted form (0-based rows of nzm levels, x offsets as
// in the reference):
//   f, f1 rows 0..nx+5   u, uuu rows 0..nx+4   w, www rows 0..nx+3
//   U2 rows 0..nx+2 (u row j+1)   W2, mx/mn rows 0..nx+1 (f row j+2)
//   U3[j] (j=0..nx) and W3[j] (j=0..nx-1) are stored at row j+1 of the slot
//   that held U2/W2, which is the row each one reads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;       // the hoisted form: threads per slice
constexpr int SWEEP_WARPS = 4;     // the staged form: slices (warps) per block
constexpr int MAX_LEVELS = 32 * 8; // the staged form: nzm it takes (L <= 8)
constexpr unsigned FULL = 0xffffffffu;

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

__host__ __device__ inline size_t hoisted_smem_elems(int nx, int nzm) {
  return (size_t)(12 * nx + 50) * nzm;
}

template <typename S, typename C>
__global__ void __launch_bounds__(THREADS)
mpdata_hoisted_kernel(const S* __restrict__ f_in, const S* __restrict__ u_in,
                      const S* __restrict__ w_in, const S* __restrict__ rho_in,
                      const S* __restrict__ rhow_in, const S* __restrict__ adz_in,
                      const S* __restrict__ flux_in, S* __restrict__ f_out,
                      S* __restrict__ flux_out, int nx, int nzm, int nsteps) {
  using V = Cvt<S, C>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  S* sm = reinterpret_cast<S*>(smem_raw);
  const int nz = nzm + 1;
  const int XF = nx + 6, XU = nx + 5, XW = nx + 4;
  const size_t s = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;

  S* irho = sm;                  // per level
  S* iadz = irho + nzm;
  S* dd = iadz + nzm;
  S* irhow = dd + nzm;
  S* rho = irhow + nzm;
  S* flux = rho + nzm;           // the step's flux, levels 0..nzm-1
  S* fa = flux + nzm;            // XF rows: f / f1, swapped each step
  S* fb = fa + XF * nzm;
  S* u = fb + XF * nzm;          // XU rows
  S* w = u + XU * nzm;           // XW rows, levels 0..nzm-1 of w
  S* cA = w + XW * nzm;          // nx+3 rows
  S* xA = cA + (nx + 3) * nzm;
  S* cB = xA + (nx + 3) * nzm;   // nx+2 rows
  S* xB = cB + (nx + 2) * nzm;
  S* A = xB + (nx + 2) * nzm;    // XU rows: uuu -> U2 -> U3
  S* B = A + XU * nzm;           // XW rows: www -> W2 -> W3
  S* mxr = B + XW * nzm;         // nx+2 rows
  S* mnr = mxr + (nx + 2) * nzm;

  // ---- load the slice
  const S* fs = f_in + s * XF * nzm;
  for (int i = tid; i < XF * nzm; i += nt) fa[i] = fs[i];
  const S* us = u_in + s * XU * nzm;
  for (int i = tid; i < XU * nzm; i += nt) u[i] = us[i];
  const S* ws = w_in + s * XW * nz;
  for (int i = tid; i < XW * nzm; i += nt) w[i] = ws[(i / nzm) * nz + i % nzm];
  for (int k = tid; k < nzm; k += nt) {
    const C r = V::ld(rho_in[s * nzm + k]), a = V::ld(adz_in[s * nzm + k]);
    const int span = min(nzm - 1, k + 1) - max(0, k - 1);
    irho[k] = V::st(C(1) / r);
    iadz[k] = V::st(C(1) / a);
    dd[k] = V::st(C(2) / C(span) / a);
    irhow[k] = V::st(C(1) / (V::ld(rhow_in[s * nz + k]) * a));
    rho[k] = rho_in[s * nzm + k];
    flux[k] = flux_in[s * nz + k];
  }
  __syncthreads();

  // ---- step-invariant antidiffusive coefficients (make_invariants)
  for (int i = tid; i < (nx + 3) * nzm; i += nt) {
    const int j = i / nzm, k = i % nzm, kc = min(k + 1, nzm - 1);
    const C au = u[(j + 1) * nzm + k];
    const C wsum = ((w[j * nzm + k] + w[j * nzm + kc]) + w[(j + 1) * nzm + k]) +
                   w[(j + 1) * nzm + kc];
    cA[i] = (fabs(au) - au * au * irho[k]) * C(0.5);
    xA[i] = (((C(0.03125) * au) * wsum) * dd[k]) * irho[k];
  }
  for (int i = tid; i < (nx + 2) * nzm; i += nt) {
    const int j = i / nzm, k = i % nzm, kb = max(k - 1, 0);
    const C bw = w[(j + 1) * nzm + k];
    const C usum = ((u[(j + 1) * nzm + kb] + u[(j + 1) * nzm + k]) +
                    u[(j + 2) * nzm + k]) + u[(j + 2) * nzm + kb];
    cB[i] = (fabs(bw) - bw * bw * irhow[k]) * C(0.5);
    xB[i] = ((C(0.03125) * bw) * usum) * irho[k];
  }
  __syncthreads();

  S* f = fa;
  S* f1 = fb;
  for (int step = 0; step < nsteps; ++step) {
    // -- stage 2: first-order upwind fluxes
    for (int i = tid; i < XU * nzm; i += nt) {
      const C uv = V::ld(u[i]);
      A[i] = V::st(pp(uv) * V::ld(f[i]) - pn(uv) * V::ld(f[i + nzm]));
    }
    for (int i = tid; i < XW * nzm; i += nt) {
      const int j = i / nzm, k = i % nzm, kb = max(k - 1, 0);
      const C wv = V::ld(w[i]);
      B[i] = V::st(pp(wv) * V::ld(f[(j + 1) * nzm + kb]) -
                   pn(wv) * V::ld(f[(j + 1) * nzm + k]));
    }
    __syncthreads();

    // -- flux column sum over i=1..nx; stage 3: upwind update (rows 1..nx+4)
    for (int k = tid; k < nzm; k += nt) {
      C acc = C(0);
      for (int j = 2; j < nx + 2; ++j) acc += V::ld(B[j * nzm + k]);
      flux[k] = V::st(acc);
    }
    for (int i = tid; i < XF * nzm; i += nt) {
      const int j = i / nzm, k = i % nzm;
      if (j == 0 || j == XF - 1) {
        f1[i] = f[i];
      } else {
        const int r = j - 1;  // uuu / www row of this update
        const C wtop = k + 1 < nzm ? V::ld(B[r * nzm + k + 1]) : C(0);  // www(nz)=0
        const C upd = ((V::ld(A[(r + 1) * nzm + k]) - V::ld(A[r * nzm + k])) +
                       (wtop - V::ld(B[r * nzm + k])) * V::ld(iadz[k])) * V::ld(irho[k]);
        f1[i] = V::st(V::ld(f[i]) - upd);
      }
    }
    __syncthreads();

    // -- stage 4: antidiffusive pseudo-velocities U2 -> A, W2 -> B, in body
    // coordinates (U2[j] is uuu2 at u row j+1, W2[j] is www2 at w row j+1)
    for (int i = tid; i < (nx + 3) * nzm; i += nt) {
      const int j = i / nzm, k = i % nzm;
      const int kb = max(k - 1, 0), kc = min(k + 1, nzm - 1);
      const C fib = V::ld(f1[(j + 1) * nzm + k]), fi = V::ld(f1[(j + 2) * nzm + k]);
      const C tc = V::ld(f1[(j + 1) * nzm + kc]) + V::ld(f1[(j + 2) * nzm + kc]);
      const C tb = V::ld(f1[(j + 1) * nzm + kb]) + V::ld(f1[(j + 2) * nzm + kb]);
      A[i] = V::st(V::ld(cA[i]) * (fi - fib) - V::ld(xA[i]) * (tc - tb));
    }
    for (int i = tid; i < (nx + 2) * nzm; i += nt) {
      const int j = i / nzm, k = i % nzm, kb = max(k - 1, 0);
      if (k == 0) {  // bottom boundary www(:,:,1) = 0
        B[i] = V::st(C(0));
        continue;
      }
      const C bfi = V::ld(f1[(j + 2) * nzm + k]), bfib = V::ld(f1[(j + 2) * nzm + kb]);
      const C dfc = V::ld(f1[(j + 3) * nzm + k]) - V::ld(f1[(j + 1) * nzm + k]);
      const C dfcb = V::ld(f1[(j + 3) * nzm + kb]) - V::ld(f1[(j + 1) * nzm + kb]);
      B[i] = V::st(V::ld(cB[i]) * (bfi - bfib) - V::ld(xB[i]) * (dfcb + dfc));
    }
    __syncthreads();

    // -- stage 5a/5b: extrema over f and f1 (max/min are exact, so both
    // passes' stencils fold into one), in/out flux ratios
    for (int i = tid; i < (nx + 2) * nzm; i += nt) {
      const int j = i / nzm, k = i % nzm;
      const int kb = max(k - 1, 0), kc = min(k + 1, nzm - 1);
      const int c = (j + 2) * nzm;
      C mx = fmax(fmax(fmax(V::ld(f[c - nzm + k]), V::ld(f[c + nzm + k])),
                       fmax(V::ld(f[c + kb]), V::ld(f[c + kc]))),
                  V::ld(f[c + k]));
      C mn = fmin(fmin(fmin(V::ld(f[c - nzm + k]), V::ld(f[c + nzm + k])),
                       fmin(V::ld(f[c + kb]), V::ld(f[c + kc]))),
                  V::ld(f[c + k]));
      const C f1c = V::ld(f1[c + k]);
      mx = fmax(fmax(fmax(V::ld(f1[c - nzm + k]), V::ld(f1[c + nzm + k])),
                     fmax(V::ld(f1[c + kb]), V::ld(f1[c + kc]))),
                fmax(f1c, mx));
      mn = fmin(fmin(fmin(V::ld(f1[c - nzm + k]), V::ld(f1[c + nzm + k])),
                     fmin(V::ld(f1[c + kb]), V::ld(f1[c + kc]))),
                fmin(f1c, mn));
      const C rui = V::ld(A[j * nzm + k]), ruic = V::ld(A[(j + 1) * nzm + k]);
      const C rwi = V::ld(B[j * nzm + k]), rwkc = V::ld(B[j * nzm + kc]);
      const C r = V::ld(rho[k]), iz = V::ld(iadz[k]);
      mxr[i] = V::st(r * (mx - f1c) /
                     (((pn(ruic) + pp(rui)) + iz * (pn(rwkc) + pp(rwi))) + C(1.0e-10)));
      mnr[i] = V::st(r * (f1c - mn) /
                     (((pp(ruic) + pn(rui)) + iz * (pp(rwkc) + pn(rwi))) + C(1.0e-10)));
    }
    __syncthreads();

    // -- stage 5c: limited fluxes, each written over the U2/W2 value it reads
    for (int i = tid; i < (nx + 1) * nzm; i += nt) {
      const int j = i / nzm, k = i % nzm;
      const int r = (j + 1) * nzm + k;
      const C lu = V::ld(A[r]);
      A[r] = V::st(pp(lu) * min3(C(1), V::ld(mxr[r]), V::ld(mnr[j * nzm + k])) -
                   pn(lu) * min3(C(1), V::ld(mxr[j * nzm + k]), V::ld(mnr[r])));
    }
    for (int i = tid; i < nx * nzm; i += nt) {
      const int j = i / nzm, k = i % nzm, kb = max(k - 1, 0);
      const int r = (j + 1) * nzm;
      const C lw = V::ld(B[r + k]);
      B[r + k] = V::st(pp(lw) * min3(C(1), V::ld(mxr[r + k]), V::ld(mnr[r + kb])) -
                       pn(lw) * min3(C(1), V::ld(mxr[r + kb]), V::ld(mnr[r + k])));
    }
    __syncthreads();

    // -- flux += column sum of W3; stage 6: final update with positive clip
    for (int k = tid; k < nzm; k += nt) {
      C acc = C(0);
      for (int j = 1; j < nx + 1; ++j) acc += V::ld(B[j * nzm + k]);
      flux[k] = V::st(V::ld(flux[k]) + V::ld(V::st(acc)));
    }
    for (int i = tid; i < nx * nzm; i += nt) {
      const int j = i / nzm, k = i % nzm;
      const C wtop = k + 1 < nzm ? V::ld(B[(j + 1) * nzm + k + 1]) : C(0);
      const C upd = ((V::ld(A[(j + 2) * nzm + k]) - V::ld(A[(j + 1) * nzm + k])) +
                     (wtop - V::ld(B[(j + 1) * nzm + k])) * V::ld(iadz[k])) *
                    V::ld(irho[k]);
      const int r = (j + 3) * nzm + k;
      f1[r] = V::st(fmax(C(0), V::ld(f1[r]) - upd));
    }
    __syncthreads();
    // the new f is f1 with its interior replaced (halo rows keep f1's values)
    S* t = f;
    f = f1;
    f1 = t;
  }

  // ---- write back; flux(:, nz) passes through
  S* fo = f_out + s * XF * nzm;
  for (int i = tid; i < XF * nzm; i += nt) fo[i] = f[i];
  for (int k = tid; k < nz; k += nt)
    flux_out[s * nz + k] = k < nzm ? flux[k] : flux_in[s * nz + k];
}

template <typename S, typename C>
int launch_hoisted(const void* f, const void* u, const void* w, const void* rho,
                   const void* rhow, const void* adz, const void* flux, void* f_out,
                   void* flux_out, int nslices, int nx, int nzm, int nsteps,
                   void* stream) {
  const size_t bytes = hoisted_smem_elems(nx, nzm) * sizeof(S);
  auto kernel = mpdata_hoisted_kernel<S, C>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<nslices, THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const S*>(f), static_cast<const S*>(u), static_cast<const S*>(w),
      static_cast<const S*>(rho), static_cast<const S*>(rhow),
      static_cast<const S*>(adz), static_cast<const S*>(flux),
      static_cast<S*>(f_out), static_cast<S*>(flux_out), nx, nzm, nsteps);
  return static_cast<int>(cudaGetLastError());
}

// ---- the staged form: one warp per slice, an x sweep

__device__ __forceinline__ float ad(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sb(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mu(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float dv(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double ad(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sb(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ double mu(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double dv(double a, double b) { return __ddiv_rn(a, b); }

// loads at L2 (ld.global.cg): coherent with the stores of f_out that a later
// step of the same launch reads back, and nothing a lane reads is reused in L1
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

// the storage of one slice's flux rows (www and www3, rows 2..nx+1) when its
// x range is split among warps, and of each warp's six halo rows
template <typename C>
__host__ __device__ inline size_t sweep_smem_bytes(int nx, int L, int chunks) {
  return chunks == 1 ? 0
                     : (SWEEP_WARPS / chunks * 2 * (size_t)nx + SWEEP_WARPS * 6) * 32 * L *
                           sizeof(C);
}

// SPLIT instantiates the split-slice mode; without it chunks is 1 and its
// arithmetic folds away, which keeps the whole-slice sweep at its registers
template <typename S, typename C, int L, bool SPLIT>
__global__ void __launch_bounds__(SWEEP_WARPS * 32)
mpdata_sweep_kernel(const S* __restrict__ f_in, const S* __restrict__ u_in,
                    const S* __restrict__ w_in, const S* __restrict__ rho_in,
                    const S* __restrict__ rhow_in, const S* __restrict__ adz_in,
                    const S* __restrict__ flux_in, S* f_out, S* __restrict__ flux_out,
                    int nslices, int nx, int nzm, int nsteps, int split_chunks) {
  const int chunks = SPLIT ? split_chunks : 1;
  using V = Cvt<S, C>;
  using Row = Lv<L, C>;
  // a value as the storage type holds it
  auto rnd = [](C x) { return V::ld(V::st(x)); };
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int group = warp / chunks, c = warp % chunks;  // slice of the block, chunk
  const long long s = static_cast<long long>(blockIdx.x) * (SWEEP_WARPS / chunks) + group;
  if (s >= nslices) return;
  const int nz = nzm + 1, XF = nx + 6, XU = nx + 5, XW = nx + 4;
  const int k0 = L * lane, NZP = 32 * L;
  const S* fs = f_in + s * XF * nzm;
  S* fo = f_out + s * XF * nzm;
  const S* us = u_in + s * XU * nzm;
  const S* ws = w_in + s * XW * nz;
  // this warp's share of the slice: it writes f rows [own_lo, own_hi) (the
  // interior rows 3..nx+2 split evenly, the halo rows with the end chunks) and
  // sweeps rows [p0, p1], three more each side, which every row it writes needs
  const int q0 = 3 + nx * c / chunks, q1 = 3 + nx * (c + 1) / chunks;
  const int p0 = q0 - 3, p1 = q1 + 2;
  const int own_lo = c == 0 ? 0 : q0, own_hi = c == chunks - 1 ? XF : q1;
  auto owned = [&](int r) { return r >= own_lo && r < own_hi; };
  // split slices: the flux rows in shared memory, summed in x order at the
  // end, and each warp's halo rows (3 left, 3 right), lane-private slots
  extern __shared__ __align__(16) unsigned char smem_raw[];
  C* flux_rows = reinterpret_cast<C*>(smem_raw) + group * 2 * nx * NZP;
  C* halo = reinterpret_cast<C*>(smem_raw) + (SWEEP_WARPS / chunks * 2 * nx + warp * 6) * NZP;
  // the chunks of a slice meet at a named barrier of their own
  auto sync_slice = [&]() {
    asm volatile("bar.sync %0, %1;" ::"r"(1 + group), "r"(32 * chunks) : "memory");
  };

  if (lane == 0 && c == 0) flux_out[s * nz + nzm] = flux_in[s * nz + nzm];  // flux(:, nz)
  if (nsteps == 0) {
    for (int j = own_lo; j < own_hi; ++j)
      store_row<L, S, C>(fo + j * nzm, load_row<L, S, C>(fs + j * nzm, k0, nzm), k0, nzm);
    if (c == 0)
      store_row<L, S, C>(flux_out + s * nz, load_row<L, S, C>(flux_in + s * nz, k0, nzm),
                         k0, nzm);
    return;
  }

  // per-level fields, as the storage type holds them
  Row irho, iadz, dd, irhow, rho;
  EACH(i) {
    const int k = k0 + i;
    const bool in = k < nzm;
    const C r = in ? V::ld(rho_in[s * nzm + k]) : C(1);
    const C a = in ? V::ld(adz_in[s * nzm + k]) : C(1);
    const C rw = in ? V::ld(rhow_in[s * nz + k]) : C(1);
    const int span = in ? min(nzm - 1, k + 1) - max(0, k - 1) : 1;
    irho.v[i] = rnd(dv(C(1), r));
    iadz.v[i] = rnd(dv(C(1), a));
    dd.v[i] = rnd(dv(dv(C(2), C(span)), a));
    irhow.v[i] = rnd(dv(C(1), mu(rw, a)));
    rho.v[i] = r;
  }

  Row fl1, fl2;  // the step's two flux column sums
  for (int step = 0; step < nsteps; ++step) {
    const S* src = step > 0 ? fo : fs;
    // a later step of a split slice reads the rows its neighbours write in
    // this step: each warp first copies the halo rows it does not own, once
    // every warp has finished the step before
    const bool split = step > 0 && chunks > 1;
    if (split) {
      sync_slice();
      for (int j = 0; j < 3; ++j) {
        const int lo = p0 + j, hi = own_hi + j;
        const Row left = lo < own_lo ? load_row<L, S, C>(fo + lo * nzm, k0, nzm) : Row{};
        const Row right = hi <= p1 ? load_row<L, S, C>(fo + hi * nzm, k0, nzm) : Row{};
        EACH(i) {
          halo[j * NZP + k0 + i] = left.v[i];
          halo[(3 + j) * NZP + k0 + i] = right.v[i];
        }
      }
      sync_slice();
    }
    auto load_f = [&](int r) {
      if (split && (r < own_lo || r >= own_hi)) {
        const C* h = halo + (r < own_lo ? r - p0 : 3 + r - own_hi) * NZP;
        Row x;
        EACH(i) x.v[i] = h[k0 + i];
        return x;
      }
      return load_row<L, S, C>(src + r * nzm, k0, nzm);
    };
    // rows by lag: f[p], f[p-1], f[p-2]; u, w rows p-1, p-2, p-3; uuu, www
    // p-1 (a1, b1); f1 p-1, p-2, p-3 (g1, g2, g3) with their k-1 and k+1
    // neighbours; uuu2 p-2, p-3 (U2a, U2b); the ratios at f rows p-2, p-3
    // (MXr, MXrP); uuu3, www3 p-3, p-4 (U3a/b, W3a/b); f's extrema at f row
    // p-2 (mxfP); the k-1 / k+1 neighbours each later stage reuses
    Row fA{}, fB{}, fC{}, fkbB{}, u1{}, u2{}, u3{}, ukb3{}, w1{}, w2{}, w3{}, wkc3{};
    Row a1{}, b1{}, g1{}, g2{}, g3{}, gkb1{}, gkb2{}, gkb3{}, gkc1{}, gkc2{};
    Row mxfP{}, mnfP{}, U2a{}, MXr{}, MNr{}, U3a{}, W3a{};
    EACH(i) fl1.v[i] = fl2.v[i] = C(0);
    Row nf = load_f(p0), nu{}, nw{};
    if (p0 > 0) {
      nu = load_row<L, S, C>(us + (p0 - 1) * nzm, k0, nzm);
      nw = load_row<L, S, C>(ws + (p0 - 1) * nz, k0, nzm);
    }
    for (int p = p0; p <= p1; ++p) {
      fC = fB;
      fB = fA;
      fA = nf;
      u3 = u2;
      u2 = u1;
      u1 = nu;
      w3 = w2;
      w2 = w1;
      w1 = nw;
      if (p < p1) nf = load_f(p + 1);
      if (p < XU) nu = load_row<L, S, C>(us + p * nzm, k0, nzm);
      if (p < XW) nw = load_row<L, S, C>(ws + p * nz, k0, nzm);

      // -- stage 2: uuu[p-1] from f rows p-1, p; www[p-1] from f row p
      const Row fkbA = below(fA, lane);
      const Row a2 = a1, b2 = b1;
      EACH(i) {
        a1.v[i] = rnd(sb(mu(pp(u1.v[i]), fB.v[i]), mu(pn(u1.v[i]), fA.v[i])));
        b1.v[i] = rnd(sb(mu(pp(w1.v[i]), fkbA.v[i]), mu(pn(w1.v[i]), fA.v[i])));
      }
      // -- stage 3: the upwind update f1[p-1]
      const Row b2up = above<true>(b2, k0, nzm);
      g3 = g2;
      g2 = g1;
      EACH(i) {
        const C upd = mu(ad(sb(a1.v[i], a2.v[i]), mu(sb(b2up.v[i], b2.v[i]), iadz.v[i])),
                         irho.v[i]);
        g1.v[i] = rnd(sb(fB.v[i], upd));
      }
      gkb3 = gkb2;
      gkb2 = gkb1;
      gkb1 = below(g1, lane);
      gkc2 = gkc1;
      gkc1 = above<false>(g1, k0, nzm);

      // -- stage 1: f's extrema at f row p-1 (used at the next iteration)
      const Row fkcB = above<false>(fB, k0, nzm);
      Row mxfN, mnfN;
      EACH(i) {
        mxfN.v[i] = fmax(fmax(fmax(fC.v[i], fA.v[i]), fmax(fkbB.v[i], fkcB.v[i])), fB.v[i]);
        mnfN.v[i] = fmin(fmin(fmin(fC.v[i], fA.v[i]), fmin(fkbB.v[i], fkcB.v[i])), fB.v[i]);
      }

      // -- stage 4: uuu2[p-2] (f1 rows p-2, p-1; u row p-2; w rows p-3, p-2)
      const Row wkc2 = above<false>(w2, k0, nzm);
      const Row U2b = U2a;
      EACH(i) {
        const C au = u2.v[i], ir = irho.v[i];
        const C wsum = ad(ad(ad(w3.v[i], wkc3.v[i]), w2.v[i]), wkc2.v[i]);
        const C coef = mu(sb(fabs(au), mu(mu(au, au), ir)), C(0.5));
        const C dz = mu(dd.v[i], sb(sb(ad(gkc2.v[i], gkc1.v[i]), gkb2.v[i]), gkb1.v[i]));
        const C across = mu(mu(mu(C(0.03125), au), wsum), dz);
        U2a.v[i] = rnd(sb(mu(coef, sb(g1.v[i], g2.v[i])), mu(across, ir)));
      }
      // www2[p-3] (f1 rows p-3..p-1; w row p-3; u rows p-3, p-2), zero at k = 0
      const Row ukb2 = below(u2, lane);
      Row W2;
      EACH(i) {
        const C bw = w3.v[i];
        const C usum = ad(ad(ad(ukb3.v[i], u3.v[i]), u2.v[i]), ukb2.v[i]);
        const C coef = mu(sb(fabs(bw), mu(mu(bw, bw), irhow.v[i])), C(0.5));
        const C dx = sb(sb(ad(gkb1.v[i], g1.v[i]), gkb3.v[i]), g3.v[i]);
        const C across = mu(mu(mu(C(0.03125), bw), usum), dx);
        W2.v[i] = k0 + i == 0
                      ? C(0)
                      : rnd(sb(mu(coef, sb(g2.v[i], gkb2.v[i])), mu(across, irho.v[i])));
      }

      // -- stage 5a/5b: f1's extrema at f row p-2 folded with f's; the
      // in/out flux ratios there
      const Row W2kc = above<false>(W2, k0, nzm);
      const Row MXrP = MXr, MNrP = MNr;
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

      // -- stage 5c: the limited fluxes uuu3[p-3] and www3[p-3]
      const Row MXkb = below(MXr, lane), MNkb = below(MNr, lane);
      const Row U3b = U3a, W3b = W3a;
      EACH(i) {
        const C lu = U2b.v[i], lw = W2.v[i];
        U3a.v[i] = rnd(sb(mu(pp(lu), min3(C(1), MXr.v[i], MNrP.v[i])),
                          mu(pn(lu), min3(C(1), MXrP.v[i], MNr.v[i]))));
        W3a.v[i] = rnd(sb(mu(pp(lw), min3(C(1), MXr.v[i], MNkb.v[i])),
                          mu(pn(lw), min3(C(1), MXkb.v[i], MNr.v[i]))));
      }

      // -- stage 6: the final update of f row p-3, with the positive clip
      const Row W3up = above<true>(W3b, k0, nzm);
      Row fN;
      EACH(i) {
        const C upd = mu(ad(sb(U3a.v[i], U3b.v[i]), mu(sb(W3up.v[i], W3b.v[i]), iadz.v[i])),
                         irho.v[i]);
        fN.v[i] = rnd(fmax(C(0), sb(g3.v[i], upd)));
      }

      mxfP = mxfN;
      mnfP = mnfN;
      fkbB = fkbA;
      wkc3 = wkc2;
      ukb3 = ukb2;

      // flux sums over www rows 2..nx+1 and www3 rows 2..nx+1, in x order: a
      // whole slice's warp sums as it goes; a split slice's warps keep the
      // rows of the f rows they own (row r with f row r+1) of the last step
      if (p - 1 >= 2 && p - 1 <= nx + 1 && owned(p)) {
        if (chunks == 1) {
          EACH(i) fl1.v[i] = ad(fl1.v[i], b1.v[i]);
        } else if (step == nsteps - 1) {
          EACH(i) flux_rows[(p - 3) * NZP + k0 + i] = b1.v[i];
        }
      }
      if (p - 3 >= 2 && p - 3 <= nx + 1 && owned(p - 2)) {
        if (chunks == 1) {
          EACH(i) fl2.v[i] = ad(fl2.v[i], W3a.v[i]);
        } else if (step == nsteps - 1) {
          EACH(i) flux_rows[(nx + p - 5) * NZP + k0 + i] = W3a.v[i];
        }
      }
      // the new f: rows 0 and nx+5 pass through, 1, 2, nx+3 and nx+4 are f1,
      // 3..nx+2 the final update
      if ((p == 0 || p == XF - 1) && owned(p)) store_row<L, S, C>(fo + p * nzm, fA, k0, nzm);
      if ((p == 2 || p == 3 || p == nx + 4 || p == nx + 5) && owned(p - 1))
        store_row<L, S, C>(fo + (p - 1) * nzm, g1, k0, nzm);
      if (p >= 6 && owned(p - 3)) store_row<L, S, C>(fo + (p - 3) * nzm, fN, k0, nzm);
    }
  }
  if (chunks > 1) {  // the first warp of a split slice sums its flux rows
    sync_slice();
    if (c != 0) return;
    EACH(i) fl1.v[i] = fl2.v[i] = C(0);
    for (int r = 0; r < nx; ++r) {
      EACH(i) {
        fl1.v[i] = ad(fl1.v[i], flux_rows[r * NZP + k0 + i]);
        fl2.v[i] = ad(fl2.v[i], flux_rows[(nx + r) * NZP + k0 + i]);
      }
    }
  }
  // flux(:, k < nz) = (the www sum) + (the www3 sum), each as S holds it
  EACH(i) {
    if (k0 + i < nzm) flux_out[s * nz + k0 + i] = V::st(ad(rnd(fl1.v[i]), rnd(fl2.v[i])));
  }
}

// One warp per slice fills the card only when there are slices enough: below
// FEW_SLICES a slice's x range is split among 2 or 4 warps of one block, each
// writing at least 4 of the interior rows, where shared memory holds the
// slice's flux rows.  f and flux come out the same, bit for bit.
constexpr int FEW_SLICES = 1024;

template <typename S, typename C, int L, bool SPLIT>
int launch_sweep(const void* f, const void* u, const void* w, const void* rho,
                 const void* rhow, const void* adz, const void* flux, void* f_out,
                 void* flux_out, int nslices, int nx, int nzm, int nsteps, int chunks,
                 void* stream) {
  const size_t bytes = sweep_smem_bytes<C>(nx, L, chunks);
  auto kernel = mpdata_sweep_kernel<S, C, L, SPLIT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int per_block = SWEEP_WARPS / chunks;  // slices
  const unsigned blocks = static_cast<unsigned>((nslices + per_block - 1) / per_block);
  kernel<<<blocks, SWEEP_WARPS * 32, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const S*>(f), static_cast<const S*>(u), static_cast<const S*>(w),
      static_cast<const S*>(rho), static_cast<const S*>(rhow),
      static_cast<const S*>(adz), static_cast<const S*>(flux),
      static_cast<S*>(f_out), static_cast<S*>(flux_out), nslices, nx, nzm, nsteps, chunks);
  return static_cast<int>(cudaGetLastError());
}

template <typename S, typename C>
int launch_staged(const void* f, const void* u, const void* w, const void* rho,
                  const void* rhow, const void* adz, const void* flux, void* f_out,
                  void* flux_out, int nslices, int nx, int nzm, int nsteps, void* stream) {
  // slices of up to 64 levels (the split mode's only form) are split when few
  int device = 0, optin = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  int chunks = 1;
  while (nzm <= 64 && chunks < SWEEP_WARPS && nslices * chunks < FEW_SLICES &&
         nx >= 8 * chunks && sweep_smem_bytes<C>(nx, 2, 2 * chunks) <= static_cast<size_t>(optin))
    chunks *= 2;
  if (chunks > 1)
    return launch_sweep<S, C, 2, true>(f, u, w, rho, rhow, adz, flux, f_out, flux_out,
                                       nslices, nx, nzm, nsteps, chunks, stream);
  if (nzm <= 64)
    return launch_sweep<S, C, 2, false>(f, u, w, rho, rhow, adz, flux, f_out, flux_out,
                                        nslices, nx, nzm, nsteps, 1, stream);
  if (nzm <= 128)
    return launch_sweep<S, C, 4, false>(f, u, w, rho, rhow, adz, flux, f_out, flux_out,
                                        nslices, nx, nzm, nsteps, 1, stream);
  if (nzm <= MAX_LEVELS)
    return launch_sweep<S, C, 8, false>(f, u, w, rho, rhow, adz, flux, f_out, flux_out,
                                        nslices, nx, nzm, nsteps, 1, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// Shared memory one slice of the hoisted form needs, in bytes.
long long cdk_mpdata_resident_smem_bytes(int nx, int nzm, int itemsize) {
  return static_cast<long long>(hoisted_smem_elems(nx, nzm)) * itemsize;
}

// The most levels (nzm) a slice of the staged form may have.
int cdk_mpdata_staged_max_levels() { return MAX_LEVELS; }

// The largest dynamic shared memory a block may opt in to on `device`.
int cdk_max_shared_optin(int device) {
  int v = 0;
  cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return v;
}

// f (S,nx+6,nzm), u (S,nx+5,nzm), w (S,nx+4,nzm+1), rho/adz (S,nzm),
// rhow/flux (S,nzm+1); outputs shaped like f and flux; all contiguous on one
// device.  Returns cudaGetLastError() after the launch.
#define CDK_MPDATA_ENTRY(name, launcher, S, C)                                          \
  int name(const void* f, const void* u, const void* w, const void* rho,               \
           const void* rhow, const void* adz, const void* flux, void* f_out,           \
           void* flux_out, int nslices, int nx, int nzm, int nsteps, void* stream) {   \
    return launcher<S, C>(f, u, w, rho, rhow, adz, flux, f_out, flux_out, nslices, nx, \
                          nzm, nsteps, stream);                                         \
  }

CDK_MPDATA_ENTRY(cdk_mpdata_resident_f32, launch_hoisted, float, float)
CDK_MPDATA_ENTRY(cdk_mpdata_resident_f64, launch_hoisted, double, double)
CDK_MPDATA_ENTRY(cdk_mpdata_staged_f32, launch_staged, float, float)
CDK_MPDATA_ENTRY(cdk_mpdata_staged_f64, launch_staged, double, double)
CDK_MPDATA_ENTRY(cdk_mpdata_staged_bf16, launch_staged, __nv_bfloat16, float)

}  // extern "C"
