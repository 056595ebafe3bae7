// n MPDATA advect_scalar2D steps in one kernel launch, in two forms:
//
//   hoisted (HOIST = true): K2 and K9.  The step-invariant factors are computed
//     once per launch and the antidiffusive velocities from them.  Replaces
//     cdk_tpu/kernels/mpdata/pallas_xmajor.py::_kernel (via _run_xmajor) and
//     pallas_resident.py::_kernel_hoisted, whose stage math is
//     pallas_resident.py::make_invariants and advect_packed_hoisted.
//   staged (HOIST = false): K6, K7 and K8.  Every step is the stage-exact
//     reference.advect_scalar2d: the antidiffusive velocities are computed from
//     u and w each step in the reference's operation order (_andiff, _across,
//     dd * (kc + kc - kb - kb)).  Replaces mpdata/pallas_fused.py::_kernel (one
//     step), pallas_packed.py::_kernel (one step; its bf16 form is the
//     __nv_bfloat16 storage type below) and pallas_resident.py::_kernel (n steps
//     in the kernel).
//
// The TPU kernels' vreg packings (16 slices per (8,128) tile or two slices per
// 128-lane row, 64-lane z segments, per-segment clamp masks, the kspan input) are
// not carried over: this kernel takes the canonical (S, X, Z) layout.  Values are
// stored as S and computed in C: S = C = float or double, or S = bf16 with C =
// float, where every value the kernel stores (each stage's result) is rounded to
// bf16.  nvcc contracts a*b + c into FMAs, so the staged form differs from its
// plain version (separate rounded tensor ops) by a few ulps per step.
//
// Design: one block per CRM slice (slices are independent 2-D x-z problems).
// The slice's f, the upwind state, (hoisted) the antidiffusive coefficients and
// the stage temporaries live in dynamic shared memory for the whole run; each stage is
// a loop of the block's threads over (x, z) points followed by __syncthreads().
// The two column sums of the vertical flux are taken per level k by one thread in
// a fixed x order, so the result does not depend on scheduling.  u, w and the
// per-level fields are read once per run, f and flux once in and once out.
//
// Bound: once the slice is resident the kernel is bound by the stencil
// arithmetic and its shared-memory operand traffic.  A slice needs
// (12*nx + 50) * nzm elements of shared memory hoisted (195 KB at nx=32,
// nzm=57, f64) and (8*nx + 40) * nzm staged (133 KB); the wrapper refuses a
// geometry beyond the card's per-block opt-in limit.
//
// Index conventions (0-based rows of nzm levels, x offsets as in the reference):
//   f, f1 rows 0..nx+5   u, uuu rows 0..nx+4   w, www rows 0..nx+3
//   U2 rows 0..nx+2 (u row j+1)   W2, mx/mn rows 0..nx+1 (f row j+2)
//   U3[j] (j=0..nx) and W3[j] (j=0..nx-1) are stored at row j+1 of the slot
//   that held U2/W2, which is the row each one reads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

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

__host__ __device__ inline size_t smem_elems(int nx, int nzm, bool hoist) {
  return (size_t)(hoist ? 12 * nx + 50 : 8 * nx + 40) * nzm;
}

template <typename S, typename C, bool HOIST>
__global__ void __launch_bounds__(THREADS)
mpdata_resident_kernel(const S* __restrict__ f_in, const S* __restrict__ u_in,
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
  S* cA = w + XW * nzm;          // hoisted only: nx+3 rows
  S* xA = cA + (HOIST ? (nx + 3) * nzm : 0);
  S* cB = xA + (HOIST ? (nx + 3) * nzm : 0);  // hoisted only: nx+2 rows
  S* xB = cB + (HOIST ? (nx + 2) * nzm : 0);
  S* A = xB + (HOIST ? (nx + 2) * nzm : 0);   // XU rows: uuu -> U2 -> U3
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

  if constexpr (HOIST) {
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
  }

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
      if constexpr (HOIST) {
        const C tc = V::ld(f1[(j + 1) * nzm + kc]) + V::ld(f1[(j + 2) * nzm + kc]);
        const C tb = V::ld(f1[(j + 1) * nzm + kb]) + V::ld(f1[(j + 2) * nzm + kb]);
        A[i] = V::st(V::ld(cA[i]) * (fi - fib) - V::ld(xA[i]) * (tc - tb));
      } else {
        // andiff(fib, fi, au, irho) - across(dd*(kc fib + kc fi - kb fib - kb fi),
        //                                   au, wib + kc wib + wi + kc wi) * irho
        const C au = V::ld(u[(j + 1) * nzm + k]), ir = V::ld(irho[k]);
        const C dz = V::ld(dd[k]) *
                     (((V::ld(f1[(j + 1) * nzm + kc]) + V::ld(f1[(j + 2) * nzm + kc])) -
                       V::ld(f1[(j + 1) * nzm + kb])) - V::ld(f1[(j + 2) * nzm + kb]));
        const C wsum = ((V::ld(w[j * nzm + k]) + V::ld(w[j * nzm + kc])) +
                        V::ld(w[(j + 1) * nzm + k])) + V::ld(w[(j + 1) * nzm + kc]);
        const C andiff = ((fabs(au) - au * au * ir) * C(0.5)) * (fi - fib);
        const C across = ((C(0.03125) * au) * wsum) * dz;
        A[i] = V::st(andiff - across * ir);
      }
    }
    for (int i = tid; i < (nx + 2) * nzm; i += nt) {
      const int j = i / nzm, k = i % nzm, kb = max(k - 1, 0);
      if (k == 0) {  // bottom boundary www(:,:,1) = 0
        B[i] = V::st(C(0));
        continue;
      }
      const C bfi = V::ld(f1[(j + 2) * nzm + k]), bfib = V::ld(f1[(j + 2) * nzm + kb]);
      if constexpr (HOIST) {
        const C dfc = V::ld(f1[(j + 3) * nzm + k]) - V::ld(f1[(j + 1) * nzm + k]);
        const C dfcb = V::ld(f1[(j + 3) * nzm + kb]) - V::ld(f1[(j + 1) * nzm + kb]);
        B[i] = V::st(V::ld(cB[i]) * (bfi - bfib) - V::ld(xB[i]) * (dfcb + dfc));
      } else {
        // andiff(kb fi, fi, bw, irhow) - across(kb fic + fic - kb fib - fib, bw,
        //                                       kb u + u + uic + kb uic) * irho
        const C bw = V::ld(w[(j + 1) * nzm + k]);
        const C dx = ((V::ld(f1[(j + 3) * nzm + kb]) + V::ld(f1[(j + 3) * nzm + k])) -
                      V::ld(f1[(j + 1) * nzm + kb])) - V::ld(f1[(j + 1) * nzm + k]);
        const C usum = ((V::ld(u[(j + 1) * nzm + kb]) + V::ld(u[(j + 1) * nzm + k])) +
                        V::ld(u[(j + 2) * nzm + k])) + V::ld(u[(j + 2) * nzm + kb]);
        const C andiff = ((fabs(bw) - bw * bw * V::ld(irhow[k])) * C(0.5)) * (bfi - bfib);
        const C across = ((C(0.03125) * bw) * usum) * dx;
        B[i] = V::st(andiff - across * V::ld(irho[k]));
      }
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

template <typename S, typename C, bool HOIST>
int launch(const void* f, const void* u, const void* w, const void* rho,
           const void* rhow, const void* adz, const void* flux, void* f_out,
           void* flux_out, int nslices, int nx, int nzm, int nsteps, void* stream) {
  const size_t bytes = smem_elems(nx, nzm, HOIST) * sizeof(S);
  auto kernel = mpdata_resident_kernel<S, C, HOIST>;
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

}  // namespace

extern "C" {

// Shared memory one slice needs, in bytes (hoist: the K2/K9 form).
long long cdk_mpdata_resident_smem_bytes(int nx, int nzm, int itemsize, int hoist) {
  return static_cast<long long>(smem_elems(nx, nzm, hoist != 0)) * itemsize;
}

// The largest dynamic shared memory a block may opt in to on `device`.
int cdk_max_shared_optin(int device) {
  int v = 0;
  cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return v;
}

// f (S,nx+6,nzm), u (S,nx+5,nzm), w (S,nx+4,nzm+1), rho/adz (S,nzm),
// rhow/flux (S,nzm+1); outputs shaped like f and flux; all contiguous on one
// device.  Returns cudaGetLastError() after the launch.
#define CDK_MPDATA_ENTRY(name, S, C, HOIST)                                             \
  int name(const void* f, const void* u, const void* w, const void* rho,               \
           const void* rhow, const void* adz, const void* flux, void* f_out,           \
           void* flux_out, int nslices, int nx, int nzm, int nsteps, void* stream) {   \
    return launch<S, C, HOIST>(f, u, w, rho, rhow, adz, flux, f_out, flux_out,         \
                               nslices, nx, nzm, nsteps, stream);                       \
  }

CDK_MPDATA_ENTRY(cdk_mpdata_resident_f32, float, float, true)
CDK_MPDATA_ENTRY(cdk_mpdata_resident_f64, double, double, true)
CDK_MPDATA_ENTRY(cdk_mpdata_staged_f32, float, float, false)
CDK_MPDATA_ENTRY(cdk_mpdata_staged_f64, double, double, false)
CDK_MPDATA_ENTRY(cdk_mpdata_staged_bf16, __nv_bfloat16, float, false)

}  // extern "C"
