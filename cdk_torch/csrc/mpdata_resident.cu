// K2: n MPDATA advect_scalar2D steps in one kernel launch, with the
// step-invariant factors computed once per launch.
//
// Replaces cdk_tpu/kernels/mpdata/pallas_xmajor.py::_kernel (via _run_xmajor),
// whose stage math is pallas_resident.py::make_invariants and
// advect_packed_hoisted.  The TPU kernel's x-major vreg packing (16 slices per
// (8,128) tile, 64-lane z segments, per-segment clamp masks) is not carried over:
// this kernel takes the canonical (S, X, Z) layout.
//
// Design: one block per CRM slice (slices are independent 2-D x-z problems).
// The slice's f, the upwind state, the hoisted antidiffusive coefficients and the
// stage temporaries live in dynamic shared memory for the whole run; each stage is
// a loop of the block's threads over (x, z) points followed by __syncthreads().
// The two column sums of the vertical flux are taken per level k by one thread in
// a fixed x order, so the result does not depend on scheduling.  u, w and the
// per-level fields are read once per run, f and flux once in and once out.
//
// Bound: once the slice is resident the kernel is bound by the stencil
// arithmetic and its shared-memory operand traffic.  A slice needs
// (12*nx + 50) * nzm elements of shared memory (195 KB at nx=32, nzm=57, f64);
// the wrapper refuses a geometry beyond the card's per-block opt-in limit.
//
// Index conventions (0-based rows of nzm levels, x offsets as in the reference):
//   f, f1 rows 0..nx+5   u, uuu rows 0..nx+4   w, www rows 0..nx+3
//   U2 rows 0..nx+2 (u row j+1)   W2, mx/mn rows 0..nx+1 (f row j+2)
//   U3[j] (j=0..nx) and W3[j] (j=0..nx-1) are stored at row j+1 of the slot
//   that held U2/W2, which is the row each one reads.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

template <typename T>
__device__ __forceinline__ T pp(T y) { return fmax(T(0), y); }
template <typename T>
__device__ __forceinline__ T pn(T y) { return -fmin(T(0), y); }
template <typename T>
__device__ __forceinline__ T min3(T a, T b, T c) { return fmin(fmin(a, b), c); }

__host__ __device__ inline size_t smem_elems(int nx, int nzm) {
  return (size_t)(12 * nx + 50) * nzm;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
mpdata_resident_kernel(const T* __restrict__ f_in, const T* __restrict__ u_in,
                       const T* __restrict__ w_in, const T* __restrict__ rho_in,
                       const T* __restrict__ rhow_in, const T* __restrict__ adz_in,
                       const T* __restrict__ flux_in, T* __restrict__ f_out,
                       T* __restrict__ flux_out, int nx, int nzm, int nsteps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int nz = nzm + 1;
  const int XF = nx + 6, XU = nx + 5, XW = nx + 4;
  const size_t s = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;

  T* irho = sm;                  // per level
  T* iadz = irho + nzm;
  T* dd = iadz + nzm;
  T* irhow = dd + nzm;
  T* rho = irhow + nzm;
  T* flux = rho + nzm;           // the step's flux, levels 0..nzm-1
  T* fa = flux + nzm;            // XF rows: f / f1, swapped each step
  T* fb = fa + XF * nzm;
  T* u = fb + XF * nzm;          // XU rows
  T* w = u + XU * nzm;           // XW rows, levels 0..nzm-1 of w
  T* cA = w + XW * nzm;          // nx+3 rows
  T* xA = cA + (nx + 3) * nzm;
  T* cB = xA + (nx + 3) * nzm;   // nx+2 rows
  T* xB = cB + (nx + 2) * nzm;
  T* A = xB + (nx + 2) * nzm;    // XU rows: uuu -> U2 -> U3
  T* B = A + XU * nzm;           // XW rows: www -> W2 -> W3
  T* mxr = B + XW * nzm;         // nx+2 rows
  T* mnr = mxr + (nx + 2) * nzm;

  // ---- load the slice
  const T* fs = f_in + s * XF * nzm;
  for (int i = tid; i < XF * nzm; i += nt) fa[i] = fs[i];
  const T* us = u_in + s * XU * nzm;
  for (int i = tid; i < XU * nzm; i += nt) u[i] = us[i];
  const T* ws = w_in + s * XW * nz;
  for (int i = tid; i < XW * nzm; i += nt) w[i] = ws[(i / nzm) * nz + i % nzm];
  for (int k = tid; k < nzm; k += nt) {
    const T r = rho_in[s * nzm + k], a = adz_in[s * nzm + k];
    const int span = min(nzm - 1, k + 1) - max(0, k - 1);
    irho[k] = T(1) / r;
    iadz[k] = T(1) / a;
    dd[k] = T(2) / T(span) / a;
    irhow[k] = T(1) / (rhow_in[s * nz + k] * a);
    rho[k] = r;
    flux[k] = flux_in[s * nz + k];
  }
  __syncthreads();

  // ---- step-invariant antidiffusive coefficients (make_invariants)
  for (int i = tid; i < (nx + 3) * nzm; i += nt) {
    const int j = i / nzm, k = i % nzm, kc = min(k + 1, nzm - 1);
    const T au = u[(j + 1) * nzm + k];
    const T wsum = ((w[j * nzm + k] + w[j * nzm + kc]) + w[(j + 1) * nzm + k]) +
                   w[(j + 1) * nzm + kc];
    cA[i] = (fabs(au) - au * au * irho[k]) * T(0.5);
    xA[i] = (((T(0.03125) * au) * wsum) * dd[k]) * irho[k];
  }
  for (int i = tid; i < (nx + 2) * nzm; i += nt) {
    const int j = i / nzm, k = i % nzm, kb = max(k - 1, 0);
    const T bw = w[(j + 1) * nzm + k];
    const T usum = ((u[(j + 1) * nzm + kb] + u[(j + 1) * nzm + k]) +
                    u[(j + 2) * nzm + k]) + u[(j + 2) * nzm + kb];
    cB[i] = (fabs(bw) - bw * bw * irhow[k]) * T(0.5);
    xB[i] = ((T(0.03125) * bw) * usum) * irho[k];
  }
  __syncthreads();

  T* f = fa;
  T* f1 = fb;
  for (int step = 0; step < nsteps; ++step) {
    // -- stage 2: first-order upwind fluxes
    for (int i = tid; i < XU * nzm; i += nt) {
      const T uv = u[i];
      A[i] = pp(uv) * f[i] - pn(uv) * f[i + nzm];
    }
    for (int i = tid; i < XW * nzm; i += nt) {
      const int j = i / nzm, k = i % nzm, kb = max(k - 1, 0);
      const T wv = w[i];
      B[i] = pp(wv) * f[(j + 1) * nzm + kb] - pn(wv) * f[(j + 1) * nzm + k];
    }
    __syncthreads();

    // -- flux column sum over i=1..nx; stage 3: upwind update (rows 1..nx+4)
    for (int k = tid; k < nzm; k += nt) {
      T acc = T(0);
      for (int j = 2; j < nx + 2; ++j) acc += B[j * nzm + k];
      flux[k] = acc;
    }
    for (int i = tid; i < XF * nzm; i += nt) {
      const int j = i / nzm, k = i % nzm;
      if (j == 0 || j == XF - 1) {
        f1[i] = f[i];
      } else {
        const int r = j - 1;  // uuu / www row of this update
        const T wtop = k + 1 < nzm ? B[r * nzm + k + 1] : T(0);  // www(nz)=0
        const T upd = ((A[(r + 1) * nzm + k] - A[r * nzm + k]) +
                       (wtop - B[r * nzm + k]) * iadz[k]) * irho[k];
        f1[i] = f[i] - upd;
      }
    }
    __syncthreads();

    // -- stage 4: antidiffusive pseudo-velocities U2 -> A, W2 -> B
    for (int i = tid; i < (nx + 3) * nzm; i += nt) {
      const int j = i / nzm, k = i % nzm;
      const int kb = max(k - 1, 0), kc = min(k + 1, nzm - 1);
      const T fib = f1[(j + 1) * nzm + k], fi = f1[(j + 2) * nzm + k];
      const T tc = f1[(j + 1) * nzm + kc] + f1[(j + 2) * nzm + kc];
      const T tb = f1[(j + 1) * nzm + kb] + f1[(j + 2) * nzm + kb];
      A[i] = cA[i] * (fi - fib) - xA[i] * (tc - tb);
    }
    for (int i = tid; i < (nx + 2) * nzm; i += nt) {
      const int j = i / nzm, k = i % nzm, kb = max(k - 1, 0);
      if (k == 0) {  // bottom boundary www(:,:,1) = 0
        B[i] = T(0);
        continue;
      }
      const T bfi = f1[(j + 2) * nzm + k], bfib = f1[(j + 2) * nzm + kb];
      const T dfc = f1[(j + 3) * nzm + k] - f1[(j + 1) * nzm + k];
      const T dfcb = f1[(j + 3) * nzm + kb] - f1[(j + 1) * nzm + kb];
      B[i] = cB[i] * (bfi - bfib) - xB[i] * (dfcb + dfc);
    }
    __syncthreads();

    // -- stage 5a/5b: extrema over f and f1 (max/min are exact, so both
    // passes' stencils fold into one), in/out flux ratios
    for (int i = tid; i < (nx + 2) * nzm; i += nt) {
      const int j = i / nzm, k = i % nzm;
      const int kb = max(k - 1, 0), kc = min(k + 1, nzm - 1);
      const int c = (j + 2) * nzm;
      T mx = fmax(fmax(fmax(f[c - nzm + k], f[c + nzm + k]), fmax(f[c + kb], f[c + kc])),
                  f[c + k]);
      T mn = fmin(fmin(fmin(f[c - nzm + k], f[c + nzm + k]), fmin(f[c + kb], f[c + kc])),
                  f[c + k]);
      const T f1c = f1[c + k];
      mx = fmax(fmax(fmax(f1[c - nzm + k], f1[c + nzm + k]), fmax(f1[c + kb], f1[c + kc])),
                fmax(f1c, mx));
      mn = fmin(fmin(fmin(f1[c - nzm + k], f1[c + nzm + k]), fmin(f1[c + kb], f1[c + kc])),
                fmin(f1c, mn));
      const T rui = A[j * nzm + k], ruic = A[(j + 1) * nzm + k];
      const T rwi = B[j * nzm + k], rwkc = B[j * nzm + kc];
      mxr[i] = rho[k] * (mx - f1c) /
               (((pn(ruic) + pp(rui)) + iadz[k] * (pn(rwkc) + pp(rwi))) + T(1.0e-10));
      mnr[i] = rho[k] * (f1c - mn) /
               (((pp(ruic) + pn(rui)) + iadz[k] * (pp(rwkc) + pn(rwi))) + T(1.0e-10));
    }
    __syncthreads();

    // -- stage 5c: limited fluxes, each written over the U2/W2 value it reads
    for (int i = tid; i < (nx + 1) * nzm; i += nt) {
      const int j = i / nzm, k = i % nzm;
      const int r = (j + 1) * nzm + k;
      const T lu = A[r];
      A[r] = pp(lu) * min3(T(1), mxr[r], mnr[j * nzm + k]) -
             pn(lu) * min3(T(1), mxr[j * nzm + k], mnr[r]);
    }
    for (int i = tid; i < nx * nzm; i += nt) {
      const int j = i / nzm, k = i % nzm, kb = max(k - 1, 0);
      const int r = (j + 1) * nzm;
      const T lw = B[r + k];
      B[r + k] = pp(lw) * min3(T(1), mxr[r + k], mnr[r + kb]) -
                 pn(lw) * min3(T(1), mxr[r + kb], mnr[r + k]);
    }
    __syncthreads();

    // -- flux += column sum of W3; stage 6: final update with positive clip
    for (int k = tid; k < nzm; k += nt) {
      T acc = T(0);
      for (int j = 1; j < nx + 1; ++j) acc += B[j * nzm + k];
      flux[k] = flux[k] + acc;
    }
    for (int i = tid; i < nx * nzm; i += nt) {
      const int j = i / nzm, k = i % nzm;
      const T wtop = k + 1 < nzm ? B[(j + 1) * nzm + k + 1] : T(0);
      const T upd = ((A[(j + 2) * nzm + k] - A[(j + 1) * nzm + k]) +
                     (wtop - B[(j + 1) * nzm + k]) * iadz[k]) * irho[k];
      const int r = (j + 3) * nzm + k;
      f1[r] = fmax(T(0), f1[r] - upd);
    }
    __syncthreads();
    // the new f is f1 with its interior replaced (halo rows keep f1's values)
    T* t = f;
    f = f1;
    f1 = t;
  }

  // ---- write back; flux(:, nz) passes through
  T* fo = f_out + s * XF * nzm;
  for (int i = tid; i < XF * nzm; i += nt) fo[i] = f[i];
  for (int k = tid; k < nz; k += nt)
    flux_out[s * nz + k] = k < nzm ? flux[k] : flux_in[s * nz + k];
}

template <typename T>
int launch(const void* f, const void* u, const void* w, const void* rho,
           const void* rhow, const void* adz, const void* flux, void* f_out,
           void* flux_out, int nslices, int nx, int nzm, int nsteps, void* stream) {
  const size_t bytes = smem_elems(nx, nzm) * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      mpdata_resident_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  mpdata_resident_kernel<T><<<nslices, THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(f), static_cast<const T*>(u), static_cast<const T*>(w),
      static_cast<const T*>(rho), static_cast<const T*>(rhow),
      static_cast<const T*>(adz), static_cast<const T*>(flux),
      static_cast<T*>(f_out), static_cast<T*>(flux_out), nx, nzm, nsteps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Shared memory one slice needs, in bytes.
long long cdk_mpdata_resident_smem_bytes(int nx, int nzm, int itemsize) {
  return static_cast<long long>(smem_elems(nx, nzm)) * itemsize;
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
int cdk_mpdata_resident_f32(const void* f, const void* u, const void* w,
                            const void* rho, const void* rhow, const void* adz,
                            const void* flux, void* f_out, void* flux_out,
                            int nslices, int nx, int nzm, int nsteps, void* stream) {
  return launch<float>(f, u, w, rho, rhow, adz, flux, f_out, flux_out, nslices,
                       nx, nzm, nsteps, stream);
}

int cdk_mpdata_resident_f64(const void* f, const void* u, const void* w,
                            const void* rho, const void* rhow, const void* adz,
                            const void* flux, void* f_out, void* flux_out,
                            int nslices, int nx, int nzm, int nsteps, void* stream) {
  return launch<double>(f, u, w, rho, rhow, adz, flux, f_out, flux_out, nslices,
                        nx, nzm, nsteps, stream);
}

}  // extern "C"
