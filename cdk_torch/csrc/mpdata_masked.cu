// The masked-global MPDATA step on a shard's column window, one step or n steps
// in one launch: K20-K25.  Replaces cdk_tpu/kernels/mpdata/pallas_masked.py's
// _kernel (K20), _kernel_packed (K21), _kernel_xmajor (K22), _kernel_xmajor_split
// (K23), _kernel_xmajor_kloop (K24) and _kernel_xmajor_kloop_split (K25).
//
// The step is dist.mpdata.advect_scalar2d_masked: every stage runs over all X
// columns of the collocated window (f, u, w on one x grid) with neighbour reads
// clamped at the window's edges, and each Fortran x-range restriction is a test
// of the column's global index gi = gi0 + x.  The flux partial is the sum over
// the owned columns [owned_lo, owned_hi) whose gi lies in [1, nx].
//
// Switches (uniform per launch):
//   hoist  the order of operations of the JAX hoisted loop (K24, K25:
//          make_masked_invariants and advect_masked_hoisted) instead of the staged
//          one (K20-K23).  The invariant coefficients are recomputed per point from
//          u and w in registers each step, which gives the hoisted values bitwise
//          (the same operations in the same order) and keeps shared memory at the
//          staged form's eight window arrays, so deep windows fit.
//   split  (f_left non-null) the window is assembled from three f pointers (left
//          strip, owned block, right strip; halo columns each side) and only the
//          owned columns are written back (K23, K25).  The arithmetic is the same
//          code, so K23 equals K22 and K25 equals K24 bitwise on the concatenated
//          window.
//
// The TPU kernels' layouts (lane packing, 64-lane z segments, pad-lane masks, the
// kspan input, the SMEM gi0 scalar, VMEM requests) are not carried over: the
// kernel takes the canonical (S, X, Z) layout.  Every add, subtract, multiply and
// divide is an _rn intrinsic, so nvcc contracts nothing into FMAs and each value
// is rounded as the plain PyTorch version rounds it; only the two flux column sums
// are taken in another order than torch.sum.
//
// Design: one block per CRM slice.  The window's f, the next f, u, w (levels
// 0..nzm-1), the two flux slots (uuu -> uuu2 -> uuu3, www -> www2 -> www3, each
// updated in place) and the two limiter ratios live in dynamic shared memory for
// the whole run: (8 X + 6) nzm values.  Each stage is a loop of the block's
// threads over (x, z) points followed by __syncthreads(); the flux partial is taken
// per level by one thread in increasing x order, so it does not depend on
// scheduling.  u, w and the per-level fields are read once per launch, f once in
// and once out.  Bound: the stencil arithmetic and its shared-memory operand
// traffic once the window is resident; the wrapper refuses a window beyond the
// card's per-block opt-in limit (at nzm = 57: X <= 62 at f64, 126 at f32).

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float ad(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sb(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mu(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float dv(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double ad(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sb(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ double mu(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double dv(double a, double b) { return __ddiv_rn(a, b); }

template <typename T>
__device__ __forceinline__ T pp(T y) { return fmax(T(0), y); }
template <typename T>
__device__ __forceinline__ T pn(T y) { return -fmin(T(0), y); }
template <typename T>
__device__ __forceinline__ T min3(T a, T b, T c) { return fmin(fmin(a, b), c); }

__host__ __device__ inline size_t smem_elems(int X, int nzm) {
  return (size_t)(8 * X + 6) * nzm;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
mpdata_masked_kernel(const T* __restrict__ f_left, const T* __restrict__ f_in,
                     const T* __restrict__ f_right, const T* __restrict__ u_in,
                     const T* __restrict__ w_in, const T* __restrict__ rho_in,
                     const T* __restrict__ rhow_in, const T* __restrict__ adz_in,
                     T* __restrict__ f_out, T* __restrict__ flux_out, int X, int nzm,
                     int nx, int gi0, int owned_lo, int owned_hi, int halo, int nsteps,
                     bool hoist) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int nz = nzm + 1;
  const int N = X * nzm;
  const size_t s = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;

  T* irho = sm;  // per level
  T* iadz = irho + nzm;
  T* dd = iadz + nzm;
  T* irhow = dd + nzm;
  T* rho = irhow + nzm;
  T* flux = rho + nzm;  // the step's flux partial
  T* fa = flux + nzm;   // X columns each from here on: f / next f, swapped per step
  T* fb = fa + N;
  T* u = fb + N;
  T* w = u + N;  // levels 0..nzm-1 of w
  T* A = w + N;  // uuu -> uuu2 -> uuu3
  T* B = A + N;  // www -> www2 -> www3
  T* MX = B + N;  // limiter ratios mxr, mnr
  T* MN = MX + N;

  // x-range restriction on the global Fortran index, and the flux columns
  auto in = [&](int x, int lo, int hi) {
    const int g = gi0 + x;
    return g >= lo && g <= hi;
  };
  auto fmask = [&](int x) { return x >= owned_lo && x < owned_hi && in(x, 1, nx); };

  // ---- load the window
  const int chunk = X - 2 * halo;
  for (int i = tid; i < N; i += nt) {
    const int x = i / nzm, k = i % nzm;
    if (f_left != nullptr) {
      if (x < halo)
        fa[i] = f_left[(s * halo + x) * nzm + k];
      else if (x < halo + chunk)
        fa[i] = f_in[(s * chunk + x - halo) * nzm + k];
      else
        fa[i] = f_right[(s * halo + x - halo - chunk) * nzm + k];
    } else {
      fa[i] = f_in[s * N + i];
    }
    u[i] = u_in[s * N + i];
    w[i] = w_in[(s * X + x) * nz + k];
  }
  for (int k = tid; k < nzm; k += nt) {
    const T r = rho_in[s * nzm + k], a = adz_in[s * nzm + k];
    const int span = min(nzm - 1, k + 1) - max(0, k - 1);
    irho[k] = dv(T(1), r);
    iadz[k] = dv(T(1), a);
    dd[k] = dv(dv(T(2), T(span)), a);
    irhow[k] = dv(T(1), mu(rhow_in[s * nz + k], a));
    rho[k] = r;
    flux[k] = T(0);
  }
  __syncthreads();

  T* f = fa;
  T* f1 = fb;
  for (int step = 0; step < nsteps; ++step) {
    // -- stage 2: upwind fluxes
    for (int i = tid; i < N; i += nt) {
      const int x = i / nzm, k = i % nzm, kb = max(k - 1, 0);
      const T fc = f[i], uv = u[i], wv = w[i];
      A[i] = sb(mu(pp(uv), f[max(x - 1, 0) * nzm + k]), mu(pn(uv), fc));
      B[i] = sb(mu(pp(wv), f[x * nzm + kb]), mu(pn(wv), fc));
    }
    __syncthreads();

    // -- flux partial of www; stage 3: upwind update on gi in [-1, nx+2]
    for (int k = tid; k < nzm; k += nt) {
      T acc = T(0);
      for (int x = 0; x < X; ++x)
        if (fmask(x)) acc = ad(acc, B[x * nzm + k]);
      flux[k] = acc;
    }
    for (int i = tid; i < N; i += nt) {
      const int x = i / nzm, k = i % nzm;
      if (!in(x, -1, nx + 2)) {
        f1[i] = f[i];
        continue;
      }
      const T wtop = k + 1 < nzm ? B[i + 1] : T(0);  // www(nz) = 0
      const T upd = mu(ad(sb(A[min(x + 1, X - 1) * nzm + k], A[i]),
                          mu(sb(wtop, B[i]), iadz[k])),
                       irho[k]);
      f1[i] = sb(f[i], upd);
    }
    __syncthreads();

    // -- stage 4: antidiffusive velocities, over uuu on gi in [0, nx+2] and
    // www on gi in [0, nx+1]; www(:,:,1) = 0
    for (int i = tid; i < N; i += nt) {
      const int x = i / nzm, k = i % nzm;
      const int kb = max(k - 1, 0), kc = min(k + 1, nzm - 1);
      const int l = max(x - 1, 0) * nzm, c = x * nzm, r = min(x + 1, X - 1) * nzm;
      const T fc1 = f1[c + k], lf1 = f1[l + k], ir = irho[k];
      if (in(x, 0, nx + 2)) {
        const T au = u[c + k];
        const T wsum = ad(ad(ad(w[l + k], w[l + kc]), w[c + k]), w[c + kc]);
        const T coef = mu(sb(fabs(au), mu(mu(au, au), ir)), T(0.5));
        if (hoist) {
          const T across = mu(mu(mu(mu(T(0.03125), au), wsum), dd[k]), ir);
          const T tc = ad(f1[l + kc], f1[c + kc]), tb = ad(f1[l + kb], f1[c + kb]);
          A[i] = sb(mu(coef, sb(fc1, lf1)), mu(across, sb(tc, tb)));
        } else {
          const T dz = mu(dd[k], sb(sb(ad(f1[l + kc], f1[c + kc]), f1[l + kb]),
                                    f1[c + kb]));
          const T across = mu(mu(mu(T(0.03125), au), wsum), dz);
          A[i] = sb(mu(coef, sb(fc1, lf1)), mu(across, ir));
        }
      }
      if (k == 0) {
        B[i] = T(0);
      } else if (in(x, 0, nx + 1)) {
        const T bw = w[c + k];
        const T usum = ad(ad(ad(u[c + kb], u[c + k]), u[r + k]), u[r + kb]);
        const T coef = mu(sb(fabs(bw), mu(mu(bw, bw), irhow[k])), T(0.5));
        const T dfk = sb(fc1, f1[c + kb]);
        if (hoist) {
          const T across = mu(mu(mu(T(0.03125), bw), usum), ir);
          const T dfc = sb(f1[r + k], lf1), dfcb = sb(f1[r + kb], f1[l + kb]);
          B[i] = sb(mu(coef, dfk), mu(across, ad(dfcb, dfc)));
        } else {
          const T dx = sb(sb(ad(f1[r + kb], f1[r + k]), f1[l + kb]), lf1);
          const T across = mu(mu(mu(T(0.03125), bw), usum), dx);
          B[i] = sb(mu(coef, dfk), mu(across, ir));
        }
      }
    }
    __syncthreads();

    // -- stage 5a/5b: extrema over f and the updated f (max and min are
    // exact, so both passes fold into one), in/out flux ratios
    for (int i = tid; i < N; i += nt) {
      const int x = i / nzm, k = i % nzm;
      const int kb = max(k - 1, 0), kc = min(k + 1, nzm - 1);
      const int l = max(x - 1, 0) * nzm, c = x * nzm, r = min(x + 1, X - 1) * nzm;
      T mx = fmax(fmax(fmax(f[l + k], f[r + k]), fmax(f[c + kb], f[c + kc])), f[c + k]);
      T mn = fmin(fmin(fmin(f[l + k], f[r + k]), fmin(f[c + kb], f[c + kc])), f[c + k]);
      const T fc1 = f1[c + k];
      mx = fmax(fmax(fmax(f1[l + k], f1[r + k]), fmax(f1[c + kb], f1[c + kc])),
                fmax(fc1, mx));
      mn = fmin(fmin(fmin(f1[l + k], f1[r + k]), fmin(f1[c + kb], f1[c + kc])),
                fmin(fc1, mn));
      const T ru = A[r + k], uc = A[c + k], wkc = B[c + kc], wc = B[c + k];
      const T iz = iadz[k], rr = rho[k];
      MX[i] = dv(mu(rr, sb(mx, fc1)),
                 ad(ad(ad(pn(ru), pp(uc)), mu(iz, ad(pn(wkc), pp(wc)))), T(1.0e-10)));
      MN[i] = dv(mu(rr, sb(fc1, mn)),
                 ad(ad(ad(pp(ru), pn(uc)), mu(iz, ad(pp(wkc), pn(wc)))), T(1.0e-10)));
    }
    __syncthreads();

    // -- stage 5c: limited fluxes, each written over the value it reads
    for (int i = tid; i < N; i += nt) {
      const int x = i / nzm, k = i % nzm, kb = max(k - 1, 0);
      const int l = max(x - 1, 0) * nzm, c = x * nzm;
      if (in(x, 1, nx + 1)) {
        const T lu = A[i];
        A[i] = sb(mu(pp(lu), min3(T(1), MX[i], MN[l + k])),
                  mu(pn(lu), min3(T(1), MX[l + k], MN[i])));
      }
      if (in(x, 1, nx)) {
        const T lw = B[i];
        B[i] = sb(mu(pp(lw), min3(T(1), MX[i], MN[c + kb])),
                  mu(pn(lw), min3(T(1), MX[c + kb], MN[i])));
      }
    }
    __syncthreads();

    // -- flux partial += www3 over the flux columns (all in [1, nx], where www3
    // is stored); stage 6: final update with positive clip on gi in [1, nx]
    for (int k = tid; k < nzm; k += nt) {
      T acc = T(0);
      for (int x = 0; x < X; ++x)
        if (fmask(x)) acc = ad(acc, B[x * nzm + k]);
      flux[k] = ad(flux[k], acc);
    }
    for (int i = tid; i < N; i += nt) {
      const int x = i / nzm, k = i % nzm;
      if (!in(x, 1, nx)) continue;
      const T wtop = k + 1 < nzm ? B[i + 1] : T(0);
      const T upd = mu(ad(sb(A[min(x + 1, X - 1) * nzm + k], A[i]),
                          mu(sb(wtop, B[i]), iadz[k])),
                       irho[k]);
      f1[i] = fmax(T(0), sb(f1[i], upd));
    }
    __syncthreads();
    T* t = f;
    f = f1;
    f1 = t;
  }

  // ---- write back: the whole window, or (split) its owned columns
  if (f_left != nullptr) {
    for (int i = tid; i < chunk * nzm; i += nt)
      f_out[s * chunk * nzm + i] = f[halo * nzm + i];
  } else {
    for (int i = tid; i < N; i += nt) f_out[s * N + i] = f[i];
  }
  for (int k = tid; k < nzm; k += nt) flux_out[s * nzm + k] = flux[k];
}

template <typename T>
int launch(const void* fl, const void* f, const void* fr, const void* u, const void* w,
           const void* rho, const void* rhow, const void* adz, void* f_out,
           void* flux_out, int nslices, int X, int nzm, int nx, int gi0, int owned_lo,
           int owned_hi, int halo, int nsteps, int hoist, void* stream) {
  const size_t bytes = smem_elems(X, nzm) * sizeof(T);
  auto kernel = mpdata_masked_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<nslices, THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(fl), static_cast<const T*>(f), static_cast<const T*>(fr),
      static_cast<const T*>(u), static_cast<const T*>(w), static_cast<const T*>(rho),
      static_cast<const T*>(rhow), static_cast<const T*>(adz), static_cast<T*>(f_out),
      static_cast<T*>(flux_out), X, nzm, nx, gi0, owned_lo, owned_hi, halo, nsteps,
      hoist != 0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Shared memory one window of X columns x nzm levels needs, in bytes.
long long cdk_mpdata_masked_smem_bytes(int X, int nzm, int itemsize) {
  return static_cast<long long>(smem_elems(X, nzm)) * itemsize;
}

// A window of X columns: f (S,X,nzm), or with f_left non-null the owned block f
// (S,X-2*halo,nzm) between f_left and f_right (S,halo,nzm); u (S,X,nzm),
// w (S,X,nzm+1), rho/adz (S,nzm), rhow (S,nzm+1).  Outputs: f_out shaped like f,
// flux_out (S,nzm), the last step's flux partial.  gi0 is the global Fortran
// index of window column 0; hoist selects the K24/K25 order of operations.
// Returns cudaGetLastError() after the launch.
#define CDK_MASKED_ENTRY(name, T)                                                      \
  int name(const void* fl, const void* f, const void* fr, const void* u, const void* w, \
           const void* rho, const void* rhow, const void* adz, void* f_out,            \
           void* flux_out, int nslices, int X, int nzm, int nx, int gi0, int owned_lo, \
           int owned_hi, int halo, int nsteps, int hoist, void* stream) {              \
    return launch<T>(fl, f, fr, u, w, rho, rhow, adz, f_out, flux_out, nslices, X,   \
                       nzm, nx, gi0, owned_lo, owned_hi, halo, nsteps, hoist, stream);  \
  }

CDK_MASKED_ENTRY(cdk_mpdata_masked_f32, float)
CDK_MASKED_ENTRY(cdk_mpdata_masked_f64, double)

}  // extern "C"
