// K10: one MPDATA advect_scalar2D step with the slices on the fast axis, layout
// (x, z, s): a warp's loads are 32 consecutive slices of one (x, z) point.
//
// Replaces cdk_tpu/kernels/mpdata/pallas_lanes.py::_kernel (the slice batch on
// the TPU's lanes, the staged reference vmapped over it).  The TPU form's z
// padding to a sublane multiple, its 128-slice lane blocks and the padded slice
// batch are not carried over.
//
// Design: one slice's stage chain does not fit a thread's registers, and 32
// slices' worth of it does not fit one block's shared memory, so the step is four
// launches over (x, z, s) temporaries in device memory, one thread per point.
// Each launch ends where a stage reads neighbours of the stage before it:
//   1. upwind fluxes (recomputed at the two x and two z neighbours each update
//      reads) + upwind update -> f1; the first flux column sum -> flux1
//   2. antidiffusive pseudo-velocities U2, W2 (reference.advect_scalar2d's
//      operation order), in body coordinates as in csrc/mpdata_resident.cu
//   3. both extrema passes folded (max/min are exact) + in/out flux ratios
//   4. limited fluxes (recomputed at the neighbours the update reads) + the
//      final update with positive clip; flux = flux1 + the second column sum
// Each column sum is taken by the row-0 thread of its (z, s) in a fixed x order.
// nvcc contracts a*b + c into FMAs, so the result differs from the plain version
// (separate rounded tensor ops) by a few ulps.
//
// Bound: the step reads f, u, w and the level fields once and writes f and flux
// (~289 MB at the production 8192 x 32 x 58, f32), but the temporaries add about
// three field-sized round trips through device memory (L2 holds some of them),
// which is the price of this layout.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

template <typename T>
__device__ __forceinline__ T pp(T y) { return fmax(T(0), y); }
template <typename T>
__device__ __forceinline__ T pn(T y) { return -fmin(T(0), y); }
template <typename T>
__device__ __forceinline__ T min3(T a, T b, T c) { return fmin(fmin(a, b), c); }

// (x, z, s) offsets: fields with nzm levels, w with nz, per-level (z, s) fields
struct Geo {
  int nx, nzm, ns;
  __device__ size_t at(int x, int k, int s) const { return ((size_t)x * nzm + k) * ns + s; }
  __device__ size_t atw(int x, int k, int s) const {
    return ((size_t)x * (nzm + 1) + k) * ns + s;
  }
  __device__ size_t lev(int k, int s) const { return (size_t)k * ns + s; }
  // thread -> (x, k, s) over `rows` x rows
  __device__ bool point(int rows, int* x, int* k, int* s) const {
    const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= (size_t)rows * nzm * ns) return false;
    *s = i % ns;
    *k = (i / ns) % nzm;
    *x = i / ((size_t)ns * nzm);
    return true;
  }
};

// first-order upwind fluxes: uuu at u row r, www at w row r
template <typename T>
__device__ __forceinline__ T uuu(const T* f, const T* u, const Geo& g, int r, int k, int s) {
  const T uv = u[g.at(r, k, s)];
  return pp(uv) * f[g.at(r, k, s)] - pn(uv) * f[g.at(r + 1, k, s)];
}
template <typename T>
__device__ __forceinline__ T www(const T* f, const T* w, const Geo& g, int r, int k, int s) {
  const T wv = w[g.atw(r, k, s)];
  return pp(wv) * f[g.at(r + 1, max(k - 1, 0), s)] - pn(wv) * f[g.at(r + 1, k, s)];
}

// stages 2-3: f1 (nx+6 rows) and the first flux column sum flux1 (nzm, S)
template <typename T>
__global__ void __launch_bounds__(THREADS)
lanes_upwind(const T* __restrict__ f, const T* __restrict__ u, const T* __restrict__ w,
             const T* __restrict__ rho, const T* __restrict__ adz, T* __restrict__ f1,
             T* __restrict__ flux1, Geo g) {
  int j, k, s;
  if (!g.point(g.nx + 6, &j, &k, &s)) return;
  if (j == 0) {
    T acc = T(0);
    for (int r = 2; r < g.nx + 2; ++r) acc += www(f, w, g, r, k, s);
    flux1[g.lev(k, s)] = acc;
  }
  if (j == 0 || j == g.nx + 5) {
    f1[g.at(j, k, s)] = f[g.at(j, k, s)];
    return;
  }
  const int r = j - 1;  // uuu / www row of this update
  const T wtop = k + 1 < g.nzm ? www(f, w, g, r, k + 1, s) : T(0);  // www(nz) = 0
  const T upd = ((uuu(f, u, g, r + 1, k, s) - uuu(f, u, g, r, k, s)) +
                 (wtop - www(f, w, g, r, k, s)) * (T(1) / adz[g.lev(k, s)])) *
                (T(1) / rho[g.lev(k, s)]);
  f1[g.at(j, k, s)] = f[g.at(j, k, s)] - upd;
}

// stage 4: U2[j] = uuu2 at u row j+1 (nx+3 rows), W2[j] = www2 at w row j+1
// (nx+2 rows), bottom level of W2 = 0
template <typename T>
__global__ void __launch_bounds__(THREADS)
lanes_antidiff(const T* __restrict__ f1, const T* __restrict__ u, const T* __restrict__ w,
               const T* __restrict__ rho, const T* __restrict__ rhow,
               const T* __restrict__ adz, T* __restrict__ U2, T* __restrict__ W2, Geo g) {
  int j, k, s;
  if (!g.point(g.nx + 3, &j, &k, &s)) return;
  const int nzm = g.nzm, kb = max(k - 1, 0), kc = min(k + 1, nzm - 1);
  const T a = adz[g.lev(k, s)];
  const T irho = T(1) / rho[g.lev(k, s)];
  const int span = min(nzm - 1, k + 1) - max(0, k - 1);
  const T dd = T(2) / T(span) / a;
  {
    const T fib = f1[g.at(j + 1, k, s)], fi = f1[g.at(j + 2, k, s)];
    const T au = u[g.at(j + 1, k, s)];
    const T dz = dd * (((f1[g.at(j + 1, kc, s)] + f1[g.at(j + 2, kc, s)]) -
                        f1[g.at(j + 1, kb, s)]) - f1[g.at(j + 2, kb, s)]);
    const T wsum = ((w[g.atw(j, k, s)] + w[g.atw(j, kc, s)]) + w[g.atw(j + 1, k, s)]) +
                   w[g.atw(j + 1, kc, s)];
    const T andiff = ((fabs(au) - au * au * irho) * T(0.5)) * (fi - fib);
    const T across = ((T(0.03125) * au) * wsum) * dz;
    U2[g.at(j, k, s)] = andiff - across * irho;
  }
  if (j >= g.nx + 2) return;
  if (k == 0) {  // bottom boundary www(:,:,1) = 0
    W2[g.at(j, k, s)] = T(0);
    return;
  }
  const T irhow = T(1) / (rhow[g.lev(k, s)] * a);
  const T bfi = f1[g.at(j + 2, k, s)], bfib = f1[g.at(j + 2, kb, s)];
  const T bw = w[g.atw(j + 1, k, s)];
  const T dx = ((f1[g.at(j + 3, kb, s)] + f1[g.at(j + 3, k, s)]) - f1[g.at(j + 1, kb, s)]) -
               f1[g.at(j + 1, k, s)];
  const T usum = ((u[g.at(j + 1, kb, s)] + u[g.at(j + 1, k, s)]) + u[g.at(j + 2, k, s)]) +
                 u[g.at(j + 2, kb, s)];
  const T andiff = ((fabs(bw) - bw * bw * irhow) * T(0.5)) * (bfi - bfib);
  const T across = ((T(0.03125) * bw) * usum) * dx;
  W2[g.at(j, k, s)] = andiff - across * irho;
}

// stage 5a/5b: extrema over f and f1, in/out flux ratios (nx+2 rows, f row j+2)
template <typename T>
__global__ void __launch_bounds__(THREADS)
lanes_ratios(const T* __restrict__ f, const T* __restrict__ f1, const T* __restrict__ U2,
             const T* __restrict__ W2, const T* __restrict__ rho, const T* __restrict__ adz,
             T* __restrict__ mxr, T* __restrict__ mnr, Geo g) {
  int j, k, s;
  if (!g.point(g.nx + 2, &j, &k, &s)) return;
  const int kb = max(k - 1, 0), kc = min(k + 1, g.nzm - 1), c = j + 2;
  T mx = fmax(fmax(fmax(f[g.at(c - 1, k, s)], f[g.at(c + 1, k, s)]),
                   fmax(f[g.at(c, kb, s)], f[g.at(c, kc, s)])),
              f[g.at(c, k, s)]);
  T mn = fmin(fmin(fmin(f[g.at(c - 1, k, s)], f[g.at(c + 1, k, s)]),
                   fmin(f[g.at(c, kb, s)], f[g.at(c, kc, s)])),
              f[g.at(c, k, s)]);
  const T f1c = f1[g.at(c, k, s)];
  mx = fmax(fmax(fmax(f1[g.at(c - 1, k, s)], f1[g.at(c + 1, k, s)]),
                 fmax(f1[g.at(c, kb, s)], f1[g.at(c, kc, s)])),
            fmax(f1c, mx));
  mn = fmin(fmin(fmin(f1[g.at(c - 1, k, s)], f1[g.at(c + 1, k, s)]),
                 fmin(f1[g.at(c, kb, s)], f1[g.at(c, kc, s)])),
            fmin(f1c, mn));
  const T rui = U2[g.at(j, k, s)], ruic = U2[g.at(j + 1, k, s)];
  const T rwi = W2[g.at(j, k, s)], rwkc = W2[g.at(j, kc, s)];
  const T r = rho[g.lev(k, s)], iz = T(1) / adz[g.lev(k, s)];
  mxr[g.at(j, k, s)] =
      r * (mx - f1c) / (((pn(ruic) + pp(rui)) + iz * (pn(rwkc) + pp(rwi))) + T(1.0e-10));
  mnr[g.at(j, k, s)] =
      r * (f1c - mn) / (((pp(ruic) + pn(rui)) + iz * (pp(rwkc) + pn(rwi))) + T(1.0e-10));
}

// limited fluxes: U3 at U2 row a (a = 1..nx+1), W3 at W2 row a (a = 1..nx)
template <typename T>
__device__ __forceinline__ T u3(const T* U2, const T* mxr, const T* mnr, const Geo& g,
                                int a, int k, int s) {
  const T lu = U2[g.at(a, k, s)];
  return pp(lu) * min3(T(1), mxr[g.at(a, k, s)], mnr[g.at(a - 1, k, s)]) -
         pn(lu) * min3(T(1), mxr[g.at(a - 1, k, s)], mnr[g.at(a, k, s)]);
}
template <typename T>
__device__ __forceinline__ T w3(const T* W2, const T* mxr, const T* mnr, const Geo& g,
                                int a, int k, int s) {
  const int kb = max(k - 1, 0);
  const T lw = W2[g.at(a, k, s)];
  return pp(lw) * min3(T(1), mxr[g.at(a, k, s)], mnr[g.at(a, kb, s)]) -
         pn(lw) * min3(T(1), mxr[g.at(a, kb, s)], mnr[g.at(a, k, s)]);
}

// stages 5c-6: f_out (nx+6 rows: halo rows are f1's), flux_out
template <typename T>
__global__ void __launch_bounds__(THREADS)
lanes_update(const T* __restrict__ f1, const T* __restrict__ U2, const T* __restrict__ W2,
             const T* __restrict__ mxr, const T* __restrict__ mnr,
             const T* __restrict__ rho, const T* __restrict__ adz,
             const T* __restrict__ flux1, const T* __restrict__ flux_in,
             T* __restrict__ f_out, T* __restrict__ flux_out, Geo g) {
  int j, k, s;
  if (!g.point(g.nx + 6, &j, &k, &s)) return;
  if (j == 0) {
    T acc = T(0);
    for (int a = 1; a < g.nx + 1; ++a) acc += w3(W2, mxr, mnr, g, a, k, s);
    flux_out[g.lev(k, s)] = flux1[g.lev(k, s)] + acc;
    if (k == g.nzm - 1)  // flux(:, nz) passes through
      flux_out[g.lev(k + 1, s)] = flux_in[g.lev(k + 1, s)];
  }
  if (j < 3 || j >= g.nx + 3) {
    f_out[g.at(j, k, s)] = f1[g.at(j, k, s)];
    return;
  }
  const int a = j - 2;  // this update reads U3 rows a, a+1 and W3 row a
  const T wtop = k + 1 < g.nzm ? w3(W2, mxr, mnr, g, a, k + 1, s) : T(0);
  const T upd = ((u3(U2, mxr, mnr, g, a + 1, k, s) - u3(U2, mxr, mnr, g, a, k, s)) +
                 (wtop - w3(W2, mxr, mnr, g, a, k, s)) * (T(1) / adz[g.lev(k, s)])) *
                (T(1) / rho[g.lev(k, s)]);
  f_out[g.at(j, k, s)] = fmax(T(0), f1[g.at(j, k, s)] - upd);
}

unsigned blocks(int rows, int nzm, int ns) {
  return (unsigned)(((size_t)rows * nzm * ns + THREADS - 1) / THREADS);
}

template <typename T>
int step(const void* f_, const void* u_, const void* w_, const void* rho_,
         const void* rhow_, const void* adz_, const void* flux_, void* f1_, void* U2_,
         void* W2_, void* mxr_, void* mnr_, void* flux1_, void* f_out_, void* flux_out_,
         int ns, int nx, int nzm, void* stream) {
  const Geo g{nx, nzm, ns};
  auto st = static_cast<cudaStream_t>(stream);
  auto c = [](const void* p) { return static_cast<const T*>(p); };
  auto m = [](void* p) { return static_cast<T*>(p); };
  lanes_upwind<T><<<blocks(nx + 6, nzm, ns), THREADS, 0, st>>>(
      c(f_), c(u_), c(w_), c(rho_), c(adz_), m(f1_), m(flux1_), g);
  lanes_antidiff<T><<<blocks(nx + 3, nzm, ns), THREADS, 0, st>>>(
      c(f1_), c(u_), c(w_), c(rho_), c(rhow_), c(adz_), m(U2_), m(W2_), g);
  lanes_ratios<T><<<blocks(nx + 2, nzm, ns), THREADS, 0, st>>>(
      c(f_), c(f1_), c(U2_), c(W2_), c(rho_), c(adz_), m(mxr_), m(mnr_), g);
  lanes_update<T><<<blocks(nx + 6, nzm, ns), THREADS, 0, st>>>(
      c(f1_), c(U2_), c(W2_), c(mxr_), c(mnr_), c(rho_), c(adz_), c(flux1_), c(flux_),
      m(f_out_), m(flux_out_), g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// One step in the (x, z, s) layout: f (nx+6,nzm,S), u (nx+5,nzm,S),
// w (nx+4,nzm+1,S), rho/adz (nzm,S), rhow/flux (nzm+1,S); scratch f1 (nx+6,nzm,S),
// U2 (nx+3,nzm,S), W2/mxr/mnr (nx+2,nzm,S), flux1 (nzm,S); outputs shaped like f
// and flux.  All contiguous on one device.  Returns cudaGetLastError() after the
// four launches.
int cdk_mpdata_lanes_f32(const void* f, const void* u, const void* w, const void* rho,
                         const void* rhow, const void* adz, const void* flux, void* f1,
                         void* U2, void* W2, void* mxr, void* mnr, void* flux1,
                         void* f_out, void* flux_out, int nslices, int nx, int nzm,
                         void* stream) {
  return step<float>(f, u, w, rho, rhow, adz, flux, f1, U2, W2, mxr, mnr, flux1, f_out,
                     flux_out, nslices, nx, nzm, stream);
}

int cdk_mpdata_lanes_f64(const void* f, const void* u, const void* w, const void* rho,
                         const void* rhow, const void* adz, const void* flux, void* f1,
                         void* U2, void* W2, void* mxr, void* mnr, void* flux1,
                         void* f_out, void* flux_out, int nslices, int nx, int nzm,
                         void* stream) {
  return step<double>(f, u, w, rho, rhow, adz, flux, f1, U2, W2, mxr, mnr, flux1, f_out,
                      flux_out, nslices, nx, nzm, stream);
}

}  // extern "C"
