// K10: one MPDATA advect_scalar2D step with the slices on the fast axis, layout
// (x, z, s): a slice's levels lie nslices apart, a level's slices side by side.
//
// Replaces cdk_tpu/kernels/mpdata/pallas_lanes.py::_kernel (the slice batch on
// the TPU's lanes, the staged reference vmapped over it).  The TPU form's z
// padding to a sublane multiple, its 128-slice lane blocks and the padded slice
// batch are not carried over.
//
// Bound: the step reads f, u, w and the level fields once and writes f and
// flux once: ~289 MB at the production 8192 x 32 x 58 in f32, 0.0862 ms at
// 3.35 TB/s; its ~2.1 G operations take 0.031 ms at 67 TFLOP/s.
//
// Design: the staged x sweep of csrc/mpdata_sweep.cuh (LANES mode), the stage
// chain K6 runs, in one launch with no temporary in device memory: a warp per
// slice sweeps x, every stage a fixed lag behind the rows it reads, in
// registers.  What the layout changes is how rows come and go.  A block of
// LANES_WARPS warps holds W slices side by side; its threads copy each tile
// row (f row r, u and w row r - 1) into shared memory with cp.async as runs of
// W consecutive slices of one level (coalesced, one element a copy, so any
// slice count and alignment takes the same path), a tile row ahead of the one
// the warps read, one barrier a row; the finished f rows and the flux row
// leave through a ring in shared memory as runs of W slices.  So every input
// is read once and every output written once, in whole sectors where W
// elements fill them.  Below 1024 slices a slice's rows split among up to 8
// warps of the block (W = 8 / chunks slices a block), the flux rows summed
// in x order in shared memory, so the split changes no bit.  Every operation
// is an _rn intrinsic: f is bit for bit the staged reference's
// (advect_lanes_plain), at f32 and f64; the flux column sums run in x order.
// Up to 256 levels (nzm) a slice.

#include "mpdata_sweep.cuh"

namespace {

template <typename S>
int launch_lanes(const void* f, const void* u, const void* w, const void* rho,
                 const void* rhow, const void* adz, const void* flux, void* f_out,
                 void* flux_out, int nslices, int nx, int nzm, int warps, void* stream) {
  Sweep<S> a{static_cast<const S*>(f), nullptr, nullptr, static_cast<const S*>(u),
             static_cast<const S*>(w), static_cast<const S*>(rho),
             static_cast<const S*>(rhow), static_cast<const S*>(adz),
             static_cast<const S*>(flux), static_cast<S*>(f_out),
             static_cast<S*>(flux_out), nullptr,
             nslices, nx + 6, nzm, nx, -2, 0, nx + 6, 0, 1, 1};
  return launch_mpdata_sweep<S, S, false, false, true>(a, warps, stream);
}

}  // namespace

extern "C" {

// One step in the (x, z, s) layout: f (nx+6,nzm,S), u (nx+5,nzm,S),
// w (nx+4,nzm+1,S), rho/adz (nzm,S), rhow/flux (nzm+1,S); outputs shaped like f
// and flux; all contiguous on one device.  warps: warps a slice (0 picks:
// 8 below 1024 slices where the rows allow, else 1).  Returns
// cudaGetLastError() after the one launch.
int cdk_mpdata_lanes_f32(const void* f, const void* u, const void* w, const void* rho,
                         const void* rhow, const void* adz, const void* flux, void* f_out,
                         void* flux_out, int nslices, int nx, int nzm, int warps,
                         void* stream) {
  return launch_lanes<float>(f, u, w, rho, rhow, adz, flux, f_out, flux_out, nslices, nx,
                             nzm, warps, stream);
}

int cdk_mpdata_lanes_f64(const void* f, const void* u, const void* w, const void* rho,
                         const void* rhow, const void* adz, const void* flux, void* f_out,
                         void* flux_out, int nslices, int nx, int nzm, int warps,
                         void* stream) {
  return launch_lanes<double>(f, u, w, rho, rhow, adz, flux, f_out, flux_out, nslices, nx,
                              nzm, warps, stream);
}

}  // extern "C"
