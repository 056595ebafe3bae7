// n MPDATA advect_scalar2D steps in one kernel launch, in two forms on one
// design, the x sweep of csrc/mpdata_sweep.cuh:
//
//   hoisted: K2 and K9.  The order of operations of the step-invariant
//     factors (make_invariants) and of the step that uses them
//     (advect_hoisted), with the factors recomputed per point from u and w in
//     registers.  Replaces cdk_tpu/kernels/mpdata/pallas_xmajor.py::_kernel
//     (via _run_xmajor) and pallas_resident.py::_kernel_hoisted, whose stage
//     math is pallas_resident.py::make_invariants and advect_packed_hoisted.
//   staged: K6, K7 and K8.  Every step is the stage-exact
//     reference.advect_scalar2d: the antidiffusive velocities are computed from
//     u and w each step in the reference's operation order (_andiff, _across,
//     dd * (kc + kc - kb - kb)).  Replaces mpdata/pallas_fused.py::_kernel (one
//     step), pallas_packed.py::_kernel (one step; its bf16 form is the
//     __nv_bfloat16 storage type) and pallas_resident.py::_kernel (n steps in
//     the kernel).
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
// The block-per-slice design both forms had (the slice in dynamic shared
// memory, 98.9 KB for the hoisted form at f32, each stage a loop of 256
// threads over (x, z) followed by a barrier, the slice's load and store in
// series with its compute, the two flux column sums each on 57 of 256
// threads) is gone: one warp owns a slice and sweeps it along x, the stage
// rows in registers, the next rows loaded one iteration ahead, the flux sums
// running lane sums in x order (below 1024 slices up to 8 warps share a
// slice; mpdata_sweep.cuh).  Every operation is an _rn intrinsic, so f is bit
// for bit the plain version's (advect_resident_plain for the hoisted form,
// the staged reference for the staged one) at f32 and f64; a slice of any nx
// and up to 256 levels runs.

#include "mpdata_sweep.cuh"

namespace {

template <typename S, typename C, bool HOIST>
int launch_step(const void* f, const void* u, const void* w, const void* rho,
                const void* rhow, const void* adz, const void* flux, void* f_out,
                void* flux_out, int nslices, int nx, int nzm, int nsteps, int warps,
                void* stream) {
  Sweep<S> a{static_cast<const S*>(f), nullptr, nullptr, static_cast<const S*>(u),
             static_cast<const S*>(w), static_cast<const S*>(rho),
             static_cast<const S*>(rhow), static_cast<const S*>(adz),
             static_cast<const S*>(flux), static_cast<S*>(f_out),
             static_cast<S*>(flux_out), nullptr,
             nslices, nx + 6, nzm, nx, -2, 0, nx + 6, 0, nsteps, 1};
  return launch_mpdata_sweep<S, C, HOIST, false>(a, warps, stream);
}

}  // namespace

extern "C" {

// The most levels (nzm) a slice of the MPDATA sweep may have.
int cdk_mpdata_max_levels() { return MAX_LEVELS; }

// f (S,nx+6,nzm), u (S,nx+5,nzm), w (S,nx+4,nzm+1), rho/adz (S,nzm),
// rhow/flux (S,nzm+1); outputs shaped like f and flux; all contiguous on one
// device.  warps: warps a slice (0 picks).  Returns cudaGetLastError() after
// the launch.
#define CDK_MPDATA_ENTRY(name, S, C, HOIST)                                              \
  int name(const void* f, const void* u, const void* w, const void* rho,               \
           const void* rhow, const void* adz, const void* flux, void* f_out,           \
           void* flux_out, int nslices, int nx, int nzm, int nsteps, int warps,        \
           void* stream) {                                                             \
    return launch_step<S, C, HOIST>(f, u, w, rho, rhow, adz, flux, f_out, flux_out,    \
                                    nslices, nx, nzm, nsteps, warps, stream);          \
  }

CDK_MPDATA_ENTRY(cdk_mpdata_resident_f32, float, float, true)
CDK_MPDATA_ENTRY(cdk_mpdata_resident_f64, double, double, true)
CDK_MPDATA_ENTRY(cdk_mpdata_staged_f32, float, float, false)
CDK_MPDATA_ENTRY(cdk_mpdata_staged_f64, double, double, false)
CDK_MPDATA_ENTRY(cdk_mpdata_staged_bf16, __nv_bfloat16, float, false)

}  // extern "C"
