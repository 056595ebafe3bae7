// The masked-global MPDATA step on a shard's column window, one step or n steps
// in one launch: K20-K25.  Replaces cdk_tpu/kernels/mpdata/pallas_masked.py's
// _kernel (K20), _kernel_packed (K21), _kernel_xmajor (K22), _kernel_xmajor_split
// (K23), _kernel_xmajor_kloop (K24) and _kernel_xmajor_kloop_split (K25).
//
// The step is advect_scalar2d_masked: every stage runs over all X columns of
// the collocated window (f, u, w on one x grid) with neighbour reads clamped at
// the window's edges, and each Fortran x-range restriction is a test of the
// column's global index gi = gi0 + x.  The flux partial is the sum over the
// owned columns [owned_lo, owned_hi) whose gi lies in [1, nx].
//
// Switches:
//   hoist  the order of operations of the JAX hoisted loop (K24, K25:
//          make_masked_invariants and advect_masked_hoisted) instead of the staged
//          one (K20-K23), an instantiation of its own.
//   split  (f_left non-null) the window is assembled from three f pointers (left
//          strip, owned block, right strip; halo columns each side), the pointer
//          picked once per row, and only the owned columns are written back (K23,
//          K25).  The arithmetic is the same code, so K23 equals K22 and K25
//          equals K24 bitwise on the concatenated window.  K25's steps before
//          its last need the whole window: they sweep `win`, a window-sized
//          buffer in device memory that the wrapper allocates, in place.
//
// The TPU kernels' layouts (lane packing, 64-lane z segments, pad-lane masks, the
// kspan input, the SMEM gi0 scalar, VMEM requests) are not carried over: the
// kernel takes the canonical (S, X, Z) layout.
//
// Bound: a step's bytes, each input read once and f and the flux written once
// (at production, 8192 slices on the 44-column window, nzm 57, f32: 338 MB,
// 0.10 ms at 3.35 TB/s); a k-step launch by its arithmetic over the cone the
// owned columns need (0.16 ms at kstep 4).
//
// Design: the masked mode of the MPDATA x sweep (mpdata_sweep.cuh): one warp
// per CRM slice (below 1024 slices up to 8 warps share one) sweeps the window's
// columns as its rows, the stage rows in registers, with no shared memory and
// no barrier while a warp has its slice alone; a neighbour past either edge is
// the stage's own edge row, and each gi test is uniform across the warp.  u, w
// and the per-level fields are read once per step, f once in and once out.
// The block-per-slice design it replaces held the window in shared memory
// ((8 X + 6) nzm values, each stage a loop of 256 threads followed by a
// barrier), so it refused windows past X = 62 at f64 and 126 at f32 (nzm 57);
// the sweep takes any X and up to 256 levels.  Every operation is an _rn
// intrinsic, so f is bit for bit the plain version's; only the flux partial's
// column sums run in another order than torch.sum.

#include "mpdata_sweep.cuh"

extern "C" {

// A window of X columns: f (S,X,nzm), or with f_left non-null the owned block f
// (S,X-2*halo,nzm) between f_left and f_right (S,halo,nzm); u (S,X,nzm),
// w (S,X,nzm+1), rho/adz (S,nzm), rhow (S,nzm+1).  Outputs: f_out shaped like f,
// flux_out (S,nzm), the last step's flux partial; win (S,X,nzm) scratch, needed
// with f_left and nsteps > 1, else null.  gi0 is the global Fortran index of
// window column 0; hoist selects the K24/K25 order of operations; warps the
// warps a slice (0 picks).  Returns cudaGetLastError() after the launch.
#define CDK_MASKED_ENTRY(name, T)                                                        \
  int name(const void* fl, const void* f, const void* fr, const void* u, const void* w, \
           const void* rho, const void* rhow, const void* adz, void* f_out,            \
           void* flux_out, void* win, int nslices, int X, int nzm, int nx, int gi0,    \
           int owned_lo, int owned_hi, int halo, int nsteps, int hoist, int warps,     \
           void* stream) {                                                             \
    Sweep<T> a{static_cast<const T*>(f), static_cast<const T*>(fl),                    \
               static_cast<const T*>(fr), static_cast<const T*>(u),                    \
               static_cast<const T*>(w), static_cast<const T*>(rho),                   \
               static_cast<const T*>(rhow), static_cast<const T*>(adz), nullptr,       \
               static_cast<T*>(f_out), static_cast<T*>(flux_out), static_cast<T*>(win), \
               nslices, X, nzm, nx, gi0, owned_lo, owned_hi, halo, nsteps, 1};         \
    return hoist ? launch_mpdata_sweep<T, T, true, true>(a, warps, stream)             \
                 : launch_mpdata_sweep<T, T, false, true>(a, warps, stream);           \
  }

CDK_MASKED_ENTRY(cdk_mpdata_masked_f32, float)
CDK_MASKED_ENTRY(cdk_mpdata_masked_f64, double)

}  // extern "C"
