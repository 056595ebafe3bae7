"""K6, K7 and K8: the stage-exact MPDATA step (`reference.advect_scalar2d`)
in one kernel, one step per launch or n steps per launch.

The three TPU kernels compute the same staged step and differ in layout
and loop placement:

  K6  cdk_tpu/kernels/mpdata/pallas_fused.py::_kernel      `pallas_fused`
      one step per launch, z on lanes
  K7  cdk_tpu/kernels/mpdata/pallas_packed.py::_kernel     `pallas_packed`,
      one step per launch, two slices per 128-lane row     `pallas_packed_bf16`
  K8  cdk_tpu/kernels/mpdata/pallas_resident.py::_kernel   `pallas_resident`
      n steps in one launch on the packed layout

The layouts are TPU machinery (lane packing, z segments, clamp masks, the
kspan input, the slice padding and the even-slice and nz <= 64 guards) and
are not ported.  All three run the staged form of csrc/mpdata_resident.cu
(one warp per slice sweeping it along x with the levels across its lanes,
every stage a fixed lag behind the rows it reads, in registers; below 1024
slices a slice's x range split among up to 8 warps; the antidiffusive
velocities computed each step in the reference's operation order), through
wrappers with their own launch counts: `advect_fused`
(K6), `advect_packed` (K7) and `advect_staged_resident` (K8).  The kernel
takes any nx and up to 256 levels (nzm) and raises UnsupportedConfigError
past that.  Every arithmetic operation rounds as the plain version's, so f
matches it bit for bit at f32 and f64; the flux column sums run in x
order, not torch.sum's.

`pallas_packed_bf16` casts the fields to bfloat16 on entry and the outputs
back on exit, as the JAX form does; the kernel stores every value in bf16
and computes each stage in f32.  The plain version of all four,
`advect_staged_plain`, is the staged reference stepped n times (in bf16
for the bf16 form, where torch rounds every operation).
"""

from __future__ import annotations

import torch

from cdk_torch.core.registry import forms, register
from cdk_torch.core.trace import span
from cdk_torch.kernels.mpdata.launch import resident_forms, step_kernel
from cdk_torch.kernels.mpdata.problem import MpdataData
from cdk_torch.kernels.mpdata.reference import advect_scalar2d


def advect_staged_plain(f, u, w, rho, rhow, adz, flux, n: int):
    """n staged reference steps; (f, flux) feed back."""
    for _ in range(n):
        f, flux = advect_scalar2d(f, u, w, rho, rhow, adz, flux)
    return f, flux


advect_fused = step_kernel(
    "advect_fused", False, advect_staged_plain,
    "K6 (`pallas_fused`): the staged step kernel, one step per launch.")
advect_packed = step_kernel(
    "advect_packed", False, advect_staged_plain,
    "K7 (`pallas_packed`, `pallas_packed_bf16`): the staged step kernel, one "
    "step per launch, float32, float64 or bfloat16.")
advect_staged_resident = step_kernel(
    "advect_staged_resident", False, advect_staged_plain,
    "K8 (`pallas_resident`): n staged steps in one launch.")


def _invariants(data: MpdataData, dtype):
    """u, w, rho, rhow, adz in the kernel's dtype, contiguous."""
    with span("cdk.prepare"):
        return tuple(t.to(dtype).contiguous() for t in
                     (data.u, data.w, data.rho, data.rhow, data.adz))


@register(
    "mpdata",
    "pallas_fused",
    "single fused kernel: all 7 MPDATA stages of one step in one x sweep "
    "per slice, the stage rows in registers; the analog of the reference "
    "openacc variants (advect_scalar2D…F90:72-474) without openacc_2's "
    "fusion bug",
)
def make_pallas_fused(cfg):
    def step(data: MpdataData):
        return advect_fused(data.f.contiguous(), *_invariants(data, data.f.dtype),
                            data.flux.contiguous(), 1)

    return step


def _packed_forms(compute_dtype=None):
    """step, prepare and a loop of n one-step launches (the JAX scan).  With
    compute_dtype the fields are cast on entry and the outputs cast back."""

    def prepare(data: MpdataData):
        return _invariants(data, compute_dtype or data.f.dtype)

    def run(aux, data: MpdataData, n: int):
        dt = compute_dtype or data.f.dtype
        f, flux = data.f.to(dt).contiguous(), data.flux.to(dt).contiguous()
        for _ in range(n):
            f, flux = advect_packed(f, *aux, flux, 1)
        return f.to(data.f.dtype), flux.to(data.f.dtype)

    return forms(prepare, run)


@register(
    "mpdata",
    "pallas_packed",
    "the staged step kernel one step per launch (the JAX form packs two "
    "slices per 128-lane register; the layout is TPU machinery, the "
    "stage-exact math is the same)",
)
def make_pallas_packed(cfg):
    return _packed_forms()


@register(
    "mpdata",
    "pallas_packed_bf16",
    "the staged step kernel storing every value in bfloat16 (fields cast on "
    "entry, outputs cast back): the JAX package's recorded design point",
    supports_f64=False,
    fast_math=True,
    experimental=True,
)
def make_pallas_packed_bf16(cfg):
    return _packed_forms(torch.bfloat16)


@register(
    "mpdata",
    "pallas_resident",
    "staged step kernel with the n-step time loop inside the kernel: one "
    "launch sweeps each slice n times (the per-level fields derived once "
    "per run, f carried in the output between steps); same stage-exact "
    "math as pallas_packed",
)
def make_pallas_resident(cfg):
    return resident_forms(advect_staged_resident)
