"""K10: the MPDATA step with the slice batch on the fast axis, layout
(x, z, s) — the JAX package's `pallas_lanes` design study.

Replaces cdk_tpu/kernels/mpdata/pallas_lanes.py::_kernel (experimental, as
there).  The variant exists for its layout: slices innermost, so the
slices of one (x, z) point lie side by side.  The JAX form pads z
to a sublane multiple and the slice batch to 128-slice lane blocks; both
are TPU tiling and are not ported.

The CUDA kernel (csrc/mpdata_lanes.cu) runs the step in one launch: the
staged x sweep of csrc/mpdata_sweep.cuh (a warp per slice, the stage rows
in registers), fed from and drained to the (x, z, s) layout through
shared-memory tiles of a block's slices side by side, with no temporary
in device memory; below 1024 slices a slice's x range splits among up to
8 warps.  Every operation rounds as the plain version's, so f is bit for
bit `advect_lanes_plain`'s at f32 and f64; the flux column sums run in x
order.  It takes up to 256 levels (nzm) and raises UnsupportedConfigError
past that.  Beside it here: `advect_lanes_plain`, the same step in plain
PyTorch (the staged reference on the (s, x, z) view), and the wrapper
`advect_lanes`, which launches the kernel for CUDA tensors and runs the
plain version for CPU tensors.  `to_xzs`/`from_xzs` change the layout;
the variant's `loop` changes it once per call, as the JAX `_loop` does,
and its public functions keep the canonical (S, X, Z) layout.
"""

from __future__ import annotations

import torch

from cdk_torch.core import build
from cdk_torch.core.registry import register
from cdk_torch.core.trace import counted, span
from cdk_torch.kernels.mpdata.launch import check_levels, check_warps
from cdk_torch.kernels.mpdata.problem import MpdataData
from cdk_torch.kernels.mpdata.reference import advect_scalar2d

FIELDS = ("f", "u", "w", "rho", "rhow", "adz", "flux")


def to_xzs(t: torch.Tensor) -> torch.Tensor:
    """(S, ...) -> contiguous (..., S): the slice axis last."""
    with span("cdk.layout"):
        return t.movedim(0, -1).contiguous()


def from_xzs(t: torch.Tensor) -> torch.Tensor:
    """Inverse of to_xzs."""
    with span("cdk.layout"):
        return t.movedim(-1, 0).contiguous()


def advect_lanes_plain(f, u, w, rho, rhow, adz, flux):
    """One staged step on (x, z, s) fields; returns (f, flux) in (x, z, s)."""
    f_o, flux_o = advect_scalar2d(*(from_xzs(t) for t in
                                    (f, u, w, rho, rhow, adz, flux)))
    return to_xzs(f_o), to_xzs(flux_o)


def _validate(f, u, w, rho, rhow, adz, flux):
    xf, nzm, s = f.shape
    nx, nz = xf - 6, nzm + 1
    want = dict(f=(nx + 6, nzm, s), u=(nx + 5, nzm, s), w=(nx + 4, nz, s),
                rho=(nzm, s), rhow=(nz, s), adz=(nzm, s), flux=(nz, s))
    for name, t in zip(FIELDS, (f, u, w, rho, rhow, adz, flux)):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, want {want[name]} "
                             "in the (x, z, s) layout")
        if t.dtype != f.dtype or t.device != f.device:
            raise TypeError(f"{name}: {t.dtype} on {t.device}; every field "
                            f"must be {f.dtype} on {f.device}")
    if f.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"advect_lanes takes float32 or float64, not {f.dtype}")
    if f.is_cuda:
        check_levels(nzm, "advect_lanes")


@counted
def advect_lanes(f, u, w, rho, rhow, adz, flux, *, warps=None):
    """One step on (x, z, s) fields; returns (f, flux) in (x, z, s).  CUDA
    tensors launch the kernel (never anything else); CPU tensors run
    advect_lanes_plain.  `warps` sets the warps a slice (1, 2, 4 or 8)
    where the kernel's own choice by slice count is not wanted."""
    args = (f, u, w, rho, rhow, adz, flux)
    _validate(*args)
    if f.device.type == "cpu":
        return advect_lanes_plain(*args)
    if not all(t.is_contiguous() for t in args):
        raise ValueError("advect_lanes needs contiguous fields")
    xf, nzm, s = f.shape
    f_out, flux_out = torch.empty_like(f), torch.empty_like(flux)
    build.launch(advect_lanes, 1, "advect_lanes",
                 "cdk_mpdata_lanes_f32" if f.dtype == torch.float32
                 else "cdk_mpdata_lanes_f64", f.device, *args, f_out, flux_out,
                 s, xf - 6, nzm, check_warps(warps))
    return f_out, flux_out


@register(
    "mpdata",
    "pallas_lanes",
    "staged step with the slice batch on the fast axis ((x, z, s) layout): "
    "rows move as runs of consecutive slices through shared-memory tiles "
    "feeding the one-launch x sweep (design study, see the module docstring)",
    experimental=True,
)
def make_pallas_lanes(cfg):
    def _run(data: MpdataData, n: int):
        """n steps in the (x, z, s) layout, changed once at each end."""
        f, u, w, rho, rhow, adz, flux = (to_xzs(getattr(data, name))
                                         for name in FIELDS)
        for _ in range(n):
            f, flux = advect_lanes(f, u, w, rho, rhow, adz, flux)
        return from_xzs(f), from_xzs(flux)

    def step(data: MpdataData):
        return _run(data, 1)

    return {"step": step, "loop": _run}
