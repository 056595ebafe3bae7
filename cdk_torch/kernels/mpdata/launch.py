"""What the MPDATA kernels, the x sweep of csrc/mpdata_sweep.cuh, share:
csrc/mpdata_resident.cu, the step kernel in its hoisted form (K2, K9; see
resident.py) and its staged form (K6, K7, K8; see staged.py),
csrc/mpdata_masked.cu, the masked-global step (K20-K25; see masked.py) and
csrc/mpdata_lanes.cu (K10; see lanes.py).  The level limit they take
(`check_levels`: the sweep holds any nx and at most
`cdk_mpdata_max_levels()` levels), the warps a slice (`check_warps`), the
checks of the resident/staged wrappers, `step_kernel`, which makes such a
wrapper, and `resident_forms`, the registry forms of an
n-steps-per-launch variant.
"""

from __future__ import annotations

import functools

import torch

from cdk_torch.core import build
from cdk_torch.core.registry import UnsupportedConfigError, forms
from cdk_torch.core.trace import counted, span
from cdk_torch.kernels.mpdata.problem import MpdataData


@functools.cache
def max_levels() -> int:
    """The most levels (nzm) a slice of the sweep may have."""
    fn, _ = build.library()["cdk_mpdata_max_levels"]
    return fn()


def check_levels(nzm: int, what: str) -> None:
    """Refuse (UnsupportedConfigError, never a fallback) a slice of more
    levels than the sweep's lanes hold."""
    if nzm > (most := max_levels()):
        raise UnsupportedConfigError(
            f"{what} takes at most {most} levels a slice (nzm={nzm})")


def check_warps(warps: int | None) -> int:
    """The C entries' `warps`: 0 picks by slice count; else 1, 2, 4 or 8
    warps a slice."""
    if warps is None:
        return 0
    if warps not in (1, 2, 4, 8):
        raise ValueError(f"warps a slice must be 1, 2, 4 or 8 (got {warps})")
    return warps


_ENTRY = {(True, torch.float32): "cdk_mpdata_resident_f32",
          (True, torch.float64): "cdk_mpdata_resident_f64",
          (False, torch.float32): "cdk_mpdata_staged_f32",
          (False, torch.float64): "cdk_mpdata_staged_f64",
          (False, torch.bfloat16): "cdk_mpdata_staged_bf16"}


def _validate(f, u, w, rho, rhow, adz, flux, n, hoist):
    if n < 0:
        raise ValueError(f"n must be >= 0 (got {n})")
    fields = dict(f=f, u=u, w=w, rho=rho, rhow=rhow, adz=adz, flux=flux)
    s, xf, nzm = f.shape
    nx, nz = xf - 6, nzm + 1
    want = dict(f=(s, nx + 6, nzm), u=(s, nx + 5, nzm), w=(s, nx + 4, nz),
                rho=(s, nzm), rhow=(s, nz), adz=(s, nzm), flux=(s, nz))
    for name, t in fields.items():
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, want {want[name]}")
        if t.dtype != f.dtype or t.device != f.device:
            raise TypeError(f"{name}: {t.dtype} on {t.device}; every field "
                            f"must be {f.dtype} on {f.device}")
    if (hoist, f.dtype) not in _ENTRY:
        kinds = [str(d).removeprefix("torch.") for h, d in _ENTRY if h == hoist]
        raise TypeError(f"the {'hoisted' if hoist else 'staged'} step takes "
                        f"{' or '.join(kinds)}, not {f.dtype}")
    if f.is_cuda:  # the sweep's level limit, both forms
        check_levels(nzm, f"the {'hoisted' if hoist else 'staged'} step")


def step_kernel(name: str, hoist: bool, plain, doc: str):
    """A wrapper of csrc/mpdata_resident.cu, hoisted or staged, with its own
    launch count: fn(f, u, w, rho, rhow, adz, flux, n) -> (f, flux) after
    n steps.  CUDA tensors launch the kernel (never anything else); CPU
    tensors run `plain` with the same arguments.  `warps` sets the warps a
    slice (1, 2, 4 or 8) where the kernel's own choice by slice count is
    not wanted, as a measurement of that choice does."""

    @counted
    def wrapper(f, u, w, rho, rhow, adz, flux, n: int, *, warps=None):
        _validate(f, u, w, rho, rhow, adz, flux, n, hoist)
        if f.device.type == "cpu":
            return plain(f, u, w, rho, rhow, adz, flux, n)
        args = (f, u, w, rho, rhow, adz, flux)
        if not all(t.is_contiguous() for t in args):
            raise ValueError("the MPDATA step kernel needs contiguous fields")
        s, xf, nzm = f.shape
        f_out = torch.empty_like(f)
        flux_out = torch.empty_like(flux)
        build.launch(wrapper, n, "mpdata_resident", _ENTRY[hoist, f.dtype],
                     f.device, *args, f_out, flux_out, s, xf - 6, nzm, n,
                     check_warps(warps))
        return f_out, flux_out

    wrapper.__name__ = wrapper.__qualname__ = name
    wrapper.__doc__ = doc
    return wrapper


def resident_forms(run):
    """The registry forms of a variant whose kernel runs n steps in one
    launch: `prepare` stages the step-invariant fields, `step` is one
    launch at n = 1 and `loop` one launch at n."""
    def prepare(data: MpdataData):
        """The step-invariant fields, contiguous (untimed staging)."""
        with span("cdk.prepare"):
            return tuple(t.contiguous() for t in
                         (data.u, data.w, data.rho, data.rhow, data.adz))

    return forms(prepare, lambda aux, data, n: run(
        data.f.contiguous(), *aux, data.flux.contiguous(), n))
