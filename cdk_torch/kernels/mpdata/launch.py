"""Binding of the MPDATA kernels: csrc/mpdata_resident.cu, the step kernel
in its hoisted form (K2, K9; see resident.py) and its staged form (K6, K7,
K8; see staged.py), and csrc/mpdata_masked.cu, the masked-global step
(K20-K25; see masked.py).  The ctypes entry points, the shared-memory
refusal and the launch count every wrapper of both sources uses
(`require_smem`, `counted`), the checks of the resident/staged wrappers
(the hoisted form holds a slice in one block's shared memory; the staged
form, a warp's x sweep, holds any nx and at most
`cdk_mpdata_staged_max_levels()` levels), `step_kernel`, which makes such a
wrapper, and `resident_forms`, the registry forms of an n-steps-per-launch
variant.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from cdk_torch.core import build
from cdk_torch.core.registry import UnsupportedConfigError
from cdk_torch.kernels.mpdata.problem import MpdataData


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.library()
    for name in ("cdk_mpdata_resident_f32", "cdk_mpdata_resident_f64",
                 "cdk_mpdata_staged_f32", "cdk_mpdata_staged_f64",
                 "cdk_mpdata_staged_bf16"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    for name in ("cdk_mpdata_masked_f32", "cdk_mpdata_masked_f64"):
        fn = getattr(lib, name)
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 10
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    lib.cdk_mpdata_resident_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.cdk_mpdata_resident_smem_bytes.restype = ctypes.c_longlong
    lib.cdk_mpdata_staged_max_levels.argtypes = []
    lib.cdk_mpdata_staged_max_levels.restype = ctypes.c_int
    lib.cdk_mpdata_masked_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.cdk_mpdata_masked_smem_bytes.restype = ctypes.c_longlong
    lib.cdk_max_shared_optin.argtypes = [ctypes.c_int]
    lib.cdk_max_shared_optin.restype = ctypes.c_int
    return lib


def require_smem(need: int, device: torch.device, what: str) -> None:
    """Refuse (UnsupportedConfigError, never a fallback) a launch whose
    block needs more than the card's opt-in shared memory."""
    have = _lib().cdk_max_shared_optin(device.index)
    if need > have:
        raise UnsupportedConfigError(
            f"{what} needs {need} B of shared memory; the card allows "
            f"{have} B per block")


def counted(fn):
    """Give the kernel wrapper `fn` its launch count, to which it adds one
    where it launches its kernel and nowhere else."""
    fn.launches = 0  # kernel launches in this process
    return fn


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


def _launch(f, u, w, rho, rhow, adz, flux, n, hoist):
    args = (f, u, w, rho, rhow, adz, flux)
    if not all(t.is_contiguous() for t in args):
        raise ValueError("the MPDATA step kernel needs contiguous fields")
    s, xf, nzm = f.shape
    nx = xf - 6
    lib = _lib()
    if hoist:
        require_smem(lib.cdk_mpdata_resident_smem_bytes(nx, nzm, f.element_size()),
                     f.device, f"one slice (nx={nx}, nzm={nzm}, {f.dtype})")
    elif nzm > (most := lib.cdk_mpdata_staged_max_levels()):
        raise UnsupportedConfigError(
            f"the staged step takes at most {most} levels a slice (nzm={nzm})")
    f_out = torch.empty_like(f)
    flux_out = torch.empty_like(flux)
    stream = torch.cuda.current_stream(f.device).cuda_stream
    with torch.cuda.device(f.device):
        err = getattr(lib, _ENTRY[hoist, f.dtype])(
            *(t.data_ptr() for t in args), f_out.data_ptr(),
            flux_out.data_ptr(), s, nx, nzm, n, stream)
    build.check(err, "mpdata_resident")
    return f_out, flux_out


def step_kernel(name: str, hoist: bool, plain, doc: str):
    """A wrapper of csrc/mpdata_resident.cu, hoisted or staged, with its own
    launch count: fn(f, u, w, rho, rhow, adz, flux, n) -> (f, flux) after
    n steps.  CUDA tensors launch the kernel (never anything else); CPU
    tensors run `plain` with the same arguments."""

    @counted
    def wrapper(f, u, w, rho, rhow, adz, flux, n: int):
        _validate(f, u, w, rho, rhow, adz, flux, n, hoist)
        if f.device.type == "cpu":
            return plain(f, u, w, rho, rhow, adz, flux, n)
        out = _launch(f, u, w, rho, rhow, adz, flux, n, hoist)
        wrapper.launches += 1
        return out

    wrapper.__name__ = wrapper.__qualname__ = name
    wrapper.__doc__ = doc
    return wrapper


def resident_forms(run):
    """The registry forms of a variant whose kernel runs n steps in one
    launch: `prepare` stages the step-invariant fields, `step` is one
    launch at n = 1 and `loop` one launch at n."""
    def prepare(data: MpdataData):
        """The step-invariant fields, contiguous (untimed staging)."""
        return tuple(t.contiguous() for t in
                     (data.u, data.w, data.rho, data.rhow, data.adz))

    def step(aux, data: MpdataData):
        return run(data.f.contiguous(), *aux, data.flux.contiguous(), 1)

    def loop(data: MpdataData, n: int):
        """n steps inside one launch (the timed path)."""
        return run(data.f.contiguous(), *prepare(data),
                   data.flux.contiguous(), n)

    return {"step": step, "prepare": prepare, "loop": loop}
