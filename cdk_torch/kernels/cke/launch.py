"""What the four CKE kernel wrappers (K3, K11, K12, K13) share: the input
checks, the ctypes binding of a kernel's C entry point, and the launch.

Every entry point takes its tensors' device pointers, then int sizes, then
coef3rdOrder as a double (a value of the working dtype), an optional int
flag, and the stream; it returns cudaGetLastError() after the launch, which
`launch` turns into an exception.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from cdk_torch.core import build

FLOATS = (torch.float32, torch.float64)


def check_inputs(what: str, dtype: torch.dtype, device: torch.device,
                 **fields: tuple[torch.Tensor, tuple[int, ...]]) -> None:
    """Each field is (tensor, wanted shape).  Fields named `cells*` are
    int32 cell indices; the others share `dtype`, float32 or float64.  All
    lie on `device`; on a card they must be contiguous."""
    if dtype not in FLOATS:
        raise TypeError(f"{what} takes float32 or float64, not {dtype}")
    for name, (t, shape) in fields.items():
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{what}: {name} has shape {tuple(t.shape)}, "
                             f"want {tuple(shape)}")
        want = torch.int32 if name.startswith("cells") else dtype
        if t.dtype != want or t.device != device:
            raise TypeError(f"{what}: {name} is {t.dtype} on {t.device}; "
                            f"want {want} on {device}")
        if device.type == "cuda" and not t.is_contiguous():
            raise ValueError(f"{what} needs contiguous inputs ({name} is not)")


@functools.cache
def _entry(name: str, npointers: int, nints: int, flag: bool):
    fn = getattr(build.library(), name)
    fn.argtypes = ([ctypes.c_void_p] * npointers + [ctypes.c_int] * nints
                   + [ctypes.c_double] + [ctypes.c_int] * flag
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def launch(what: str, entry: str, tensors: list[torch.Tensor],
           ints: list[int], coef3: float, flag: int | None = None) -> None:
    """Launch `entry`_f32 or `entry`_f64 (by the last tensor's dtype, the
    output) on PyTorch's current stream; raise if the launch failed."""
    out = tensors[-1]
    suffix = "f32" if out.dtype == torch.float32 else "f64"
    fn = _entry(f"{entry}_{suffix}", len(tensors), len(ints), flag is not None)
    extra = [] if flag is None else [flag]
    stream = torch.cuda.current_stream(out.device).cuda_stream
    with torch.cuda.device(out.device):
        err = fn(*(t.data_ptr() for t in tensors), *ints, coef3, *extra,
                 stream)
    build.check(err, what)
