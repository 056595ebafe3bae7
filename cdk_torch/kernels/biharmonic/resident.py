"""K1: the resident biharmonic operator chain — n applications
q <- L[e] q of every element's 16x16 operator in one kernel launch.

Replaces cdk_tpu/kernels/biharmonic/pallas_bd8.py::_resident_kernel
(`apply_bd8_resident`), under the same variant names:

  fused_operator_bd8_resident     "highest": exact f32 or f64 products
  fused_operator_bd8_resident_x3  "bf16x3": L_hi·q_hi + L_hi·q_lo + L_lo·q_hi
                                  with bf16 hi/lo splits, accumulated in f32

The CUDA kernel is csrc/biharmonic_resident.cu.  Beside it here:
`bd8_resident_plain`, the same function in plain PyTorch (the CPU path,
and what the card's kernel is compared with), and the wrapper
`bd8_resident`, which launches the kernel for CUDA tensors and runs the
plain version for CPU tensors.  The plain version runs its matrix products
with TF32 off (`exact_fp32`), so "highest" means true f32 on the card.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from cdk_torch.core import build
from cdk_torch.core.platform import exact_fp32
from cdk_torch.core.registry import register
from cdk_torch.kernels.biharmonic.operator import build_element_operator
from cdk_torch.kernels.biharmonic.problem import (
    BiharmonicData,
    from_lane_layout,
    to_lane_layout,
)
from cdk_torch.kernels.biharmonic.reference import rrearth_as

NPTS = 16
PRECISIONS = ("highest", "bf16x3")


def _bf16_round(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(x.dtype)


def bd8_resident_plain(L: torch.Tensor, q_lane: torch.Tensor, n: int,
                       precision: str = "highest") -> torch.Tensor:
    """n chained batched products q <- L @ q.  L: (e, 16, 16), q_lane:
    (e, 16, ncol).  "bf16x3" forms each product from bf16-valued hi/lo
    parts (exact products, f32 sums), as the TPU kernel's manual split."""
    exact_fp32()
    q = q_lane
    if precision == "highest":
        for _ in range(n):
            q = torch.bmm(L, q)
        return q
    L_hi = _bf16_round(L)
    L_lo = _bf16_round(L - L_hi)
    for _ in range(n):
        q_hi = _bf16_round(q)
        q_lo = _bf16_round(q - q_hi)
        q = torch.bmm(L_hi, q_hi) + torch.bmm(L_hi, q_lo) + torch.bmm(L_lo, q_hi)
    return q


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.library()
    lib.cdk_bd8_resident_f32.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    lib.cdk_bd8_resident_f64.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    lib.cdk_bd8_resident_f32.restype = ctypes.c_int
    lib.cdk_bd8_resident_f64.restype = ctypes.c_int
    return lib


def _validate(L, q_lane, n, precision):
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r} not in {PRECISIONS}")
    if n < 0:
        raise ValueError(f"n must be >= 0 (got {n})")
    if q_lane.dtype not in (torch.float32, torch.float64) or L.dtype != q_lane.dtype:
        raise TypeError(f"L and q_lane must share float32 or float64 "
                        f"(got {L.dtype}, {q_lane.dtype})")
    if precision == "bf16x3" and q_lane.dtype != torch.float32:
        raise TypeError("bf16x3 is a float32 form")
    if L.device != q_lane.device:
        raise ValueError(f"L on {L.device}, q_lane on {q_lane.device}")
    e = q_lane.shape[0]
    if q_lane.dim() != 3 or q_lane.shape[1] != NPTS or L.shape != (e, NPTS, NPTS):
        raise ValueError(f"want L (e,{NPTS},{NPTS}) and q_lane (e,{NPTS},ncol); "
                         f"got {tuple(L.shape)}, {tuple(q_lane.shape)}")


def bd8_resident(L: torch.Tensor, q_lane: torch.Tensor, n: int,
                 precision: str = "highest") -> torch.Tensor:
    """Run n chained applications.  CUDA tensors launch the kernel (never
    anything else); CPU tensors run bd8_resident_plain."""
    _validate(L, q_lane, n, precision)
    if q_lane.device.type == "cpu":
        return bd8_resident_plain(L, q_lane, n, precision)
    if not (L.is_contiguous() and q_lane.is_contiguous()):
        raise ValueError("bd8_resident needs contiguous L and q_lane")
    e, _, ncol = q_lane.shape
    out = torch.empty_like(q_lane)
    stream = torch.cuda.current_stream(q_lane.device).cuda_stream
    with torch.cuda.device(q_lane.device):
        if q_lane.dtype == torch.float32:
            err = _lib().cdk_bd8_resident_f32(
                L.data_ptr(), q_lane.data_ptr(), out.data_ptr(), e, ncol, n,
                int(precision == "bf16x3"), stream)
        else:
            err = _lib().cdk_bd8_resident_f64(
                L.data_ptr(), q_lane.data_ptr(), out.data_ptr(), e, ncol, n,
                stream)
    build.check(err, "bd8_resident")
    bd8_resident.launches += 1
    return out


bd8_resident.launches = 0  # kernel launches in this process


def _bd8_resident_forms(cfg, precision: str):
    rr = rrearth_as(cfg)

    def _operator(data: BiharmonicData) -> torch.Tensor:
        return build_element_operator(
            data.dvv, data.dinv, data.spheremp, data.tensorvisc, rr)

    def prepare(data: BiharmonicData):
        return (_operator(data),)

    def _run(L, qtens, n):
        out = bd8_resident(L, to_lane_layout(qtens), n, precision)
        return from_lane_layout(out, cfg)

    def step(aux, data: BiharmonicData) -> torch.Tensor:
        (L,) = aux
        return _run(L, data.qtens, 1)

    def loop(data: BiharmonicData, n: int) -> torch.Tensor:
        """n applications in one launch (the timed path); the layout
        changes once at each end, not per step."""
        return _run(_operator(data), data.qtens, n)

    return {"prepare": prepare, "step": step, "loop": loop}


@register(
    "biharmonic",
    "fused_operator_bd8_resident",
    "resident operator chain: each element's 16x16 operator applied n "
    "times in one kernel with the tracer columns held in registers "
    "(device memory touched once per run); exact f32/f64 products",
)
def make_fused_operator_bd8_resident(cfg):
    return _bd8_resident_forms(cfg, "highest")


@register(
    "biharmonic",
    "fused_operator_bd8_resident_x3",
    "resident operator chain with the 3-pass bf16 hi/lo split products "
    "accumulated in f32 (the TPU champion's arithmetic)",
    supports_f64=False,
)
def make_fused_operator_bd8_resident_x3(cfg):
    return _bd8_resident_forms(cfg, "bf16x3")
