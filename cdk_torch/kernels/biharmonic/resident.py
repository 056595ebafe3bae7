"""K1: the resident biharmonic operator chain — n applications
q <- L[e] q of every element's 16x16 operator in one kernel launch — and
K5, the one-step operator apply, on the same kernel.

K1 replaces cdk_tpu/kernels/biharmonic/pallas_bd8.py::_resident_kernel
(`apply_bd8_resident`), under the same variant names:

  fused_operator_bd8_resident     "highest": exact f32 or f64 products
  fused_operator_bd8_resident_x3  "bf16x3": L_hi·q_hi + L_hi·q_lo + L_lo·q_hi
                                  with bf16 hi/lo splits, accumulated in f32

K5 replaces cdk_tpu/kernels/biharmonic/operator.py::_pallas_apply_kernel
(`apply_operator_pallas`), variant `fused_operator_pallas`: out[e] =
L[e] @ q[e] with exact products, one step per launch.  That is K1's
"highest" kernel at n = 1, so `apply_operator_pallas` launches it with
n = 1 and counts its launches apart from K1's.

The CUDA kernel is csrc/biharmonic_resident.cu.  Beside it here:
`bd8_resident_plain`, the same function in plain PyTorch (the CPU path,
and what the card's kernel is compared with), and the wrappers
`bd8_resident` and `apply_operator_pallas`, which launch the kernel for
CUDA tensors and run the plain version for CPU tensors.  The plain version
runs its matrix products with TF32 off (`exact_fp32`), so "highest" means
true f32 on the card.

`bd8_resident` takes q in either layout and chooses the kernel's load
from its shape: a 3-D (e, 16, ncol) tensor is the lane layout, a
contiguous 5-D (e, q, k, 4, 4) tensor the state's own layout, which the
kernel reads where it lies (`count("natural_loads")`), so the resident
forms' loops pass `data.qtens` and make no lane copy.  The output is the
lane layout either way.  K5 takes the lane layout only.
"""

from __future__ import annotations

import torch

from cdk_torch.core import build
from cdk_torch.core.registry import register
from cdk_torch.core.trace import count, counted
from cdk_torch.kernels.biharmonic.operator import (
    apply_operator,
    element_forms,
    element_operator,
)
from cdk_torch.kernels.biharmonic.problem import (
    BiharmonicData,
    from_lane_layout,
    lane_of,
    lane_shape,
    to_lane_layout,
)
from cdk_torch.kernels.biharmonic.reference import rrearth_as

NPTS = 16
PRECISIONS = ("highest", "bf16x3")


def bd8_resident_plain(L: torch.Tensor, q_lane: torch.Tensor, n: int,
                       precision: str = "highest") -> torch.Tensor:
    """n chained batched products q <- L @ q.  L: (e, 16, 16), q_lane:
    (e, 16, ncol), or the state's own (e, q, k, 4, 4), turned first.
    "bf16x3" forms each product from bf16-valued hi/lo parts (exact
    products, f32 sums), as the TPU kernel's manual split
    (`apply_operator`'s "high")."""
    q = lane_of(q_lane)
    for _ in range(n):
        q = apply_operator(L, q, "high" if precision == "bf16x3" else "highest")
    return q


def _validate(L, q_lane, n, precision) -> bool:
    """Refuse what the kernel cannot run; True where q_lane is the state's
    own layout."""
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
    shape = lane_shape(q_lane)
    e = shape[0]
    if len(shape) != 3 or shape[1] != NPTS or L.shape != (e, NPTS, NPTS):
        raise ValueError(f"want L (e,{NPTS},{NPTS}) and q (e,{NPTS},ncol) or "
                         f"(e,q,k,4,4); got {tuple(L.shape)}, "
                         f"{tuple(q_lane.shape)}")
    return q_lane.dim() == 5


def _launch(wrapper, L: torch.Tensor, q_lane: torch.Tensor, n: int,
            precision: str) -> torch.Tensor:
    """One launch of the operator kernel, counted on `wrapper`."""
    if not (L.is_contiguous() and q_lane.is_contiguous()):
        raise ValueError("the operator kernel needs contiguous L and q_lane")
    natural = q_lane.dim() == 5
    if natural and q_lane.data_ptr() % 16:
        raise ValueError("the operator kernel reads the state's own layout "
                         "in 16-byte pieces: it must start 16-byte aligned")
    e, _, ncol = lane_shape(q_lane)
    out = torch.empty((e, NPTS, ncol), dtype=q_lane.dtype, device=q_lane.device)
    args = (L, q_lane, out, e, ncol, n)
    if q_lane.dtype == torch.float32:
        build.launch(wrapper, n, "biharmonic_resident", "cdk_bd8_resident_f32",
                     q_lane.device, *args, int(precision == "bf16x3"),
                     int(natural))
    else:
        build.launch(wrapper, n, "biharmonic_resident", "cdk_bd8_resident_f64",
                     q_lane.device, *args, int(natural))
    return out


@counted
def bd8_resident(L: torch.Tensor, q_lane: torch.Tensor, n: int,
                 precision: str = "highest") -> torch.Tensor:
    """K1: run n chained applications to q_lane, (e, 16, ncol) or the
    state's own contiguous (e, q, k, 4, 4), which the kernel reads where it
    lies; -> (e, 16, ncol).  CUDA tensors launch the kernel (never anything
    else); CPU tensors run bd8_resident_plain."""
    if _validate(L, q_lane, n, precision):
        count("natural_loads")
    if q_lane.device.type == "cpu":
        return bd8_resident_plain(L, q_lane, n, precision)
    return _launch(bd8_resident, L, q_lane, n, precision)


@counted
def apply_operator_pallas(L: torch.Tensor, q_lane: torch.Tensor) -> torch.Tensor:
    """K5: out[e] = L[e] @ q_lane[e], exact products, one launch of the
    operator kernel at n = 1 (CPU tensors: the exact batched product)."""
    if _validate(L, q_lane, 1, "highest"):
        raise ValueError(f"K5 takes the lane layout (e,{NPTS},ncol)")
    if q_lane.device.type == "cpu":
        return bd8_resident_plain(L, q_lane, 1)
    return _launch(apply_operator_pallas, L, q_lane, 1, "highest")


@register(
    "biharmonic",
    "fused_operator_pallas",
    "prebuilt per-element operator applied by the operator kernel one step "
    "per launch: exact f32 FMAs, device memory touched once in and once out "
    "per step (no precision trade)",
)
def make_fused_operator_pallas(cfg):
    rr = rrearth_as(cfg)

    def run(aux, data: BiharmonicData, n: int) -> torch.Tensor:
        """n launches, one step each (as the JAX scan of its kernel)."""
        (L,) = aux
        q = to_lane_layout(data.qtens)
        for _ in range(n):
            q = apply_operator_pallas(L, q)
        return from_lane_layout(q, cfg)

    return element_forms(lambda data: (element_operator(data, rr),), run)


def _bd8_resident_forms(cfg, precision: str):
    rr = rrearth_as(cfg)

    def run(aux, data: BiharmonicData, n: int) -> torch.Tensor:
        """n applications in one launch (the timed path), reading the
        state's own layout; the output is a view of the lane layout."""
        (L,) = aux
        out = bd8_resident(L, data.qtens.contiguous(), n, precision)
        return from_lane_layout(out, cfg)

    return element_forms(lambda data: (element_operator(data, rr),), run)


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
