"""K19: the resident torus-DSS biharmonic chain — k chained steps (apply →
2-D DSS → apply) of every element in one kernel launch.

Replaces cdk_tpu/kernels/biharmonic/pallas_dss2d_resident.py::
_dss2d_resident_kernel (caller `apply_dss2d_resident`), under the same
variant names of `biharmonic_dss2d`:

  fused_operator_bd8_resident      "highest": exact f32 or f64 products
  fused_operator_bd8_resident_x3   "bf16x3" products (f32 only)

The CUDA kernels are csrc/biharmonic_dss2d_resident.cu.  A launch of k
steps computes windows of element rows with k halo units per side and
stores their centres: 2k+1 or more whole rows where they fit in WINDOW
elements, as in the TPU kernel, so the j assembly stays inside the window
and only the i assembly consumes halo rows; where they do not (long rows:
the production 75 x 72 torus), a rectangle of elements with halo in both
directions, which takes at most RECT_STEPS steps.  So the port runs every
torus, where the JAX variants raise UnsupportedConfigError once their
full-row window exceeds VMEM (at production, for one).  The bf16x3 form
runs on the tensor cores (mma.sync), two window elements a warp at 16
columns in windows of up to 64 (whole rows where 2k+1 fit, else 8 x 8; the
shapes chip_smoke.py's sweep and scripts/torch_dss2d_window_variants.py
measured on the H100, PERF.md §6), in persistent blocks that sweep each
window's column tiles; the tensor core sums a product's terms in its own
order, so it matches the plain version within the registered 5e-5, not bit
for bit.  The exact forms keep one thread per column and are bit for bit
the plain version.  Beside the wrapper here: `dss2d_resident_plain`, the
same function in plain PyTorch over the whole field (the CPU path, and what
the kernel is compared with on the card).  The TPU's grouping, window
geometry, VMEM budget and 128-lane pad are not ported.
"""

from __future__ import annotations

import torch

from cdk_torch.core import build
from cdk_torch.core.registry import register
from cdk_torch.core.trace import counted
from cdk_torch.kernels.biharmonic.dss2d import dss2d_lane, dss2d_weights, torus_shape
from cdk_torch.kernels.biharmonic.dss_resident import NPG, NPTS, validate
from cdk_torch.kernels.biharmonic.operator import (
    apply_operator,
    build_element_operator,
    element_forms,
)
from cdk_torch.kernels.biharmonic.problem import (
    BiharmonicData,
    from_lane_layout,
    to_lane_layout,
)
from cdk_torch.kernels.biharmonic.reference import rrearth_as

WINDOW = 64  # the kernels' largest window, in elements (at 16 columns)
RECT_STEPS = 3  # steps an 8 x 8 window takes (2k+1 < 8)
# steps per launch in `loop` where whole rows fit (capped by their
# capacity): the fastest of 1-4 at the shipped 4 x 4 torus on the H100, f32
# x3 and f64 (PERF.md §6); else RECT_DEPTH
DEPTH = 2
RECT_DEPTH = 1


def row_steps(ey: int) -> int:
    """The most steps a window of whole rows of ey elements takes: 2k+1
    rows must fit in WINDOW elements."""
    return max(0, (WINDOW // ey - 1) // 2)


def max_steps(ey: int) -> int:
    """The most steps one launch takes on a torus with rows of ey
    elements."""
    return max(row_steps(ey), RECT_STEPS)


def loop_depth(ey: int) -> int:
    """The launch depth `loop` uses on a torus with rows of ey elements."""
    return min(DEPTH, row_steps(ey)) if row_steps(ey) else RECT_DEPTH


def dss2d_resident_plain(L: torch.Tensor, w: torch.Tensor,
                         q_lane: torch.Tensor, ex: int, ey: int, nsteps: int,
                         precision: str = "highest") -> torch.Tensor:
    """nsteps chained torus-DSS steps over the whole field.  L: (e, 16, 16);
    w: (e, 16) inverse assembled mass in lane order; q_lane: (e, 16, ncol)
    on the (ex, ey) torus, e = a*ey + b."""
    prec = "high" if precision == "bf16x3" else "highest"
    w3 = w.reshape(-1, NPTS, 1)
    q = q_lane
    for _ in range(nsteps):
        s = dss2d_lane(apply_operator(L, q, prec), w3, ex, ey, NPG)
        q = apply_operator(L, s, prec)
    return q


@counted
def dss2d_resident(L: torch.Tensor, w: torch.Tensor, q_lane: torch.Tensor,
                   ex: int, ey: int, nsteps: int,
                   precision: str = "highest") -> torch.Tensor:
    """Run nsteps chained steps.  CUDA tensors launch the kernel (never
    anything else); CPU tensors run dss2d_resident_plain."""
    validate(L, w, q_lane, nsteps, precision, None, max_steps(ey))
    if ex * ey != q_lane.shape[0]:
        raise ValueError(f"want an ({ex}x{ey}) torus of {ex * ey} elements; "
                         f"got {q_lane.shape[0]}")
    if q_lane.device.type == "cpu":
        return dss2d_resident_plain(L, w, q_lane, ex, ey, nsteps, precision)
    return launch(L, w, q_lane, ex, ey, nsteps, precision)


def launch(L, w, q_lane, ex, ey, nsteps, precision):
    """One launch of csrc/biharmonic_dss2d_resident.cu on CUDA tensors
    that dss2d_resident has validated, counted on dss2d_resident."""
    if not all(t.is_contiguous() for t in (L, w, q_lane)):
        raise ValueError("dss2d_resident needs contiguous operands")
    out = torch.empty_like(q_lane)
    args = (L, w, q_lane, out, ex, ey, q_lane.shape[2], nsteps)
    if q_lane.dtype == torch.float32:
        build.launch(dss2d_resident, nsteps, "dss2d_resident",
                     "cdk_dss2d_resident_f32", q_lane.device, *args,
                     int(precision == "bf16x3"))
    else:
        build.launch(dss2d_resident, nsteps, "dss2d_resident",
                     "cdk_dss2d_resident_f64", q_lane.device, *args)
    return out


def _dss2d_resident_forms(cfg, precision: str):
    rr = rrearth_as(cfg)
    ex, ey = torus_shape(cfg.nelemd)
    depth = loop_depth(ey)

    def prepare(data: BiharmonicData):
        L = build_element_operator(data.dvv, data.dinv, data.spheremp,
                                   data.tensorvisc, rr)
        w = dss2d_weights(data.spheremp, ex, ey).reshape(cfg.nelemd, NPTS)
        return L, w.contiguous()

    def run(aux, data: BiharmonicData, n: int) -> torch.Tensor:
        """n steps: launches of `depth` steps, then the remainder; the
        layout changes once at each end."""
        L, w = aux
        q = to_lane_layout(data.qtens)
        while n > 0:
            k = min(depth, n)
            q = dss2d_resident(L, w, q, ex, ey, k, precision)
            n -= k
        return from_lane_layout(q, cfg)

    return element_forms(prepare, run)


@register(
    "biharmonic_dss2d",
    "fused_operator_bd8_resident",
    "resident torus-DSS chain: k full steps (apply - 2-D DSS - apply) in one "
    "kernel over deep-halo element-ROW windows, the state in registers; the "
    "j assembly stays in the window, only the i assembly uses halo rows "
    "(exact products)",
)
def make_dss2d_bd8_resident(cfg):
    return _dss2d_resident_forms(cfg, "highest")


@register(
    "biharmonic_dss2d",
    "fused_operator_bd8_resident_x3",
    "resident torus-DSS chain with 3-pass bf16 hi/lo products accumulated in "
    "f32",
    supports_f64=False,
    verify_tol=5e-5,
)
def make_dss2d_bd8_resident_x3(cfg):
    return _dss2d_resident_forms(cfg, "bf16x3")
