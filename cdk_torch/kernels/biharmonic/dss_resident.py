"""K14: the resident ring-DSS biharmonic chain — k chained steps
(apply → ring DSS → apply) of every element in one kernel launch.

Replaces cdk_tpu/kernels/biharmonic/pallas_dss_resident.py::
_dss_resident_kernel (single-chip caller `apply_dss_resident`), under the
same variant names:

  fused_operator_bd8_resident        "highest": exact f32 or f64 products
  fused_operator_bd8_resident_x3     "bf16x3" products (f32 only)
  fused_operator_bd8_resident_sq     the precomposed d-carry chain
                                     A·D·(A²·D)^(k-1)·A, "highest"
  fused_operator_bd8_resident_sq_x3  the same with bf16x3 products

The CUDA kernel is csrc/biharmonic_dss_resident.cu: a window of elements
with h = k halo elements per side, so one launch takes at most MAX_STEPS
steps.  The bf16x3 forms run on the tensor cores (mma.sync), which sum a
product's terms in their own order, so they match the plain version within
the registered 5e-5, not bit for bit; the exact forms are bit for bit.
K19, the same chain over the torus (`dss2d_resident.py`), has a kernel of
its own and shares `validate` from here.  Beside it here:
`dss_resident_plain`, the same function in plain PyTorch over the whole
field (the CPU path, and what the kernel is compared with on the card), and
the wrapper `dss_resident`.  `loop(data, n)` chains launches of DEPTH steps
and one launch for the remainder.  The
TPU's grouping, window geometry and VMEM budgets (`_pick_geometry`,
`_pick_k`, `KMAX`, the `CDK_DSS*` hooks, the 128-lane pad) are not ported.

The kernel's window-fed mode (K14w) runs the chain on one shard of a
decomposed ring (`dist/biharmonic.make_dist_loop_dss_kstep`): the owned
block between two exchanged strips, stored back owned only.  It replaces
the dist callers `apply_dss_resident_windowed` and its split form; here
both are `dss_resident_window`, whose strips and owned block may be three
arrays (split) or three views into one extended array (padded), the same
launch either way.  Beside it, `dss_resident_window_plain`.
"""

from __future__ import annotations

import torch

from cdk_torch.core import build
from cdk_torch.core.registry import register
from cdk_torch.core.trace import counted
from cdk_torch.kernels.biharmonic.dss import (
    dss_line_lane,
    dss_ring_lane,
    dss_weights,
)
from cdk_torch.kernels.biharmonic.operator import (
    apply_operator,
    build_element_operator,
    element_forms,
    precompose_operator,
)
from cdk_torch.kernels.biharmonic.problem import (
    BiharmonicData,
    from_lane_layout,
    to_lane_layout,
)
from cdk_torch.kernels.biharmonic.reference import rrearth_as

NPG = 4
NPTS = NPG * NPG
PRECISIONS = ("highest", "bf16x3")
MAX_STEPS = 15  # 2·steps + 1 window elements <= the kernel's 32
# steps per launch in `loop`, the fastest at production f32 on the H100
# (chip_smoke.py's depth sweep, PERF.md §6), us per step at 2 / 3 / ... / 8:
#   sq_x3  168.2 / 133.8 / 117.8 / 109.4 / 109.2 / 110.7 / 115.0
#   sq     286.3 / 236.8 / 214.8 / 206.1 / 203.8 / 214.2 / 225.6
# deeper launches pass through device memory less often but pay the
# window's (B+2k)/B overcompute
DEPTH = 6


def dss_resident_plain(L: torch.Tensor, w: torch.Tensor, q_lane: torch.Tensor,
                       nsteps: int, precision: str = "highest",
                       L2: torch.Tensor | None = None) -> torch.Tensor:
    """nsteps chained ring-DSS steps over the whole field.  L: (e, 16, 16);
    w: (e, 16) inverse assembled mass in lane order (p = i*np + j); q_lane:
    (e, 16, ncol).  With L2 (= A², `precompose_operator`) the d-carry chain
    A·D·(A²·D)^(nsteps-1)·A."""
    prec = "high" if precision == "bf16x3" else "highest"
    w3 = w.reshape(-1, NPG, NPG)

    def dss(s):
        return dss_ring_lane(s, w3, NPG)

    q = q_lane
    if L2 is None:
        for _ in range(nsteps):
            q = apply_operator(L, dss(apply_operator(L, q, prec)), prec)
        return q
    if nsteps == 0:
        return q
    d = dss(apply_operator(L, q, prec))
    for _ in range(nsteps - 1):
        d = dss(apply_operator(L2, d, prec))
    return apply_operator(L, d, prec)


def dss_resident_window_plain(L_ext: torch.Tensor, w_ext: torch.Tensor,
                              hl: torch.Tensor, q_lane: torch.Tensor,
                              hr: torch.Tensor, nsteps: int,
                              precision: str = "highest",
                              L2_ext: torch.Tensor | None = None) -> torch.Tensor:
    """dss_resident_plain on the extended block [hl | q_lane | hr] cut open
    (its two end elements assemble with zeros), the owned block returned.
    L_ext, L2_ext: (e+2h, 16, 16); w_ext: (e+2h, 16); hl, hr: (h, 16,
    ncol); q_lane: (e, 16, ncol).  Exact on the owned block for nsteps <= h."""
    prec = "high" if precision == "bf16x3" else "highest"
    h = hl.shape[0]
    w3 = w_ext.reshape(-1, NPG, NPG)

    def dss(s):
        return dss_line_lane(s, w3, NPG)

    q = torch.cat([hl, q_lane, hr])
    if L2_ext is None:
        for _ in range(nsteps):
            q = apply_operator(L_ext, dss(apply_operator(L_ext, q, prec)), prec)
    elif nsteps > 0:
        d = dss(apply_operator(L_ext, q, prec))
        for _ in range(nsteps - 1):
            d = dss(apply_operator(L2_ext, d, prec))
        q = apply_operator(L_ext, d, prec)
    return q[h:h + q_lane.shape[0]]


def validate(L, w, q_lane, nsteps, precision, L2, max_steps=MAX_STEPS,
             n_ops=None):
    """n_ops: the operators' and weights' element count (q_lane's, unless
    given)."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r} not in {PRECISIONS}")
    if not 0 <= nsteps <= max_steps:
        raise ValueError(f"nsteps must be in [0, {max_steps}] (got {nsteps})")
    ops = [L, w] + ([] if L2 is None else [L2])
    if q_lane.dtype not in (torch.float32, torch.float64) or any(
            t.dtype != q_lane.dtype for t in ops):
        raise TypeError("L, w, L2 and q_lane must share float32 or float64")
    if precision == "bf16x3" and q_lane.dtype != torch.float32:
        raise TypeError("bf16x3 is a float32 form")
    if any(t.device != q_lane.device for t in ops):
        raise ValueError("L, w, L2 and q_lane must lie on one device")
    e = q_lane.shape[0] if n_ops is None else n_ops
    if (q_lane.dim() != 3 or q_lane.shape[1] != NPTS
            or L.shape != (e, NPTS, NPTS) or w.shape != (e, NPTS)
            or (L2 is not None and L2.shape != L.shape)):
        raise ValueError(f"want L, L2 ({e},{NPTS},{NPTS}), w ({e},{NPTS}) and "
                         f"q_lane (e,{NPTS},ncol); got {tuple(L.shape)}, "
                         f"{tuple(w.shape)}, {tuple(q_lane.shape)}")


@counted
def dss_resident(L: torch.Tensor, w: torch.Tensor, q_lane: torch.Tensor,
                 nsteps: int, precision: str = "highest",
                 L2: torch.Tensor | None = None) -> torch.Tensor:
    """Run nsteps chained steps.  CUDA tensors launch the kernel (never
    anything else); CPU tensors run dss_resident_plain."""
    validate(L, w, q_lane, nsteps, precision, L2)
    if q_lane.device.type == "cpu":
        return dss_resident_plain(L, w, q_lane, nsteps, precision, L2)
    sq = L2 is not None
    l2 = L2 if sq else L
    if not all(t.is_contiguous() for t in (L, l2, w, q_lane)):
        raise ValueError("dss_resident needs contiguous operands")
    e, _, ncol = q_lane.shape
    out = torch.empty_like(q_lane)
    args = (L, l2, w, q_lane, out, e, ncol, nsteps)
    if q_lane.dtype == torch.float32:
        build.launch(dss_resident, nsteps, "dss_resident",
                     "cdk_dss_resident_f32", q_lane.device, *args,
                     int(precision == "bf16x3"), int(sq))
    else:
        build.launch(dss_resident, nsteps, "dss_resident",
                     "cdk_dss_resident_f64", q_lane.device, *args, int(sq))
    return out


@counted
def dss_resident_window(L_ext: torch.Tensor, w_ext: torch.Tensor,
                        hl: torch.Tensor, q_lane: torch.Tensor,
                        hr: torch.Tensor, nsteps: int,
                        precision: str = "highest",
                        L2_ext: torch.Tensor | None = None,
                        out: torch.Tensor | None = None) -> torch.Tensor:
    """nsteps chained steps on one shard of a decomposed ring, its owned
    block q_lane (e, 16, ncol) between the strips hl and hr (h >= 1
    elements each, nsteps <= h); operators and weights are those of the
    extended block (e+2h, ...).  -> the owned block, written into `out` (an
    (e, 16, ncol) tensor) where one is given.  CUDA tensors launch the
    kernel (never anything else); CPU tensors run
    dss_resident_window_plain."""
    h, e = hl.shape[0], q_lane.shape[0]
    validate(L_ext, w_ext, q_lane, nsteps, precision, L2_ext, n_ops=e + 2 * h)
    if h < 1 or hr.shape != hl.shape or hl.shape[1:] != q_lane.shape[1:]:
        raise ValueError(f"want strips hl, hr (h,{NPTS},ncol), h >= 1, beside "
                         f"q_lane (e,{NPTS},ncol); got {tuple(hl.shape)}, "
                         f"{tuple(hr.shape)}, {tuple(q_lane.shape)}")
    if nsteps > h:
        raise ValueError(f"nsteps={nsteps} exceeds the strips' {h} elements")
    if any(t.dtype != q_lane.dtype or t.device != q_lane.device for t in (hl, hr)):
        raise ValueError("hl, q_lane and hr must share a dtype and a device")
    if q_lane.device.type == "cpu":
        res = dss_resident_window_plain(L_ext, w_ext, hl, q_lane, hr, nsteps,
                                        precision, L2_ext)
        return res if out is None else out.copy_(res)
    sq = L2_ext is not None
    l2 = L2_ext if sq else L_ext
    if not all(t.is_contiguous() for t in (L_ext, l2, w_ext, hl, q_lane, hr)):
        raise ValueError("dss_resident_window needs contiguous operands")
    if out is None:
        out = torch.empty_like(q_lane)
    elif (out.shape != q_lane.shape or out.dtype != q_lane.dtype
          or out.device != q_lane.device or not out.is_contiguous()):
        raise ValueError("out must be a contiguous tensor like q_lane")
    args = (L_ext, l2, w_ext, hl, q_lane, hr, out, e, h, q_lane.shape[2], nsteps)
    if q_lane.dtype == torch.float32:
        build.launch(dss_resident_window, nsteps, "dss_resident_window",
                     "cdk_dss_resident_window_f32", q_lane.device, *args,
                     int(precision == "bf16x3"), int(sq))
    else:
        build.launch(dss_resident_window, nsteps, "dss_resident_window",
                     "cdk_dss_resident_window_f64", q_lane.device, *args,
                     int(sq))
    return out


def _dss_resident_forms(cfg, precision: str, precomposed: bool = False):
    rr = rrearth_as(cfg)

    def prepare(data: BiharmonicData):
        L = build_element_operator(data.dvv, data.dinv, data.spheremp,
                                   data.tensorvisc, rr)
        w = dss_weights(data.spheremp).reshape(cfg.nelemd, NPTS).contiguous()
        return L, w, precompose_operator(L) if precomposed else None

    def run(aux, data: BiharmonicData, n: int) -> torch.Tensor:
        """n steps: launches of DEPTH steps, then the remainder; the
        layout changes once at each end."""
        L, w, L2 = aux
        q = to_lane_layout(data.qtens)
        while n > 0:
            k = min(DEPTH, n)
            q = dss_resident(L, w, q, k, precision, L2)
            n -= k
        return from_lane_layout(q, cfg)

    return element_forms(prepare, run)


@register(
    "biharmonic_dss",
    "fused_operator_bd8_resident",
    "resident DSS chain: k full steps (apply-DSS-apply) in one kernel over "
    "deep-halo element-ring windows, the state in registers; device memory "
    "once per k steps (exact products)",
)
def make_dss_bd8_resident(cfg):
    return _dss_resident_forms(cfg, "highest")


@register(
    "biharmonic_dss",
    "fused_operator_bd8_resident_x3",
    "resident DSS chain with 3-pass bf16 hi/lo products accumulated in f32",
    supports_f64=False,
    verify_tol=5e-5,
)
def make_dss_bd8_resident_x3(cfg):
    return _dss_resident_forms(cfg, "bf16x3")


@register(
    "biharmonic_dss",
    "fused_operator_bd8_resident_sq",
    "d-carry resident DSS chain with the precomposed squared operator: "
    "(A·DSS·A)^n = A·DSS·(A²·DSS)^(n-1)·A, k+1 applications per k-step "
    "launch instead of 2k (exact products)",
)
def make_dss_bd8_resident_sq(cfg):
    return _dss_resident_forms(cfg, "highest", precomposed=True)


@register(
    "biharmonic_dss",
    "fused_operator_bd8_resident_sq_x3",
    "precomposed-A² d-carry resident DSS chain with 3-pass bf16 hi/lo "
    "products (the production champion's form)",
    supports_f64=False,
    verify_tol=5e-5,
)
def make_dss_bd8_resident_sq_x3(cfg):
    return _dss_resident_forms(cfg, "bf16x3", precomposed=True)
