"""K15-K18: the t-carry rowchain of the torus-DSS biharmonic, carrying
t = jpass(A q) between steps:

    t_0     = jpass(A q)                    rowchain_bridge_in   (K15)
    t_{m+1} = jpass(F(ipass(t_m)·w))        rowchain_step        (K16; depth k: K18)
    q_N     = A(ipass(t_{N-1})·w)           rowchain_bridge_out  (K17)

F is A·A, or one application of the precomposed A² (`_sq` forms).
Replaces cdk_tpu/kernels/biharmonic/pallas_dss2d_resident.py::
_rowchain_bridge_in_kernel, _rowchain_step_kernel,
_rowchain_bridge_out_kernel and _rowchain_stepk_blocked_kernel, under the
same variant names (`fused_operator_rowchain`, `_x3`, `_sq`, `_sq_x3`).
The x3 forms split the operator they apply into bf16 hi/lo parts: A in the
bridges, A² (or A) in the step.

The CUDA kernel is csrc/biharmonic_dss2d_rowchain.cu's step_kernel, a warp
per element of a row tile, in three modes: the step computes each
element's F once per tile and exchanges the j boundary points; bridge-in
applies A once and exchanges them the same way; bridge-out applies A once
to ipass(t)·w and exchanges nothing.  Their bf16x3 forms run on the tensor
cores (mma.sync), which sum a product's terms in their own order, so they
match the plain version within the registered 5e-5, not bit for bit, and
still equal each other (depth k and k depth-1 launches, the padded mode)
bit for bit.  Beside them here:
the plain PyTorch version of each (the CPU path, and what the kernels are
compared with on the card) and the three wrappers, each with a launch
counter; `rowchain_step.depth_launches` also counts the step's launches by
depth.  `rowchain_bridge_in` takes q in either layout and chooses the
kernel's load from its shape: a 3-D (e, 16, ncol) tensor is the lane
layout, a contiguous 5-D (e, q, k, 4, 4) tensor the state's own layout,
which the kernel reads where it lies (`count("natural_loads")`); t is the
lane layout either way, as the step and bridge-out carry it.  `step` is
bridge-in then bridge-out; `loop(data, n)` is bridge-in,
n-1 t-steps in launches of `loop_depth` steps and one for the remainder,
then bridge-out.  The TPU's window geometry, VMEM budgets, the ±13/±12-row
shift masks and the `CDK_DSS2D*`/`CDK_ROWCHAIN_KMAX` hooks are not ported.

The kernels' padded mode runs them on one shard of a row-decomposed torus
(`dist/biharmonic.py`): ex owned element rows, the t input padded by p rows
exchanged from each neighbour shard, the i-neighbours the rows beside (no
wrap).  It replaces the JAX dist entry points `step_t_padded` and
`bridge_out_padded` (`_padded_call`) and `stepk_padded_factory`:
`rowchain_step_padded` at depth 1 (K16p) and deeper (K18p: p = depth,
operators and weights padded by depth - 1 rows, each step one row fewer on
each side, bit for bit that many K16p launches on shrinking windows) and
`rowchain_bridge_out_padded` (K17p), each with its counter.  K15 reads no
neighbour row and runs on a shard's rows as it is.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from cdk_torch.core import build
from cdk_torch.core.registry import register
from cdk_torch.core.trace import count, counted
from cdk_torch.kernels.biharmonic.dss2d import (
    _edge_pair_sum,
    dss2d_weights,
    torus_shape,
)
from cdk_torch.kernels.biharmonic.operator import (
    apply_operator,
    build_element_operator,
    precompose_operator,
    reuse_prepare,
)
from cdk_torch.kernels.biharmonic.problem import (
    BiharmonicData,
    from_lane_layout,
    lane_of,
    lane_shape,
)
from cdk_torch.kernels.biharmonic.reference import rrearth_as

NPG = 4
NPTS = NPG * NPG
PRECISIONS = ("highest", "bf16x3")
# t-steps per step launch in `loop`, from chip_smoke.py's depth sweep at
# production f32 on the H100 (PERF.md §6), us per step at depth 1 / 2 / 3 /
# 4 / 8:
#   A·A      347.8 / 348.9 / 348.2 / 348.5 / 347.9
#   x3       271.3 / 270.1 / 269.6 / 269.2 / 268.5
#   sq       273.8 / 274.1 / 274.3 / 272.4 / 271.4
#   sq_x3    253.8 / 252.3 / 251.8 / 250.8 / 250.1
# flat: every step passes through device memory, so the depth saves only
# launches; depth 4 is within 0.5 % of the fastest for every form
DEPTH = 4


def loop_depth(precision: str, precomposed: bool) -> int:
    """The step depth `loop` launches with for a form: DEPTH for every
    form."""
    return DEPTH


BRIDGE_IN, STEP, BRIDGE_OUT = 0, 1, 2  # the kernels' modes
# the step kernel's tile at f32: this many elements of one element row,
# plus one halo element on each side (step_elems in the CUDA source; 8 at
# f64)
STEP_ELEMS = 24


def _prec(precision: str) -> str:
    return "high" if precision == "bf16x3" else "highest"


def _jpass(s: torch.Tensor, ex: int, ey: int) -> torch.Tensor:
    """j-direction edge sum of a lane-layout (e, 16, ncol) field."""
    e, npts, ncol = s.shape
    return _edge_pair_sum(s.reshape(ex, ey, NPG, NPG, ncol), 1, 3).reshape(
        e, npts, ncol)


def _ipass_w(t: torch.Tensor, w: torch.Tensor, ex: int, ey: int) -> torch.Tensor:
    """i-direction edge sum of the j-summed field, times the inverse mass
    w (e, 16)."""
    e, npts, ncol = t.shape
    summed = _edge_pair_sum(t.reshape(ex, ey, NPG, NPG, ncol), 0, 2)
    return summed.reshape(e, npts, ncol) * w[..., None]


def rowchain_bridge_in_plain(L, q_lane, ex, ey, precision="highest"):
    """q_lane (e, 16, ncol), or the state's own (e, q, k, 4, 4), turned
    first."""
    return _jpass(apply_operator(L, lane_of(q_lane), _prec(precision)), ex, ey)


def rowchain_step_plain(F, w, t, ex, ey, nsteps=1, precision="highest",
                        squared=False):
    """nsteps t-steps; F is A (applied twice) or, with squared, A²."""
    prec = _prec(precision)
    for _ in range(nsteps):
        u = apply_operator(F, _ipass_w(t, w, ex, ey), prec)
        if not squared:
            u = apply_operator(F, u, prec)
        t = _jpass(u, ex, ey)
    return t


def rowchain_bridge_out_plain(L, w, t, ex, ey, precision="highest"):
    return apply_operator(L, _ipass_w(t, w, ex, ey), _prec(precision))


def _ipass_w_padded(tp: torch.Tensor, w: torch.Tensor, ex: int,
                    ey: int) -> torch.Tensor:
    """_ipass_w of the ex inner rows of a t padded by one row on each side
    ((ex+2)*ey elements): the i-neighbours are the rows beside, no wrap."""
    ncol = tp.shape[2]
    t6 = tp.reshape(ex + 2, ey, NPG, NPG, ncol)
    c = t6[1:-1]
    summed = torch.cat([(c[:, :, :1] + t6[:-2, :, -1:]), c[:, :, 1:-1],
                        (c[:, :, -1:] + t6[2:, :, :1])], 2)
    return summed.reshape(ex * ey, NPTS, ncol) * w[..., None]


def rowchain_step_padded_plain(F, w, tp, ex, ey, nsteps=1, precision="highest",
                               squared=False):
    """nsteps t-steps of a shard's ex owned rows: tp ((ex+2n)*ey, 16, ncol)
    padded by n = nsteps rows per side, F and w by n - 1; step j computes
    the rows that stay exact, one fewer per side each step.  -> the owned
    rows (ex*ey, 16, ncol)."""
    prec = _prec(precision)
    t = tp
    for j in range(nsteps):
        rows = ex + 2 * (nsteps - 1 - j)  # rows computed by this step
        Fj, wj = F[j * ey:(j + rows) * ey], w[j * ey:(j + rows) * ey]
        u = apply_operator(Fj, _ipass_w_padded(t, wj, rows, ey), prec)
        if not squared:
            u = apply_operator(Fj, u, prec)
        t = _jpass(u, rows, ey)
    return t


def rowchain_bridge_out_padded_plain(L, w, tp, ex, ey, precision="highest"):
    """q = A(ipass(t)·w) on a shard's ex owned rows, tp padded by one row
    per side."""
    return apply_operator(L, _ipass_w_padded(tp, w, ex, ey), _prec(precision))


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.library()
    head = [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
    lib.cdk_rowchain_f32.argtypes = head + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    lib.cdk_rowchain_f64.argtypes = head + [ctypes.c_int] + [ctypes.c_void_p]
    lib.cdk_rowchain_f32.restype = ctypes.c_int
    lib.cdk_rowchain_f64.restype = ctypes.c_int
    return lib


def _check(op, w, x, ex, ey, precision, pad=0, shape=None):
    """pad > 0: the padded mode, x with pad more rows per side and op/w
    with pad - 1.  shape: x's (e, 16, ncol), where x is not that tensor."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r} not in {PRECISIONS}")
    ts = [op, x] + ([] if w is None else [w])
    if x.dtype not in (torch.float32, torch.float64) or any(
            t.dtype != x.dtype for t in ts):
        raise TypeError("operator, w and field must share float32 or float64")
    if precision == "bf16x3" and x.dtype != torch.float32:
        raise TypeError("bf16x3 is a float32 form")
    if any(t.device != x.device for t in ts):
        raise ValueError("operator, w and field must lie on one device")
    e = (ex + 2 * pad) * ey
    eo = (ex + 2 * pad - 2 if pad else ex) * ey
    shape = tuple(x.shape) if shape is None else shape
    if (len(shape) != 3 or shape[:2] != (e, NPTS) or op.shape != (eo, NPTS, NPTS)
            or (w is not None and w.shape != (eo, NPTS))):
        where = f" padded by {pad} rows" if pad else ""
        raise ValueError(f"want an ({ex}x{ey}) torus{where}: operator "
                         f"({eo},{NPTS},{NPTS}), w ({eo},{NPTS}), field "
                         f"({e},{NPTS},ncol); got {tuple(op.shape)}, "
                         f"{tuple(x.shape)}")


def _launch(mode, op, w, x, ex, ey, nsteps, precision, squared, what, pad=0,
            out=None, tmp=None):
    """One launch; w is None for bridge-in, which reads no inverse mass.
    pad > 0 is the padded mode on ex owned rows, x padded by pad rows per
    side; `out` (allocated where None) then has ex rows or x's shape."""
    if not all(t is None or t.is_contiguous() for t in (op, w, x, out, tmp)):
        raise ValueError(f"{what} needs contiguous operands")
    if any(t is not None and t.data_ptr() % 16 for t in (op, w)):
        raise ValueError(f"{what} copies the operator and w in 16-byte pieces: "
                         "they must start 16-byte aligned")
    natural = x.dim() == 5
    if natural and x.data_ptr() % 16:
        raise ValueError(f"{what} copies the state's own layout in 16-byte "
                         "pieces: it must start 16-byte aligned")
    ncol = lane_shape(x)[2]
    if out is None:
        out = torch.empty((ex * ey, NPTS, ncol), dtype=x.dtype, device=x.device)
    if tmp is None and nsteps > 1:
        tmp = torch.empty_like(x)
    out_pad = int(pad > 0 and out.shape[0] == x.shape[0])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        args = (mode, op.data_ptr(), None if w is None else w.data_ptr(),
                x.data_ptr(), out.data_ptr(),
                None if tmp is None else tmp.data_ptr(), ex, ey, ncol, nsteps,
                pad, out_pad, int(natural))
        if x.dtype == torch.float32:
            err = _lib().cdk_rowchain_f32(*args, int(precision == "bf16x3"),
                                          int(squared), stream)
        else:
            err = _lib().cdk_rowchain_f64(*args, int(squared), stream)
    build.check(err, what)
    return out


@counted
def rowchain_bridge_in(L, q_lane, ex, ey, precision="highest"):
    """t_0 = jpass(A q), q (e, 16, ncol) or the state's own contiguous (e,
    q, k, 4, 4), which the kernel reads where it lies; -> t_0 (e, 16,
    ncol).  CUDA tensors launch the kernel (never anything else); CPU
    tensors run the plain version."""
    _check(L, None, q_lane, ex, ey, precision, shape=lane_shape(q_lane))
    if q_lane.dim() == 5:
        count("natural_loads")
    if q_lane.device.type == "cpu":
        return rowchain_bridge_in_plain(L, q_lane, ex, ey, precision)
    out = _launch(BRIDGE_IN, L, None, q_lane, ex, ey, 1, precision, False,
                  "rowchain_bridge_in")
    rowchain_bridge_in.launches += 1
    rowchain_bridge_in.steps += 1
    return out


@counted
def rowchain_step(F, w, t, ex, ey, nsteps=1, precision="highest",
                  squared=False):
    """nsteps chained t-steps in one launch (depth nsteps >= 1)."""
    _check(F, w, t, ex, ey, precision)
    if nsteps < 1:
        raise ValueError(f"nsteps must be >= 1 (got {nsteps})")
    if t.device.type == "cpu":
        return rowchain_step_plain(F, w, t, ex, ey, nsteps, precision, squared)
    out = _launch(STEP, F, w, t, ex, ey, nsteps, precision, squared,
                  "rowchain_step")
    rowchain_step.launches += 1
    rowchain_step.steps += nsteps
    rowchain_step.depth_launches[nsteps] = (
        rowchain_step.depth_launches.get(nsteps, 0) + 1)
    return out


@counted
def rowchain_bridge_out(L, w, t, ex, ey, precision="highest"):
    """q = A(ipass(t)·w)."""
    _check(L, w, t, ex, ey, precision)
    if t.device.type == "cpu":
        return rowchain_bridge_out_plain(L, w, t, ex, ey, precision)
    out = _launch(BRIDGE_OUT, L, w, t, ex, ey, 1, precision, False,
                  "rowchain_bridge_out")
    rowchain_bridge_out.launches += 1
    rowchain_bridge_out.steps += 1
    return out


@counted
def rowchain_step_padded(F, w, tp, ex, ey, nsteps=1, precision="highest",
                         squared=False, padded_out=False, out=None, tmp=None):
    """nsteps chained t-steps of a shard's ex owned rows in one launch (K16p
    at depth 1, K18p deeper), tp padded by nsteps rows per side, F and w by
    nsteps - 1 (rowchain_step_padded_plain).  -> the owned rows: as
    (ex*ey, 16, ncol), or with padded_out (needed for nsteps > 1) at their
    rows of a tensor shaped like tp whose other rows are scratch (a deeper
    launch's earlier steps write some of them).  out/tmp: buffers to write
    into (tp's shape for tmp; the kernel writes every row of them before it
    reads it).  CUDA tensors launch the kernel (never anything else); CPU
    tensors run the plain version."""
    if nsteps < 1:
        raise ValueError(f"nsteps must be >= 1 (got {nsteps})")
    _check(F, w, tp, ex, ey, precision, pad=nsteps)
    if nsteps > 1 and not padded_out:
        raise ValueError("a deeper padded step writes the padded shape "
                         "(padded_out=True)")
    shape = tp.shape if padded_out else (ex * ey, *tp.shape[1:])
    if out is not None and (out.shape != shape or out.dtype != tp.dtype
                            or out.device != tp.device):
        raise ValueError(f"out must be {tuple(shape)} {tp.dtype} on {tp.device}")
    if tmp is not None and (tmp.shape != tp.shape or tmp.dtype != tp.dtype
                            or tmp.device != tp.device):
        raise ValueError("tmp must be shaped like tp")
    lo = nsteps * ey if padded_out else 0
    if tp.device.type == "cpu":
        t = rowchain_step_padded_plain(F, w, tp, ex, ey, nsteps, precision,
                                       squared)
        if out is None:
            if not padded_out:
                return t
            out = torch.zeros_like(tp)
        out[lo:lo + ex * ey] = t
        return out
    out = _launch(STEP, F, w, tp, ex, ey, nsteps, precision, squared,
                  "rowchain_step_padded", pad=nsteps,
                  out=torch.empty(shape, dtype=tp.dtype, device=tp.device)
                  if out is None else out, tmp=tmp)
    rowchain_step_padded.launches += 1
    rowchain_step_padded.steps += nsteps
    rowchain_step_padded.depth_launches[nsteps] = (
        rowchain_step_padded.depth_launches.get(nsteps, 0) + 1)
    return out


@counted
def rowchain_bridge_out_padded(L, w, tp, ex, ey, precision="highest"):
    """q = A(ipass(t)·w) of a shard's ex owned rows, tp padded by one row
    per side (K17p)."""
    _check(L, w, tp, ex, ey, precision, pad=1)
    if tp.device.type == "cpu":
        return rowchain_bridge_out_padded_plain(L, w, tp, ex, ey, precision)
    out = _launch(BRIDGE_OUT, L, w, tp, ex, ey, 1, precision, False,
                  "rowchain_bridge_out_padded", pad=1)
    rowchain_bridge_out_padded.launches += 1
    rowchain_bridge_out_padded.steps += 1
    return out


# the step's launches by depth, beside its `launches` and `steps`
rowchain_step.depth_launches = {}
rowchain_step_padded.depth_launches = {}


def _rowchain_forms(cfg, precision: str, precomposed: bool = False):
    rr = rrearth_as(cfg)
    ex, ey = torus_shape(cfg.nelemd)
    depth = loop_depth(precision, precomposed)

    @reuse_prepare
    def prepare(data: BiharmonicData):
        L = build_element_operator(data.dvv, data.dinv, data.spheremp,
                                   data.tensorvisc, rr)
        w = dss2d_weights(data.spheremp, ex, ey).reshape(cfg.nelemd, NPTS)
        return L, w.contiguous(), precompose_operator(L) if precomposed else L

    def step(aux, data: BiharmonicData) -> torch.Tensor:
        L, w, _ = aux
        # K15 reads the state where it lies (no lane copy)
        t = rowchain_bridge_in(L, data.qtens.contiguous(), ex, ey, precision)
        return from_lane_layout(
            rowchain_bridge_out(L, w, t, ex, ey, precision), cfg)

    def loop(data: BiharmonicData, n: int) -> torch.Tensor:
        """bridge-in, n-1 t-steps (launches of `depth`, then the
        remainder), bridge-out: n steps for n >= 1."""
        if n < 1:
            raise ValueError(f"the rowchain loop takes n >= 1 steps (got {n})")
        L, w, F = prepare(data)
        t = rowchain_bridge_in(L, data.qtens.contiguous(), ex, ey, precision)
        nt = n - 1
        while nt > 0:
            k = min(depth, nt)
            t = rowchain_step(F, w, t, ex, ey, k, precision, precomposed)
            nt -= k
        return from_lane_layout(
            rowchain_bridge_out(L, w, t, ex, ey, precision), cfg)

    return {"prepare": prepare, "step": step, "loop": loop}


@register(
    "biharmonic_dss2d",
    "fused_operator_rowchain",
    "t-carry rowchain: carry the j-assembled first-application output "
    "between steps, so each step kernel reads only its element row and the "
    "two rows beside it (exact products)",
)
def make_dss2d_rowchain(cfg):
    return _rowchain_forms(cfg, "highest")


@register(
    "biharmonic_dss2d",
    "fused_operator_rowchain_x3",
    "t-carry rowchain with 3-pass bf16 hi/lo products accumulated in f32",
    supports_f64=False,
    verify_tol=5e-5,
)
def make_dss2d_rowchain_x3(cfg):
    return _rowchain_forms(cfg, "bf16x3")


@register(
    "biharmonic_dss2d",
    "fused_operator_rowchain_sq",
    "rowchain with the precomposed squared operator: the t-step's two "
    "adjacent applications (t' = jp(A(A(ip(t)w)))) become one application "
    "of A² (formed once at prepare; exact products)",
)
def make_dss2d_rowchain_sq(cfg):
    return _rowchain_forms(cfg, "highest", precomposed=True)


@register(
    "biharmonic_dss2d",
    "fused_operator_rowchain_sq_x3",
    "precomposed-A² rowchain with 3-pass bf16 hi/lo products (the "
    "production champion's form)",
    supports_f64=False,
    verify_tol=5e-5,
)
def make_dss2d_rowchain_sq_x3(cfg):
    return _rowchain_forms(cfg, "bf16x3", precomposed=True)
