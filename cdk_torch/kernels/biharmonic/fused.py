"""K4: the structured biharmonic kernel — one weak Laplacian as its stage
chain (gradient -> Dinv -> tensorVisc -> Dinv·spheremp -> weak
divergence) in one kernel launch, every intermediate on chip.

Replaces cdk_tpu/kernels/biharmonic/pallas_fused.py::_kernel, under the
same variant names (f32 only, as in the JAX package):

  pallas_fused        "highest": exact f32 stage products
  pallas_fused_bf16   "default": each stage product in one bf16 pass (both
                      operands rounded to bf16, f32 sums)

With GLL points flattened C-order p = i*np + j the stage matrices are
A1 = kron(Dvvᵀ, I), A2 = kron(I, Dvvᵀ) (gradient), B1 = kron(Dvv, I),
B2 = kron(I, Dvv) (weak divergence); `stage_matrices` builds them and the
plain version `fused_laplace_plain` runs the chain with `torch.matmul` over
them.  The CUDA kernel (csrc/biharmonic_fused.cu) contracts with Dvv
directly: each matrix row has 4 nonzeros, and the 12 products it skips are
exact zeros.  The TPU kernel's element blocking (kron(I_B, ·) of the stage
matrices, `_eblock`, `_group`) is a matrix-unit tiling and is not ported.
The wrapper `fused_laplace` launches the kernel for CUDA tensors and runs
the plain version for CPU tensors.
"""

from __future__ import annotations

import torch

from cdk_torch.core import build
from cdk_torch.core.platform import exact_fp32
from cdk_torch.core.registry import register
from cdk_torch.core.trace import counted, span
from cdk_torch.kernels.biharmonic.operator import bf16_round, reuse_prepare
from cdk_torch.kernels.biharmonic.problem import (
    BiharmonicData,
    from_lane_layout,
    to_lane_layout,
)
from cdk_torch.kernels.biharmonic.reference import rrearth_as

NPTS = 16
NFIELDS = 9  # d00, d01, d10, d11, spheremp, t00, t01, t10, t11
PRECISIONS = ("highest", "default")


def stage_matrices(dvv: torch.Tensor) -> torch.Tensor:
    """(4, 16, 16) stacked [A1, A2, B1, B2] for the flattened-point
    formulation (the JAX package's `stage_matrices_jnp` at one element)."""
    eye = torch.eye(dvv.shape[0], dtype=dvv.dtype, device=dvv.device)
    dvv_t = dvv.T.contiguous()
    return torch.stack([torch.kron(dvv_t, eye), torch.kron(eye, dvv_t),
                        torch.kron(dvv, eye), torch.kron(eye, dvv)])


def pack_element_fields(dinv, spheremp, tensorvisc) -> torch.Tensor:
    """-> contiguous (nelemd, 9, 16) per-point element fields, points
    flattened C-order to match `stage_matrices`."""
    e = dinv.shape[0]
    rows = [dinv[..., 0, 0], dinv[..., 0, 1], dinv[..., 1, 0], dinv[..., 1, 1],
            spheremp,
            tensorvisc[..., 0, 0], tensorvisc[..., 0, 1],
            tensorvisc[..., 1, 0], tensorvisc[..., 1, 1]]
    return torch.stack([r.reshape(e, NPTS) for r in rows], dim=1).contiguous()


def _stage(a: torch.Tensor, x: torch.Tensor, precision: str) -> torch.Tensor:
    """a (16, 16) @ x (e, 16, ncol), exact or in one bf16 pass."""
    if precision == "default":
        return torch.matmul(bf16_round(a), bf16_round(x))
    return torch.matmul(a, x)


def fused_laplace_plain(dvv: torch.Tensor, elem: torch.Tensor,
                        q_lane: torch.Tensor, rrearth: float,
                        precision: str = "highest") -> torch.Tensor:
    """One weak Laplacian of q_lane (e, 16, ncol) as the stage chain, in
    the JAX kernel's operation order."""
    exact_fp32()
    a1, a2, b1, b2 = stage_matrices(dvv)
    d00, d01, d10, d11, sp, t00, t01, t10, t11 = (
        elem[:, i, :, None] for i in range(NFIELDS))
    v1 = rrearth * _stage(a1, q_lane, precision)
    v2 = rrearth * _stage(a2, q_lane, precision)
    ds1 = d00 * v1 + d10 * v2
    ds2 = d01 * v1 + d11 * v2
    g1 = ds1 * t00 + ds2 * t01
    g2 = ds1 * t10 + ds2 * t11
    x = sp * (d00 * g1 + d01 * g2)
    y = sp * (d10 * g1 + d11 * g2)
    return -rrearth * (_stage(b1, x, precision) + _stage(b2, y, precision))


def _validate(dvv, elem, q_lane, precision):
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r} not in {PRECISIONS}")
    if q_lane.dtype != torch.float32 or {dvv.dtype, elem.dtype} != {torch.float32}:
        raise TypeError(f"fused_laplace is a float32 kernel (got dvv "
                        f"{dvv.dtype}, elem {elem.dtype}, q_lane {q_lane.dtype})")
    if not dvv.device == elem.device == q_lane.device:
        raise ValueError("dvv, elem and q_lane must share a device")
    e = q_lane.shape[0]
    if (q_lane.dim() != 3 or q_lane.shape[1] != NPTS or dvv.shape != (4, 4)
            or elem.shape != (e, NFIELDS, NPTS)):
        raise ValueError(f"want dvv (4,4), elem (e,{NFIELDS},{NPTS}) and "
                         f"q_lane (e,{NPTS},ncol); got {tuple(dvv.shape)}, "
                         f"{tuple(elem.shape)}, {tuple(q_lane.shape)}")


@counted
def fused_laplace(dvv: torch.Tensor, elem: torch.Tensor, q_lane: torch.Tensor,
                  rrearth: float, precision: str = "highest") -> torch.Tensor:
    """One weak Laplacian.  CUDA tensors launch the kernel (never anything
    else); CPU tensors run fused_laplace_plain."""
    _validate(dvv, elem, q_lane, precision)
    if q_lane.device.type == "cpu":
        return fused_laplace_plain(dvv, elem, q_lane, rrearth, precision)
    args = (dvv, elem, q_lane)
    if not all(t.is_contiguous() for t in args):
        raise ValueError("fused_laplace needs contiguous dvv, elem and q_lane")
    e, _, ncol = q_lane.shape
    out = torch.empty_like(q_lane)
    build.launch(fused_laplace, 1, "fused_laplace", "cdk_biharmonic_fused",
                 q_lane.device, *args, out, e, ncol, float(rrearth),
                 int(precision == "default"))
    return out


def _fused_forms(cfg, precision: str):
    rr = rrearth_as(cfg)

    def fields(data: BiharmonicData):
        """dvv and the packed element fields, as the kernel reads them."""
        with span("cdk.prepare"):
            return data.dvv.contiguous(), pack_element_fields(
                data.dinv, data.spheremp, data.tensorvisc)

    reused_fields = reuse_prepare(fields)

    def _run(dvv, elem, qtens, n: int) -> torch.Tensor:
        """n launches (the JAX scan of its kernel); the layout changes once
        per call."""
        q = to_lane_layout(qtens)
        for _ in range(n):
            q = fused_laplace(dvv, elem, q, rr, precision)
        return from_lane_layout(q, cfg)

    def step(data: BiharmonicData) -> torch.Tensor:
        return _run(*fields(data), data.qtens, 1)

    def loop(data: BiharmonicData, n: int) -> torch.Tensor:
        """n launches; the fields packed once per set of element fields."""
        return _run(*reused_fields(data), data.qtens, n)

    return {"step": step, "loop": loop}


@register(
    "biharmonic",
    "pallas_fused",
    "single fused kernel (gradient->visc->divergence) with every "
    "intermediate in registers and exact f32 stage contractions; analog of "
    "the reference GPU push-loop + cache variants",
    supports_f64=False,
)
def make_pallas_fused(cfg):
    return _fused_forms(cfg, "highest")


@register(
    "biharmonic",
    "pallas_fused_bf16",
    "fused kernel with single-pass bf16 stage contractions (operands "
    "rounded to bf16, f32 sums): the speed point",
    supports_f64=False,
    fast_math=True,
)
def make_pallas_fused_bf16(cfg):
    return _fused_forms(cfg, "default")
