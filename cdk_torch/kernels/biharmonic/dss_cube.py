"""biharmonic_dss_cube: the two-application biharmonic with the DSS over
HOMME's cubed sphere (`cube.py`: 6 faces of ne x ne elements, nelemd =
6 * ne^2, valence-3 vertices at the 8 cube corners, rotated and reversed
seams between faces):

    step(q) = laplace_wk( dss_cube( laplace_wk(q) ) · W ),  W = 1 / dss_cube(spheremp)

dss_cube sums every shared GLL point over its sharers, as the assembly map
lists them (`cube.assembly_map`, in its slot order).  The JAX package has no
such family: its DSS families lay the elements out as a ring or a torus
(cdk_tpu/kernels/biharmonic/dss2d.py:1-23 calls the torus a stand-in for
the cube).

Variants:
  reference_jnp              the trusted plain form, as the other families'
  fused_operator_cube_sq_x3  K26 (csrc/biharmonic_dss_cube.cu): K1's apply
                             of A from the state where it lies (bridge-in),
                             then one K26 launch a step, each assembling the
                             boundary points, scaling by W and applying A²
                             (A in the last step), bf16x3 on the tensor
                             cores; one pass of the state a launch

K26 sums the sharers in the map's slot order, as its plain version does;
its products run on the tensor cores (mma.sync), which sum a product's
terms in their own order, so it meets its plain version within the
registered 5e-5, not bit for bit.  Beside it here: `dss_cube_step_plain`
(the CPU path, and what the kernel is compared with on the card) and the
wrapper `dss_cube_step`, which counts `cube_state_passes` (one a call, on
either device); the loop counts the bridge-in's pass too, so a 6-step
interval counts 7.
"""

from __future__ import annotations

import torch

from cdk_torch.core import build
from cdk_torch.core.registry import register
from cdk_torch.core.trace import count, counted
from cdk_torch.kernels.biharmonic import cube
from cdk_torch.kernels.biharmonic.operator import (
    apply_operator,
    build_element_operator,
    element_forms,
    precompose_operator,
)
from cdk_torch.kernels.biharmonic.problem import BiharmonicData, from_lane_layout
from cdk_torch.kernels.biharmonic.reference import laplace_sphere_wk, rrearth_as
from cdk_torch.kernels.biharmonic.resident import bd8_resident

NPTS = cube.NPTS
BOUNDARY = list(cube.BOUNDARY)
NB = len(BOUNDARY)


def dss_cube_sum(s: torch.Tensor, amap: torch.Tensor) -> torch.Tensor:
    """The sum over sharers of s, (nelemd, 16, ...) with the points in
    rows: each boundary point gains its sharers' values in the map's slot
    order."""
    e = s.shape[0]
    rows = s.reshape(e * NPTS, -1)
    b = s[:, BOUNDARY].reshape(e, NB, -1)
    for k in range(cube.SHARERS):
        idx = amap[:, :, k].long()
        got = rows[idx.clamp(min=0)]
        b = b + torch.where((idx >= 0)[..., None], got, torch.zeros_like(got))
    out = s.clone()
    out[:, BOUNDARY] = b.reshape(out[:, BOUNDARY].shape)
    return out


def dss_cube_weights(spheremp: torch.Tensor, amap: torch.Tensor) -> torch.Tensor:
    """W (nelemd, 16): the inverse of the assembled spheremp, points p =
    i*np + j."""
    e = spheremp.shape[0]
    return 1.0 / dss_cube_sum(spheremp.reshape(e, NPTS), amap)


def biharmonic_wk_dss_cube_reference(qtens, dvv, dinv, spheremp, tensorvisc,
                                     rrearth, amap) -> torch.Tensor:
    """laplace → cube DSS → laplace on (e, q, k, i, j) qtens."""
    def bc(a):
        return a[:, None, None]

    def lap(x):
        return laplace_sphere_wk(x, dvv, bc(dinv), bc(spheremp),
                                 bc(tensorvisc), rrearth)

    e, nq, nk, n, _ = qtens.shape
    w = dss_cube_weights(spheremp, amap)
    s = lap(qtens).reshape(e, nq * nk, NPTS).transpose(1, 2)
    s = dss_cube_sum(s, amap) * w[..., None]
    return lap(s.transpose(1, 2).reshape(qtens.shape))


@register(
    "biharmonic_dss_cube",
    "reference_jnp",
    "trusted PyTorch reference: weak Laplacian twice with the cubed-sphere "
    "DSS between (HOMME's assembly over the 6-face cube, 3-sharer cube "
    "corners, rotated face seams)",
)
def make_reference(cfg):
    rr = rrearth_as(cfg)
    cube.cube_ne(cfg.nelemd)

    def step(data: BiharmonicData) -> torch.Tensor:
        amap = cube.build_map(cfg.nelemd, data.qtens.device)
        return biharmonic_wk_dss_cube_reference(
            data.qtens, data.dvv, data.dinv, data.spheremp, data.tensorvisc,
            rr, amap)

    return step


def dss_cube_step_plain(op: torch.Tensor, amap: torch.Tensor, w: torch.Tensor,
                        t: torch.Tensor) -> torch.Tensor:
    """op (e, 16, 16) applied at bf16x3 to W · dss_cube(t), t (e, 16, ncol)
    in the lane layout."""
    return apply_operator(op, dss_cube_sum(t, amap) * w[..., None], "high")


def _check(op, amap, w, t):
    if t.dtype != torch.float32 or op.dtype != t.dtype or w.dtype != t.dtype:
        raise TypeError("K26 is a float32 form: op, w and t must be float32")
    if amap.dtype != torch.int32:
        raise TypeError("the assembly map must be int32")
    if any(x.device != t.device for x in (op, amap, w)):
        raise ValueError("op, map, w and t must lie on one device")
    e = t.shape[0]
    if (t.dim() != 3 or t.shape[1] != NPTS or op.shape != (e, NPTS, NPTS)
            or amap.shape != (e, NB, cube.SHARERS) or w.shape != (e, NPTS)):
        raise ValueError(f"want op ({e},{NPTS},{NPTS}), map ({e},{NB},"
                         f"{cube.SHARERS}), w ({e},{NPTS}), t ({e},{NPTS},ncol); "
                         f"got {tuple(op.shape)}, {tuple(amap.shape)}, "
                         f"{tuple(w.shape)}, {tuple(t.shape)}")


@counted
def dss_cube_step(op: torch.Tensor, amap: torch.Tensor, w: torch.Tensor,
                  t: torch.Tensor) -> torch.Tensor:
    """K26: op applied to W · dss_cube(t), one pass of the state -> a new
    (e, 16, ncol) tensor.  CUDA tensors launch the kernel (never anything
    else); CPU tensors run dss_cube_step_plain."""
    _check(op, amap, w, t)
    count("cube_state_passes")
    if t.device.type == "cpu":
        return dss_cube_step_plain(op, amap, w, t)
    if not all(x.is_contiguous() for x in (op, amap, w, t)):
        raise ValueError("K26 needs contiguous operands")
    out = torch.empty_like(t)
    e, _, ncol = t.shape
    build.launch(dss_cube_step, 1, "dss_cube_step", "cdk_dss_cube_f32",
                 t.device, op, amap, w, t, out, e, ncol)
    return out


def _cube_forms(cfg):
    rr = rrearth_as(cfg)
    cube.cube_ne(cfg.nelemd)

    def prepare(data: BiharmonicData):
        L = build_element_operator(data.dvv, data.dinv, data.spheremp,
                                   data.tensorvisc, rr)
        amap = cube.build_map(cfg.nelemd, data.qtens.device)
        w = dss_cube_weights(data.spheremp, amap).contiguous()
        return L, precompose_operator(L), amap, w

    def run(aux, data: BiharmonicData, n: int) -> torch.Tensor:
        """A from the state where it lies (K1, one pass), then n K26
        steps: A² between two assemblies, A after the last."""
        if n < 1:
            raise ValueError(f"the cube loop takes n >= 1 steps (got {n})")
        L, A2, amap, w = aux
        t = bd8_resident(L, data.qtens.contiguous(), 1, "bf16x3")
        count("cube_state_passes")
        for m in range(n):
            t = dss_cube_step(A2 if m < n - 1 else L, amap, w, t)
        return from_lane_layout(t, cfg)

    return element_forms(prepare, run)


@register(
    "biharmonic_dss_cube",
    "fused_operator_cube_sq_x3",
    "cubed-sphere chain: A from the state where it lies, then one K26 "
    "launch a step that assembles over the cube's map, scales by the "
    "inverse mass and applies A² (A last), 3-pass bf16 hi/lo products",
    supports_f64=False,
    verify_tol=5e-5,
)
def make_cube_sq_x3(cfg):
    return _cube_forms(cfg)
