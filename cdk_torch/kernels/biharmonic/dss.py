"""biharmonic_dss: the two-application biharmonic with the DSS
element-boundary assembly between the applications (the port of
``cdk_tpu.kernels.biharmonic.dss``).

TOPOLOGY — a periodic 1-D ring of elements along the j GLL axis: element
e's j=np-1 GLL column is the same degree of freedom as element e+1's j=0
column (wrapping at nelemd).

DSS — assembled(s)[dof] = Σ_sharers s / Σ_sharers spheremp; interior dofs
are s / spheremp.  Both sharers compute the identical assembled value.

    biharmonic_dss(q) = laplace_wk( dss( laplace_wk(q) ) )

Variants: the trusted reference, and the fused-operator forms, which apply
the per-element 16x16 operator twice with the lane-layout assembly between
(`fused_operator` "high", `_f32` "highest", `_bf16` "default").
`fused_operator_bd8` is the JAX package's grouped block-diagonal form; the
port has no grouping (`operator.py`), so it applies the per-element
operators at the same "high" precision.  `dss_ring_grouped` exists only
for that TPU layout and is not ported.  The resident chain (K14) is in
`dss_resident.py`.
"""

from __future__ import annotations

import torch

from cdk_torch.core.registry import register
from cdk_torch.core.trace import span
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
from cdk_torch.kernels.biharmonic.reference import laplace_sphere_wk, rrearth_as


def dss_weights(spheremp: torch.Tensor) -> torch.Tensor:
    """Per-dof inverse assembled mass W (e, i, j): 1/spheremp at interior
    points, 1/(spheremp_e + spheremp_neighbor) on the shared j=0 / j=np-1
    columns of the periodic element ring."""
    sp = spheremp
    with span("cdk.prepare"):
        m_r = sp[..., -1] + torch.roll(sp, -1, 0)[..., 0]
        m_l = sp[..., 0] + torch.roll(sp, 1, 0)[..., -1]
        return 1.0 / torch.cat([m_l[..., None], sp[..., 1:-1], m_r[..., None]],
                               -1)


def dss_apply(s, w, left_col, right_col):
    """Assemble with explicit neighbor columns.

    s:         (..., i, j) weak-form contributions
    w:         inverse assembled mass, broadcastable to s
    left_col:  (..., i) — LEFT neighbor's j=np-1 contribution column
    right_col: (..., i) — RIGHT neighbor's j=0 contribution column
    """
    summed = torch.cat([(s[..., 0] + left_col)[..., None], s[..., 1:-1],
                        (s[..., -1] + right_col)[..., None]], -1)
    return summed * w


def dss_ring(s: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """DSS over the periodic element ring (axis 0 of s)."""
    return dss_apply(s, w, torch.roll(s, 1, 0)[..., -1],
                     torch.roll(s, -1, 0)[..., 0])


def biharmonic_wk_dss_reference(qtens, dvv, dinv, spheremp, tensorvisc,
                                rrearth) -> torch.Tensor:
    """laplace → DSS → laplace on (e, q, k, i, j) qtens."""
    def bc(a):
        return a[:, None, None]

    def lap(x):
        return laplace_sphere_wk(x, dvv, bc(dinv), bc(spheremp),
                                 bc(tensorvisc), rrearth)

    return lap(dss_ring(lap(qtens), bc(dss_weights(spheremp))))


@register(
    "biharmonic_dss",
    "reference_jnp",
    "trusted PyTorch reference: weak Laplacian twice with ring-DSS assembly "
    "between (the HOMME structure the miniapp extracts one application of, "
    "biharmonic_wk_kernel.F90:186-200)",
)
def make_reference(cfg):
    rr = rrearth_as(cfg)

    def step(data: BiharmonicData) -> torch.Tensor:
        return biharmonic_wk_dss_reference(
            data.qtens, data.dvv, data.dinv, data.spheremp, data.tensorvisc,
            rr)

    return step


def dss_ring_lane(s_lane: torch.Tensor, w: torch.Tensor,
                  npg: int) -> torch.Tensor:
    """DSS in the (e, npts, ncol) lane layout (p = i*np + j): the j=0 /
    j=np-1 GLL columns are the p % np == 0 / np-1 rows.  w: (e, np, np)
    inverse assembled mass."""
    e, npts, ncol = s_lane.shape
    s4 = s_lane.reshape(e, npg, npg, ncol)
    left = torch.roll(s4[:, :, -1], 1, 0)
    right = torch.roll(s4[:, :, 0], -1, 0)
    summed = torch.cat([(s4[:, :, 0] + left)[:, :, None], s4[:, :, 1:-1],
                        (s4[:, :, -1] + right)[:, :, None]], 2)
    return (summed * w.reshape(e, npg, npg, 1)).reshape(e, npts, ncol)


def dss_line_lane(s_lane: torch.Tensor, w: torch.Tensor,
                  npg: int) -> torch.Tensor:
    """dss_ring_lane with the ring cut open between its last and first
    element: the two end elements assemble with zeros (a shard's window)."""
    e, npts, ncol = s_lane.shape
    s4 = s_lane.reshape(e, npg, npg, ncol)
    z = torch.zeros_like(s4[:1, :, 0])
    left = torch.cat([z, s4[:-1, :, -1]])
    right = torch.cat([s4[1:, :, 0], z])
    summed = torch.cat([(s4[:, :, 0] + left)[:, :, None], s4[:, :, 1:-1],
                        (s4[:, :, -1] + right)[:, :, None]], 2)
    return (summed * w.reshape(e, npg, npg, 1)).reshape(e, npts, ncol)


def _fused_dss_forms(cfg, precision):
    rr = rrearth_as(cfg)
    npg = cfg.np_gll

    def prepare(data: BiharmonicData):
        L = build_element_operator(data.dvv, data.dinv, data.spheremp,
                                   data.tensorvisc, rr)
        return L, dss_weights(data.spheremp)

    def run(aux, data: BiharmonicData, n: int) -> torch.Tensor:
        """n steps with the state kept in the lane layout."""
        L, w = aux
        q = to_lane_layout(data.qtens)
        for _ in range(n):
            s = dss_ring_lane(apply_operator(L, q, precision), w, npg)
            q = apply_operator(L, s, precision)
        return from_lane_layout(q, cfg)

    return element_forms(prepare, run)


@register(
    "biharmonic_dss",
    "fused_operator",
    "two per-element 16x16-operator applications with the lane-layout DSS "
    "assembly between (bf16x3 'high' products; within the f32 gate)",
    verify_tol=5e-5,
)
def make_fused_dss(cfg):
    return _fused_dss_forms(cfg, "high")


@register(
    "biharmonic_dss",
    "fused_operator_f32",
    "fused-operator DSS form at precision 'highest' (exact f32 products)",
)
def make_fused_dss_f32(cfg):
    return _fused_dss_forms(cfg, "highest")


@register(
    "biharmonic_dss",
    "fused_operator_bf16",
    "fused-operator DSS form with one bf16 pass per product (speed point)",
    supports_f64=False,
    fast_math=True,
)
def make_fused_dss_bf16(cfg):
    return _fused_dss_forms(cfg, "default")


@register(
    "biharmonic_dss",
    "fused_operator_bd8",
    "the JAX package's grouped block-diagonal apply form; here the "
    "per-element operators at the same bf16x3 'high' precision (the "
    "grouping only fills the TPU's 128x128 matrix unit)",
    verify_tol=5e-5,
)
def make_fused_dss_bd8(cfg):
    return _fused_dss_forms(cfg, "high")
