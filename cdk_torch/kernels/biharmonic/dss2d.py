"""biharmonic_dss2d: the two-application biharmonic with a two-dimensional
element-grid DSS — edges in both GLL directions plus 4-way corner dofs (the
port of ``cdk_tpu.kernels.biharmonic.dss2d``).

TOPOLOGY — a periodic (ex, ey) torus of elements, flattened row-major
e = a*ey + b.  Element (a, b)'s j = np-1 column is element (a, b+1 mod ey)'s
j = 0 column; its i = np-1 row is element (a+1 mod ex, b)'s i = 0 row; each
corner dof is shared by four elements.

DSS — assembled(s)[dof] = Σ_sharers s / Σ_sharers spheremp, as TWO passes:
a j-direction edge sum, then an i-direction edge sum of the already
j-summed field, so the corners collect all four sharers from two
nearest-neighbor passes.

    biharmonic_dss2d(q) = laplace_wk( dss2d( laplace_wk(q) ) )

Variants: the trusted reference and the four fused-operator forms, as in
`dss.py`.  `dss2d_grouped` serves only the TPU's grouped layout and is not
ported.  The rowchain kernels (K15-K18) are in `dss2d_rowchain.py`.
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


def torus_shape(nelemd: int) -> tuple[int, int]:
    """Most-square (ex, ey) factorization with ey <= ex (shipped 16 -> 4x4;
    production 5400 -> 75x72).  Prime counts degenerate to the ring (ey=1)."""
    ey = int(nelemd**0.5)
    while nelemd % ey:
        ey -= 1
    return nelemd // ey, ey


def _edge_pair_sum(s: torch.Tensor, eax: int, gax: int) -> torch.Tensor:
    """One direction's shared-edge sum: along GLL axis `gax`, boundary
    slice 0 gains the `eax`-rolled(+1) neighbor's slice n-1 and slice n-1
    gains the rolled(-1) neighbor's slice 0."""
    n = s.shape[gax]
    lo0 = s.narrow(gax, 0, 1)
    hi0 = s.narrow(gax, n - 1, 1)
    lo = lo0 + torch.roll(hi0, 1, eax)
    hi = hi0 + torch.roll(lo0, -1, eax)
    return torch.cat([lo, s.narrow(gax, 1, n - 2), hi], gax)


def dss2d_sum(s5: torch.Tensor, iax: int = -2, jax_: int = -1) -> torch.Tensor:
    """Σ_sharers over the torus: the j pass, then the i pass of the
    j-summed field.  s5: (ex, ey, ...) with the GLL i/j axes at iax/jax_."""
    return _edge_pair_sum(_edge_pair_sum(s5, 1, jax_), 0, iax)


def dss2d_weights(spheremp: torch.Tensor, ex: int, ey: int) -> torch.Tensor:
    """Inverse assembled mass W (e, np, np): the two-pass sum applied to
    spheremp itself, inverted."""
    n = spheremp.shape[-1]
    with span("cdk.prepare"):
        return (1.0 / dss2d_sum(spheremp.reshape(ex, ey, n, n))).reshape(
            spheremp.shape)


def dss_torus(s: torch.Tensor, w: torch.Tensor, ex: int,
              ey: int) -> torch.Tensor:
    """DSS on (e, ..., i, j) over the torus, projected back with the
    inverse assembled mass w."""
    s5 = s.reshape(ex, ey, *s.shape[1:])
    return dss2d_sum(s5).reshape(s.shape) * w


def biharmonic_wk_dss2d_reference(qtens, dvv, dinv, spheremp, tensorvisc,
                                  rrearth, ex: int, ey: int) -> torch.Tensor:
    """laplace → torus-DSS → laplace on (e, q, k, i, j) qtens."""
    def bc(a):
        return a[:, None, None]

    def lap(x):
        return laplace_sphere_wk(x, dvv, bc(dinv), bc(spheremp),
                                 bc(tensorvisc), rrearth)

    w = bc(dss2d_weights(spheremp, ex, ey))
    return lap(dss_torus(lap(qtens), w, ex, ey))


@register(
    "biharmonic_dss2d",
    "reference_jnp",
    "trusted PyTorch reference: weak Laplacian twice with the 2-D torus DSS "
    "between (edge + 4-way corner assembly; the ring family's topology is "
    "the j-direction subcase)",
)
def make_reference(cfg):
    rr = rrearth_as(cfg)
    ex, ey = torus_shape(cfg.nelemd)

    def step(data: BiharmonicData) -> torch.Tensor:
        return biharmonic_wk_dss2d_reference(
            data.qtens, data.dvv, data.dinv, data.spheremp, data.tensorvisc,
            rr, ex, ey)

    return step


def dss2d_lane(s_lane: torch.Tensor, w_lane: torch.Tensor, ex: int, ey: int,
               npg: int) -> torch.Tensor:
    """Torus DSS in the (e, npts, ncol) lane layout (p = i*np + j).
    w_lane: (e, npts, 1) inverse assembled mass in the same layout."""
    e, npts, ncol = s_lane.shape
    summed = dss2d_sum(s_lane.reshape(ex, ey, npg, npg, ncol), iax=2, jax_=3)
    return summed.reshape(e, npts, ncol) * w_lane


def _fused_dss2d_forms(cfg, precision):
    rr = rrearth_as(cfg)
    npg = cfg.np_gll
    ex, ey = torus_shape(cfg.nelemd)

    def prepare(data: BiharmonicData):
        L = build_element_operator(data.dvv, data.dinv, data.spheremp,
                                   data.tensorvisc, rr)
        w = dss2d_weights(data.spheremp, ex, ey)
        return L, w.reshape(cfg.nelemd, cfg.npts, 1)

    def run(aux, data: BiharmonicData, n: int) -> torch.Tensor:
        """n steps with the state kept in the lane layout."""
        L, w = aux
        q = to_lane_layout(data.qtens)
        for _ in range(n):
            s = dss2d_lane(apply_operator(L, q, precision), w, ex, ey, npg)
            q = apply_operator(L, s, precision)
        return from_lane_layout(q, cfg)

    return element_forms(prepare, run)


@register(
    "biharmonic_dss2d",
    "fused_operator",
    "two per-element 16x16-operator applications with the torus-DSS "
    "assembly between (bf16x3 'high' products; within the f32 gate)",
    verify_tol=5e-5,
)
def make_fused_dss2d(cfg):
    return _fused_dss2d_forms(cfg, "high")


@register(
    "biharmonic_dss2d",
    "fused_operator_f32",
    "fused-operator torus-DSS form at precision 'highest' (exact f32)",
)
def make_fused_dss2d_f32(cfg):
    return _fused_dss2d_forms(cfg, "highest")


@register(
    "biharmonic_dss2d",
    "fused_operator_bf16",
    "fused-operator torus-DSS form with one bf16 pass per product (speed "
    "point)",
    supports_f64=False,
    fast_math=True,
)
def make_fused_dss2d_bf16(cfg):
    return _fused_dss2d_forms(cfg, "default")


@register(
    "biharmonic_dss2d",
    "fused_operator_bd8",
    "the JAX package's grouped block-diagonal form with the assembly in the "
    "grouped layout; here the per-element operators and the lane-layout "
    "assembly at the same bf16x3 'high' precision",
    verify_tol=5e-5,
)
def make_fused_dss2d_bd8(cfg):
    return _fused_dss2d_forms(cfg, "high")
