"""Per-element 16x16 weak-Laplacian operator.

For fixed element matrices (Dvv, Dinv, spheremp, tensorVisc),
`laplace_sphere_wk` is a linear map on the 16 GLL points of a level, so

    qtens[e, :, col] = L[e] @ qtens[e, :, col],   L[e] ∈ R^{16×16}

and L[e] is built once by probing the trusted reference with the 16
identity basis fields (exact, since the operator is linear).  A form's
set-up from the element fields (L, the DSS weights, A²) is built once per
set of them: `reuse_prepare` keeps the last one while dvv, dinv, spheremp
and tensorvisc are the same tensors, written by nothing since.

The JAX package also groups eight operators into (128, 128)
block-diagonal tiles (`blockdiag_group_operator`) only to fill the TPU's
matrix unit; the Hopper kernel takes the per-element operators as they
are, so that grouping is not ported, and the `fused_operator_bd8` forms
here apply the per-element operators, as K1 does.

`apply_operator` is the batched product under the JAX package's precision
names; every plain version of the biharmonic kernels is built from it.
The variants registered here are the JAX package's XLA forms: plain
PyTorch products (`torch.bmm`, one dense `torch.matmul` for
`fused_operator_bd`), with no kernel of their own.
"""

from __future__ import annotations

import torch

from cdk_torch.core.platform import exact_fp32
from cdk_torch.core.registry import (
    UnsupportedConfigError,
    forms,
    keep_last,
    register,
)
from cdk_torch.core.trace import count, span
from cdk_torch.kernels.biharmonic.problem import (
    BiharmonicData,
    from_lane_layout,
    to_lane_layout,
)
from cdk_torch.kernels.biharmonic.reference import laplace_sphere_wk, rrearth_as


def build_element_operator(dvv, dinv, spheremp, tensorvisc,
                           rrearth) -> torch.Tensor:
    """L: (nelemd, npts, npts) with out_flat = L[e] @ s_flat (C-order
    points p = i*np + j)."""
    count("operator_builds")
    n = dvv.shape[0]
    npts = n * n
    with span("cdk.prepare"):
        basis = torch.eye(npts, dtype=dvv.dtype, device=dvv.device).reshape(
            npts, n, n)
        # out[e, b] = laplace of basis field b under element e's fields
        out = laplace_sphere_wk(basis[None], dvv, dinv[:, None],
                                spheremp[:, None], tensorvisc[:, None], rrearth)
        # L[e, p_out, p_in] = out[e, p_in] at flattened p_out
        return out.reshape(-1, npts, npts).transpose(1, 2).contiguous()


ELEMENT_FIELDS = ("dvv", "dinv", "spheremp", "tensorvisc")


def reuse_prepare(prepare):
    """`prepare(data)`, a form's set-up from the element fields (L, the
    DSS weights, A²), kept (`registry.keep_last`) while dvv, dinv,
    spheremp and tensorvisc are the tensors of the last build, none
    written since; a kept result counts `prepare_reuses`.  qtens is never
    read: the result is a constant of the grid, and every output is
    computed from the call's tracers."""
    return keep_last(
        prepare, lambda data: ([getattr(data, f) for f in ELEMENT_FIELDS], ()),
        "prepare_reuses")


def element_forms(prepare, run) -> dict:
    """`registry.forms(prepare, run)` for a HOMME loop whose set-up
    `prepare(data)` is built from the element fields alone: the set-up is
    kept by `reuse_prepare` while they are unchanged."""
    return forms(reuse_prepare(prepare), run)


PRECISIONS = ("highest", "high", "default")


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to the nearest bf16 value, kept in x's dtype."""
    return x.to(torch.bfloat16).to(x.dtype)


def apply_operator(L: torch.Tensor, q_lane: torch.Tensor,
                   precision: str | None = "high") -> torch.Tensor:
    """q_lane: (e, npts, ncol) -> L[e] @ q_lane[e], batched (the JAX
    package's `operator.apply_operator`), under its precision names:

      "highest"  exact products (f32 with TF32 off, `exact_fp32`)
      "high"     bf16x3: L_hi·q_hi + L_hi·q_lo + L_lo·q_hi from bf16 hi/lo
                 splits (exact products, f32 sums), as the TPU's 3-pass dot
      "default"  one pass of bf16-rounded operands, f32 sums

    float64 (or precision None) is always the exact product."""
    exact_fp32()
    if q_lane.dtype == torch.float64 or precision in (None, "highest"):
        return torch.bmm(L, q_lane)
    if precision == "high":
        L_hi = bf16_round(L)
        L_lo = bf16_round(L - L_hi)
        q_hi = bf16_round(q_lane)
        q_lo = bf16_round(q_lane - q_hi)
        return (torch.bmm(L_hi, q_hi) + torch.bmm(L_hi, q_lo)) + torch.bmm(L_lo, q_hi)
    if precision == "default":
        return torch.bmm(bf16_round(L), bf16_round(q_lane))
    raise ValueError(f"precision {precision!r} not in {PRECISIONS} or None")


def precompose_operator(L: torch.Tensor) -> torch.Tensor:
    """The per-element square A² = L[e] @ L[e], exact (TF32 off), formed
    once at prepare for the precomposed chains (the JAX package's
    `precompose_operator`, a 'highest' einsum)."""
    exact_fp32()
    with span("cdk.prepare"):
        return torch.bmm(L, L)


def blockdiag_operator(L: torch.Tensor) -> torch.Tensor:
    """The per-element operators as one dense block-diagonal
    (e*npts, e*npts) matrix (the JAX package's `blockdiag_operator`)."""
    return torch.block_diag(*L)


def apply_operator_blockdiag(Lbd: torch.Tensor,
                             q_flat: torch.Tensor) -> torch.Tensor:
    """q_flat: (e*npts, ncol) -> Lbd @ q_flat, one dense exact product."""
    exact_fp32()
    return Lbd @ q_flat


def element_operator(data: BiharmonicData, rr: float) -> torch.Tensor:
    """L of `build_element_operator` for the problem's element fields."""
    return build_element_operator(data.dvv, data.dinv, data.spheremp,
                                  data.tensorvisc, rr)


def _chain(L, data: BiharmonicData, n: int, precision: str, cfg):
    """n applications of L with qtens kept in lane layout (the layout
    changes once at each end, not per step)."""
    q = to_lane_layout(data.qtens)
    for _ in range(n):
        q = apply_operator(L, q, precision)
    return from_lane_layout(q, cfg)


def _fused_operator_forms(cfg, precision: str):
    """step builds L and applies it once (as the JAX step does); loop
    applies L n times, built once per set of element fields
    (`reuse_prepare`)."""
    rr = rrearth_as(cfg)

    @reuse_prepare
    def operator(data: BiharmonicData) -> torch.Tensor:
        return element_operator(data, rr)

    def step(data: BiharmonicData) -> torch.Tensor:
        return _chain(element_operator(data, rr), data, 1, precision, cfg)

    def loop(data: BiharmonicData, n: int) -> torch.Tensor:
        return _chain(operator(data), data, n, precision, cfg)

    return {"step": step, "loop": loop}


@register(
    "biharmonic",
    "fused_operator",
    "per-element 16x16 fused Laplacian matrix applied as one batched "
    "product over the fused (qsize*nlev) column batch, bf16x3 ('high') "
    "products (fusion of the reference push-loop, "
    "biharmonic_wk_kernel.F90:369-536)",
)
def make_fused_operator(cfg):
    return _fused_operator_forms(cfg, "high")


@register(
    "biharmonic",
    "fused_operator_bd",
    "block-diagonal dense assembly of the per-element operators: the whole "
    "timestep is ONE (e*16, e*16) x (e*16, ncol) product",
)
def make_fused_operator_bd(cfg):
    rr = rrearth_as(cfg)
    e, npts, ncol = cfg.nelemd, cfg.npts, cfg.ncol
    # the dense operator is (e*16)^2: a demonstration form for miniapp
    # sizes only (the JAX package's 2 GiB guard)
    if (e * npts) ** 2 * 4 > 2 * 2**30:
        raise UnsupportedConfigError(
            f"fused_operator_bd: dense operator would be "
            f"{(e * npts) ** 2 * 4 / 2**30:.1f} GiB; use fused_operator")

    def step(data: BiharmonicData) -> torch.Tensor:
        q_flat = to_lane_layout(data.qtens).reshape(e * npts, ncol)
        out = apply_operator_blockdiag(
            blockdiag_operator(element_operator(data, rr)), q_flat)
        return from_lane_layout(out.reshape(e, npts, ncol), cfg)

    return step


@register(
    "biharmonic",
    "fused_operator_bf16",
    "fused-operator product in single bf16 passes ('default'): the "
    "explicit speed point of the precision/throughput trade (use "
    "fused_operator for verification-grade f32)",
    supports_f64=False,
    fast_math=True,
)
def make_fused_operator_bf16(cfg):
    return _fused_operator_forms(cfg, "default")


def _bd8_forms(cfg, precision: str):
    """prepare builds L (untimed, reused while the element fields are
    unchanged); the JAX package's 8-element
    block-diagonal grouping is a TPU tiling, so the per-element operators
    are applied as they are."""
    rr = rrearth_as(cfg)
    return element_forms(lambda data: (element_operator(data, rr),),
                         lambda aux, data, n: _chain(aux[0], data, n,
                                                     precision, cfg))


@register(
    "biharmonic",
    "fused_operator_bd8",
    "prebuilt per-element operators applied as one batched bf16x3 product "
    "(the JAX form's 8-element (128,128) tiles are a TPU tiling and are "
    "not ported)",
)
def make_fused_operator_bd8(cfg):
    return _bd8_forms(cfg, "high")


@register(
    "biharmonic",
    "fused_operator_bd8_bf16",
    "prebuilt per-element operators applied in single bf16 passes: the "
    "JAX package's recorded design point",
    supports_f64=False,
    fast_math=True,
    experimental=True,
)
def make_fused_operator_bd8_bf16(cfg):
    return _bd8_forms(cfg, "default")
