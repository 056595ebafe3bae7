"""Per-element 16x16 weak-Laplacian operator.

For fixed element matrices (Dvv, Dinv, spheremp, tensorVisc),
`laplace_sphere_wk` is a linear map on the 16 GLL points of a level, so

    qtens[e, :, col] = L[e] @ qtens[e, :, col],   L[e] ∈ R^{16×16}

and L[e] is built once by probing the trusted reference with the 16
identity basis fields (exact, since the operator is linear).

The JAX package also groups eight operators into (128, 128)
block-diagonal tiles (`blockdiag_group_operator`) only to fill the TPU's
matrix unit; the Hopper kernel takes the per-element operators as they
are, so that grouping is not ported.

`apply_operator` is the batched product under the JAX package's precision
names; every plain version of the biharmonic kernels is built from it.
"""

from __future__ import annotations

import torch

from cdk_torch.core.platform import exact_fp32
from cdk_torch.kernels.biharmonic.reference import laplace_sphere_wk


def build_element_operator(dvv, dinv, spheremp, tensorvisc,
                           rrearth) -> torch.Tensor:
    """L: (nelemd, npts, npts) with out_flat = L[e] @ s_flat (C-order
    points p = i*np + j)."""
    n = dvv.shape[0]
    npts = n * n
    basis = torch.eye(npts, dtype=dvv.dtype, device=dvv.device).reshape(
        npts, n, n)
    # out[e, b] = laplace of basis field b under element e's fields
    out = laplace_sphere_wk(basis[None], dvv, dinv[:, None],
                            spheremp[:, None], tensorvisc[:, None], rrearth)
    # L[e, p_out, p_in] = out[e, p_in] at flattened p_out
    return out.reshape(-1, npts, npts).transpose(1, 2).contiguous()


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
    return torch.bmm(L, L)
