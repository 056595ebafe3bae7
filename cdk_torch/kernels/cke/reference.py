"""Trusted PyTorch reference of the CKE nested-loop edge-flux kernel.

Semantics match the reference's original CPU form
(nested_loops/nested.F90:119-157, 495-564), as the JAX package's
`cdk_tpu/kernels/cke/reference.py` states them:

    wgt(k,e)  = normalThicknessFlux(k,e) · advMaskHighOrder(k,e)
    sgn(k,e)  = sign(1, normalThicknessFlux(k,e))      (+1 for ntf ≥ 0)
    flx(k,e)  = Σ_{i=1..nAdv} tracerCur(k, advCellsForEdge(i,e))
                · wgt(k,e) · (advCoefs(i,e) + advCoefs3rd(i,e)
                              · coef3rdOrder · sgn(k,e))

with the tracer masked (`tracer · cellMask`), which equals the k-bound
restriction of the original form because the tracer is zero outside the
active range (:71-83).  The reference gathers all (edge, slot) rows at once
and contracts them; `slot_order_flux` is the slot-by-slot accumulation
(mul, then add, i = 0..nAdv-1, like the Fortran inner loop :533-552) that
the gather champion and the kernels' plain versions share.
"""

from __future__ import annotations

from typing import Iterable

import torch

from cdk_torch.core.platform import exact_fp32
from cdk_torch.core.registry import register
from cdk_torch.kernels.cke.problem import CkeData


def fsign1(x: torch.Tensor) -> torch.Tensor:
    """Fortran sign(1, x): +1 for x ≥ 0 (including ±0), −1 for x < 0.
    (torch.sign would give 0 at 0.)"""
    return torch.where(x >= 0, 1.0, -1.0).to(x.dtype)


def coef3_of(cfg) -> float:
    """coef3rdOrder rounded to the working dtype (a Python float that the
    dtype holds exactly), as the JAX package's `cfg.np_dtype(...)`."""
    return float(torch.tensor(cfg.coef3rdorder, dtype=cfg.torch_dtype))


def finish(s1, s3, ntf, adv_mask, coef3):
    """flx = (ntf·advMask)·(s1 + (C·s3)·sgn), in that order."""
    return ntf * adv_mask * (s1 + coef3 * s3 * fsign1(ntf))


def edge_flux(adv_cells, adv_coefs, adv_coefs3, tracer, cell_mask, ntf,
              adv_mask, coef3rdorder):
    """-> highOrderFlx (nedges, nvert): one gather of every (edge, slot)
    row, then two contractions over the slots."""
    exact_fp32()
    t = tracer * cell_mask
    tg = t[adv_cells.long()]  # (nedges, nadv, nvert) gather along cells
    s1 = torch.einsum("ea,eak->ek", adv_coefs, tg)
    s3 = torch.einsum("ea,eak->ek", adv_coefs3, tg)
    return finish(s1, s3, ntf, adv_mask, coef3rdorder)


def slot_order_flux(slot_rows: Iterable[torch.Tensor], c1, c3, ntf,
                    adv_mask, coef3):
    """The flux from each slot's (nedges, nvert) block of gathered masked
    tracer rows, taken in slot order: s1 += c1_i·rows_i, s3 += c3_i·rows_i
    (a product, then a sum, never fused), then `finish`."""
    s1 = torch.zeros_like(ntf)
    s3 = torch.zeros_like(ntf)
    for i, g in enumerate(slot_rows):
        s1 = s1 + c1[:, i:i + 1] * g
        s3 = s3 + c3[:, i:i + 1] * g
    return finish(s1, s3, ntf, adv_mask, coef3)


def gathered_slots(t: torch.Tensor, adv_cells: torch.Tensor):
    """Slot i's rows t[adv_cells[:, i]], one index_select per slot."""
    for i in range(adv_cells.shape[1]):
        yield torch.index_select(t, 0, adv_cells[:, i])


@register(
    "cke",
    "reference_jnp",
    "trusted PyTorch gather+contraction reference (the JAX package's jnp "
    "reference: original CPU form, nested.F90:119-157)",
)
def make_reference(cfg):
    c3 = coef3_of(cfg)

    def step(data: CkeData) -> torch.Tensor:
        return edge_flux(
            data.adv_cells, data.adv_coefs, data.adv_coefs3, data.tracer,
            data.cell_mask, data.ntf, data.adv_mask, c3,
        )

    return step
