"""Sign-folded single-accumulator CKE gather (the JAX package's
`cdk_tpu/kernels/cke/gather_selfold.py`): one multiply-add per gathered row.

The reference's weight couples a per-(e,i) coefficient pair with the
per-(e,k) sign of ntf, which takes only two values, so the pair collapses
to a precombined pair selected per (e,k):

    cp(e,i) = c1 + C·c3          (used where ntf ≥ 0)
    cm(e,i) = c1 − C·c3          (used where ntf < 0)
    flx(e,k) = ntf·advMask · Σ_i select(ntf ≥ 0, cp_i, cm_i) · T[cells_i]

One running sum instead of two.  It is not the reference's per-term
arithmetic (the two sums are merged before the sign is applied), so it is
held to the family gate, not bitwise.  cp/cm are built once, untimed, in
`prepare` (the reference's untimed staging, nested.F90:400-403).  No kernel
of this package is involved.
"""

from __future__ import annotations

import torch

from cdk_torch.core.registry import register
from cdk_torch.kernels.cke.problem import CkeData
from cdk_torch.kernels.cke.reference import coef3_of, gathered_slots


def edge_flux_selfold(adv_cells, cp, cm, tracer, cell_mask, ntf, adv_mask):
    t = tracer * cell_mask
    pos = ntf >= 0  # Fortran sign(1,·): +1 at ±0
    s = torch.zeros_like(ntf)
    for i, g in enumerate(gathered_slots(t, adv_cells)):
        coef = torch.where(pos, cp[:, i:i + 1], cm[:, i:i + 1])
        s = s + coef * g
    return ntf * adv_mask * s


@register(
    "cke",
    "gather_selfold",
    "sign-folded per-slot gathers: the per-(e,k) sign select moved into a "
    "precombined coefficient pair so each gathered row feeds ONE "
    "accumulator, exact arithmetic",
)
def make_gather_selfold(cfg):
    c3 = coef3_of(cfg)

    def prepare(data: CkeData):
        return (data.adv_coefs + c3 * data.adv_coefs3,
                data.adv_coefs - c3 * data.adv_coefs3)

    def step2(aux, data: CkeData) -> torch.Tensor:
        cp, cm = aux
        return edge_flux_selfold(data.adv_cells, cp, cm, data.tracer,
                                 data.cell_mask, data.ntf, data.adv_mask)

    return prepare, step2
