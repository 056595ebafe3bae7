"""Per-adv-slot gather CKE variant, the JAX package's champion exact form
(`cdk_tpu/kernels/cke/gather_peradv.py`, an XLA gather there).

One `index_select` of (nedges,) rows per contributing-cell slot, each
weighted and accumulated in slot order i = 0..nadv-1 like the Fortran inner
loop (nested.F90:533-552): the same per-term arithmetic as the reference,
so f64 parity holds at errTol.  No kernel is involved: `gather_flux` is
also K3's plain version (`rows.cke_rows_plain`).
"""

from __future__ import annotations

import torch

from cdk_torch.core.registry import register
from cdk_torch.kernels.cke.problem import CkeData
from cdk_torch.kernels.cke.reference import (
    coef3_of,
    gathered_slots,
    slot_order_flux,
)


def gather_flux(cells, c1, c3, t, ntf, adv_mask, coef3: float):
    """flx (E, K) from cells (E, A) int32, c1/c3 (E, A), the masked tracer
    table t (C, K), ntf/adv_mask (E, K): slot i's rows t[cells[:, i]],
    accumulated in slot order."""
    return slot_order_flux(gathered_slots(t, cells), c1, c3, ntf, adv_mask,
                           coef3)


@register(
    "cke",
    "gather_peradv",
    "per-adv-slot row gathers (nAdv 1-D-indexed index_selects, weighted "
    "accumulate in slot order): exact arithmetic; scales to production "
    "sizes",
)
def make_gather_peradv(cfg):
    c3 = coef3_of(cfg)

    def step(data: CkeData) -> torch.Tensor:
        return gather_flux(data.adv_cells, data.adv_coefs, data.adv_coefs3,
                           data.tracer * data.cell_mask, data.ntf,
                           data.adv_mask, c3)

    return step
