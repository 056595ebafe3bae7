"""The benchmark's own plain reference of MPAS-Ocean's high-order horizontal
tracer-advection edge flux, as the nested_loops miniapp's original form
computes it (nested_loops/nested.F90:119-157), for every tracer of a group:

    do iEdge
      wgt(k) = normalThicknessFlux(k, iEdge) * advMaskHighOrder(k, iEdge)
      sgn(k) = sign(1, normalThicknessFlux(k, iEdge))
      highOrderFlx(:, iEdge) = 0
      do i = 1, nAdvCellsForEdge(iEdge)
        iCell = advCellsForEdge(i, iEdge)
        coef1 = advCoefs(i, iEdge)
        coef3 = advCoefs3rd(i, iEdge) * coef3rdOrder
        do k = minLevelCell(iCell), maxLevelCell(iCell)
          highOrderFlx(k, iEdge) += tracerCur(k, iCell) * wgt(k)
                                    * (coef1 + coef3 * sgn(k))

The level bounds come from minLevelCell and maxLevelCell, not from the
cell mask the program multiplies by.  Tracer by tracer, in blocks of
edges, so the (edges, nAdv, levels) gather fits.  `precision` is "float64"
(the reference) or "bfloat16" (the control: the same computation in
float64 from a bfloat16-rounded tracer table, the step below the float32
the configuration states).  Family `cke`: every step of an interval
computes the same fluxes (the miniapp has no tracer update), so an
interval's answer is one step's.  TF32 is turned off, so no product here
runs below float64's precision.  It imports nothing of the program.
"""

from __future__ import annotations

import torch

# edges a block: the (block, nAdv, levels) float64 gather stays a few
# hundred MB at 60 levels
BLOCK = 1 << 15


def tracer_flux(out, tracer, active, cells, coef1, coef3, wgt, sgn):
    """highOrderFlx (E, K) of one tracer table (C, K) into `out`, float64:
    each slot's term tracerCur * wgt * (coef1 + coef3 * sgn) inside the
    cell's level bounds, summed in slot order."""
    for a in range(0, cells.shape[0], BLOCK):
        b = slice(a, a + BLOCK)
        idx = cells[b]
        rows = tracer[idx] * active[idx]  # (B, A, K), zero outside bounds
        terms = rows * wgt[b, None, :] * (coef1[b, :, None]
                                          + coef3[b, :, None] * sgn[b, None, :])
        acc = torch.zeros_like(wgt[b])
        for i in range(idx.shape[1]):
            acc = acc + terms[:, i]
        out[b] = acc


def interval(cfg: dict, raw: dict, steps: int, precision: str) -> dict:
    """Every tracer's edge flux from the interval's input: flux (T, E, K)
    in float64 (or (E, K) for one tracer table)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    f64 = torch.float64
    tracer = raw["tracer"]
    if precision == CONTROL:
        tracer = tracer.to(torch.bfloat16)
    levels = torch.arange(raw["ntf"].shape[1], device=tracer.device)
    active = ((levels >= raw["min_level"][:, None])
              & (levels <= raw["max_level"][:, None])).to(f64)
    ntf = raw["ntf"].to(f64)
    wgt = ntf * raw["adv_mask"].to(f64)
    sgn = torch.where(ntf >= 0, 1.0, -1.0).to(f64)
    cells = raw["adv_cells"].long()
    coef1 = raw["adv_coefs"].to(f64)
    coef3 = raw["adv_coefs3"].to(f64) * float(cfg["coef3rdorder"])
    tables = tracer if tracer.dim() == 3 else tracer[None]
    flux = wgt.new_empty((tables.shape[0], *wgt.shape))
    for t, out in zip(tables, flux):
        tracer_flux(out, t.to(f64), active, cells, coef1, coef3, wgt, sgn)
    return {"flux": flux if tracer.dim() == 3 else flux[0]}


# the control's precision: a bfloat16 tracer table, the step below the
# float32 the configuration states
CONTROL = "bfloat16"
# the gate's norm (check.py), as the port's harness/specs.py gates the
# family in float32
NORM = "rel_l1"
