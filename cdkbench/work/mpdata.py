"""The least work of an interval of family `mpdata`: `steps` MPDATA steps of
every slice, f and flux fed from step to step.

Bytes: every input field (f, u, w, rho, rhow, adz, flux) read once and f
and flux written once, per interval.  Operations: those of the stage code
(each add, mul, div, min, max, abs and negation one) in its hoisted form,
whose step-invariant coefficients (12 operations a point over the
antidiffusive velocities' rows) are formed once per interval; float32
throughout, since a bf16 form fails the family's gate.  The counts are
chip_smoke.py's (`_step_ops`, `_invariant_ops`, `mpdata_ops`).  Nothing can
do less, so a share of this least time cannot pass 100 %.
"""

from __future__ import annotations

from cdkbench.peaks import least as _least

ITEMSIZE = {"float32": 4}


def step_ops(nx: int, hoisted: bool) -> int:
    """Operations per level of one step that produces nx columns, over each
    stage's rows: upwind fluxes 6 each, the flux sums 1, the upwind update
    6, the antidiffusive velocities 19 each (7 hoisted), extrema and ratios
    46, limited fluxes 10 each, the final update 7."""
    anti = 7 if hoisted else 19
    return (6 * (nx + 5) + 6 * (nx + 4) + 2 * nx + 6 * (nx + 4)
            + anti * (2 * nx + 5) + 46 * (nx + 2) + 10 * (2 * nx + 1) + 7 * nx)


def invariant_ops(nx: int) -> int:
    """Operations per level of the hoisted invariants."""
    return 12 * (2 * nx + 5)


def ops(nslices: int, nx: int, nzm: int, n: int) -> float:
    """Operations of n hoisted steps, the invariants once."""
    return float(nslices * nzm * (n * step_ops(nx, True) + invariant_ops(nx)))


def least(cfg: dict, steps: int) -> dict:
    s, nx, nz = cfg["nslices"], cfg["nx"], cfg["nz"]
    nzm = nz - 1
    f = s * (nx + 6) * nzm
    inputs = f + s * (nx + 5) * nzm + s * (nx + 4) * nz + 2 * s * nzm + 2 * s * nz
    outputs = f + s * nz
    return _least((inputs + outputs) * ITEMSIZE[cfg["dtype"]],
                  f32_ops=ops(s, nx, nzm, steps))
