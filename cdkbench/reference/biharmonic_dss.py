"""The benchmark's own plain reference of the two-application biharmonic with
the ring DSS (family `biharmonic_dss`):

    step(q) = laplace_wk( dss( laplace_wk(q) ) · W ),  W = 1 / dss(spheremp)

The nelemd elements form a periodic ring along the GLL j axis: element e's
j = np-1 column is element (e+1 mod nelemd)'s j = 0 column, so dss adds to
each element's j = 0 column its left neighbour's j = np-1 column and to its
j = np-1 column its right neighbour's j = 0 column.  It imports nothing of
the program.
"""

from __future__ import annotations

import torch

from cdkbench.reference.biharmonic import (CONTROL, NORM, by_blocks,
                                           element_fields, laplace_sphere_wk)

__all__ = ["CONTROL", "NORM", "interval"]


def dss_sum(s: torch.Tensor) -> torch.Tensor:
    """The sum over sharers of s (nelemd, ..., i, j) on the ring."""
    lo = s[..., 0] + torch.roll(s[..., -1], 1, 0)
    hi = s[..., -1] + torch.roll(s[..., 0], -1, 0)
    return torch.cat([lo[..., None], s[..., 1:-1], hi[..., None]], -1)


def interval(cfg: dict, raw: dict, steps: int, precision: str) -> dict:
    """`steps` chained steps from the interval's qtens, a block of tracers
    at a time (the DSS joins elements, never tracers or levels)."""

    def chain(q, f):
        dinv, sph, tv = element_fields(f)
        winv = (1.0 / dss_sum(f["spheremp"]))[:, None, None]

        def lap(x):
            return laplace_sphere_wk(x, f["dvv"], dinv, sph, tv,
                                     cfg["rrearth"], precision)

        for _ in range(steps):
            q = lap(dss_sum(lap(q)) * winv)
        return q

    return by_blocks(raw, precision, chain)
