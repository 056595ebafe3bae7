"""The benchmark's own plain reference of the two-application biharmonic with
the torus DSS (family `biharmonic_dss2d`), copied from the port's:

    step(q) = laplace_wk( dss2d( laplace_wk(q) ) )

The nelemd elements form the most-square (ex, ey) torus, e = a*ey + b;
element (a, b)'s j = np-1 column is element (a, b+1 mod ey)'s j = 0 column
and its i = np-1 row element (a+1 mod ex, b)'s i = 0 row.  dss2d sums every
shared point over its sharers (a j pass, then an i pass of the j-summed
field, so the corners collect four) and multiplies by the inverse of the
same sum of spheremp.  It imports nothing of the program.
"""

from __future__ import annotations

import torch

from cdkbench.reference.biharmonic import (CONTROL, NORM, by_blocks,
                                           element_fields, laplace_sphere_wk)

__all__ = ["CONTROL", "NORM", "interval", "torus_shape"]


def torus_shape(nelemd: int) -> tuple[int, int]:
    """Most-square (ex, ey), ey <= ex (5400 -> 75 x 72)."""
    ey = int(nelemd**0.5)
    while nelemd % ey:
        ey -= 1
    return nelemd // ey, ey


def _edge_pair_sum(s, eax: int, gax: int):
    """Along GLL axis gax, slice 0 gains the eax-previous element's slice
    n-1 and slice n-1 the eax-next element's slice 0."""
    n = s.shape[gax]
    lo0, hi0 = s.narrow(gax, 0, 1), s.narrow(gax, n - 1, 1)
    lo = lo0 + torch.roll(hi0, 1, eax)
    hi = hi0 + torch.roll(lo0, -1, eax)
    return torch.cat([lo, s.narrow(gax, 1, n - 2), hi], gax)


def dss_sum(s, ex: int, ey: int):
    """The sum over sharers of s (nelemd, ..., i, j)."""
    s5 = s.reshape(ex, ey, *s.shape[1:])
    return _edge_pair_sum(_edge_pair_sum(s5, 1, -1), 0, -2).reshape(s.shape)


def interval(cfg: dict, raw: dict, steps: int, precision: str) -> dict:
    """`steps` chained steps from the interval's qtens, a block of tracers
    at a time (the DSS joins elements, never tracers or levels)."""
    ex, ey = torus_shape(cfg["nelemd"])

    def chain(q, f):
        dinv, sph, tv = element_fields(f)
        winv = (1.0 / dss_sum(f["spheremp"], ex, ey))[:, None, None]

        def lap(x):
            return laplace_sphere_wk(x, f["dvv"], dinv, sph, tv,
                                     cfg["rrearth"], precision)

        for _ in range(steps):
            q = lap(dss_sum(lap(q), ex, ey) * winv)
        return q

    return by_blocks(raw, precision, chain)
