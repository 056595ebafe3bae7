"""The benchmark's own plain reference of the two-application biharmonic with
the DSS over HOMME's cubed sphere (family `biharmonic_dss_cube`):

    step(q) = laplace_wk( dss( laplace_wk(q) ) · W ),  W = 1 / dss(spheremp)

The nelemd = 6 * ne^2 elements lie face-major, row-major within a face:
element (f, a, b) is e = f*ne^2 + a*ne + b, with its GLL i axis along a and
j along b.  GLL point (i, j) of it lies at the integer lattice position
3*ne*O + (3a + i)*U + (3b + j)*V on the cube [0, 3*ne]^3 (np - 1 = 3
intervals an element side), with (O, U, V) face f's origin and axes
(FACES, the convention E3SM's cube_mod.F90 cube is laid out by here, every
face oriented alike seen from outside).  Points at one position are one
degree of freedom: dss sums each over its sharers (itself and up to three
others, in the order of their rows e*16 + i*4 + j) and every sharer takes
the sum.  Nothing here walks edges or vertices: the sharers are the points
that land on one lattice site, so the program's assembly map, built from
element edges (cdk_torch/kernels/biharmonic/cube.py), is held to this one
by the check.  float64, a block of tracers at a time; it imports nothing of
the program.
"""

from __future__ import annotations

import torch

from cdkbench.reference.biharmonic import (CONTROL, NORM, by_blocks,
                                           element_fields, laplace_sphere_wk)

__all__ = ["CONTROL", "NORM", "FACES", "interval", "sharers"]

# (origin, U, V) of each face in units of the cube's side
FACES = (
    ((1, 0, 0), (0, 1, 0), (0, 0, 1)),
    ((1, 1, 0), (-1, 0, 0), (0, 0, 1)),
    ((0, 1, 0), (0, -1, 0), (0, 0, 1)),
    ((0, 0, 0), (1, 0, 0), (0, 0, 1)),
    ((0, 0, 1), (1, 0, 0), (0, 1, 0)),
    ((0, 0, 0), (0, 1, 0), (1, 0, 0)),
)
NP = 4
MOST = 4  # the most sharers of one point (a vertex inside a face)


def sharers(nelemd: int, device=None) -> torch.Tensor:
    """(nelemd * 16, MOST) for each point (row e*16 + i*4 + j) the rows of
    every point at its lattice position, itself included, in row order,
    padded with -1."""
    ne = round((nelemd / 6) ** 0.5)
    if 6 * ne * ne != nelemd:
        raise ValueError(f"a cubed sphere has 6 * ne^2 elements; got {nelemd}")
    faces = torch.tensor(FACES, device=device)
    f, a, b, i, j = torch.meshgrid(*(torch.arange(n, device=device) for n in
                                     (6, ne, ne, NP, NP)), indexing="ij")
    o, u, v = faces[f, 0], faces[f, 1], faces[f, 2]
    side = (NP - 1) * ne
    pos = (side * o + ((NP - 1) * a + i)[..., None] * u
           + ((NP - 1) * b + j)[..., None] * v).reshape(-1, 3)
    site = (pos[:, 0] * (side + 1) + pos[:, 1]) * (side + 1) + pos[:, 2]
    order = torch.argsort(site, stable=True)
    srt = site[order]
    # each sorted row's first index among the rows of its site
    first = torch.searchsorted(srt, srt)
    count = torch.searchsorted(srt, srt, right=True) - first
    k = torch.arange(MOST, device=device)
    members = torch.where(k < count[:, None],
                          order[(first[:, None] + k).clamp(max=len(srt) - 1)], -1)
    out = torch.empty_like(members)
    out[order] = members
    return out


def dss_sum(s: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """The sum over sharers of s (nelemd, ..., i, j), in `sharers` order."""
    e = s.shape[0]
    flat = s.movedim(0, -3).reshape(-1, e * NP * NP)  # (..., points)
    tot = torch.zeros_like(flat)
    for k in range(MOST):
        idx = rows[:, k]
        tot = tot + torch.where(idx >= 0, flat[:, idx.clamp(min=0)],
                                torch.zeros_like(flat))
    return tot.reshape(*s.shape[1:-2], e, NP, NP).movedim(-3, 0)


def interval(cfg: dict, raw: dict, steps: int, precision: str) -> dict:
    """`steps` chained steps from the interval's qtens, a block of tracers
    at a time (the DSS joins elements, never tracers or levels)."""
    rows = sharers(cfg["nelemd"], raw["qtens"].device)

    def chain(q, f):
        dinv, sph, tv = element_fields(f)
        winv = (1.0 / dss_sum(f["spheremp"], rows))[:, None, None]

        def lap(x):
            return laplace_sphere_wk(x, f["dvv"], dinv, sph, tv,
                                     cfg["rrearth"], precision)

        for _ in range(steps):
            q = lap(dss_sum(lap(q), rows) * winv)
        return q

    return by_blocks(raw, precision, chain)
