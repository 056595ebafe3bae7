"""MPAS-Ocean's high-order tracer-advection edge flux over a tracer group on a
doubly periodic planar hexagonal mesh: the inputs of a cell, made on the
card from the seed, and how they map onto the program's config and data.

The mesh is built here from the cells' positions, apart from the program's
own `cdk_torch/kernels/cke/mesh.py`, which builds it from index formulas
and MPAS-Ocean's no-repeat rule: `to_program` hands the program the
connectivity of its own build and the reference this one, so the check
holds the one against the other.  Cell c lies in row c // nx, column
c % nx, at x = column + 0.5 (odd rows), y = row * sqrt(3) / 2 (in cell
widths); its neighbour k lies one cell width away at 180 + 60 k degrees
(W, SW, SE, E, NE, NW), wrapped in both directions; it owns edges 3c + j
towards its neighbours j = 0, 1, 2.  advCellsForEdge of edge (c, j): c,
its neighbour n = c_j, c's other five neighbours in order, then n's three
neighbours that touch neither c nor c's neighbours, in n's order.

Fields (C order, 0-based cells): adv_cells (E, 10) int32; adv_coefs,
adv_coefs3 (E, 10); tracer (T, C, K), zero below each cell's bottom;
cell_mask (C, K); ntf, adv_mask (E, K); min_level, max_level (C,) int32.
"""

from __future__ import annotations

import math

import torch

OUTPUTS = ("flux",)
# every interval starts from the seeded tracers: nothing is handed on
STATE: dict = {}
# the CPU tests' sizes over the configuration's: a 4 x 4 mesh of 6
# levels and 3 tracers
TINY = dict(nx=4, ny=4, ncells=16, nedges=48, nvertlevels=6, ntracers=3)
DTYPES = {"float32": torch.float32, "float64": torch.float64}
NADV = 10
# the directions of a cell's six neighbours, counterclockwise from the west
ANGLES = (180.0, 240.0, 300.0, 0.0, 60.0, 120.0)
ROW_HEIGHT = math.sqrt(3.0) / 2.0


def _offsets():
    return [(math.cos(math.radians(a)), math.sin(math.radians(a)))
            for a in ANGLES]


def neighbours(nx: int, ny: int, device) -> torch.Tensor:
    """cellsOnCell (C, 6) int64, from the cells' positions."""
    cell = torch.arange(nx * ny, device=device)
    row = cell // nx
    x = (cell % nx).double() + 0.5 * (row % 2).double()
    y = row.double() * ROW_HEIGHT
    out = []
    for dx, dy in _offsets():
        r = torch.round((y + dy) / ROW_HEIGHT).long()
        col = torch.round(x + dx - 0.5 * (r % 2).double()).long()
        out.append((r % ny) * nx + col % nx)
    return torch.stack(out, dim=1)


def adv_cells(nx: int, ny: int, device) -> torch.Tensor:
    """advCellsForEdge (3 nx ny, 10) int32, edge 3c + j the one between
    cell c and its neighbour j."""
    coc = neighbours(nx, ny, device)
    cell = torch.arange(nx * ny, device=device)
    d = _offsets()
    rows = []
    for j in range(3):
        n = coc[:, j]
        own = [k for k in range(6) if k != j]
        # n's neighbours more than 1.5 cell widths from c: neither c nor
        # one of c's neighbours
        far = [k for k in range(6)
               if math.hypot(d[j][0] + d[k][0], d[j][1] + d[k][1]) > 1.5]
        rows.append(torch.cat([cell[:, None], n[:, None], coc[:, own],
                               coc[n][:, far]], dim=1))
    adv = torch.stack(rows, dim=1).reshape(-1, NADV)
    return adv.to(torch.int32)


def _check(cfg: dict) -> None:
    nx, ny = cfg["nx"], cfg["ny"]
    want = dict(ncells=nx * ny, nedges=3 * nx * ny, nadv=NADV)
    got = {k: cfg.get(k, v) for k, v in want.items()}
    if got != want or ny % 2 or min(nx, ny) < 4:
        raise ValueError(f"mpaso: a planar hexagonal mesh of nx {nx} x ny "
                         f"{ny} (even, both >= 4) has {want}, not {got}")


def make(cfg: dict, seed: int, device) -> dict:
    """The mesh's stencil, then one torch.Generator on `device` seeded by
    `seed`, in the miniapp's order: bottom depth, tracers, advCoefs,
    advCoefs3rd, normalThicknessFlux; float64 uniforms, then the config's
    dtype."""
    _check(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    c, e, k = cfg["ncells"], cfg["nedges"], cfg["nvertlevels"]
    dtype = DTYPES[cfg["dtype"]]

    def u(*shape):
        return torch.rand(shape, generator=gen, device=device,
                          dtype=torch.float64)

    depth = torch.clamp(torch.round(u(c) * 2.0 * k), 3, k).to(torch.int32)
    max_level = depth - 1
    min_level = torch.zeros(c, dtype=torch.int32, device=device)
    levels = torch.arange(k, device=device)
    active = (levels >= min_level[:, None]) & (levels <= max_level[:, None])
    tracer = torch.where(active, 15.0 * u(cfg["ntracers"], c, k), 0.0)
    coefs, coefs3 = 20.0 * u(e, NADV), 21.0 * u(e, NADV)
    ntf = 15.0 * (0.5 - u(e, k))
    return dict(
        adv_cells=adv_cells(cfg["nx"], cfg["ny"], device),
        adv_coefs=coefs.to(dtype), adv_coefs3=coefs3.to(dtype),
        tracer=tracer.to(dtype), cell_mask=active.to(dtype),
        ntf=ntf.to(dtype), adv_mask=torch.ones_like(ntf, dtype=dtype),
        min_level=min_level, max_level=max_level)


def to_program(cfg: dict, raw: dict):
    """-> (the program's CkeConfig on its planar_hex mesh, its CkeData):
    the seeded fields are raw's tensors, the connectivity the program's
    own build."""
    from cdk_torch.core.config import CkeConfig
    from cdk_torch.kernels.cke import mesh
    from cdk_torch.kernels.cke.problem import CkeData

    pcfg = CkeConfig(nvertlevels=cfg["nvertlevels"],
                     coef3rdorder=cfg["coef3rdorder"], dtype=cfg["dtype"],
                     device_init=True, mesh="planar_hex", nx=cfg["nx"],
                     ny=cfg["ny"], ntracers=cfg["ntracers"])
    device = raw["tracer"].device
    cells = mesh.adv_cells_for_edge(mesh.planar_hex(cfg["nx"], cfg["ny"],
                                                    device))
    return pcfg, CkeData(**{**raw, "adv_cells": cells})


def named(result) -> dict:
    """The program's loop result, every tracer's flux (T, E, K), by output
    name."""
    return {"flux": result}
