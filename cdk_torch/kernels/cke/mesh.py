"""MPAS-Tools' doubly periodic planar hexagonal mesh and MPAS-Ocean's
high-order advection stencil on it, built on the device with integer ops.

`planar_hex(nx, ny)` numbers cells as `mpas_tools.planar_hex` does, row by
row (cell c in row c // nx, column c % nx, odd rows shifted half a cell
east), so ny must be even for the rows to wrap.  cellsOnCell lists the six
neighbours counterclockwise from the west: W, SW, SE, E, NE, NW.  Cell c
owns edges 3c, 3c + 1 and 3c + 2, towards its neighbours 0, 1 and 2, so
cellsOnEdge[3c + j] = (c, cellsOnCell[c, j]) and every cell has 3 edges
of its own and 6 in all.

`adv_cells_for_edge` is MPAS-Ocean's rule for advCellsForEdge: the edge's
two cells, then each other neighbour of the first cell, then each of the
second, in cellsOnCell order, none twice; on a hexagon that is 10 cells.
Indices are 0-based, int32.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

NADV = 10


class Mesh(NamedTuple):
    cells_on_cell: torch.Tensor  # (C, 6)
    cells_on_edge: torch.Tensor  # (E, 2)


def planar_hex(nx: int, ny: int, device="cpu") -> Mesh:
    """The connectivity of `make_planar_hex_mesh(nx, ny)`, doubly
    periodic: nx * ny cells, 3 * nx * ny edges."""
    if nx < 4 or ny < 4 or ny % 2:
        raise ValueError(f"planar_hex needs nx >= 4 and an even ny >= 4, "
                         f"not {nx} x {ny}")
    cell = torch.arange(nx * ny, device=device, dtype=torch.int64)
    row, col = cell // nx, cell % nx
    even = row % 2 == 0
    mx, px = (col - 1) % nx, (col + 1) % nx
    my, py = (row - 1) % ny, (row + 1) % ny
    coc = torch.stack([
        row * nx + mx,
        my * nx + torch.where(even, mx, col),
        my * nx + torch.where(even, col, px),
        row * nx + px,
        py * nx + torch.where(even, col, px),
        py * nx + torch.where(even, mx, col),
    ], dim=1)
    coe = torch.stack([cell.repeat_interleave(3), coc[:, :3].reshape(-1)],
                      dim=1)
    return Mesh(coc.to(torch.int32), coe.to(torch.int32))


def adv_cells_for_edge(mesh: Mesh) -> torch.Tensor:
    """advCellsForEdge (E, 10) int32: per edge its cells c1, c2, then
    cellsOnCell of c1 and of c2 in order, each cell at its first place
    only."""
    coc = mesh.cells_on_cell.long()
    c1, c2 = mesh.cells_on_edge.long().unbind(1)
    cand = torch.cat([c1[:, None], c2[:, None], coc[c1], coc[c2]], dim=1)
    n = cand.shape[1]
    earlier = torch.ones(n, n, dtype=torch.bool, device=cand.device).tril(-1)
    seen = ((cand[:, :, None] == cand[:, None, :]) & earlier).any(dim=2)
    first = ~seen
    if not bool((first.sum(dim=1) == NADV).all()):
        raise ValueError(f"adv_cells_for_edge: an edge has other than {NADV} "
                         f"distinct cells (a mesh too small to hold them)")
    return cand[first].view(-1, NADV).to(torch.int32)
