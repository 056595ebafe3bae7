"""K3g: the CKE edge flux of a whole tracer group in one launch, each tile of
consecutive edges staging its distinct stencil rows in shared memory.

The group form of K3 (`rows.py`, `pallas_rows`); it replaces no TPU kernel.
K3 reads the edge fields once a tracer and gathers every (edge, slot) row
from L2, E * A rows a tracer, so however tuned a tracer costs its gathered
rows at L2's rate.  On a mesh whose edges are numbered along it, consecutive
edges share most of their stencil: a tile's 10 * tile slots name a few
times fewer distinct cells.  K3g (csrc/cke_group.cu) cuts the edges into
tiles of consecutive edges and, per tile, reads the edge fields and the
slots' coefficients once into registers and the distinct cells' cellMask
rows once into shared memory, then for each tracer of the group copies the
tile's distinct rows of that tracer's table into a ring of shared-memory
stages, a few tracers ahead, and multiplies each value by its cellMask
value in place (the masked table, tracer * cellMask, bit for bit).  Each
thread gathers the slot rows of two level groups of one edge from the
stage and accumulates them in slot order, a product then a sum: bitwise
K3's flux of each tracer's masked table.  Its bound is the cell's: every
table, the mask and the edge fields read once, the (T, E, K) flux written
once.

The tile map (`tile_map`) is a function of advCellsForEdge alone, made once
in the variant's set-up and kept while the connectivity tensor is the same
and unwritten (`tiles`).  A map fits (`fits`) when its widest tile's stage,
rows by 16-byte level groups, is at most the vectors the block's threads
carry (CARRY a thread), an edge has at most MAX_SLOTS slots and a row's
level groups fit a block; connectivity without locality (the miniapp's
random draw) does not fit, and its group runs K3 once a tracer.

`cke_group_plain` computes the same through the same map in plain PyTorch:
the CPU path of the wrapper `cke_group` and what the card's kernel is
compared with.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from cdk_torch.core import build
from cdk_torch.core.registry import keep_last
from cdk_torch.core.trace import counted
from cdk_torch.kernels.cke.launch import check_inputs
from cdk_torch.kernels.cke.reference import slot_order_flux

# mirrors of csrc/cke_group.cu
THREADS = 256  # a block's threads, two level groups of an edge each
CARRY = 4  # stage vectors (16 bytes) a thread copies for each tracer
MAX_SLOTS = 10  # an edge's slots, held in a thread's registers
VECTOR = 16  # bytes of a level group


class TileMap(NamedTuple):
    """Tiles of `tile` consecutive edges (the last one ragged): `cells`
    (ntiles, width) int32, each tile's distinct cells sorted, clamped to
    [0, ncells) and padded with 0; `counts` (ntiles,) int32 how many;
    `local` (E, A) int16 the place of each slot's cell in its tile's list."""

    tile: int
    width: int
    cells: torch.Tensor
    counts: torch.Tensor
    local: torch.Tensor


def level_groups(nvert: int, dtype: torch.dtype) -> int:
    """16-byte groups of levels in a row of nvert values."""
    w = VECTOR // dtype.itemsize
    return -(-nvert // w)


def edge_lanes(groups: int) -> int:
    """Threads for `groups` level groups of an edge: rounded up to a power of
    two up to 8, else to a multiple of 8, so that the eight 16-byte reads
    of a quarter warp fall in one edge's row (no shared-memory bank
    conflict)."""
    if groups <= 8:
        return 1 << max(groups - 1, 0).bit_length()
    return -(-groups // 8) * 8


def tile_edges(nvert: int, dtype: torch.dtype) -> int:
    """Edges a tile at these levels: as many as the block's threads hold,
    each thread two level groups of an edge (0 where one edge's row is
    wider than a block)."""
    return THREADS // edge_lanes(-(-level_groups(nvert, dtype) // 2))


def tile_map(cells: torch.Tensor, ncells: int, tile: int) -> TileMap:
    """The tile map of connectivity `cells` (E, A) over `ncells` cells, in
    tiles of `tile` consecutive edges, on the connectivity's device."""
    e, a = cells.shape
    nt = -(-e // tile)
    c = cells.long().clamp(0, ncells - 1)
    if nt * tile > e:  # the last tile repeats its last edge's cells
        c = torch.cat([c, c[-1:].expand(nt * tile - e, a)])
    srt, idx = c.view(nt, tile * a).sort(dim=1)
    new = torch.ones_like(srt, dtype=torch.bool)
    new[:, 1:] = srt[:, 1:] != srt[:, :-1]
    rank = new.cumsum(1) - 1
    counts = new.sum(1)
    width = int(counts.max()) if nt else 0
    lists = torch.zeros((nt, width), dtype=torch.int32, device=cells.device)
    lists[new.nonzero(as_tuple=True)[0], rank[new]] = srt[new].int()
    local = torch.empty_like(rank).scatter_(1, idx, rank)
    return TileMap(tile, width, lists, counts.int(),
                   local.view(-1, a)[:e].to(torch.int16).contiguous())


def fits(tm: TileMap, ncells: int, nvert: int, nadv: int,
         dtype: torch.dtype) -> bool:
    """Whether K3g takes this map at these sizes: tiles of the edges a
    block holds, at most MAX_SLOTS slots, the widest stage within the
    vectors the threads carry, and a table's offsets within 32 bits."""
    g = level_groups(nvert, dtype)
    return (tm.tile >= 1 and tm.tile == tile_edges(nvert, dtype)
            and nadv <= MAX_SLOTS and tm.width * g <= CARRY * THREADS
            and ncells * nvert < 2**31)


def tiles():
    """A fresh tile-map set-up, `get(cells, tracers)`: the map of
    connectivity `cells` (E, A) for tracer tables shaped and typed as
    `tracers` (..., C, K), kept (`registry.keep_last`) while `cells` is the
    same tensor, unwritten since, at the same sizes, and built again
    otherwise, so a stale map is never read."""
    kept = keep_last(lambda cells, ncells, tile: tile_map(cells, ncells, tile),
                     lambda cells, ncells, tile: ((cells,), (ncells, tile)))

    def get(cells: torch.Tensor, tracers: torch.Tensor) -> TileMap:
        ncells, nvert = tracers.shape[-2:]
        return kept(cells, ncells, max(tile_edges(nvert, tracers.dtype), 1))

    return get


def cke_group_plain(tm: TileMap, c1, c3, tracers, cell_mask, ntf, adv_mask,
                    coef3: float) -> torch.Tensor:
    """(T, E, K) from the (T, C, K) group through the map: each tile's
    distinct rows masked (tracer * cellMask), each slot's row taken from
    its tile's stage by its local index, accumulated in slot order as
    K3's plain version does."""
    t, _, k = tracers.shape
    e, a = tm.local.shape
    idx = tm.cells.long()
    stage = (tracers[:, idx] * cell_mask[idx]).reshape(t, -1, k)
    first = torch.arange(e, device=tm.local.device) // tm.tile * tm.width
    slots = (stage[:, first + tm.local[:, i].long()] for i in range(a))
    return slot_order_flux(slots, c1, c3, ntf, adv_mask, coef3)


@counted
def cke_group(tm: TileMap, c1, c3, tracers, cell_mask, ntf, adv_mask,
              coef3: float) -> torch.Tensor:
    """Every tracer's flux (T, E, K) of the (T, C, K) group `tracers`, the
    flux of cke_group_plain.  CUDA tensors launch K3g once (never anything
    else); CPU tensors run cke_group_plain.  The map must fit (`fits`)."""
    t, c, k = tracers.shape
    e, a = tm.local.shape
    check_inputs("cke_group", tracers.dtype, tracers.device, c1=(c1, (e, a)),
                 c3=(c3, (e, a)), tracers=(tracers, (t, c, k)),
                 cell_mask=(cell_mask, (c, k)), ntf=(ntf, (e, k)),
                 adv_mask=(adv_mask, (e, k)))
    if tm.local.dtype != torch.int16 or tm.local.device != tracers.device:
        raise TypeError("cke_group: the tile map is not int16 on the "
                        "tracers' device")
    if not fits(tm, c, k, a, tracers.dtype):
        raise ValueError(f"cke_group: a tile map of {tm.tile} edges and "
                         f"{tm.width} cells a tile does not fit {k} levels "
                         f"of {tracers.dtype}")
    if tracers.device.type == "cpu":
        return cke_group_plain(tm, c1, c3, tracers, cell_mask, ntf, adv_mask,
                               coef3)
    out = torch.empty((t, e, k), dtype=tracers.dtype, device=tracers.device)
    if out.numel():
        build.launch(cke_group, 1, "cke_group", "cdk_cke_group_f32"
                     if tracers.dtype == torch.float32 else "cdk_cke_group_f64",
                     tracers.device, tm.local, tm.cells, tm.counts, c1, c3,
                     tracers, cell_mask, ntf, adv_mask, out, t, e, c, a, k,
                     tm.tile, tm.width, coef3)
    return out
