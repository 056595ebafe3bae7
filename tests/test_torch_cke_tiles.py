"""A CPU rehearsal of the CKE gather kernels' schedule (csrc/cke_rows.cu,
csrc/cke_lanegather.cu and the gather core in csrc/cke_common.cuh).

`rows_schedule` and `lanegather_schedule` below run the kernels' index
schedule in torch, block by block: K3's edge tiles of as many edges as one
pass of its 128 threads covers, K13's transpose pass in 32 x 32 tiles and
its tiles of 128 bytes of edges in chunks of 64 levels over 160 threads,
the (edge, level group) pairs of W = 16 bytes / itemsize levels with a
ragged last group read as zeros past nvert, the slot rows loaded five at a
time before their
in-order accumulation, and K13's shared tile with its odd-vector pitch read
back edges-fastest for the finish.  Every operation rounds as the kernels'
_rn intrinsics do (a product, then a sum), so the result must come out
`torch.equal` to the plain versions, f32 and f64, at ragged edge counts and
level counts that are and are not a multiple of W.  Sizes are tiny.
"""

from __future__ import annotations

import pytest
import torch

from cdk_torch.core.config import CkeConfig, with_overrides
from cdk_torch.kernels.cke import problem as cp
from cdk_torch.kernels.cke.lanegather import cke_lanegather_plain
from cdk_torch.kernels.cke.reference import coef3_of, fsign1
from cdk_torch.kernels.cke.rows import cke_rows_plain

THREADS3 = 128   # K3's block
THREADS13 = 160  # K13's block
SLOTS = 5        # slot rows in flight (cke_common.cuh)
CHUNK = 64       # K13's levels per shared tile
NEDGES, NCELLS, NADV = 70, 23, 12  # ragged tiles; a second, partial slot batch


def _w(dtype):
    return 128 // torch.finfo(dtype).bits


def _pitch(groups, w):
    return w * (groups | 1)


def _gather_levels(tab, lev, cell, c1, c3):
    """cke::gather_levels for a batch of pairs: lev (P, W) levels, cell,
    c1, c3 (P, A) the pairs' edges' slots; levels past nvert read zero."""
    nvert = tab.shape[1]
    valid = lev < nvert
    safe = lev.clamp(max=nvert - 1)
    s1 = torch.zeros(lev.shape, dtype=tab.dtype)
    s3 = torch.zeros(lev.shape, dtype=tab.dtype)
    nadv = cell.shape[1]
    for i0 in range(0, nadv, SLOTS):
        batch = range(i0, min(i0 + SLOTS, nadv))
        g = [torch.where(valid, tab[cell[:, i:i + 1], safe], 0.0) for i in batch]
        for j, i in enumerate(batch):
            s1 = s1 + c1[:, i:i + 1] * g[j]
            s3 = s3 + c3[:, i:i + 1] * g[j]
    return s1, s3


def _finish(s1, s3, ntfm, sgn, coef3):
    return ntfm * (s1 + coef3 * s3 * sgn)


def rows_schedule(cells, c1, c3, t, ntf, advm, coef3):
    """K3 block by block: (E, K)."""
    e, a = cells.shape
    ncells, nvert = t.shape
    w = _w(t.dtype)
    ngroups = -(-nvert // w)
    tile = max(1, THREADS3 // ngroups)
    out = torch.full_like(ntf, float("nan"))
    for e0 in range(0, e, tile):
        ne = min(tile, e - e0)
        cell = cells[e0:e0 + ne].clamp(0, ncells - 1)
        for p0 in range(0, ne * ngroups, THREADS3):
            p = torch.arange(p0, min(p0 + THREADS3, ne * ngroups))
            el = p // ngroups
            lev = ((p - el * ngroups) * w)[:, None] + torch.arange(w)
            valid = lev < nvert
            edge = (e0 + el)[:, None].expand_as(lev)
            safe = lev.clamp(max=nvert - 1)
            n = torch.where(valid, ntf[edge, safe], 0.0)
            m = torch.where(valid, advm[edge, safe], 0.0)
            s1, s3 = _gather_levels(t, lev, cell[el], c1[e0 + el], c3[e0 + el])
            r = _finish(s1, s3, n * m, fsign1(n), coef3)
            out[edge[valid], lev[valid]] = r[valid]
    return out


def transpose_schedule(tm_t):
    """K13's first kernel: (K, C) -> (C, K) in 32 x 32 tiles."""
    rows, cols = tm_t.shape
    tab = torch.full((cols, rows), float("nan"), dtype=tm_t.dtype)
    for r0 in range(0, rows, 32):
        for c0 in range(0, cols, 32):
            tab[c0:c0 + 32, r0:r0 + 32] = tm_t[r0:r0 + 32, c0:c0 + 32].T
    return tab


def lanegather_schedule(cells_t, c1t, c3t, tm_t, ntfm_t, sgn_t, coef3):
    """K13 block by block: (K, E)."""
    a, e = cells_t.shape
    nvert, ncells = tm_t.shape
    w = _w(tm_t.dtype)
    tile = 128 // tm_t.element_size()
    tab = transpose_schedule(tm_t)
    kp = _pitch(-(-min(CHUNK, nvert) // w), w)
    out_t = torch.full_like(ntfm_t, float("nan"))
    for e0 in range(0, e, tile):
        ne = min(tile, e - e0)
        # the tile's slots, edge-major, loaded from (A, E)
        cell = cells_t[:, e0:e0 + ne].T.clamp(0, ncells - 1)
        c1, c3 = c1t[:, e0:e0 + ne].T, c3t[:, e0:e0 + ne].T
        for kc in range(0, nvert, CHUNK):
            groups = -(-min(CHUNK, nvert - kc) // w)
            sums = torch.full((2, tile * kp), float("nan"), dtype=tm_t.dtype)
            for p0 in range(0, ne * groups, THREADS13):
                p = torch.arange(p0, min(p0 + THREADS13, ne * groups))
                el, v = p // groups, p % groups
                lev = (kc + v * w)[:, None] + torch.arange(w)
                s1, s3 = _gather_levels(tab, lev, cell[el], c1[el], c3[el])
                at = (el * kp + v * w)[:, None] + torch.arange(w)
                sums[0, at], sums[1, at] = s1, s3
            for q0 in range(0, tile * groups, THREADS13):
                q = torch.arange(q0, min(q0 + THREADS13, tile * groups))
                v, el = q // tile, q % tile
                keep = el < ne
                v, el = v[keep], el[keep]
                at = (el * kp + v * w)[:, None] + torch.arange(w)
                lev = (kc + v * w)[:, None] + torch.arange(w)
                edge = (e0 + el)[:, None].expand_as(lev)
                ok = lev < nvert
                k, ed = lev[ok], edge[ok]
                out_t[k, ed] = _finish(sums[0, at][ok], sums[1, at][ok],
                                       ntfm_t[k, ed], sgn_t[k, ed], coef3)
    return out_t


def _problem(nvert, dtype, duplicates):
    cfg = with_overrides(CkeConfig(), nedges=NEDGES, ncells=NCELLS,
                         nvertlevels=nvert, nadv=NADV)
    d = cp.init_data(cfg)
    if duplicates:  # slots 0-1 and 2-4 name one cell each
        d.adv_cells[:, 1] = d.adv_cells[:, 0]
        d.adv_cells[:, 3] = d.adv_cells[:, 4] = d.adv_cells[:, 2]
    d = d.to(dtype)
    return d, coef3_of(with_overrides(cfg, dtype=str(dtype)[6:]))


LEVELS = [1, 21, 37, 100, 129]
DTYPES = [torch.float32, torch.float64]


@pytest.mark.parametrize("duplicates", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("nvert", LEVELS)
def test_rows_schedule_is_plain(nvert, dtype, duplicates):
    """K3's tiles and pairs give cke_rows_plain's flux bit for bit."""
    d, c3 = _problem(nvert, dtype, duplicates)
    args = (d.adv_cells, d.adv_coefs, d.adv_coefs3, d.tracer * d.cell_mask,
            d.ntf, d.adv_mask)
    want = cke_rows_plain(*args, c3)
    assert float(want.abs().max()) > 0
    assert torch.equal(rows_schedule(*args, c3), want)


@pytest.mark.parametrize("duplicates", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("nvert", LEVELS)
def test_lanegather_schedule_is_plain(nvert, dtype, duplicates):
    """K13's transpose, edge tiles, level chunks and transposed finish give
    cke_lanegather_plain's flux bit for bit."""
    d, c3 = _problem(nvert, dtype, duplicates)
    trans = (d.adv_cells.T.contiguous(), d.adv_coefs.T.contiguous(),
             d.adv_coefs3.T.contiguous(),
             (d.tracer * d.cell_mask).T.contiguous(),
             (d.ntf * d.adv_mask).T.contiguous(), fsign1(d.ntf).T.contiguous())
    want = cke_lanegather_plain(*trans, c3)
    assert float(want.abs().max()) > 0
    assert torch.equal(lanegather_schedule(*trans, c3), want)


@pytest.mark.parametrize("nvert", [37, 100, 129, 300])
def test_transpose_schedule_covers_the_table(nvert):
    """Every (k, c) of the table lands at (c, k), ragged tiles included."""
    tm_t = torch.arange(nvert * NCELLS, dtype=torch.float64).reshape(nvert, NCELLS)
    assert torch.equal(transpose_schedule(tm_t), tm_t.T)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("nvert", LEVELS + [300])
def test_finish_reads_hit_distinct_banks(nvert, dtype):
    """K13's finish reads a W-vector of its shared tile per lane, the lanes
    on consecutive edges: at the odd-vector pitch each quarter warp's eight
    16-byte reads cover the 32 banks once, and the tile fits the 48 KB a
    block gets without opting in, at ten slots."""
    w = _w(dtype)
    itemsize = 16 // w
    tile = 128 // itemsize
    groups = -(-min(CHUNK, nvert) // w)
    kp = _pitch(groups, w)
    assert kp >= groups * w and (kp // w) % 2 == 1
    for warp in range(0, tile * groups, 32):
        q = torch.arange(warp, min(warp + 32, tile * groups))
        v, el = q // tile, q % tile
        word = (el * kp + v * w) * itemsize // 4  # first 4-byte bank word
        for phase in word.split(8):
            banks = (phase[:, None] + torch.arange(4)) % 32
            assert banks.unique().numel() == banks.numel()
    slots = tile * 10 * (2 * itemsize + 4)
    assert 2 * tile * kp * itemsize + slots <= 48 * 1024
