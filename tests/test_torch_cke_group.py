"""K3g's tile map and its group step on the CPU (`cdk_torch/kernels/cke/
group.py`, the group form of `pallas_rows`): each tile's list of distinct
cells and the slots' places in it, the fit rule that decides between K3g
and K3 once a tracer, the map kept while the connectivity is unwritten and
built again after a write, the plain version through the map bitwise the
per-tracer plain K3, and a row-by-row rehearsal of the kernel's stage
addressing (csrc/cke_group.cu: the vectors each thread copies, the stage
places each (edge, level group) pair reads).  No jax."""

import dataclasses
import re
from pathlib import Path

import pytest
import torch

import cdk_torch.kernels  # noqa: F401  (registers the variants)
from cdk_torch.core import registry, trace
from cdk_torch.core.config import CkeConfig, with_overrides
from cdk_torch.harness.specs import get_spec
from cdk_torch.kernels.cke import group, mesh
from cdk_torch.kernels.cke import problem as cp
from cdk_torch.kernels.cke import rows as krows
from cdk_torch.kernels.cke.reference import coef3_of, slot_order_flux

ROOT = Path(__file__).resolve().parents[1]
CELL = (486, 488)  # the cell mpaso.tracers' mesh


def _hex(nx, ny):
    return mesh.adv_cells_for_edge(mesh.planar_hex(nx, ny)), nx * ny


def _random(nedges, ncells, seed=0):
    """Random connectivity, a few indices out of range (the map clamps them
    as K3 does) and repeats within an edge."""
    g = torch.Generator().manual_seed(seed)
    cells = torch.randint(-3, ncells + 3, (nedges, 10), generator=g,
                          dtype=torch.int32)
    cells[::5, 1] = cells[::5, 0]
    return cells, ncells


@pytest.mark.parametrize("cells,tile", [
    (_hex(6, 8), 16), (_hex(7, 10), 8), (_hex(24, 20), 128), (_hex(5, 6), 5),
    (_random(97, 40), 16), (_random(50, 1000), 7)])
def test_tile_map_lists_each_tiles_cells_and_their_places(cells, tile):
    cells, ncells = cells
    tm = group.tile_map(cells, ncells, tile)
    e, a = cells.shape
    nt = -(-e // tile)
    assert tm.tile == tile and tm.cells.shape == (nt, tm.width)
    assert tm.cells.dtype == tm.counts.dtype == torch.int32
    assert tm.local.dtype == torch.int16 and tm.local.shape == (e, a)
    clamped = cells.long().clamp(0, ncells - 1)
    for t in range(nt):
        mine = clamped[t * tile:(t + 1) * tile].reshape(-1)
        n = int(tm.counts[t])
        # the tile's distinct cells, sorted, each once; zeros after them
        assert tm.cells[t, :n].tolist() == sorted(set(mine.tolist()))
        assert not tm.cells[t, n:].any()
    assert tm.width == int(tm.counts.max())
    # each slot's place gives back its (clamped) cell
    first = torch.arange(e) // tile
    assert torch.equal(tm.cells[first[:, None], tm.local.long()].long(),
                       clamped)


def test_tile_edges_rounds_an_edges_levels_to_whole_quarter_warps():
    assert [group.edge_lanes(g) for g in (1, 2, 3, 5, 8, 9, 15, 16, 17, 30)] == [
        1, 2, 4, 8, 8, 16, 16, 16, 24, 32]
    # a thread takes two of an edge's level groups: lanes for half of them
    threads = group.THREADS
    assert group.tile_edges(60, torch.float32) == threads // 8
    assert group.tile_edges(60, torch.float64) == threads // 16
    assert group.tile_edges(7, torch.float32) == threads // 1
    assert group.tile_edges(100, torch.float32) == threads // 16
    assert group.tile_edges(8 * threads + 1, torch.float32) == 0


def test_constants_mirror_the_kernel_source():
    src = (ROOT / "cdk_torch" / "csrc" / "cke_group.cu").read_text()
    for name in ("THREADS", "CARRY", "MAX_SLOTS"):
        got = re.search(rf"constexpr int {name} = (\d+);", src)
        assert got and int(got.group(1)) == getattr(group, name), name


def _fits(cells, ncells, nvert, dtype):
    tm = group.tile_map(cells, ncells, group.tile_edges(nvert, dtype))
    return group.fits(tm, ncells, nvert, cells.shape[1], dtype)


@pytest.mark.parametrize("nvert,dtype", [
    (7, torch.float32), (60, torch.float32), (100, torch.float32),
    (7, torch.float64), (30, torch.float64)])
def test_the_hexagonal_mesh_fits(nvert, dtype):
    assert _fits(*_hex(24, 20), nvert, dtype)


@pytest.mark.parametrize("nvert,dtype", [
    (60, torch.float32), (7, torch.float64), (30, torch.float64)])
def test_the_cells_mesh_fits(nvert, dtype):
    assert _fits(*_hex(*CELL), nvert, dtype)


def test_a_row_too_wide_for_the_stage_does_not_fit():
    """At 60 levels of float64 on the cell's mesh a tile is 16 edges whose
    36 distinct rows of 30 vectors overflow the stage."""
    assert not _fits(*_hex(*CELL), 60, torch.float64)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_the_miniapps_random_connectivity_does_not_fit(dtype):
    """2,800 cells, 100 levels: a tile's slots name nearly as many distinct
    cells, more than a stage holds."""
    cfg = CkeConfig()
    d = cp.init_data(cfg)
    assert (cfg.ncells, cfg.nvertlevels) == (2800, 100)
    assert not _fits(d.adv_cells, cfg.ncells, 100, dtype)


def _crowded(distinct, nvert=64, nedges=160, ncells=400):
    """Connectivity whose first tile at `nvert` f32 names exactly `distinct`
    cells and every other tile at most seven."""
    tile = group.tile_edges(nvert, torch.float32)
    cells = torch.arange(nedges * 10, dtype=torch.int32).remainder(7)
    cells[:tile * 10] = torch.arange(tile * 10).remainder(distinct) + 100
    return cells.view(nedges, 10).contiguous(), ncells


@pytest.mark.parametrize("over", [0, 1])
def test_a_stage_at_capacity_fits_and_one_more_cell_does_not(over):
    g = group.level_groups(64, torch.float32)
    cap = group.CARRY * group.THREADS // g
    cells, ncells = _crowded(cap + over)
    tm = group.tile_map(cells, ncells, group.tile_edges(64, torch.float32))
    assert tm.width == cap + over
    assert group.fits(tm, ncells, 64, 10, torch.float32) == (not over)


def test_fit_refuses_more_slots_another_tile_or_wide_offsets():
    cells, ncells = _hex(6, 8)
    tm = group.tile_map(cells, ncells, group.tile_edges(60, torch.float32))
    assert group.fits(tm, ncells, 60, 10, torch.float32)
    assert not group.fits(tm, ncells, 60, 11, torch.float32)
    assert not group.fits(tm, ncells, 60, 10, torch.float64)  # another tile
    assert not group.fits(tm, 2**31 // 60 + 1, 60, 10, torch.float32)


def _cfg(ntracers=3, dtype="float64", nvert=7, **kw):
    base = dict(mesh="planar_hex", nx=6, ny=8)
    return with_overrides(CkeConfig(), **{**base, **kw}, nvertlevels=nvert,
                          ntracers=ntracers, dtype=dtype)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("nvert", [7, 60])
def test_group_plain_is_the_per_tracer_plain_bit_for_bit(dtype, nvert):
    cfg = _cfg(4, dtype, nvert)
    d = cp.init_data(cfg)
    c3 = coef3_of(cfg)
    tm = group.tile_map(d.adv_cells, cfg.ncells,
                        group.tile_edges(nvert, d.tracer.dtype))
    got = group.cke_group(tm, d.adv_coefs, d.adv_coefs3, d.tracer,
                          d.cell_mask, d.ntf, d.adv_mask, c3)
    assert got.shape == (4, cfg.nedges, nvert)
    for i in range(4):
        want = krows.cke_rows_plain(d.adv_cells, d.adv_coefs, d.adv_coefs3,
                                    d.tracer[i] * d.cell_mask, d.ntf,
                                    d.adv_mask, c3)
        assert torch.equal(got[i], want), i


def _step(cfg, d, n=1):
    step2, aux, _ = registry._materialize(registry.get("cke", "pallas_rows"),
                                          cfg, d)
    before = trace.counts()
    got = get_spec("cke").loop_runner(step2, aux, n)(d)
    after = trace.counts()
    return got, aux, {k: after.get(k, 0) - before.get(k, 0)
                      for k in ("cke_mesh_passes", "cke_group_launches")}


def test_the_map_is_built_in_set_up_and_kept_while_unwritten(monkeypatch):
    cfg = _cfg()
    d = cp.init_data(cfg)
    step2, aux, _ = registry._materialize(registry.get("cke", "pallas_rows"),
                                          cfg, d)
    tm = aux(d.adv_cells, d.tracer)
    loop = get_spec("cke").loop_runner(step2, aux, 2)
    loop(d)
    assert aux(d.adv_cells, d.tracer) is tm
    # a one-table set-up builds no map
    built = []
    real = group.tile_map
    monkeypatch.setattr(group, "tile_map",
                        lambda *a: built.append(a) or real(*a))
    registry._materialize(registry.get("cke", "pallas_rows"), _cfg(1),
                          cp.init_data(_cfg(1)))
    assert built == []


def test_the_map_is_built_again_after_the_connectivity_is_written():
    """A write in place (the same tensor, its version bumped) or another
    tensor of the same values gives a new map; the step after the write
    computes from the new connectivity."""
    cfg = _cfg()
    d = cp.init_data(cfg)
    got, aux, _ = _step(cfg, d)
    tm = aux(d.adv_cells, d.tracer)
    d.adv_cells[0, 0] = d.adv_cells[40, 3]
    d.adv_cells[1].copy_(d.adv_cells[1].flip(0))
    step2 = registry._materialize(registry.get("cke", "pallas_rows"), cfg, d)[0]
    after = get_spec("cke").loop_runner(step2, aux, 1)(d)
    new = aux(d.adv_cells, d.tracer)
    assert new is not tm
    assert torch.equal(new.local, group.tile_map(d.adv_cells, cfg.ncells,
                                                 new.tile).local)
    assert not torch.equal(after, got)
    for i in range(cfg.ntracers):
        want = krows.cke_rows_plain(d.adv_cells, d.adv_coefs, d.adv_coefs3,
                                    d.tracer[i] * d.cell_mask, d.ntf,
                                    d.adv_mask, coef3_of(cfg))
        assert torch.equal(after[i], want), i
    same = d.adv_cells.clone()
    assert aux(same, d.tracer) is not new


def test_an_inference_tensor_builds_the_map_each_time():
    cfg = _cfg()
    with torch.inference_mode():
        d = cp.init_data(cfg)
    get = group.tiles()
    a = get(d.adv_cells, d.tracer)
    b = get(d.adv_cells, d.tracer)
    assert a is not b and torch.equal(a.local, b.local)


@pytest.mark.parametrize("ntracers", [1, 3])
def test_one_table_and_random_groups_take_k3_once_a_tracer(ntracers):
    """A 2-D tracer is no group; the miniapp's random connectivity does not
    fit: both run the per-tracer step, one pass a tracer, no K3g."""
    cfg = with_overrides(CkeConfig(), ncells=2800, nedges=256,
                         nvertlevels=100, ntracers=ntracers)
    d = cp.init_data(cfg)
    got, _, rises = _step(cfg, d)
    assert rises == {"cke_mesh_passes": ntracers, "cke_group_launches": 0}
    flux = got if ntracers > 1 else got[None]
    tracers = d.tracer if ntracers > 1 else d.tracer[None]
    for i in range(ntracers):
        want = krows.cke_rows_plain(d.adv_cells, d.adv_coefs, d.adv_coefs3,
                                    tracers[i] * d.cell_mask, d.ntf,
                                    d.adv_mask, coef3_of(cfg))
        assert torch.equal(flux[i], want), i


def test_a_group_on_the_mesh_takes_k3g_once_a_step():
    cfg = _cfg(5, "float32", 60)
    d = cp.init_data(cfg)
    got, _, rises = _step(cfg, d, n=3)
    assert rises == {"cke_mesh_passes": 3, "cke_group_launches": 3}
    assert got.shape == (5, cfg.nedges, 60)


def test_the_wrapper_refuses_a_map_that_does_not_fit():
    cfg = _cfg(3, "float32", 60)
    d = cp.init_data(cfg)
    tm = group.tile_map(d.adv_cells, cfg.ncells, 5)
    with pytest.raises(ValueError, match="does not fit"):
        group.cke_group(tm, d.adv_coefs, d.adv_coefs3, d.tracer, d.cell_mask,
                        d.ntf, d.adv_mask, coef3_of(cfg))
    tm = group.tile_map(d.adv_cells, cfg.ncells, 16)
    with pytest.raises(TypeError, match="int16"):
        group.cke_group(tm._replace(local=tm.local.int()), d.adv_coefs,
                        d.adv_coefs3, d.tracer, d.cell_mask, d.ntf,
                        d.adv_mask, coef3_of(cfg))
    with pytest.raises(ValueError, match="shape"):
        group.cke_group(tm, d.adv_coefs, d.adv_coefs3, d.tracer,
                        d.cell_mask[:-1], d.ntf, d.adv_mask, coef3_of(cfg))


def _rehearse(tm, c1, c3, tracers, cell_mask, ntf, adv_mask, coef3):
    """csrc/cke_group.cu's addressing, tile by tile on flat tensors: thread
    j of the block copies stage vectors v = j + c * THREADS (c < CARRY) of
    its tile, cell v // groups and level group v % groups, to byte v * 16
    of the stage, times its cellMask vector; thread el * lanes + g takes
    edge el's level groups g and g + lanes (lanes for half the groups)
    and reads slot i's row at byte local * groups * 16 + g * 16 and 16 *
    lanes past it.  The padded levels of a ragged row are zeros.  Returns
    the (T, E, K) flux from those reads, slot order."""
    t, c, k = tracers.shape
    e, a = tm.local.shape
    w = group.VECTOR // tracers.element_size()
    groups = -(-k // w)
    lanes = group.edge_lanes(-(-groups // 2))
    pitch = groups * w
    pad = torch.zeros((t, c, pitch), dtype=tracers.dtype)
    pad[..., :k] = tracers
    mpad = torch.zeros((c, pitch), dtype=tracers.dtype)
    mpad[:, :k] = cell_mask
    out = torch.full((t, e, k), float("nan"), dtype=tracers.dtype)
    for tile in range(tm.cells.shape[0]):
        stage = torch.full((t, group.CARRY * group.THREADS * w), float("nan"),
                           dtype=tracers.dtype)
        nvec = int(tm.counts[tile]) * groups
        for j in range(group.THREADS):
            for carry in range(group.CARRY):
                v = j + carry * group.THREADS
                if v < nvec:
                    cell = int(tm.cells[tile, v // groups])
                    lev = v % groups * w
                    stage[:, v * w:(v + 1) * w] = (
                        pad[:, cell, lev:lev + w] * mpad[cell, lev:lev + w])
        e0 = tile * tm.tile
        for j, h in ((j, h) for j in range(group.THREADS) for h in (0, 1)):
            el, g = divmod(j, lanes)
            k0 = (g + h * lanes) * w
            if el >= min(tm.tile, e - e0) or k0 >= k:
                continue
            edge = e0 + el
            rows = [stage[:, int(tm.local[edge, i]) * pitch + k0:
                          int(tm.local[edge, i]) * pitch + k0 + w]
                    for i in range(a)]
            kk = min(w, k - k0)
            flux = slot_order_flux(
                [r[:, None, :kk] for r in rows], c1[edge:edge + 1],
                c3[edge:edge + 1], ntf[edge:edge + 1, k0:k0 + kk],
                adv_mask[edge:edge + 1, k0:k0 + kk], coef3)
            out[:, edge, k0:k0 + kk] = flux[:, 0]
    return out


@pytest.mark.parametrize("nx,ny,nvert,dtype", [
    (4, 4, 60, "float32"), (4, 4, 60, "float64"), (6, 8, 7, "float32"),
    (5, 6, 9, "float64")])
def test_rehearsal_of_the_kernels_addressing_gives_the_flux(nx, ny, nvert,
                                                            dtype):
    cfg = _cfg(2, dtype, nvert, nx=nx, ny=ny)
    d = cp.init_data(cfg)
    c3 = coef3_of(cfg)
    tm = group.tile_map(d.adv_cells, cfg.ncells,
                        group.tile_edges(nvert, d.tracer.dtype))
    assert tm.width * group.level_groups(nvert, d.tracer.dtype) <= (
        group.CARRY * group.THREADS)
    got = _rehearse(tm, d.adv_coefs, d.adv_coefs3, d.tracer, d.cell_mask,
                    d.ntf, d.adv_mask, c3)
    want = group.cke_group_plain(tm, d.adv_coefs, d.adv_coefs3, d.tracer,
                                 d.cell_mask, d.ntf, d.adv_mask, c3)
    assert torch.equal(got, want)


def test_the_group_step_leaves_its_inputs_alone():
    cfg = _cfg(3, "float32", 60)
    d = cp.init_data(cfg)
    kept = {f.name: getattr(d, f.name).clone() for f in dataclasses.fields(d)}
    _step(cfg, d)
    for name, t in kept.items():
        assert torch.equal(getattr(d, name), t), name
