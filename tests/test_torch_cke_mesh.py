"""The CKE edge flux on MPAS-Tools' periodic planar hexagonal mesh and over a
tracer group, on the CPU: the mesh (`cdk_torch/kernels/cke/mesh.py`) and
its advection stencil, the same connectivity as the benchmark's own build
(`cdkbench/problems/mpaso.py`, from the cells' positions), the config's
init-only settings, and the group step of the family's loop (K3's plain
version here) against the benchmark's float64 reference
(`cdkbench/reference/cke.py`) and the port's reference, tracer by tracer.
Gates are the family's: f64 per-point relative error < errTol, f32 rel L1
< 1e-6.  No jax."""

import dataclasses
import importlib.util
from pathlib import Path

import pytest
import torch

import cdk_torch.kernels  # noqa: F401  (registers the variants)
from cdk_torch.core import registry, trace
from cdk_torch.core.config import CkeConfig, with_overrides
from cdk_torch.core.norms import pointwise_check, rel_l1
from cdk_torch.harness.specs import get_spec
from cdk_torch.kernels.cke import mesh
from cdk_torch.kernels.cke import problem as cp
from cdk_torch.kernels.cke import reference as cref
from cdk_torch.kernels.cke import rows as krows

ROOT = Path(__file__).resolve().parents[1]
SIZES = [(4, 4), (6, 8), (5, 6), (7, 10)]


def _bench(kind, name):
    """cdkbench/<kind>/<name>.py, loaded by path."""
    spec = importlib.util.spec_from_file_location(
        f"bench_{kind}_{name}", ROOT / "cdkbench" / kind / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("nx,ny", SIZES)
def test_three_edges_a_cell_six_neighbours_symmetric(nx, ny):
    m = mesh.planar_hex(nx, ny)
    c = nx * ny
    coc, coe = m.cells_on_cell.long(), m.cells_on_edge.long()
    assert coc.shape == (c, 6) and coe.shape == (3 * c, 2)
    assert m.cells_on_cell.dtype == torch.int32
    # each cell owns three edges and lies on six
    assert torch.equal(coe[:, 0], torch.arange(c).repeat_interleave(3))
    assert torch.equal(torch.bincount(coe.reshape(-1), minlength=c),
                       torch.full((c,), 6))
    # six distinct neighbours, none the cell itself
    assert all(len(set(row)) == 6 for row in coc.tolist())
    assert not (coc == torch.arange(c)[:, None]).any()
    # symmetric: the neighbour the opposite way round is the cell
    opposite = coc[coc, (torch.arange(6) + 3) % 6]
    assert torch.equal(opposite, torch.arange(c)[:, None].expand(c, 6))
    # every edge joins two neighbours, and each pair of neighbours has one
    pairs = {tuple(sorted(p)) for p in coe.tolist()}
    assert len(pairs) == 3 * c
    assert pairs == {tuple(sorted((i, int(n)))) for i in range(c) for n in coc[i]}


@pytest.mark.parametrize("nx,ny", SIZES)
def test_ten_distinct_adv_cells_led_by_the_edge(nx, ny):
    m = mesh.planar_hex(nx, ny)
    adv = mesh.adv_cells_for_edge(m)
    assert adv.shape == (3 * nx * ny, 10) and adv.dtype == torch.int32
    assert all(len(set(row)) == 10 for row in adv.tolist())
    assert torch.equal(adv[:, :2], m.cells_on_edge)
    coc = m.cells_on_cell.long()
    for e, row in enumerate(adv.long().tolist()):
        c1, c2 = row[:2]
        # the union of both cells' neighbourhoods, c1's first
        assert set(row) == {c1, c2} | set(coc[c1].tolist()) | set(coc[c2].tolist())
        assert row[2:7] == [n for n in coc[c1].tolist() if n != c2]


@pytest.mark.parametrize("nx,ny", SIZES)
def test_periodic_wrap_at_both_seams(nx, ny):
    coc = mesh.planar_hex(nx, ny).cells_on_cell.long()

    def rc(cell):
        return divmod(int(cell), nx)

    for row in range(ny):
        # the west seam: column 0's west neighbour is its row's last cell
        assert rc(coc[row * nx, 0]) == (row, nx - 1)
        assert rc(coc[row * nx + nx - 1, 3]) == (row, 0)
    for col in range(nx):
        # the south seam: row 0's south neighbours lie in the top row, and
        # the top row's north neighbours in row 0
        assert {rc(coc[col, k])[0] for k in (1, 2)} == {ny - 1}
        assert {rc(coc[(ny - 1) * nx + col, k])[0] for k in (4, 5)} == {0}
    # an odd row's cells sit half a cell east: the top row's NW neighbour
    # of column 0 is column 0 of row 0, its NE column 1
    assert rc(coc[(ny - 1) * nx, 5]) == (0, 0)
    assert rc(coc[(ny - 1) * nx, 4]) == (0, 1)


@pytest.mark.parametrize("nx,ny", [(4, 4), (6, 8)])
def test_program_mesh_is_the_benchmarks(nx, ny):
    """The program's index-formula build and the benchmark's build from the
    cells' positions give the same connectivity."""
    bench = _bench("problems", "mpaso")
    m = mesh.planar_hex(nx, ny)
    assert torch.equal(bench.neighbours(nx, ny, "cpu"), m.cells_on_cell.long())
    assert torch.equal(bench.adv_cells(nx, ny, "cpu"),
                       mesh.adv_cells_for_edge(m))


def test_benchmark_tiny_is_a_mesh():
    bench = _bench("problems", "mpaso")
    t = bench.TINY
    assert (t["ncells"], t["nedges"]) == (t["nx"] * t["ny"], 3 * t["nx"] * t["ny"])
    assert torch.equal(bench.adv_cells(t["nx"], t["ny"], "cpu"),
                       mesh.adv_cells_for_edge(mesh.planar_hex(t["nx"], t["ny"])))


@pytest.mark.parametrize("nx,ny", [(3, 4), (4, 5), (4, 2)])
def test_mesh_refuses_what_is_no_periodic_hexagon(nx, ny):
    with pytest.raises(ValueError, match="planar_hex"):
        mesh.planar_hex(nx, ny)
    with pytest.raises(ValueError, match="planar_hex"):
        CkeConfig(mesh="planar_hex", nx=nx, ny=ny)


def test_config_mesh_and_group_are_init_only():
    """The fields stay the JAX package's; the mesh sets ncells, nedges and
    nadv; replace and with_overrides carry the settings over."""
    base = CkeConfig()
    assert (base.mesh, base.ntracers) == ("random", 1)
    hexa = with_overrides(base, mesh="planar_hex", nx=6, ny=8, ntracers=3)
    assert {f.name for f in dataclasses.fields(hexa)} == set(dataclasses.asdict(base))
    assert (hexa.ncells, hexa.nedges, hexa.nadv) == (48, 144, 10)
    f32 = with_overrides(hexa, dtype="float32")
    assert (f32.mesh, f32.nx, f32.ny, f32.ntracers, f32.ncells) == (
        "planar_hex", 6, 8, 3, 48)
    assert CkeConfig(mesh="planar_hex", nx=6, ny=10).nedges == 180
    # the mesh sets the sizes: another value of one of them is refused
    with pytest.raises(ValueError, match="ncells 48 given with the 6 x 10"):
        dataclasses.replace(hexa, ny=10)
    with pytest.raises(ValueError, match="nadv 8 given"):
        CkeConfig(mesh="planar_hex", nx=6, ny=8, nadv=8)
    for bad in (dict(mesh="voronoi"), dict(ntracers=0)):
        with pytest.raises(ValueError):
            CkeConfig(**bad)
    with pytest.raises(ValueError, match="unknown config fields"):
        with_overrides(base, meshes=1)


def test_config_compares_and_prints_its_settings():
    """Two configs that build different data differ: the settings count in
    ==, hash and repr."""
    hexa = CkeConfig(mesh="planar_hex", nx=6, ny=8)
    flat = CkeConfig(ncells=48, nedges=144, nadv=10)
    assert hexa != flat
    assert hexa == CkeConfig(mesh="planar_hex", nx=6, ny=8)
    assert hash(hexa) == hash(CkeConfig(mesh="planar_hex", nx=6, ny=8))
    assert hexa != with_overrides(hexa, ntracers=2)
    assert len({hexa, flat, with_overrides(hexa, ntracers=2)}) == 3
    assert "mesh='planar_hex', nx=6, ny=8, ntracers=1" in repr(hexa)
    assert CkeConfig() == CkeConfig() and "mesh='random'" in repr(CkeConfig())


@pytest.mark.parametrize("device_init", [False, True])
def test_init_data_on_the_mesh(device_init):
    """On the planar_hex mesh the connectivity is the mesh's stencil, and a
    group draws one table a tracer, zero below each cell's bottom, with
    the same other fields as one table."""
    cfg = CkeConfig(mesh="planar_hex", nx=6, ny=8, nvertlevels=7, ntracers=3,
                    device_init=device_init)
    d = cp.init_data(cfg)
    assert torch.equal(d.adv_cells, mesh.adv_cells_for_edge(mesh.planar_hex(6, 8)))
    assert d.tracer.shape == (3, 48, 7) and d.tracer.is_contiguous()
    assert not (d.tracer * (1 - d.cell_mask)).any()
    assert all(not torch.equal(d.tracer[0], d.tracer[i]) for i in (1, 2))
    one = cp.init_data(dataclasses.replace(cfg, ntracers=1))
    assert one.tracer.shape == (48, 7)
    for name in ("cell_mask", "max_level", "adv_cells"):
        assert torch.equal(getattr(one, name), getattr(d, name)), name


def _group_cfg(ntracers, dtype):
    return CkeConfig(mesh="planar_hex", nx=6, ny=8, nvertlevels=7,
                     ntracers=ntracers, dtype=dtype)


def _raw(d):
    return {f.name: getattr(d, f.name) for f in dataclasses.fields(d)}


def _assert_gate(cfg, got, want):
    if cfg.dtype == "float64":
        assert pointwise_check(got, want, cfg.errtol)[0] == 0
    else:
        assert rel_l1(got, want) < 1e-6


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("ntracers", [1, 3])
def test_group_loop_against_both_references(ntracers, dtype):
    """The family's loop over pallas_rows (on the CPU K3g's plain version
    for the group, K3's for one table), as registry_loop runs it: every
    tracer's flux from its own table, against the benchmark's float64
    reference and the port's reference tracer by tracer; one pass over the
    edge fields a step, the group's taken whole by K3g."""
    cfg = _group_cfg(ntracers, dtype)
    d = cp.init_data(cfg)
    step2, aux, vloop = registry._materialize(
        registry.get("cke", "pallas_rows"), cfg, d)
    assert vloop is None
    loop = get_spec("cke").loop_runner(step2, aux, 1)
    before = trace.counts()
    got = loop(d)
    after = trace.counts()
    assert after["cke_mesh_passes"] - before.get("cke_mesh_passes", 0) == 1
    assert (after.get("cke_group_launches", 0)
            - before.get("cke_group_launches", 0)) == (ntracers > 1)
    tables = d.tracer if ntracers > 1 else d.tracer[None]
    flux = got if ntracers > 1 else got[None]
    assert flux.shape == (ntracers, cfg.nedges, cfg.nvertlevels)
    bench = _bench("reference", "cke").interval(
        {"coef3rdorder": cfg.coef3rdorder}, _raw(d), 1, "float64")["flux"]
    bench = bench if ntracers > 1 else bench[None]
    c3 = cref.coef3_of(cfg)
    for i, tracer in enumerate(tables):
        mine = cref.edge_flux(d.adv_cells, d.adv_coefs, d.adv_coefs3, tracer,
                              d.cell_mask, d.ntf, d.adv_mask, c3)
        _assert_gate(cfg, flux[i], mine)
        if dtype == "float64":
            _assert_gate(cfg, flux[i], bench[i])
        else:
            # the benchmark's reference takes coef3rdOrder exact, the f32
            # form its f32 rounding (5e-8 relative on the third-order term)
            assert rel_l1(flux[i], bench[i]) < 1e-6
        assert float(flux[i].abs().max()) > 0


@pytest.mark.parametrize("n", [0, 2, 3])
def test_group_loop_over_several_steps(n):
    """n steps of a group: each the fluxes of every tracer, the last
    returned (zeros for none), one pass a step (K3g takes the group)."""
    cfg = _group_cfg(3, "float64")
    d = cp.init_data(cfg)
    step2, aux, _ = registry._materialize(registry.get("cke", "pallas_rows"), cfg, d)
    loop = get_spec("cke").loop_runner
    before = trace.counts().get("cke_mesh_passes", 0)
    got = loop(step2, aux, n)(d)
    assert trace.counts().get("cke_mesh_passes", 0) - before == n
    assert got.shape == (3, cfg.nedges, cfg.nvertlevels)
    if n == 0:
        assert not got.any()
    else:
        assert torch.equal(got, loop(step2, aux, 1)(d))


@pytest.mark.parametrize("variant", sorted(registry.variants("cke")))
def test_every_variant_takes_a_group_in_the_loop(variant):
    """The family's loop over a group runs the variant's one-table step
    once per tracer: each tracer's flux is the step's on its own table."""
    cfg = _group_cfg(3, "float32")
    d = cp.init_data(cfg)
    step2, aux, _ = registry._materialize(registry.get("cke", variant), cfg, d)
    got = get_spec("cke").loop_runner(step2, aux, 1)(d)
    assert got.shape == (3, cfg.nedges, cfg.nvertlevels)
    for i in range(3):
        one = step2(aux, dataclasses.replace(d, tracer=d.tracer[i]))
        assert torch.equal(got[i], one)


def test_k3_writes_into_the_group_slice():
    """K3's wrapper writes a flux into the slice it is given and returns
    it; the group step hands it each tracer's slice."""
    cfg = _group_cfg(3, "float64")
    d = cp.init_data(cfg)
    t = d.tracer[1] * d.cell_mask
    args = (d.adv_cells, d.adv_coefs, d.adv_coefs3, t, d.ntf, d.adv_mask,
            cref.coef3_of(cfg))
    out = torch.full((3, cfg.nedges, cfg.nvertlevels), float("nan"),
                     dtype=torch.float64)
    dst = out[1]
    assert krows.cke_rows(*args, out=dst) is dst
    assert torch.equal(dst, krows.cke_rows_plain(*args))
    assert out[0].isnan().all() and out[2].isnan().all()
    with pytest.raises(ValueError, match="shape"):
        krows.cke_rows(*args, out=out[1, :-1])


def test_group_step_hands_k3_each_tracers_slice(monkeypatch):
    """Through the family's loop, on connectivity whose tile map does not
    fit K3g (the miniapp's random draw), K3 writes each tracer's flux
    straight into its slice of the (T, E, K) result: no flux is copied
    after it."""
    cfg = CkeConfig(ncells=2800, nedges=256, nvertlevels=100, ntracers=3)
    d = cp.init_data(cfg)
    step2, aux, _ = registry._materialize(registry.get("cke", "pallas_rows"), cfg, d)
    seen = []
    real = krows.cke_rows

    def spy(*a, **k):
        seen.append(a[-1])
        return real(*a, **k)

    monkeypatch.setattr(krows, "cke_rows", spy)
    got = get_spec("cke").loop_runner(step2, aux, 1)(d)
    assert [o.data_ptr() for o in seen] == [g.data_ptr() for g in got]
