"""The cubed-sphere DSS family `biharmonic_dss_cube` on the CPU (no jax):
the mesh and its assembly map (`kernels/biharmonic/cube.py`) against an
assembly built here from each GLL point's integer lattice position on a
cube of side 3*ne, the trusted reference against that assembly, K26's
plain version (the CPU path of `fused_operator_cube_sq_x3`) against the
reference, the independence of the element order, the counters and spans
the benchmark reads, and K26's schedule rehearsed lane by lane (its
addressing at both load widths, float64 products in place of the tensor
cores).  K26 itself runs on the card (tests/test_torch_gpu.py).

    python -m pytest tests/test_torch_dss_cube.py -q
"""

from __future__ import annotations

import dataclasses
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import cdk_torch.kernels  # noqa: F401  (registers the variants)
from cdk_torch.core import registry, trace
from cdk_torch.core.config import BiharmonicConfig
from cdk_torch.core.registry import UnsupportedConfigError
from cdk_torch.harness.specs import get_spec
from cdk_torch.kernels.biharmonic import cube
from cdk_torch.kernels.biharmonic import dss_cube as dc
from cdk_torch.kernels.biharmonic.problem import init_data
from cdk_torch.kernels.biharmonic.reference import laplace_sphere_wk

ROOT = Path(__file__).resolve().parents[1]
FAMILY = "biharmonic_dss_cube"
CHAMPION = "fused_operator_cube_sq_x3"


def lattice_ids(ne: int) -> torch.Tensor:
    """(6*ne^2, 16) the id of each element's GLL point (e, i*4 + j), equal
    ids for equal positions: point (i, j) of element (f, a, b) lies at
    3*ne*O + (3a + i)*U + (3b + j)*V on the cube [0, 3*ne]^3 of face f's
    (O, U, V), read from the module's FACES only."""
    faces = torch.tensor(cube.FACES)
    f, a, b, i, j = torch.meshgrid(torch.arange(6), torch.arange(ne),
                                   torch.arange(ne), torch.arange(4),
                                   torch.arange(4), indexing="ij")
    o, u, v = faces[f, 0], faces[f, 1], faces[f, 2]
    pos = (3 * ne * o + (3 * a + i)[..., None] * u + (3 * b + j)[..., None] * v)
    _, ids = torch.unique(pos.reshape(-1, 3), dim=0, return_inverse=True)
    return ids.reshape(6 * ne * ne, 16)


def lattice_sum(s: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """The sum over sharers of s (e, 16, ...) by the lattice ids."""
    flat = s.reshape(ids.numel(), -1)
    tot = torch.zeros((int(ids.max()) + 1, flat.shape[1]), dtype=s.dtype)
    tot.index_add_(0, ids.reshape(-1), flat)
    return tot[ids.reshape(-1)].reshape(s.shape)


def slot_groups(amap: torch.Tensor) -> set:
    """The partition of the (e, p) slots the map gives: each point's
    sharers with itself, as frozensets of rows e*16 + p."""
    e = amap.shape[0]
    groups = {r: {r} for r in range(e * 16)}
    for ei in range(e):
        for s, p in enumerate(cube.BOUNDARY):
            groups[ei * 16 + p] |= {int(x) for x in amap[ei, s] if x >= 0}
    return {frozenset(g) for g in groups.values()}


@pytest.mark.parametrize("ne", [2, 3])
def test_mesh_counts_and_a_symmetric_map(ne):
    amap = cube.build_map(6 * ne * ne)
    e = 6 * ne * ne
    assert amap.dtype == torch.int32 and amap.shape == (e, 12, 3)
    sharers = torch.ones(e, 16, dtype=torch.long)
    sharers[:, list(cube.BOUNDARY)] += (amap >= 0).sum(-1)
    # every point counted once over its sharers
    assert int(round(float((1.0 / sharers.double()).sum()))) == 6 * (3 * ne) ** 2 + 2
    assert sorted(torch.unique(sharers).tolist()) == [1, 2, 3, 4]
    assert int((sharers == 3).sum()) == 8 * 3  # the 8 cube corners, 3 sharers each
    assert int((sharers == 1).sum()) == 4 * e  # the interior points
    rows = {(ei * 16 + p, int(x)) for ei in range(e)
            for s, p in enumerate(cube.BOUNDARY) for x in amap[ei, s] if x >= 0}
    assert all((b, a) in rows for a, b in rows)
    assert all(a != b for a, b in rows)


@pytest.mark.parametrize("ne", [1, 2, 3])
def test_map_is_the_lattice_partition(ne):
    ids = lattice_ids(ne)
    want = {}
    for r, i in enumerate(ids.reshape(-1).tolist()):
        want.setdefault(i, set()).add(r)
    assert slot_groups(cube.build_map(6 * ne * ne)) == {
        frozenset(g) for g in want.values()}


def test_neighbours_across_the_seams_rotate_and_reverse():
    """Inside a face an edge meets its opposite edge, unreversed; across
    the seams some edges meet a rotated edge and some run reversed."""
    nbr, nedge, rev = cube.neighbours(3)
    assert torch.equal(nbr[nbr, nedge], torch.arange(54)[:, None].expand(54, 4))
    same_face = nbr // 9 == torch.arange(54)[:, None] // 9
    assert torch.equal(nedge[same_face], ((torch.arange(4) + 2) % 4).expand(54, 4)[same_face])
    assert not rev[same_face].any()
    seam = ~same_face
    assert int(seam.sum()) == 6 * 4 * 3
    assert rev[seam].any() and (~rev[seam]).any()
    assert (nedge[seam] != ((torch.arange(4) + 2) % 4).expand(54, 4)[seam]).any()


@pytest.mark.parametrize("nelemd", [0, 12, 16, 25, 5401])
def test_other_counts_are_refused(nelemd):
    with pytest.raises(UnsupportedConfigError, match="6 \\* ne\\^2"):
        cube.cube_ne(nelemd)
    cfg = BiharmonicConfig(nelemd=max(nelemd, 1), nlev=2, qsize=1)
    for name in (CHAMPION, "reference_jnp"):
        with pytest.raises(UnsupportedConfigError):
            registry.get(FAMILY, name).fn(cfg)


def _cfg(ne, dtype="float64", **kw):
    return BiharmonicConfig(nelemd=6 * ne * ne, nlev=3, qsize=2, dtype=dtype,
                            rrearth=0.1, **kw)


def _lattice_reference(ne, d, rr):
    """laplace → lattice DSS / lattice DSS(spheremp) → laplace."""
    ids = lattice_ids(ne)

    def bc(a):
        return a[:, None, None]

    def lap(x):
        return laplace_sphere_wk(x, d.dvv, bc(d.dinv), bc(d.spheremp),
                                 bc(d.tensorvisc), rr)

    e, nq, nk = d.qtens.shape[:3]
    w = 1.0 / lattice_sum(d.spheremp.reshape(e, 16), ids)
    s = lap(d.qtens).reshape(e, nq * nk, 16).transpose(1, 2)
    s = lattice_sum(s.contiguous(), ids) * w[..., None]
    return lap(s.transpose(1, 2).reshape(d.qtens.shape))


@pytest.mark.parametrize("ne", [2, 3])
def test_reference_matches_the_lattice_assembly(ne):
    cfg = _cfg(ne)
    d = init_data(cfg)
    got = registry.get(FAMILY, "reference_jnp").fn(cfg)(d)
    want = _lattice_reference(ne, d, 0.1)
    assert float((got - want).norm() / want.norm()) < 1e-13


@pytest.mark.parametrize("ne,steps", [(2, 1), (2, 6), (3, 3)])
def test_x3_chain_within_its_gate(ne, steps):
    """The champion's loop (K1's plain bridge-in, then K26's plain step)
    against the reference chained at float64, within the registered
    gate, and its one step against the reference's."""
    cfg = _cfg(ne, "float32")
    d = init_data(cfg)
    var = registry.get(FAMILY, CHAMPION)
    assert var.verify_tol == 5e-5 and not var.supports_f64
    step2, aux, loop = registry._materialize(var, cfg, d)
    ref = registry.get(FAMILY, "reference_jnp").fn(cfg)
    d64 = d.to(torch.float64)
    q = d64.qtens
    for _ in range(steps):
        q = ref(dataclasses.replace(d64, qtens=q))
    out = loop(d, steps)
    assert out.shape == d.qtens.shape
    assert float((out.double() - q).norm() / q.norm()) < 5e-5
    one = ref(d64)
    assert float((step2(aux, d).double() - one).norm() / one.norm()) < 5e-5


def test_permuted_element_order_gives_the_permuted_result():
    """The elements laid out in another order (a map built for it, every
    element field and the state permuted alike) give the permuted result,
    bit for bit: nothing depends on the face-major order."""
    ne = 3
    cfg = _cfg(ne, "float32")
    d = init_data(cfg)
    perm = torch.randperm(6 * ne * ne, generator=torch.Generator().manual_seed(5))
    fields = ("dinv", "spheremp", "tensorvisc", "qtens")
    dp = dataclasses.replace(d, **{f: getattr(d, f)[perm].contiguous() for f in fields})
    amap, pmap = cube.build_map(cfg.nelemd), cube.build_map(cfg.nelemd, order=perm)
    assert slot_groups(pmap) == {frozenset(int(torch.nonzero(perm == r // 16)) * 16 + r % 16
                                           for r in g) for g in slot_groups(amap)}
    L = dc.build_element_operator(d.dvv, d.dinv, d.spheremp, d.tensorvisc, 0.1)
    Lp = dc.build_element_operator(dp.dvv, dp.dinv, dp.spheremp, dp.tensorvisc, 0.1)
    w, wp = dc.dss_cube_weights(d.spheremp, amap), dc.dss_cube_weights(dp.spheremp, pmap)
    t = torch.rand(cfg.nelemd, 16, 6, generator=torch.Generator().manual_seed(6))
    got = dc.dss_cube_step_plain(Lp, pmap, wp, t[perm])
    assert torch.equal(got, dc.dss_cube_step_plain(L, amap, w, t)[perm])
    ref = dc.biharmonic_wk_dss_cube_reference
    assert torch.equal(ref(dp.qtens, dp.dvv, dp.dinv, dp.spheremp, dp.tensorvisc, 0.1, pmap),
                       ref(d.qtens, d.dvv, d.dinv, d.spheremp, d.tensorvisc, 0.1, amap)[perm])


def test_loop_counts_its_passes_and_reuses_its_set_up():
    """A 6-step interval: one pass for the bridge-in and one a step (7),
    K1 read the state where it lies, no kernel launched on the CPU; the
    map is built under cdk.cube.map inside cdk.prepare once, then reused."""
    cfg = _cfg(2, "float32")
    d = init_data(cfg)
    _, _, loop = registry._materialize(registry.get(FAMILY, CHAMPION), cfg, d)
    before = trace.counts()
    loop(d, 6)
    loop(d, 6)
    after = trace.counts()
    diff = {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}
    assert diff == {"cube_state_passes": 14, "natural_loads": 2,
                    "prepare_reuses": 2}
    assert dc.dss_cube_step.launches == 0
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        registry._materialize(registry.get(FAMILY, CHAMPION), cfg, d)[2](d, 2)
    names = [e.name for e in prof.events()]
    assert "cdk.cube.map" in names and "cdk.prepare" in names
    cube_map = next(e for e in prof.events() if e.name == "cdk.cube.map")
    parents = set()
    p = cube_map.cpu_parent
    while p is not None:
        parents.add(p.name)
        p = p.cpu_parent
    assert "cdk.prepare" in parents


def test_kernel_wrapper_refuses_what_it_cannot_run():
    cfg = _cfg(1, "float32")
    d = init_data(cfg)
    amap = cube.build_map(6)
    L = dc.build_element_operator(d.dvv, d.dinv, d.spheremp, d.tensorvisc, 0.1)
    w = dc.dss_cube_weights(d.spheremp, amap)
    t = torch.rand(6, 16, 5)
    with pytest.raises(TypeError, match="float32"):
        dc.dss_cube_step(L.double(), amap, w.double(), t.double())
    with pytest.raises(TypeError, match="int32"):
        dc.dss_cube_step(L, amap.long(), w, t)
    with pytest.raises(ValueError, match="want op"):
        dc.dss_cube_step(L, amap, w, t[:5])


def test_loop_and_step_through_the_spec():
    """The family's spec: its default is the smallest cube but one (ne 2),
    and its step chains as the loop does."""
    spec = get_spec(FAMILY)
    cfg = dataclasses.replace(spec.default_config(), nlev=2, qsize=1,
                              dtype="float32", rrearth=0.1)
    assert cfg.nelemd == 24
    d = spec.init(cfg, torch.device("cpu"))
    step2, aux, loop = registry._materialize(registry.get(FAMILY, CHAMPION), cfg, d)
    chained = spec.loop_runner(step2, aux, 2)(d)
    ref = registry.get(FAMILY, "reference_jnp").fn(cfg)
    d64 = d.to(torch.float64)
    want = ref(dataclasses.replace(d64, qtens=ref(d64)))
    assert spec.verify(cfg, chained.double().numpy(), want.numpy(), tol=5e-5).ok
    assert spec.verify(cfg, loop(d, 2).double().numpy(), want.numpy(), tol=5e-5).ok


def test_cli_run_biharmonic_dss_cube_exits_zero():
    proc = subprocess.run(
        [sys.executable, "-m", "cdk_torch", "run", FAMILY, "--device", "cpu",
         "--set", "nelemd=24", "--set", "nlev=4", "--set", "qsize=2",
         "--dtype", "float32", "--iters", "2", "--trials", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert CHAMPION in proc.stdout and "FAILED" not in proc.stdout


# K26's schedule (csrc/biharmonic_dss_cube.cu), mirrored: a warp an element
# and CHUNK columns in groups, lane (g, t) with points 2t, 2t+1, 8+2t, 9+2t,
# its corner q = t and edge points qe0, qe1, five sharers' rows a lane
K26_CHUNK = 128
SLOT = [0, 1, 2, 3, 4, -1, -1, 5, 6, -1, -1, 7, 8, 9, 10, 11]


def _pt(t, q):
    return 2 * t + (q & 1) + 8 * (q >> 1)


def _k26_rehearsal(op, amap, w, t, vec):
    """K26's arithmetic lane by lane as the kernel addresses it (float64
    products in place of the tensor cores) -> out, and how often each
    (element, point, column) was written."""
    e_n, _, ncol = t.shape
    rows = t.reshape(e_n * 16, ncol)
    gcols, nc = (32, 4) if vec else (16, 2)
    out = torch.zeros_like(t)
    writes = torch.zeros(t.shape, dtype=torch.long)
    for e in range(e_n):
        for c0 in range(0, ncol, K26_CHUNK):
            for cb in range(c0, min(c0 + K26_CHUNK, ncol), gcols):
                # each m-tile's 16 rows: row -> column, point -> value
                tiles = [dict() for _ in range(nc // 2)]
                for tq in range(4):
                    qe0 = 1 if tq in (0, 3) else 0
                    src, to = [], []
                    for n in range(5):
                        q = tq if n < 3 else (qe0 if n == 3 else 3 - qe0)
                        r = int(amap[e, SLOT[_pt(tq, q)], n if n < 3 else 0])
                        src.append(r if r >= 0 else e * 16 + _pt(tq, q))
                        to.append(q if r >= 0 else 4)
                    for g in range(8):
                        cols = ([cb + 4 * g + j for j in range(4)] if vec
                                else [cb + g, cb + g + 8])
                        ok = [(cb + 4 * g < ncol) if vec else c < ncol for c in cols]
                        for q in range(4):
                            for j, c in enumerate(cols):
                                v = rows[e * 16 + _pt(tq, q), c] if ok[j] else 0.0
                                for n in range(5):
                                    s = rows[src[n], c] if ok[j] else 0.0
                                    v = v + (s if to[n] == q else 0.0)
                                v = v * w[e, _pt(tq, q)]
                                mt, r = divmod(j, 2)
                                row = g + 8 * r
                                col, vals = tiles[mt].setdefault(row, (c, {}))
                                assert col == c  # every lane of a row takes its column
                                vals[_pt(tq, q)] = (v, ok[j])
                for tile in tiles:
                    for row, (c, vals) in tile.items():
                        assert sorted(vals) == list(range(16))
                        if not all(o for _, o in vals.values()):
                            continue
                        x = torch.stack([torch.as_tensor(vals[p][0]) for p in range(16)])
                        out[e, :, c] = op[e] @ x
                        writes[e, :, c] += 1
    return out, writes


@pytest.mark.parametrize("vec,ncol", [(True, 8), (True, 72), (False, 39), (False, 5),
                                      (True, 136)])
def test_k26_schedule_rehearsal(vec, ncol):
    """Every (element, point, column) written once, each m-tile row one
    column across its lanes, and the result K26's plain version's (at
    exact float64 products): the addressing of both load widths, ragged
    chunks and groups, the corner's padded slot at the cube corners."""
    e = 6
    gen = torch.Generator().manual_seed(ncol)
    amap = cube.build_map(e)
    sph = torch.rand((e, 4, 4), generator=gen, dtype=torch.float64) + 0.5
    w = dc.dss_cube_weights(sph, amap)
    op = torch.rand((e, 16, 16), generator=gen, dtype=torch.float64)
    t = torch.rand((e, 16, ncol), generator=gen, dtype=torch.float64)
    out, writes = _k26_rehearsal(op, amap, w, t, vec)
    assert torch.equal(writes, torch.ones_like(writes))
    want = torch.bmm(op, dc.dss_cube_sum(t, amap) * w[..., None])
    assert torch.allclose(out, want, rtol=1e-12, atol=1e-12)
