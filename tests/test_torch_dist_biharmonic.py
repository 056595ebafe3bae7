"""The port's domain-decomposed biharmonic (cdk_torch.dist.biharmonic)
against the JAX package's (cdk_tpu.dist.biharmonic) on bitwise-identical
inputs.

The JAX side runs on the conftest's 8 virtual CPU devices with its Pallas
kernels in interpret mode; the port runs on a mesh of P shards on the CPU,
where the window-fed K14 and the padded rowchain wrappers run their plain
versions.  Each JAX output is computed once per module.  Tolerances: rel L2
< 1e-13 at f64 (per-element products against JAX's grouped ones reorder
sums); serial and overlap forms, and the split and padded kstep forms,
bitwise; the bf16x3 f32 rowchain at its 5e-5 gate against the reference
(JAX on the CPU computes "high" products exactly, so not against JAX)."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from cdk_torch.core.config import BiharmonicConfig, with_overrides
from cdk_torch.core.norms import rel_l2
from cdk_torch.dist import biharmonic as tdist
from cdk_torch.dist import mesh as tmesh
from cdk_torch.kernels.biharmonic import dss2d_rowchain as trc
from cdk_torch.kernels.biharmonic import problem as tp
from cdk_torch.kernels.biharmonic.dss2d import (
    biharmonic_wk_dss2d_reference,
    torus_shape,
)
from cdk_torch.kernels.biharmonic.reference import rrearth_as
from cdk_tpu.core import config as jconfig
from cdk_tpu.dist import biharmonic as jdist
from cdk_tpu.dist import mesh as jmesh
from cdk_tpu.kernels.biharmonic import problem as jp

RING = with_overrides(BiharmonicConfig(), nlev=4, qsize=2)        # 16 elements
WIDE = with_overrides(BiharmonicConfig(), nelemd=32, nlev=4, qsize=2)  # 8 x 4


def _jcfg(cfg):
    return jconfig.BiharmonicConfig(**dataclasses.asdict(cfg))


@functools.cache
def _jdata(cfg):
    return jp.init_data(_jcfg(cfg))


def _tdata(cfg):
    """The port's data from the JAX package's host arrays."""
    j = _jdata(cfg)
    return tp.from_numpy({f.name: np.asarray(getattr(j, f.name))
                          for f in dataclasses.fields(j)}, dtype=cfg.torch_dtype)


def _mesh(p):
    return tmesh.make_mesh(p, "cpu")


@functools.cache
def _jax_run(cfg, factory, p, n, **kw):
    """A JAX dist factory's (shard_inputs, step or loop, gather) run on p
    devices -> the gathered qtens; n None is one step."""
    si, run, gather = getattr(jdist, factory)(_jcfg(cfg), jmesh.make_mesh(p), **kw)
    q, aux = si(_jdata(cfg))
    return gather(run(q, aux) if n is None else run(q, aux, n))


def _port_run(cfg, factory, p, n, **kw):
    si, run, gather = getattr(tdist, factory)(cfg, _mesh(p), **kw)
    q, aux = si(_tdata(cfg))
    return gather(run(q, aux) if n is None else run(q, aux, n))


@pytest.mark.parametrize("h", [1, 3])
def test_ring_strips_and_mesh2d_match_jax(h):
    """The periodic strips against lax.ppermute on 4 devices, and
    make_mesh2d's factorisation against JAX's for 1-8 shards."""
    import jax
    from jax import lax, shard_map
    from jax.sharding import PartitionSpec as P

    x = np.arange(4 * 6 * 3, dtype=np.float64).reshape(4 * 6, 3)
    m = jmesh.make_mesh(4)
    ax = m.axis_names[0]
    fwd = [(i, (i + 1) % 4) for i in range(4)]
    bwd = [(i, (i - 1) % 4) for i in range(4)]

    @jax.jit
    @functools.partial(shard_map, mesh=m, in_specs=P(ax), out_specs=(P(ax), P(ax)))
    def strips(xl):
        return lax.ppermute(xl[-h:], ax, fwd), lax.ppermute(xl[:h], ax, bwd)

    jl, jr = (np.asarray(a).reshape(4, h, 3) for a in strips(x))
    left, right = tmesh.ring_strips(torch.from_numpy(x).reshape(4, 6, 3), h)
    assert np.array_equal(left.numpy(), jl) and np.array_equal(right.numpy(), jr)
    again = tmesh.ring_strips(torch.from_numpy(x + 1).reshape(4, 6, 3), h,
                              out=(left, right))
    assert again[0] is left and np.array_equal(left.numpy(), jl + 1)
    for n in range(1, 9):
        assert (tmesh.make_mesh2d(n, device="cpu").shape
                == jmesh.make_mesh2d(n).devices.shape)
    assert tmesh.make_mesh2d(shape=(3, 2), device="cpu").size == 6


def test_element_sharded_step_matches_jax():
    """shard_data + make_dist_step (no exchange) on 2 shards."""
    m = jmesh.make_mesh(2)
    want = np.asarray(jdist.make_dist_step(_jcfg(RING), m)(
        jdist.shard_data(_jdata(RING), m)))
    got = tdist.make_dist_step(RING, _mesh(2))(
        tdist.shard_data(_tdata(RING), _mesh(2)))
    assert got.shape == want.shape and rel_l2(got, want) < 1e-13


@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("p", [2, 8])
def test_dss_step_matches_jax(p, overlap):
    """The ring-DSS step, serialized and overlapped, on 2 and 8 shards (8:
    two elements per shard, so the overlap form patches every one)."""
    got = _port_run(RING, "make_dist_step_dss", p, None, overlap=overlap)
    want = _jax_run(RING, "make_dist_step_dss", p, None, overlap=overlap)
    assert got.shape == want.shape and rel_l2(got, want) < 1e-13
    if overlap:
        serial = _port_run(RING, "make_dist_step_dss", p, None)
        assert torch.equal(got, serial)


def test_dss_loop_matches_chained_steps_and_jax():
    si, step, gather = tdist.make_dist_step_dss(RING, _mesh(4))
    q, aux = si(_tdata(RING))
    chained = q
    for _ in range(3):
        chained = step(chained, aux)
    looped = tdist.make_dist_loop_dss(RING, _mesh(4))(q, aux, 3)
    assert torch.equal(looped, chained)
    jm = jmesh.make_mesh(4)
    jsi, _, jgather = jdist.make_dist_step_dss(_jcfg(RING), jm)
    jloop = jdist.make_dist_loop_dss(_jcfg(RING), jm)
    want = jgather(jloop(*jsi(_jdata(RING)), 3))
    assert rel_l2(gather(looped), want) < 1e-13


@pytest.mark.parametrize("p,kstep", [(2, 8), (4, 4), (2, 3)])
def test_kstep_ring_matches_jax(p, kstep):
    """The communication-avoiding ring (K14w's plain version per shard),
    2·kstep steps, split and padded-window forms bitwise equal."""
    n = 2 * kstep
    got = _port_run(WIDE, "make_dist_loop_dss_kstep", p, n, kstep=kstep)
    padded = _port_run(WIDE, "make_dist_loop_dss_kstep", p, n, kstep=kstep,
                       split=False)
    want = _jax_run(WIDE, "make_dist_loop_dss_kstep", p, n, kstep=kstep)
    assert rel_l2(got, want) < 1e-13
    assert torch.equal(got, padded)


@pytest.mark.parametrize("p", [1, 4])
def test_kstep_split_equals_padded_window_f32(p):
    # rrearth 0.3 keeps 16 f32 steps finite and away from zero
    cfg = with_overrides(WIDE, dtype="float32", rrearth=0.3)
    si, loop_s, gather = tdist.make_dist_loop_dss_kstep(cfg, _mesh(p), kstep=8)
    _, loop_p, _ = tdist.make_dist_loop_dss_kstep(cfg, _mesh(p), kstep=8,
                                                 split=False)
    q, aux = si(_tdata(cfg))
    a, b = loop_s(q, aux, 16), loop_p(q, aux, 16)
    assert a.dtype == torch.float32 and torch.equal(a, b)
    assert torch.isfinite(a).all() and a.abs().max() > 0


def test_kstep_ring_guards():
    """n % kstep raises; a halo past the neighbour shard raises where JAX's
    group guard does; kstep > 15 (K14's steps per launch) raises in the
    port alone."""
    si, loop, _ = tdist.make_dist_loop_dss_kstep(WIDE, _mesh(2), kstep=4)
    with pytest.raises(ValueError, match="multiple of kstep"):
        loop(*si(_tdata(WIDE)), 6)
    for p, kstep in ((8, 8), (4, 16)):
        with pytest.raises(ValueError):
            jdist.make_dist_loop_dss_kstep(_jcfg(WIDE), jmesh.make_mesh(p),
                                           kstep=kstep)
        with pytest.raises(ValueError, match="cannot carry"):
            tdist.make_dist_loop_dss_kstep(WIDE, _mesh(p), kstep=kstep)
    wide = with_overrides(WIDE, nelemd=64)
    jdist.make_dist_loop_dss_kstep(_jcfg(wide), jmesh.make_mesh(2), kstep=16)
    with pytest.raises(ValueError, match="most steps"):
        tdist.make_dist_loop_dss_kstep(wide, _mesh(2), kstep=16)


@pytest.mark.parametrize("shape", [(2, 2), (1, 4), (4, 1), (2, 4), (4, 2)])
def test_dss2d_step_matches_jax(shape):
    """The torus-DSS step on 2-D meshes (the 4 x 4 torus split along one
    axis, both, or two elements per shard along one)."""
    m = tmesh.make_mesh2d(shape=shape, device="cpu")
    si, step, gather = tdist.make_dist_step_dss2d(RING, m)
    got = gather(step(*si(_tdata(RING))))
    jm = jmesh.make_mesh2d(shape=shape)
    jsi, jstep, jgather = jdist.make_dist_step_dss2d(_jcfg(RING), jm)
    want = jgather(jstep(*jsi(_jdata(RING))))
    assert got.shape == want.shape and rel_l2(got, want) < 1e-13


def test_dss2d_loop_matches_chained_steps_and_jax():
    m = tmesh.make_mesh2d(shape=(2, 4), device="cpu")
    si, step, gather = tdist.make_dist_step_dss2d(RING, m)
    q, aux = si(_tdata(RING))
    chained = q
    for _ in range(3):
        chained = step(chained, aux)
    looped = tdist.make_dist_loop_dss2d(RING, m)(q, aux, 3)
    assert torch.equal(looped, chained)
    jm = jmesh.make_mesh2d(shape=(2, 4))
    jsi, _, jgather = jdist.make_dist_step_dss2d(_jcfg(RING), jm)
    jloop = jdist.make_dist_loop_dss2d(_jcfg(RING), jm)
    want = jgather(jloop(*jsi(_jdata(RING)), 3))
    assert rel_l2(gather(looped), want) < 1e-13


def test_dss2d_rejects_indivisible_grid():
    with pytest.raises(ValueError, match="not divisible"):
        jdist.make_dist_step_dss2d(_jcfg(RING), jmesh.make_mesh2d(shape=(3, 2)))
    with pytest.raises(ValueError, match="not divisible"):
        tdist.make_dist_step_dss2d(
            RING, tmesh.make_mesh2d(shape=(3, 2), device="cpu"))


@pytest.mark.parametrize("p,n", [(2, 1), (2, 5), (2, 7), (4, 4)])
def test_rowchain_matches_jax(p, n):
    """The row-sharded rowchain at f64: k-step blocks (depth 3 and 2 on 4
    rows per shard), one-row steps and the bridges."""
    got = _port_run(WIDE, "make_dist_loop_dss2d_rowchain", p, n)
    want = _jax_run(WIDE, "make_dist_loop_dss2d_rowchain", p, n)
    assert rel_l2(got, want) < 1e-13


@pytest.mark.parametrize("p,kstep,n", [
    (2, 2, 5), (2, 4, 5), (4, 2, 9),
    # (n-1) % kstep != 0: the remainder chain reads the kstep-extended
    # operators at an offset
    (2, 4, 4), (2, 2, 4), (2, 4, 2)])
def test_rowchain_kstep_matches_jax(p, kstep, n):
    got = _port_run(WIDE, "make_dist_loop_dss2d_rowchain_kstep", p, n,
                    kstep=kstep)
    want = _jax_run(WIDE, "make_dist_loop_dss2d_rowchain_kstep", p, n,
                    kstep=kstep)
    assert rel_l2(got, want) < 1e-13


def test_rowchain_depth4_f32_matches_reference(monkeypatch):
    """The bf16x3 f32 loop takes depth-4 blocks (the exact form stops at 3):
    on 2 shards of 4 rows, 6 steps are one depth-4 block and one one-row
    step, within the 5e-5 gate of the reference chained 6 times."""
    cfg = with_overrides(WIDE, dtype="float32", rrearth=1.0)
    depths = []
    step = trc.rowchain_step_padded

    def spy(*args, **kw):
        depths.append(args[5])
        return step(*args, **kw)

    monkeypatch.setattr(trc, "rowchain_step_padded", spy)
    got = _port_run(cfg, "make_dist_loop_dss2d_rowchain", 2, 6)
    assert depths == [4, 4, 1, 1], depths  # one launch a shard
    d = _tdata(cfg)
    ex, ey = torus_shape(cfg.nelemd)
    q = d.qtens
    for _ in range(6):
        q = biharmonic_wk_dss2d_reference(q, d.dvv, d.dinv, d.spheremp,
                                          d.tensorvisc, rrearth_as(cfg), ex, ey)
    assert rel_l2(got, q) < 5e-5


def test_rowchain_overlap_matches_serial_exactly():
    si, loop_s, _ = tdist.make_dist_loop_dss2d_rowchain(WIDE, _mesh(4))
    _, loop_o, _ = tdist.make_dist_loop_dss2d_rowchain(WIDE, _mesh(4),
                                                       overlap=True)
    q, aux = si(_tdata(WIDE))
    assert torch.equal(loop_s(q, aux, 4), loop_o(q, aux, 4))


@pytest.mark.parametrize("case", ["rows", "overlap", "kstep_big", "kstep_zero",
                                  "ring_overlap", "ring"])
def test_guards_raise_where_jax_does(case):
    narrow = with_overrides(WIDE, nelemd=8)  # a 4 x 2 torus
    build = {
        "rows": (WIDE, 3, "make_dist_loop_dss2d_rowchain", {}),
        "overlap": (narrow, 4, "make_dist_loop_dss2d_rowchain",
                    {"overlap": True}),
        "kstep_big": (WIDE, 4, "make_dist_loop_dss2d_rowchain_kstep",
                      {"kstep": 3}),
        "kstep_zero": (WIDE, 2, "make_dist_loop_dss2d_rowchain_kstep",
                       {"kstep": 0}),
        "ring_overlap": (narrow, 8, "make_dist_step_dss", {"overlap": True}),
        "ring": (RING, 3, "make_dist_step_dss", {}),
    }
    cfg, p, factory, kw = build[case]
    with pytest.raises(ValueError):
        getattr(jdist, factory)(_jcfg(cfg), jmesh.make_mesh(p), **kw)
    with pytest.raises(ValueError):
        getattr(tdist, factory)(cfg, _mesh(p), **kw)


def test_rowchain_loops_take_at_least_one_step():
    for factory in ("make_dist_loop_dss2d_rowchain",
                    "make_dist_loop_dss2d_rowchain_kstep"):
        si, loop, _ = getattr(tdist, factory)(WIDE, _mesh(2))
        with pytest.raises(ValueError, match="n >= 1"):
            loop(*si(_tdata(WIDE)), 0)


def test_dss_legs_and_scaling_biharmonic_cli_run(capsys):
    from cdk_torch import cli
    from cdk_torch.harness.distbench import run_dist_legs

    cfg = with_overrides(WIDE, dtype="float32", rrearth=1.0)
    champions = {"biharmonic_dss": "fused_operator_bd8_resident_sq_x3",
                 "biharmonic_dss2d": "fused_operator_rowchain_sq_x3"}
    res = run_dist_legs(champions, trials=1, device="cpu",
                        configs={"biharmonic_dss": cfg, "biharmonic_dss2d": cfg})
    assert [r.family for r in res] == ["biharmonic_dss", "biharmonic_dss2d"]
    assert all(r.ok and r.err < 5e-4 and r.seconds_per_call > 0 for r in res), res
    assert cli.main(["scaling", "biharmonic", "--device", "cpu", "--devices", "1,2",
                     "--nelemd-per-device", "4", "--steps", "2", "--kstep", "2",
                     "--overlap-gain"]) == 0
    out = capsys.readouterr().out
    for line in ("weak-scaling biharmonic_dss n=2", "biharmonic_dss2d mesh=1x2",
                 "overlap biharmonic_dss n=2", "comm-avoid dss n=2",
                 "comm-avoid dss2d n=2"):
        assert line in out, out
    assert cli.main(["scaling", "all", "--device", "cpu"]) == 2
