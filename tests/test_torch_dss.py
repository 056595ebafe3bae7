"""The DSS-coupled biharmonic families in the port (cdk_torch) against the
JAX package (cdk_tpu) on bitwise-identical inputs: the ring and torus
topology, both references, every registered variant's step against the
JAX variant of the same name (the Pallas ones in interpret mode), and the
resident and rowchain loops against the JAX reference chained n times.

Tolerances: 1e-15 for the topology functions (only the order of two-term
sums can differ); the family gate otherwise (`_verify_biharmonic_dss`:
rel L2 < 1e-13 at f64, 1e-6 for the exact f32 forms, the registered 5e-5
for the bf16x3 forms, 1e-2 for the bf16 forms), and n times the f32 gate
for an f32 chain of n steps.  f32 chains run at rrearth = 1: each
application scales the state by ~rrearth², so a real-radius f32 chain
sinks below f32's range, where the two frameworks flush denormals
differently."""

import dataclasses

import numpy as np
import pytest
import torch

from cdk_torch.core.config import BiharmonicConfig, with_overrides
from cdk_torch.core.norms import rel_l2
from cdk_torch.core.registry import get, make_step, variants
from cdk_torch.harness.specs import get_spec
from cdk_torch.kernels.biharmonic import dss as tdss
from cdk_torch.kernels.biharmonic import dss2d as tdss2d
from cdk_torch.kernels.biharmonic import dss2d_resident as tres2
from cdk_torch.kernels.biharmonic import dss2d_rowchain as trc
from cdk_torch.kernels.biharmonic import dss_resident as tres
from cdk_torch.kernels.biharmonic import operator as top
from cdk_torch.kernels.biharmonic import problem as tp
from cdk_tpu.core import config as jconfig
from cdk_tpu.core import registry as jreg
from cdk_tpu.kernels.biharmonic import dss as jdss
from cdk_tpu.kernels.biharmonic import dss2d as jdss2d
from cdk_tpu.kernels.biharmonic import problem as jp

SMALL = with_overrides(BiharmonicConfig(), nlev=4, qsize=2)
SIZES = {"biharmonic_dss": (5, 8, 16), "biharmonic_dss2d": (12, 16, 160)}
CHAINED = ("fused_operator_bd8_resident", "fused_operator_rowchain")


def _jcfg(cfg):
    return jconfig.BiharmonicConfig(**dataclasses.asdict(cfg))


def _as_torch(jdata, dtype):
    return tp.from_numpy({f.name: np.asarray(getattr(jdata, f.name))
                          for f in dataclasses.fields(jdata)}, dtype=dtype)


def _pair(cfg):
    """(JAX data, the same inputs as port data)."""
    j = jp.init_data(_jcfg(cfg))
    return j, _as_torch(j, cfg.torch_dtype)


@pytest.mark.parametrize("nelemd", [1, 4, 5, 12, 16, 160, 5400])
def test_torus_shape_matches_jax(nelemd):
    assert tdss2d.torus_shape(nelemd) == jdss2d.torus_shape(nelemd)


@pytest.mark.parametrize("nelemd", [4, 5, 12, 16])
def test_topology_matches_jax(nelemd):
    """Weights, ring and torus assembly in both layouts."""
    rng = np.random.default_rng(nelemd)
    sp = rng.uniform(0.5, 2.0, (nelemd, 4, 4))
    s = rng.standard_normal((nelemd, 2, 3, 4, 4))
    ex, ey = tdss2d.torus_shape(nelemd)
    t_sp, t_s = torch.from_numpy(sp), torch.from_numpy(s)

    w1 = tdss.dss_weights(t_sp)
    assert rel_l2(w1, jdss.dss_weights(sp)) <= 1e-15
    w2 = tdss2d.dss2d_weights(t_sp, ex, ey)
    assert rel_l2(w2, jdss2d.dss2d_weights(sp, ex, ey)) <= 1e-15
    assert rel_l2(tdss.dss_ring(t_s, w1[:, None, None]),
                  jdss.dss_ring(s, np.asarray(w1)[:, None, None])) <= 1e-15
    assert rel_l2(tdss2d.dss_torus(t_s, w2[:, None, None], ex, ey),
                  jdss2d.dss_torus(s, np.asarray(w2)[:, None, None], ex, ey)) <= 1e-15

    lane = rng.standard_normal((nelemd, 16, 6))
    t_lane = torch.from_numpy(lane)
    assert rel_l2(tdss.dss_ring_lane(t_lane, w1, 4),
                  jdss.dss_ring_lane(lane, np.asarray(w1), 4)) <= 1e-15
    wl = w2.reshape(nelemd, 16, 1)
    assert rel_l2(tdss2d.dss2d_lane(t_lane, wl, ex, ey, 4),
                  jdss2d.dss2d_lane(lane, np.asarray(wl), ex, ey, 4)) <= 1e-15


@pytest.mark.parametrize("exy", [(2, 2), (4, 3), (4, 4)])
def test_torus_corners_collect_four_sharers(exy):
    """After assembly all four sharers of a corner hold the same value, the
    sum of the four contributions over the sum of the four masses; ex = 2
    makes the up and down neighbour the same element row."""
    ex, ey = exy
    rng = np.random.default_rng(ex * 10 + ey)
    sp = torch.from_numpy(rng.uniform(0.5, 2.0, (ex * ey, 4, 4)))
    s = torch.from_numpy(rng.standard_normal((ex * ey, 4, 4)))
    out = tdss2d.dss_torus(s, tdss2d.dss2d_weights(sp, ex, ey), ex, ey)
    o5, s5, m5 = (x.reshape(ex, ey, 4, 4) for x in (out, s, sp))
    for a in range(ex):
        for b in range(ey):
            a1, b1 = (a + 1) % ex, (b + 1) % ey
            corners = [(a, b, 3, 3), (a1, b, 0, 3), (a, b1, 3, 0), (a1, b1, 0, 0)]
            want = (sum(s5[c] for c in corners) / sum(m5[c] for c in corners))
            for c in corners:
                assert float(o5[c]) == pytest.approx(float(want), rel=1e-14)


@pytest.mark.parametrize("family", ["biharmonic_dss", "biharmonic_dss2d"])
def test_reference_matches_jax_at_shipped_size(family):
    cfg = BiharmonicConfig()  # 16 x 72 x 40, f64
    j, t = _pair(cfg)
    want = np.asarray(jreg.make_step(jreg.get(family, "reference_jnp"),
                                     _jcfg(cfg), j)(j))
    got = make_step(get(family, "reference_jnp"), cfg, t)(t)
    assert got.shape == want.shape and rel_l2(got, want) < 1e-13


def _step_cases():
    import cdk_torch.kernels  # noqa: F401  (registers the variants)

    return [(fam, n, name) for fam, sizes in SIZES.items() for n in sizes
            for name in variants(fam)]


@pytest.mark.parametrize("family,nelemd,name", _step_cases())
def test_variant_step_matches_jax_variant(family, nelemd, name):
    """One step of each port variant against the JAX variant of the same
    name on the same inputs, f64 where the variant has it, else f32."""
    import cdk_tpu.kernels  # noqa: F401

    var = get(family, name)
    cfg = with_overrides(SMALL, nelemd=nelemd,
                         dtype="float64" if var.supports_f64 else "float32")
    j, t = _pair(cfg)
    want = np.asarray(jreg.make_step(jreg.get(family, name), _jcfg(cfg), j)(j))
    got = make_step(var, cfg, t)(t)
    assert got.shape == want.shape and got.dtype == cfg.torch_dtype
    check = get_spec(family).verify(cfg, got, want, loose=var.fast_math,
                                    tol=var.verify_tol)
    assert check.ok, check.lines


def _shipped_f64_cases():
    import cdk_torch.kernels  # noqa: F401

    return [(fam, name) for fam in SIZES for name, var in variants(fam).items()
            if var.supports_f64]


@pytest.mark.parametrize("family,name", _shipped_f64_cases())
def test_variant_step_matches_jax_at_shipped_f64(family, name):
    """Every f64 variant at the shipped 16 x 72 x 40 against the JAX
    variant of the same name, at the f64 gate 1e-13."""
    import cdk_tpu.kernels  # noqa: F401

    cfg = BiharmonicConfig()
    j, t = _pair(cfg)
    want = np.asarray(jreg.make_step(jreg.get(family, name), _jcfg(cfg), j)(j))
    got = make_step(get(family, name), cfg, t)(t)
    assert got.shape == want.shape and rel_l2(got, want) < 1e-13


def _loop_cases():
    import cdk_torch.kernels  # noqa: F401

    out = []
    for family, size in (("biharmonic_dss", 16), ("biharmonic_dss2d", 160)):
        for name in variants(family):
            if name.startswith(CHAINED):
                dtypes = (["float64"] if get(family, name).supports_f64 else []) + ["float32"]
                out += [(family, size, name, d) for d in dtypes]
    return out


@pytest.mark.parametrize("family,nelemd,name,dtype", _loop_cases())
def test_loop_matches_chained_jax_reference(family, nelemd, name, dtype):
    """loop(n) of each resident and rowchain variant against the JAX
    reference chained n times (n = 1, 2, 5 and 9 cross the launch depth
    and its remainders)."""
    cfg = with_overrides(SMALL, nelemd=nelemd, dtype=dtype)
    if dtype == "float32":
        cfg = with_overrides(cfg, rrearth=1.0)
    j, t = _pair(cfg)
    ref = jreg.make_step(jreg.get(family, "reference_jnp"), _jcfg(cfg), j)
    var = get(family, name)
    loop = var.fn(cfg)["loop"]
    q = j.qtens
    done = 0
    for n in (1, 2, 5, 9):
        for _ in range(n - done):
            q = ref(dataclasses.replace(j, qtens=q))
        done = n
        got = loop(t, n)
        if dtype == "float64":
            check = get_spec(family).verify(cfg, got, np.asarray(q))
            assert check.ok, (n, check.lines)
        else:
            # an f32 chain of n steps compounds n steps' rounding: n times
            # the family's one-step f32 gate
            gate = n * (var.verify_tol or 1e-6)
            assert rel_l2(got, np.asarray(q)) < gate, n


def _operands(e=6, ncol=5, seed=0):
    rng = np.random.default_rng(seed)
    L = torch.from_numpy(rng.standard_normal((e, 16, 16)) / 4)
    w = torch.from_numpy(rng.uniform(0.3, 0.6, (e, 16)))
    q = torch.from_numpy(rng.standard_normal((e, 16, ncol)))
    return L, w, q


def test_dss_resident_wrapper_contract():
    """CPU tensors run the plain version (no launch counted); the plain
    precomposed chain equals the A·A chain; bad arguments raise."""
    L, w, q = _operands()
    before = tres.dss_resident.launches
    assert tres.dss_resident(L, w, q, 0) is q
    a = tres.dss_resident(L, w, q, 3)
    b = tres.dss_resident(L, w, q, 3, L2=top.precompose_operator(L))
    assert rel_l2(b, a) < 1e-13
    want = q
    for _ in range(3):
        want = torch.bmm(L, tdss.dss_ring_lane(torch.bmm(L, want),
                                               w.reshape(-1, 4, 4), 4))
    assert rel_l2(a, want) < 1e-14
    assert tres.dss_resident.launches == before
    with pytest.raises(ValueError, match="precision"):
        tres.dss_resident(L, w, q, 1, "high")
    with pytest.raises(TypeError, match="float32 form"):
        tres.dss_resident(L, w, q, 1, "bf16x3")
    with pytest.raises(TypeError):
        tres.dss_resident(L.float(), w, q, 1)
    with pytest.raises(ValueError, match="want"):
        tres.dss_resident(L, w[:, :4], q, 1)
    with pytest.raises(ValueError, match="nsteps"):
        tres.dss_resident(L, w, q, tres.MAX_STEPS + 1)


def test_dss2d_resident_wrapper_contract():
    """CPU tensors run the plain version (no launch counted), which is the
    torus DSS chain; bad arguments raise."""
    ex, ey = 3, 2
    L, w, q = _operands(e=ex * ey)
    before = tres2.dss2d_resident.launches
    assert tres2.dss2d_resident(L, w, q, ex, ey, 0) is q
    got = tres2.dss2d_resident(L, w, q, ex, ey, 3)
    want = q
    for _ in range(3):
        s = tdss2d.dss2d_lane(torch.bmm(L, want), w[..., None], ex, ey, 4)
        want = torch.bmm(L, s)
    assert rel_l2(got, want) < 1e-14
    assert tres2.dss2d_resident.launches == before
    with pytest.raises(ValueError, match="precision"):
        tres2.dss2d_resident(L, w, q, ex, ey, 1, "high")
    with pytest.raises(TypeError, match="float32 form"):
        tres2.dss2d_resident(L, w, q, ex, ey, 1, "bf16x3")
    with pytest.raises(ValueError, match="torus"):
        tres2.dss2d_resident(L, w, q, ex + 1, ey, 1)
    with pytest.raises(ValueError, match="nsteps"):
        tres2.dss2d_resident(L, w, q, ex, ey, tres2.max_steps(ey) + 1)


def test_dss2d_resident_runs_every_torus():
    """Whole rows where 2k+1 of them fit in 64 elements, else an 8 x 8
    window of at most 3 steps; so the port runs the production 75 x 72
    torus, where the JAX package's full-row window exceeds VMEM."""
    assert [tres2.row_steps(ey) for ey in (1, 3, 4, 10, 21, 22, 72)] == [
        31, 10, 7, 2, 1, 0, 0]
    assert [tres2.max_steps(ey) for ey in (1, 4, 10, 22, 72)] == [31, 7, 3, 3, 3]
    assert [tres2.loop_depth(ey) for ey in (4, 21, 72)] == [
        tres2.DEPTH, 1, tres2.RECT_DEPTH]
    cfg = with_overrides(SMALL, nelemd=5400)
    for name in ("fused_operator_bd8_resident", "fused_operator_bd8_resident_x3"):
        assert set(get("biharmonic_dss2d", name).fn(cfg)) == {"prepare", "step", "loop"}
        with pytest.raises(jreg.UnsupportedConfigError):
            jreg.get("biharmonic_dss2d", name).fn(_jcfg(cfg))


def test_rowchain_wrapper_contract():
    """The plain rowchain equals the torus DSS chain; depth k equals k
    depth-1 steps; bad arguments raise."""
    ex, ey = 3, 2
    L, w, q = _operands(e=ex * ey)
    before = (trc.rowchain_bridge_in.launches, trc.rowchain_step.launches,
              trc.rowchain_bridge_out.launches)
    t = trc.rowchain_bridge_in(L, q, ex, ey)
    deep = trc.rowchain_step(L, w, t, ex, ey, 3)
    one = t
    for _ in range(3):
        one = trc.rowchain_step(L, w, one, ex, ey, 1)
    assert torch.equal(deep, one)
    got = trc.rowchain_bridge_out(L, w, deep, ex, ey)
    want = q
    for _ in range(4):
        s = tdss2d.dss2d_lane(torch.bmm(L, want), w[..., None], ex, ey, 4)
        want = torch.bmm(L, s)
    assert rel_l2(got, want) < 1e-13
    sq = trc.rowchain_step(top.precompose_operator(L), w, t, ex, ey, 3,
                           squared=True)
    assert rel_l2(sq, deep) < 1e-13
    assert (trc.rowchain_bridge_in.launches, trc.rowchain_step.launches,
            trc.rowchain_bridge_out.launches) == before
    with pytest.raises(ValueError, match="nsteps"):
        trc.rowchain_step(L, w, t, ex, ey, 0)
    with pytest.raises(ValueError, match="torus"):
        trc.rowchain_step(L, w, t, ey, ex + 1)
    with pytest.raises(TypeError, match="float32 form"):
        trc.rowchain_bridge_out(L, w, t, ex, ey, "bf16x3")
    cfg = with_overrides(SMALL, nelemd=ex * ey)
    data = tp.init_data(cfg)
    with pytest.raises(ValueError, match="n >= 1"):
        get("biharmonic_dss2d", "fused_operator_rowchain").fn(cfg)["loop"](data, 0)
