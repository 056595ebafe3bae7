"""Biharmonic in the port (cdk_torch) against the JAX package (cdk_tpu) on
bitwise-identical inputs: init, reference, element operator, and the
resident operator chain (K1's plain version on the CPU against the JAX
kernel in Pallas interpret mode).  Tolerances: rel L2 < 1e-13 at f64 (the
family gate; only summation order differs) and < 2e-5 at f32 (the family
f32 gate, which the bf16x3 form must meet as on the TPU)."""

import dataclasses

import numpy as np
import pytest
import torch

from cdk_torch.core.config import BiharmonicConfig, with_overrides
from cdk_torch.core.norms import rel_l2
from cdk_torch.kernels.biharmonic import operator as top
from cdk_torch.kernels.biharmonic import problem as tp
from cdk_torch.kernels.biharmonic import reference as tr
from cdk_torch.kernels.biharmonic import resident as tres
from cdk_tpu.core import config as jconfig
from cdk_tpu.kernels.biharmonic import operator as jop
from cdk_tpu.kernels.biharmonic import pallas_bd8
from cdk_tpu.kernels.biharmonic import problem as jp
from cdk_tpu.kernels.biharmonic import reference as jr

SMALL = with_overrides(BiharmonicConfig(), nelemd=3, nlev=4, qsize=2)
GROUP = with_overrides(BiharmonicConfig(), nelemd=8, nlev=4, qsize=2)
CONFIGS = {"small": SMALL, "group8": GROUP}


def _jcfg(cfg):
    return jconfig.BiharmonicConfig(**dataclasses.asdict(cfg))


def _jdata(cfg):
    return jp.init_data(_jcfg(cfg))


def _as_torch(jdata, dtype):
    return tp.from_numpy({f.name: np.asarray(getattr(jdata, f.name))
                          for f in dataclasses.fields(jdata)}, dtype=dtype)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_init_bitwise_equal_to_jax(name, dtype):
    cfg = with_overrides(CONFIGS[name], dtype=dtype)
    t, j = tp.init_data(cfg), _jdata(cfg)
    via = _as_torch(j, cfg.torch_dtype)
    for f in dataclasses.fields(t):
        tv = getattr(t, f.name)
        assert tv.dtype == cfg.torch_dtype and tv.device.type == "cpu"
        assert np.array_equal(tv.numpy(), np.asarray(getattr(j, f.name)))
        assert torch.equal(getattr(via, f.name), tv)


def test_device_init_is_seeded():
    cfg = with_overrides(SMALL, device_init=True, dtype="float32")
    a, b = tp.init_data(cfg), tp.init_data(cfg)
    for f in dataclasses.fields(a):
        x = getattr(a, f.name)
        assert torch.equal(x, getattr(b, f.name))
        assert x.dtype == torch.float32 and 0 <= x.min() and x.max() < 1
    assert a.qtens.shape == (3, 2, 4, 4, 4)
    moved = a.to(torch.float64)
    assert moved.dinv.dtype == torch.float64


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_reference_parity(name):
    cfg = CONFIGS[name]
    j = _jdata(cfg)
    want = np.asarray(jr.make_reference(_jcfg(cfg))(j))
    got = tr.make_reference(cfg)(_as_torch(j, torch.float64))
    assert got.shape == want.shape
    assert rel_l2(got, want) < 1e-13


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_element_operator_parity(name):
    cfg = CONFIGS[name]
    j = _jdata(cfg)
    t = _as_torch(j, torch.float64)
    want = jop.build_element_operator(j.dvv, j.dinv, j.spheremp,
                                      j.tensorvisc, cfg.rrearth)
    got = top.build_element_operator(t.dvv, t.dinv, t.spheremp,
                                     t.tensorvisc, cfg.rrearth)
    assert got.shape == (cfg.nelemd, 16, 16) and got.is_contiguous()
    assert rel_l2(got, np.asarray(want)) < 1e-13


def test_lane_layout_matches_jax():
    j = _jdata(GROUP)
    t = _as_torch(j, torch.float64)
    lane = tp.to_lane_layout(t.qtens)
    assert lane.is_contiguous()
    assert np.array_equal(lane.numpy(), np.asarray(jp.to_lane_layout(j.qtens)))
    assert torch.equal(tp.from_lane_layout(lane, GROUP), t.qtens)


def _chain_pair(cfg, jmake, tmake, n):
    """(port, JAX) outputs of a resident form: step for n=1, loop else."""
    j = _jdata(cfg)
    t = _as_torch(j, cfg.torch_dtype)
    jm, tm = jmake(_jcfg(cfg)), tmake(cfg)
    if n == 1:
        return (tm["step"](tm["prepare"](t), t),
                np.asarray(jm["step"](jm["prepare"](j), j)))
    return tm["loop"](t, n), np.asarray(jm["loop"](j, n))


@pytest.mark.parametrize("n", [1, 3])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_bd8_resident_f64_vs_jax(name, n):
    got, want = _chain_pair(CONFIGS[name],
                            pallas_bd8.make_fused_operator_bd8_resident,
                            tres.make_fused_operator_bd8_resident, n)
    assert got.shape == want.shape
    assert rel_l2(got, want) < 1e-13


# f32 chains run with rrearth = 1: each application scales the state by
# ~rrearth^2 (~3e-14), so with the real radius a 3-step f32 chain sinks to
# f32 denormals, which the two frameworks flush differently
@pytest.mark.parametrize("n", [1, 3])
@pytest.mark.parametrize("form", ["highest", "x3"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_bd8_resident_f32_vs_jax(name, form, n):
    cfg = with_overrides(CONFIGS[name], dtype="float32", rrearth=1.0)
    makers = {
        "highest": (pallas_bd8.make_fused_operator_bd8_resident,
                    tres.make_fused_operator_bd8_resident),
        "x3": (pallas_bd8.make_fused_operator_bd8_resident_x3,
               tres.make_fused_operator_bd8_resident_x3),
    }
    got, want = _chain_pair(cfg, *makers[form], n)
    assert got.dtype == torch.float32
    assert rel_l2(got, want) < 2e-5


def test_x3_real_radius_against_reference():
    """At the real radius the bf16x3 champion lands inside the f32 gate of
    the f64 reference, as the JAX kernel does."""
    cfg = with_overrides(GROUP, dtype="float32")
    t = tp.init_data(cfg)
    m = tres.make_fused_operator_bd8_resident_x3(cfg)
    out = m["step"](m["prepare"](t), t)
    ref = tr.make_reference(GROUP)(tp.init_data(GROUP))
    assert 0 < rel_l2(out, ref) < 2e-5


def test_bd8_resident_wrapper_contract():
    t = tp.init_data(SMALL)
    L = top.build_element_operator(t.dvv, t.dinv, t.spheremp, t.tensorvisc, 1.0)
    q = tp.to_lane_layout(t.qtens)
    before = tres.bd8_resident.launches
    assert tres.bd8_resident(L, q, 0) is q
    torch.testing.assert_close(tres.bd8_resident(L, q, 2),
                               torch.bmm(L, torch.bmm(L, q)), rtol=1e-14, atol=0)
    assert tres.bd8_resident.launches == before  # CPU runs the plain version
    with pytest.raises(ValueError, match="precision"):
        tres.bd8_resident(L, q, 1, "high")
    with pytest.raises(TypeError, match="float32 form"):
        tres.bd8_resident(L, q, 1, "bf16x3")
    with pytest.raises(TypeError):
        tres.bd8_resident(L.float(), q, 1)
    with pytest.raises(ValueError, match="shape|want"):
        tres.bd8_resident(L[:2], q, 1)
    with pytest.raises(ValueError, match="n must be"):
        tres.bd8_resident(L, q, -1)
