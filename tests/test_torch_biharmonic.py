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


# ---- the XLA forms, K5 (fused_operator_pallas) and K4 (pallas_fused,
# pallas_fused_bf16) against the JAX variants of the same names.  JAX on the
# CPU ignores dot precision, so its "high" and "default" products are exact
# there; the port's plain versions emulate bf16x3 and bf16, so those forms
# are held to the family gate against the f64 reference, and the exact
# forms (every f64 one, and pallas_fused) to JAX directly.

F64_FORMS = ["fused_operator", "fused_operator_bd", "fused_operator_bd8",
             "fused_operator_pallas"]
LOOP_FORMS = ["fused_operator", "fused_operator_bd8", "fused_operator_pallas"]


def _port_out(name, cfg, n):
    from cdk_torch.core.registry import _materialize, get
    from cdk_torch.harness.specs import get_spec

    data = tp.init_data(cfg)
    step2, aux, loop = _materialize(get("biharmonic", name), cfg, data)
    if n is None:
        return step2(aux, data)
    if loop is not None:
        return loop(data, n)
    return get_spec("biharmonic").loop_runner(step2, aux, n)(data)


def _jax_out(name, cfg, n):
    from cdk_tpu.core.registry import _materialize, get

    jcfg = _jcfg(cfg)
    data = _jdata(cfg)
    step2, aux, loop = _materialize(get("biharmonic", name), jcfg, data)
    return np.asarray(step2(aux, data) if n is None else loop(data, n))


@pytest.mark.parametrize("name", F64_FORMS)
@pytest.mark.parametrize("cfg", sorted(CONFIGS))
def test_exact_forms_step_f64_vs_jax(cfg, name):
    got = _port_out(name, CONFIGS[cfg], None)
    want = _jax_out(name, CONFIGS[cfg], None)
    assert got.shape == want.shape and got.dtype == torch.float64
    assert rel_l2(got, want) < 1e-13


@pytest.mark.parametrize("n", [1, 2, 5])
@pytest.mark.parametrize("name", LOOP_FORMS)
def test_exact_forms_loop_f64_vs_jax(name, n):
    assert rel_l2(_port_out(name, GROUP, n), _jax_out(name, GROUP, n)) < 1e-13


@pytest.mark.parametrize("n", [None, 1, 2, 5])
def test_pallas_fused_f32_vs_jax(n):
    """K4's exact form against the JAX kernel (interpret mode) at the f32
    gate: one step at the real radius, loops at rrearth = 1 (denormals)."""
    cfg = with_overrides(GROUP, dtype="float32",
                         rrearth=GROUP.rrearth if n is None else 1.0)
    got = _port_out("pallas_fused", cfg, n)
    assert got.dtype == torch.float32
    assert rel_l2(got, _jax_out("pallas_fused", cfg, n)) < 2e-5


@pytest.mark.parametrize("name,gate", [
    ("fused_operator", 2e-5), ("fused_operator_bd8", 2e-5),
    ("fused_operator_pallas", 2e-5), ("fused_operator_bd", 2e-5),
    ("pallas_fused", 2e-5),
    # fast-math forms: the loose gate
    ("fused_operator_bf16", 1e-2), ("fused_operator_bd8_bf16", 1e-2),
    ("pallas_fused_bf16", 1e-2),
])
def test_f32_forms_against_reference(name, gate):
    """One f32 step at the real radius against the f64 reference, at the
    variant's gate; the bf16 forms are measurably inexact."""
    got = _port_out(name, with_overrides(GROUP, dtype="float32"), None)
    ref = tr.make_reference(GROUP)(tp.init_data(GROUP))
    err = rel_l2(got, ref)
    assert 0 < err < gate
    assert (err > 1e-4) == name.endswith("_bf16")


def test_stage_matrices_and_packing_match_jax():
    from cdk_torch.kernels.biharmonic import fused as tfused
    from cdk_tpu.kernels.biharmonic import pallas_fused as jfused

    j = _jdata(GROUP)
    t = _as_torch(j, torch.float64)
    assert np.array_equal(tfused.stage_matrices(t.dvv).numpy(),
                          np.stack(jop.stage_matrices(np.asarray(j.dvv))))
    assert np.array_equal(
        tfused.pack_element_fields(t.dinv, t.spheremp, t.tensorvisc).numpy(),
        np.asarray(jfused.pack_element_fields(j.dinv, j.spheremp, j.tensorvisc)))


def test_fused_plain_is_the_weak_laplacian():
    """The stage chain at f64 equals the reference (its contractions are
    the kron-structured stage matrices)."""
    from cdk_torch.kernels.biharmonic import fused as tfused

    t = tp.init_data(GROUP)
    elem = tfused.pack_element_fields(t.dinv, t.spheremp, t.tensorvisc)
    got = tfused.fused_laplace_plain(t.dvv, elem, tp.to_lane_layout(t.qtens),
                                     GROUP.rrearth)
    ref = tr.make_reference(GROUP)(t)
    assert rel_l2(tp.from_lane_layout(got, GROUP), ref) < 1e-13


def test_fused_laplace_and_operator_apply_contracts():
    from cdk_torch.kernels.biharmonic import fused as tfused

    t = tp.init_data(with_overrides(SMALL, dtype="float32"))
    elem = tfused.pack_element_fields(t.dinv, t.spheremp, t.tensorvisc)
    q = tp.to_lane_layout(t.qtens)
    before = (tfused.fused_laplace.launches, tres.apply_operator_pallas.launches,
              tres.bd8_resident.launches)
    out = tfused.fused_laplace(t.dvv, elem, q, 1.0)
    assert out.shape == q.shape
    torch.testing.assert_close(
        out, tfused.fused_laplace_plain(t.dvv, elem, q, 1.0), rtol=0, atol=0)
    with pytest.raises(ValueError, match="precision"):
        tfused.fused_laplace(t.dvv, elem, q, 1.0, "high")
    with pytest.raises(TypeError, match="float32"):
        tfused.fused_laplace(t.dvv.double(), elem, q, 1.0)
    with pytest.raises(ValueError, match="want"):
        tfused.fused_laplace(t.dvv, elem[:2], q, 1.0)
    L = top.build_element_operator(t.dvv, t.dinv, t.spheremp, t.tensorvisc, 1.0)
    torch.testing.assert_close(tres.apply_operator_pallas(L, q),
                               torch.bmm(L, q), rtol=0, atol=0)
    with pytest.raises(TypeError):
        tres.apply_operator_pallas(L.double(), q)
    # CPU tensors run the plain versions: no launch is counted
    assert (tfused.fused_laplace.launches, tres.apply_operator_pallas.launches,
            tres.bd8_resident.launches) == before


def test_fused_operator_bd_refuses_a_dense_operator_past_2_gib():
    from cdk_torch.core.registry import UnsupportedConfigError, get

    big = with_overrides(BiharmonicConfig(), nelemd=5400, qsize=10)
    with pytest.raises(UnsupportedConfigError, match="GiB"):
        get("biharmonic", "fused_operator_bd").fn(big)
