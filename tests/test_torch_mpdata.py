"""MPDATA in the port (cdk_torch) against the JAX package (cdk_tpu) on
bitwise-identical inputs: init, the staged reference, and the resident
step loop (K2's plain version on the CPU against the JAX `pallas_xmajor`
kernel in Pallas interpret mode).  Geometries are the JAX test's: a
padded one, an odd nzm, and the shipped (48, 32, 58).  Tolerances at f64:
rel L1 < 1e-13 for the reference (the family gate) and < 1e-12 for the
hoisted loop, whose reassociation costs ~1 ulp per step in both packages."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from cdk_torch.core.config import MpdataConfig, with_overrides
from cdk_torch.core.norms import rel_l1
from cdk_torch.kernels.mpdata import problem as tp
from cdk_torch.kernels.mpdata import reference as tr
from cdk_torch.kernels.mpdata import resident as tres
from cdk_tpu.core import config as jconfig
from cdk_tpu.core.registry import _materialize, get
from cdk_tpu.kernels.mpdata import problem as jp
from cdk_tpu.kernels.mpdata import reference as jr

GEOMS = {"padded": (4, 8, 12), "odd_nzm": (6, 5, 9), "shipped": (48, 32, 58)}


def _cfg(geom, dtype="float64"):
    s, nx, nz = GEOMS[geom]
    return with_overrides(MpdataConfig(), nslices=s, nx=nx, nz=nz, dtype=dtype)


def _jcfg(cfg):
    return jconfig.MpdataConfig(**dataclasses.asdict(cfg))


def _as_torch(jdata, dtype):
    return tp.from_numpy({f.name: np.asarray(getattr(jdata, f.name))
                          for f in dataclasses.fields(jdata)}, dtype=dtype)


@functools.cache
def _jax_xmajor(geom, dtype, n):
    """JAX pallas_xmajor (interpret mode): step for n=1, loop otherwise."""
    cfg = _jcfg(_cfg(geom, dtype))
    data = jp.init_data(cfg)
    step2, aux, loop = _materialize(get("mpdata", "pallas_xmajor"), cfg, data)
    out = step2(aux, data) if n == 1 else loop(data, n)
    return tuple(np.asarray(o) for o in out)


@pytest.mark.parametrize("geom", sorted(GEOMS))
def test_init_bitwise_equal_to_jax(geom):
    cfg = _cfg(geom)
    t, j = tp.init_data(cfg), jp.init_data(_jcfg(cfg))
    via = _as_torch(j, torch.float64)
    for f in dataclasses.fields(t):
        tv = getattr(t, f.name)
        assert np.array_equal(tv.numpy(), np.asarray(getattr(j, f.name)))
        assert torch.equal(getattr(via, f.name), tv)


def test_device_init_is_seeded():
    cfg = with_overrides(_cfg("padded", "float32"), device_init=True)
    a, b = tp.init_data(cfg), tp.init_data(cfg)
    for f in dataclasses.fields(a):
        assert torch.equal(getattr(a, f.name), getattr(b, f.name))
    assert a.w.shape == (4, 12, 12) and a.f.dtype == torch.float32
    assert -0.5 <= a.u.min() and a.u.max() < 0.5
    assert 0.5 <= a.rho.min() and a.rho.max() < 1.5


@pytest.mark.parametrize("geom", sorted(GEOMS))
def test_reference_parity(geom):
    cfg = _cfg(geom)
    j = jp.init_data(_jcfg(cfg))
    f_j, flux_j = jr.make_reference(_jcfg(cfg))(j)
    f_t, flux_t = tr.make_reference(cfg)(_as_torch(j, torch.float64))
    assert f_t.shape == f_j.shape and flux_t.shape == flux_j.shape
    assert rel_l1(f_t, np.asarray(f_j)) < 1e-13
    assert rel_l1(flux_t, np.asarray(flux_j)) < 1e-13


@pytest.mark.parametrize("n", [1, 4])
@pytest.mark.parametrize("geom", sorted(GEOMS))
def test_resident_vs_jax_xmajor(geom, n):
    cfg = _cfg(geom)
    data = tp.init_data(cfg)
    made = tres.make_pallas_xmajor(cfg)
    if n == 1:
        f_t, flux_t = made["step"](made["prepare"](data), data)
    else:
        f_t, flux_t = made["loop"](data, n)
    f_j, flux_j = _jax_xmajor(geom, "float64", n)
    assert rel_l1(f_t, f_j) < 1e-12
    assert rel_l1(flux_t, flux_j) < 1e-12
    # flux(:, nz) passes through every step
    assert torch.equal(flux_t[:, -1], data.flux[:, -1])


def test_resident_f32_vs_jax_xmajor():
    cfg = _cfg("odd_nzm", "float32")
    f_t, flux_t = tres.make_pallas_xmajor(cfg)["loop"](tp.init_data(cfg), 4)
    f_j, flux_j = _jax_xmajor("odd_nzm", "float32", 4)
    assert f_t.dtype == torch.float32
    assert rel_l1(f_t, f_j) < 1e-6 and rel_l1(flux_t, flux_j) < 1e-5


def test_resident_loop_zero_and_contract():
    d = tp.init_data(_cfg("odd_nzm"))
    args = (d.f, d.u, d.w, d.rho, d.rhow, d.adz, d.flux)
    before = tres.advect_resident.launches
    f0, flux0 = tres.advect_resident(*args, 0)
    assert torch.equal(f0, d.f) and torch.equal(flux0, d.flux)
    assert tres.advect_resident.launches == before  # CPU runs the plain version
    with pytest.raises(ValueError, match="n must be"):
        tres.advect_resident(*args, -1)
    with pytest.raises(ValueError, match="shape"):
        tres.advect_resident(d.f, d.u[:, 1:], *args[2:], 1)
    with pytest.raises(TypeError):
        tres.advect_resident(d.f, d.u.float(), *args[2:], 1)
    with pytest.raises(TypeError, match="float32 or float64"):
        tres.advect_resident(*(a.to(torch.bfloat16) for a in args), 1)


# ---- the staged kernels (K6 pallas_fused, K7 pallas_packed(_bf16), K8
# pallas_resident), K9 pallas_hoisted and K10 pallas_lanes against the JAX
# variants of the same names (Pallas in interpret mode), on the two small
# geometries (even slice counts and nz <= 64, which the JAX packed forms
# need; the port's kernels have no such guard)

NEW_VARIANTS = ["pallas_fused", "pallas_packed", "pallas_resident",
                "pallas_hoisted", "pallas_lanes"]
SMALL_GEOMS = ["padded", "odd_nzm"]


@functools.cache
def _jax_variant(name, geom, dtype, n):
    """A JAX variant's output: step for n=None, else n steps through its
    loop (or the spec's chained runner where it has none)."""
    from cdk_tpu.harness.specs import get_spec as jget_spec

    cfg = _jcfg(_cfg(geom, dtype))
    data = jp.init_data(cfg)
    step2, aux, loop = _materialize(get("mpdata", name), cfg, data)
    if n is None:
        out = step2(aux, data)
    elif loop is not None:
        out = loop(data, n)
    else:
        out = jget_spec("mpdata").scan_runner(step2, aux, n)(data)
    return tuple(np.asarray(o) for o in out)


def _port_variant(name, geom, dtype, n):
    from cdk_torch.core.registry import _materialize as tmat
    from cdk_torch.core.registry import get as tget
    from cdk_torch.harness.specs import get_spec

    cfg = _cfg(geom, dtype)
    data = tp.init_data(cfg)
    step2, aux, loop = tmat(tget("mpdata", name), cfg, data)
    if n is None:
        return step2(aux, data)
    if loop is not None:
        return loop(data, n)
    return get_spec("mpdata").loop_runner(step2, aux, n)(data)


@pytest.mark.parametrize("geom", SMALL_GEOMS)
@pytest.mark.parametrize("name", NEW_VARIANTS)
def test_new_variant_step_vs_jax_f64(name, geom):
    """One step at f64, within the family gate."""
    f_t, flux_t = _port_variant(name, geom, "float64", None)
    f_j, flux_j = _jax_variant(name, geom, "float64", None)
    assert f_t.shape == f_j.shape and flux_t.shape == flux_j.shape
    assert rel_l1(f_t, f_j) < 1e-13 and rel_l1(flux_t, flux_j) < 1e-13


@pytest.mark.parametrize("n", [1, 2, 5])
@pytest.mark.parametrize("geom", SMALL_GEOMS)
@pytest.mark.parametrize("name", NEW_VARIANTS)
def test_new_variant_loop_vs_jax_f64(name, geom, n):
    """n steps at f64: the staged forms within the family gate; the
    hoisted one within 1e-12 (its reassociation costs ~1 ulp per step)."""
    gate = 1e-12 if name == "pallas_hoisted" else 1e-13
    f_t, flux_t = _port_variant(name, geom, "float64", n)
    f_j, flux_j = _jax_variant(name, geom, "float64", n)
    assert rel_l1(f_t, f_j) < gate and rel_l1(flux_t, flux_j) < gate


@pytest.mark.parametrize("name,gate_f,gate_flux", [
    ("pallas_fused", 1e-6, 1e-5), ("pallas_packed", 1e-6, 1e-5),
    ("pallas_resident", 1e-6, 1e-5), ("pallas_hoisted", 1e-6, 1e-5),
    ("pallas_lanes", 1e-6, 1e-5),
    # the loose fast-math gate; the port rounds every operation to bf16
    ("pallas_packed_bf16", 1e-2, 1e-1),
])
def test_f32_and_bf16_forms_against_reference(name, gate_f, gate_flux):
    """f32 outputs (4 steps) at their registered gates against the f64
    reference stepped as often."""
    from cdk_torch.harness.specs import get_spec

    cfg64 = _cfg("odd_nzm")
    d64 = tp.init_data(cfg64)
    ref = get_spec("mpdata").loop_runner(
        lambda aux, d: tr.advect_scalar2d(d.f, d.u, d.w, d.rho, d.rhow,
                                          d.adz, d.flux), (), 4)(d64)
    f_t, flux_t = _port_variant(name, "odd_nzm", "float32", 4)
    assert f_t.dtype == torch.float32 and flux_t.dtype == torch.float32
    assert 0 <= rel_l1(f_t, ref[0]) < gate_f
    assert 0 <= rel_l1(flux_t, ref[1]) < gate_flux


def test_packed_bf16_matches_jax_bf16():
    """In bf16 both packages round every operation: the port's plain
    version equals the JAX form's output within the loose gate."""
    f_t, flux_t = _port_variant("pallas_packed_bf16", "padded", "float32", 2)
    f_j, flux_j = _jax_variant("pallas_packed_bf16", "padded", "float32", 2)
    assert rel_l1(f_t, f_j) < 1e-2 and rel_l1(flux_t, flux_j) < 1e-1


def test_staged_wrappers_contract():
    from cdk_torch.kernels.mpdata import staged

    d = tp.init_data(_cfg("odd_nzm"))
    args = (d.f, d.u, d.w, d.rho, d.rhow, d.adz, d.flux)
    wrappers = (staged.advect_fused, staged.advect_packed,
                staged.advect_staged_resident)
    before = [w.launches for w in wrappers]
    for w in wrappers:
        f0, flux0 = w(*args, 0)
        assert torch.equal(f0, d.f) and torch.equal(flux0, d.flux)
        f2, flux2 = w(*args, 2)
        f1, flux1 = tr.advect_scalar2d(*args)
        want = tr.advect_scalar2d(f1, *args[1:6], flux1)
        assert torch.equal(f2, want[0]) and torch.equal(flux2, want[1])
        with pytest.raises(ValueError, match="n must be"):
            w(*args, -1)
        with pytest.raises(ValueError, match="shape"):
            w(d.f, d.u[:, 1:], *args[2:], 1)
    # the staged form takes bf16 (the hoisted one does not)
    bf = [a.to(torch.bfloat16) for a in args]
    assert staged.advect_packed(*bf, 1)[0].dtype == torch.bfloat16
    with pytest.raises(TypeError, match="float32 or float64"):
        tres.advect_hoisted_resident(*bf, 1)
    with pytest.raises(TypeError, match="float32 or float64 or bfloat16"):
        staged.advect_fused(*(a.half() for a in args), 1)
    # CPU tensors run the plain version: no launch is counted
    assert [w.launches for w in wrappers] == before


def test_lanes_layout_and_wrapper_contract():
    from cdk_torch.kernels.mpdata import lanes

    d = tp.init_data(_cfg("odd_nzm"))
    xzs = [lanes.to_xzs(getattr(d, n)) for n in lanes.FIELDS]
    assert xzs[0].shape == (11, 8, 6) and xzs[0].is_contiguous()
    assert xzs[3].shape == (8, 6)
    assert torch.equal(lanes.from_xzs(xzs[0]), d.f)
    before = lanes.advect_lanes.launches
    f_x, flux_x = lanes.advect_lanes(*xzs)
    f_r, flux_r = tr.advect_scalar2d(d.f, d.u, d.w, d.rho, d.rhow, d.adz, d.flux)
    assert torch.equal(lanes.from_xzs(f_x), f_r)
    assert torch.equal(lanes.from_xzs(flux_x), flux_r)
    assert lanes.advect_lanes.launches == before
    with pytest.raises(ValueError, match=r"\(x, z, s\)"):
        lanes.advect_lanes(d.f, *xzs[1:])
    with pytest.raises(TypeError, match="float32 or float64"):
        lanes.advect_lanes(*(t.to(torch.bfloat16) for t in xzs))
