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
