"""The port's domain-decomposed MPDATA (cdk_torch.dist) against the JAX
package's (cdk_tpu.dist) on bitwise-identical inputs.

The JAX side runs on the conftest's 8 virtual CPU devices with its Pallas
kernels in interpret mode; the port runs on a mesh of P shards on the CPU,
where each masked-core wrapper (K20-K25) runs its plain version.  Each JAX
output is computed once per module.  Tolerances at f64 (rel L1): the
masked cores and steps 1e-14 on f (flux partial sums reassociate: 1e-13 for
a decomposed step's flux), the hoisted k-loop 1e-12 (~1 ulp per step of
reassociation in both packages), the slice-batch loop 1e-5 at f32."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from cdk_torch.core.config import MpdataConfig, with_overrides
from cdk_torch.core.norms import rel_l1
from cdk_torch.dist import mesh as tmesh
from cdk_torch.dist import mpdata as tdist
from cdk_torch.kernels.mpdata import masked
from cdk_torch.kernels.mpdata import problem as tp
from cdk_tpu.core import config as jconfig
from cdk_tpu.dist import mesh as jmesh
from cdk_tpu.dist import mpdata as jdist
from cdk_tpu.kernels.mpdata import problem as jp

SHIPPED = MpdataConfig()
SMALL = with_overrides(MpdataConfig(), nslices=16, nz=12)          # nx 32
WIDE = with_overrides(MpdataConfig(), nx=64, nslices=4, nz=12)


def _jcfg(cfg):
    return jconfig.MpdataConfig(**dataclasses.asdict(cfg))


def _data(cfg):
    """(JAX data, the port's data from the same host arrays)."""
    j = jp.init_data(_jcfg(cfg))
    t = tp.from_numpy({f.name: np.asarray(getattr(j, f.name))
                       for f in dataclasses.fields(j)},
                      dtype=cfg.torch_dtype)
    return j, t


def _mesh(p):
    return tmesh.make_mesh(p, "cpu")


@functools.cache
def _jax_step(cfg, p, kernel, overlap, nsteps):
    """JAX make_dist_step (or its overlap form) chained nsteps times ->
    (global f, flux) as numpy."""
    j, _ = _data(cfg)
    m = jmesh.make_mesh(p)
    si, step, gather = jdist.make_dist_step(cfg, m, kernel=kernel)
    if overlap:
        step = jdist.make_dist_step_overlap(cfg, m, kernel=kernel)
    f_s, u_s, w_s, (rho, rhow, adz, flux) = si(j)
    for _ in range(nsteps):
        f_s, flux = step(f_s, u_s, w_s, (rho, rhow, adz, flux))
    return gather(f_s), np.asarray(flux)


@functools.cache
def _jax_loop(cfg, p, n, kernel=None, kstep=1, overlap=False):
    j, _ = _data(cfg)
    m = jmesh.make_mesh(p)
    si, _, gather = jdist.make_dist_step(cfg, m, kernel=kernel)
    loop = jdist.make_dist_loop(cfg, m, kernel=kernel, kstep=kstep,
                                overlap=overlap)
    f, flux = loop(*si(j), n)
    return gather(f), np.asarray(flux)


def _port_step(cfg, p, kernel, overlap, nsteps):
    _, t = _data(cfg)
    m = _mesh(p)
    si, step, gather = tdist.make_dist_step(cfg, m, kernel=kernel)
    if overlap:
        step = tdist.make_dist_step_overlap(cfg, m, kernel=kernel)
    f_s, u_s, w_s, (rho, rhow, adz, flux) = si(t)
    for _ in range(nsteps):
        f_s, flux = step(f_s, u_s, w_s, (rho, rhow, adz, flux))
    return gather(f_s), flux


def test_masked_global_matches_jax():
    """The global masked core at the shipped f64 config."""
    j, t = _data(SHIPPED)
    f_j, flux_j = jdist.advect_masked_global(j)
    f_t, flux_t = tdist.advect_masked_global(t)
    assert f_t.shape == f_j.shape and flux_t.shape == flux_j.shape
    assert rel_l1(f_t, np.asarray(f_j)) < 1e-14
    assert rel_l1(flux_t, np.asarray(flux_j)) < 1e-14


@pytest.mark.parametrize("nsteps", [1, 3])
@pytest.mark.parametrize("p", [2, 4])
def test_dist_step_matches_jax(p, nsteps):
    """The AUTO decomposed step at the shipped config, one step and three
    chained, on the same number of shards as JAX's devices."""
    f_t, flux_t = _port_step(SHIPPED, p, None, False, nsteps)
    f_j, flux_j = _jax_step(SHIPPED, p, None, False, nsteps)
    assert f_t.shape == f_j.shape
    assert rel_l1(f_t, f_j) < 1e-14
    assert rel_l1(flux_t, flux_j) < 1e-13


@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("kernel", ["pallas", "packed", "xmajor", "jnp"])
def test_every_kernel_name_matches_jax(kernel, overlap):
    """Each named masked core (K20, K21, K22, the plain one), serialized and
    split for overlap, against JAX's same-named form on 4 shards."""
    f_t, flux_t = _port_step(SMALL, 4, kernel, overlap, 1)
    f_j, flux_j = _jax_step(SMALL, 4, kernel, overlap, 1)
    assert rel_l1(f_t, f_j) < 1e-14
    assert rel_l1(flux_t, flux_j) < 1e-14


def _window(cfg, h):
    """A P = 1 window of the collocated fields with zero strips of h."""
    _, t = _data(cfg)
    f, u, w = tdist.to_collocated(t)
    z, zw = torch.zeros_like(f[:, :h]), torch.zeros_like(w[:, :h])
    return (f, z, torch.cat([z, u, z], 1), torch.cat([zw, w, zw], 1),
            (t.rho, t.rhow, t.adz))


@pytest.mark.parametrize("nsteps", [0, 1, 2, 4])
def test_split_forms_equal_concat_window(nsteps):
    """K23's and K25's plain forms (halo assembled from the strips, owned
    columns returned) are bitwise equal to K22's and K24's on the
    concatenated window."""
    h = 3 * max(nsteps, 1)
    f, z, u_e, w_e, aux = _window(SMALL, h)
    X = f.shape[1]
    f_e = torch.cat([z, f, z], 1)
    kw = dict(nx=SMALL.nx, nzm=SMALL.nzm)
    if nsteps == 1:
        a = masked.masked_step_xmajor(f_e, u_e, w_e, *aux, -2 - h, **kw,
                                      owned_lo=h, owned_hi=h + X)
        b = masked.masked_step_xmajor_split(f, z, z, u_e, w_e, *aux, -2 - h,
                                            **kw, halo=h)
        assert torch.equal(a[0][:, h:h + X], b[0]) and torch.equal(a[1], b[1])
    a = masked.masked_kloop_xmajor(f_e, u_e, w_e, *aux, -2 - h, **kw,
                                   owned_lo=h, owned_hi=h + X, nsteps=nsteps)
    b = masked.masked_kloop_xmajor_split(f, z, z, u_e, w_e, *aux, -2 - h,
                                         **kw, halo=h, nsteps=nsteps)
    assert torch.equal(a[0][:, h:h + X], b[0]) and torch.equal(a[1], b[1])
    if nsteps == 0:
        assert torch.equal(b[0], f) and not b[1].any()


@pytest.mark.parametrize("split", [True, False])
@pytest.mark.parametrize("kstep", [2, 4])
def test_kloop_matches_jax(kstep, split):
    """The communication-avoiding loop (K25, or K24 with split=False) on 4
    shards, 8 steps, against JAX's."""
    _, t = _data(WIDE)
    m = _mesh(4)
    si, _, gather = tdist.make_dist_step(WIDE, m)
    loop = tdist.make_dist_loop(WIDE, m, kstep=kstep, split=split)
    f_t, flux_t = loop(*si(t), 8)
    f_j, flux_j = _jax_loop(WIDE, 4, 8, "xmajor", kstep)
    assert rel_l1(gather(f_t), f_j) < 1e-12
    assert rel_l1(flux_t, flux_j) < 1e-12


@pytest.mark.parametrize("kernel,overlap", [(None, False), ("pallas", False),
                                            (None, True)])
def test_step_loop_matches_chained_and_jax(kernel, overlap):
    """The per-step loop at n = 5 equals five chained port steps and JAX's
    loop of the same form."""
    _, t = _data(WIDE)
    m = _mesh(4)
    si, step, gather = tdist.make_dist_step(WIDE, m, kernel=kernel)
    f_s, u_s, w_s, aux = si(t)
    loop = tdist.make_dist_loop(WIDE, m, kernel=kernel, overlap=overlap)
    f_l, flux_l = loop(f_s, u_s, w_s, aux, 5)
    f_c, flux_c = f_s, aux[3]
    for _ in range(5):
        f_c, flux_c = step(f_c, u_s, w_s, (*aux[:3], flux_c))
    assert rel_l1(gather(f_l), gather(f_c)) < 1e-15
    assert rel_l1(flux_l, flux_c) < 1e-15
    f_j, flux_j = _jax_loop(WIDE, 4, 5, kernel, 1, overlap)
    assert rel_l1(gather(f_l), f_j) < 1e-13
    assert rel_l1(flux_l, flux_j) < 1e-13


def test_slices_loop_matches_jax():
    """The slice-batch loop on 2 shards (K2 per shard) against JAX's, f32."""
    cfg = with_overrides(MpdataConfig(), nslices=32, nx=16, nz=12,
                         dtype="float32")
    j, t = _data(cfg)
    si, loop = tdist.make_dist_loop_slices(cfg, _mesh(2))
    f_t, flux_t = loop(*si(t), 3)
    jsi, jloop, (gather_f, gather_flux) = jdist.make_dist_loop_slices(
        _jcfg(cfg), jmesh.make_mesh(2))
    f_j, flux_j = jloop(*jsi(j), 3)
    assert f_t.dtype == torch.float32
    assert rel_l1(f_t, gather_f(f_j)[:, :, :cfg.nzm]) < 1e-5
    assert rel_l1(flux_t, gather_flux(flux_j)) < 1e-5


@pytest.mark.parametrize("case", ["step", "loop", "overlap", "kloop",
                                  "kloop_kernel"])
def test_geometry_guards_raise_where_jax_does(case):
    narrow = with_overrides(MpdataConfig(), nx=10, nslices=4, nz=12)  # chunk 2
    mid = with_overrides(MpdataConfig(), nx=16, nslices=4, nz=12)     # chunk 6
    build = {
        "step": (narrow, 8, lambda mod, c, m: mod.make_dist_step(c, m)),
        "loop": (narrow, 8, lambda mod, c, m: mod.make_dist_loop(c, m)),
        "overlap": (with_overrides(narrow, nx=20), 8,                # chunk 4
                    lambda mod, c, m: mod.make_dist_step_overlap(c, m)),
        "kloop": (mid, 4, lambda mod, c, m: mod.make_dist_loop(
            c, m, kernel="xmajor", kstep=4)),
        "kloop_kernel": (mid, 1, lambda mod, c, m: mod.make_dist_loop(
            c, m, kernel="pallas", kstep=2)),
    }
    cfg, p, make = build[case]
    with pytest.raises(ValueError):
        make(jdist, _jcfg(cfg), jmesh.make_mesh(p))
    with pytest.raises(ValueError):
        make(tdist, cfg, _mesh(p))


def test_kloop_step_count_and_mesh_guards():
    m = _mesh(2)
    si, _, _ = tdist.make_dist_step(WIDE, m)
    loop = tdist.make_dist_loop(WIDE, m, kstep=4)
    with pytest.raises(ValueError, match="multiple of kstep"):
        loop(*si(tp.init_data(WIDE)), 6)
    with pytest.raises(ValueError, match="at least one shard"):
        tmesh.make_mesh(0, "cpu")
    with pytest.raises(ValueError, match="shards for"):
        tdist.make_dist_loop_slices(WIDE, _mesh(8))


@pytest.mark.parametrize("form", [dict(), dict(kernel="pallas"),
                                  dict(overlap=True), dict(kstep=2),
                                  dict(kstep=2, split=False)])
def test_loops_at_zero_steps_return_inputs(form):
    """n = 0 returns f and flux_in unchanged in every form (the JAX x-major
    loop returns a zero flux there)."""
    _, t = _data(WIDE)
    m = _mesh(4)
    si, _, _ = tdist.make_dist_step(WIDE, m)
    f_s, u_s, w_s, aux = si(t)
    f0, flux0 = tdist.make_dist_loop(WIDE, m, **form)(f_s, u_s, w_s, aux, 0)
    assert torch.equal(f0, f_s) and torch.equal(flux0, t.flux)


def test_mesh_exchange_and_psum():
    x = torch.arange(2 * 8 * 3, dtype=torch.float64).reshape(2, 8, 3) + 1
    m = _mesh(3)
    s = tmesh.shard_x(x, m, 3)                       # 8 columns -> 3 x 3
    assert s.shape == (3, 2, 3, 3) and s.is_contiguous()
    assert torch.equal(tmesh.gather_x(s)[:, :8], x) and not s[2][:, 2].any()
    left, right = tmesh.exchange_strips(s, 2)
    assert not left[0].any() and not right[-1].any()
    assert torch.equal(left[1], s[0][:, -2:]) and torch.equal(right[1], s[2][:, :2])
    ext = tmesh.exchange(s, 2)
    assert ext.shape == (3, 2, 7, 3) and torch.equal(ext[1][:, 2:5], s[1])
    again = tmesh.exchange_strips(s + 1, 2, out=(left, right))
    assert again[0] is left and torch.equal(left[1], s[0][:, -2:] + 1)
    assert not left[0].any()
    parts = torch.rand(4, 5, dtype=torch.float64)
    assert torch.equal(tmesh.psum(parts),
                       ((parts[0] + parts[1]) + parts[2]) + parts[3])


def test_masked_wrappers_contract():
    """CPU tensors run the plain version (no launch counted); shapes,
    dtypes, nzm and step counts are checked before anything runs."""
    f, z, u_e, w_e, aux = _window(SMALL, 3)
    f_e = torch.cat([z, f, z], 1)
    X = f_e.shape[1]
    wrappers = (masked.masked_step_pallas, masked.masked_step_pallas_packed,
                masked.masked_step_xmajor, masked.masked_step_xmajor_split,
                masked.masked_kloop_xmajor, masked.masked_kloop_xmajor_split)
    before = [w.launches for w in wrappers]
    kw = dict(nx=SMALL.nx, owned_lo=3, owned_hi=X - 3)
    a = masked.masked_step_pallas(f_e, u_e, w_e, *aux, -5, **kw)
    b = masked.masked_step_pallas_packed(f_e, u_e, w_e, *aux, -5, nzm=SMALL.nzm,
                                         **kw)
    c = masked.masked_kloop_xmajor(f_e, u_e, w_e, *aux, -5, nzm=SMALL.nzm,
                                   nsteps=1, **kw)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert rel_l1(c[0], a[0]) < 1e-14 and a[1].shape == (16, SMALL.nzm)
    assert [w.launches for w in wrappers] == before
    with pytest.raises(ValueError, match="shape"):
        masked.masked_step_pallas(f_e, u_e[:, 1:], w_e, *aux, -5, **kw)
    with pytest.raises(ValueError, match="nzm"):
        masked.masked_step_xmajor(f_e, u_e, w_e, *aux, -5, nzm=5, **kw)
    with pytest.raises(ValueError, match="owned"):
        masked.masked_step_pallas(f_e, u_e, w_e, *aux, -5, nx=SMALL.nx,
                                  owned_lo=0, owned_hi=X + 1)
    with pytest.raises(ValueError, match="nsteps"):
        masked.masked_kloop_xmajor(f_e, u_e, w_e, *aux, -5, nzm=SMALL.nzm,
                                   nsteps=-1, **kw)
    with pytest.raises(ValueError, match="strip"):
        masked.masked_step_xmajor_split(f, z[:, :2], z, u_e, w_e, *aux, -5,
                                        nx=SMALL.nx, nzm=SMALL.nzm, halo=3)
    with pytest.raises(TypeError, match="float32 or float64"):
        masked.masked_step_pallas(*(x.to(torch.bfloat16) for x in
                                    (f_e, u_e, w_e, *aux)), -5, **kw)


def test_dist_legs_and_scaling_cli_run(capsys):
    from cdk_torch import cli
    from cdk_torch.harness.distbench import LEGS, run_dist_legs

    cfg = with_overrides(MpdataConfig(), nslices=4, nx=16, nz=12,
                         dtype="float32")
    res = run_dist_legs({"mpdata": "pallas_xmajor"}, trials=1,
                        configs={leg: cfg for leg in LEGS}, device="cpu")
    assert [r.family for r in res] == ["mpdata", "mpdata_slices"]
    assert all(r.ok and r.err < 1e-5 and r.seconds_per_call > 0 for r in res), res
    assert cli.main(["scaling", "mpdata", "--device", "cpu", "--devices", "1,2",
                     "--nx-per-device", "16", "--steps", "2"]) == 0
    out = capsys.readouterr().out
    assert "shards on the CPU" in out and "devices" not in out
    assert cli.main(["scaling", "cke", "--device", "cpu"]) == 2
