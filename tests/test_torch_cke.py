"""CKE in the port (cdk_torch) against the JAX package (cdk_tpu) on
bitwise-identical inputs: host init, the reference (also against the scalar
oracle of tests/test_cke.py), and every variant against its JAX
counterpart, the Pallas ones run through the JAX registry in interpret
mode.  Sizes are the JAX tests' (40x12x7 A=4, 512x96x30 A=7, 300x400x21
A=6), a ragged 130-edge one with 700 cells, and the shipped 25600x2800x100.

Gates are the family's: f64 per-point relative error < errTol = 1e-10,
f32 rel L1 < 1e-6, and the fast-math (bf16) variants rel L1 < 1e-2.  The
port's bf16 forms round to bf16 as the TPU does, while JAX in interpret
mode on the CPU computes the Pallas default-precision product in full f32,
so those are compared at the loose gate only.  On the CPU the kernel
wrappers run their plain versions."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from cdk_torch.core import registry as treg
from cdk_torch.core.config import CkeConfig, with_overrides
from cdk_torch.core.norms import pointwise_check, rel_l1
from cdk_torch.harness.specs import get_spec
from cdk_torch.kernels.cke import lanegather as tlg
from cdk_torch.kernels.cke import onehot as toh
from cdk_torch.kernels.cke import problem as tp
from cdk_torch.kernels.cke import reference as tr
from cdk_torch.kernels.cke import rows as trows
from cdk_torch.kernels.cke import staged as tst
from cdk_tpu.core import config as jconfig
from cdk_tpu.core import registry as jreg
from cdk_tpu.kernels.cke import problem as jp
from cdk_tpu.kernels.cke import reference as jr

SIZES = {
    "small": (40, 12, 7, 4),         # tests/test_cke.py:18
    "mid": (512, 96, 30, 7),         # tests/test_cke.py:174
    "multigroup": (300, 400, 21, 6),  # tests/test_cke.py:194
    "ragged": (130, 700, 21, 6),
    "shipped": (25600, 2800, 100, 10),
}
EXACT = ["gather_peradv", "gather_selfold", "onehot_mxu", "pallas_lanegather",
         "pallas_onehot", "pallas_rows", "staged_consume"]
BF16 = ["onehot_mxu_bf16", "pallas_onehot_bf16"]


def _cfg(size, dtype="float64"):
    e, c, k, a = SIZES[size]
    return with_overrides(CkeConfig(), nedges=e, ncells=c, nvertlevels=k,
                          nadv=a, dtype=dtype)


def _jcfg(cfg):
    return jconfig.CkeConfig(**dataclasses.asdict(cfg))


def _np(x):
    return np.asarray(x, np.float64)


@functools.cache
def _data(size, dtype="float64"):
    """(port data, JAX data) from the same seed."""
    cfg = _cfg(size, dtype)
    return tp.init_data(cfg), jp.init_data(_jcfg(cfg))


@functools.cache
def _jax_out(variant, size, dtype="float64"):
    import cdk_tpu.kernels  # noqa: F401  (registers the JAX variants)

    cfg = _jcfg(_cfg(size, dtype))
    data = _data(size, dtype)[1]
    step2, aux, _ = jreg._materialize(jreg.get("cke", variant), cfg, data)
    return _np(step2(aux, data))


def _port_out(variant, cfg, data):
    return treg.make_step(treg.get("cke", variant), cfg, data)(data)


def oracle_edge_flux(data, coef3rdorder):
    """The scalar-loop original form of tests/test_cke.py: per-edge wgt/sgn
    column temps, gather over the contributing cells, k restricted to the
    cell's [kmin, kmax]."""
    adv_cells = np.asarray(data.adv_cells)
    c1 = _np(data.adv_coefs)
    c3a = _np(data.adv_coefs3)
    tracer = _np(data.tracer)
    ntf = _np(data.ntf)
    adv_mask = _np(data.adv_mask)
    kmin = np.asarray(data.min_level)
    kmax = np.asarray(data.max_level)
    e, a = adv_cells.shape
    flx = np.zeros((e, tracer.shape[1]))
    for ie in range(e):
        wgt = ntf[ie] * adv_mask[ie]
        sgn = np.where(ntf[ie] >= 0.0, 1.0, -1.0)
        for i in range(a):
            ic = adv_cells[ie, i]
            coef3 = c3a[ie, i] * coef3rdorder
            for k in range(kmin[ic], kmax[ic] + 1):
                flx[ie, k] += tracer[ic, k] * wgt[k] * (c1[ie, i] + coef3 * sgn[k])
    return flx


def _assert_errtol(out, want, tol=1e-10):
    n_bad, max_err, lines = pointwise_check(out, want, tol)
    assert n_bad == 0, (max_err, lines[:3])


@pytest.mark.parametrize("size", sorted(SIZES))
def test_init_bitwise_equal_to_jax(size):
    t, j = _data(size)
    via = tp.from_numpy({f.name: np.asarray(getattr(j, f.name))
                         for f in dataclasses.fields(j)})
    for f in dataclasses.fields(t):
        tv = getattr(t, f.name)
        assert np.array_equal(tv.numpy(), np.asarray(getattr(j, f.name))), f.name
        assert tv.dtype == getattr(via, f.name).dtype
        assert torch.equal(getattr(via, f.name), tv), f.name
    for name in ("adv_cells", "min_level", "max_level"):
        assert getattr(t, name).dtype == torch.int32


def test_to_keeps_the_integer_fields_int32():
    d = _data("small")[0]
    for moved in (d.to(torch.float32), d.to("cpu", torch.float32),
                  d.to(dtype=torch.float32), d.to(device="cpu")):
        for f in dataclasses.fields(moved):
            got, src = getattr(moved, f.name), getattr(d, f.name)
            if f.name in ("adv_cells", "min_level", "max_level"):
                assert got.dtype == torch.int32 and torch.equal(got, src)
            else:
                assert got.dtype in (torch.float32, torch.float64)
    assert d.to(torch.float32).tracer.dtype == torch.float32


def test_device_init_is_seeded():
    cfg = with_overrides(_cfg("mid", "float32"), device_init=True)
    a, b = tp.init_data(cfg), tp.init_data(cfg)
    for f in dataclasses.fields(a):
        assert torch.equal(getattr(a, f.name), getattr(b, f.name))
    assert a.adv_cells.dtype == torch.int32 and a.ntf.dtype == torch.float32
    assert 0 <= int(a.adv_cells.min()) and int(a.adv_cells.max()) < cfg.ncells
    assert int(a.max_level.min()) >= 2
    assert int(a.max_level.max()) <= cfg.nvertlevels - 1
    assert bool((a.tracer[a.cell_mask == 0] == 0).all())
    assert -7.5 <= float(a.ntf.min()) and float(a.ntf.max()) <= 7.5


@pytest.mark.parametrize("size", ["small", "mid", "multigroup", "ragged"])
def test_reference_matches_jax_and_oracle(size):
    cfg = _cfg(size)
    t, j = _data(size)
    out = tr.make_reference(cfg)(t)
    assert out.shape == (cfg.nedges, cfg.nvertlevels)
    _assert_errtol(out, _np(jr.make_reference(_jcfg(cfg))(j)))
    _assert_errtol(out, oracle_edge_flux(t, cfg.coef3rdorder))


def test_fsign1_is_one_at_signed_zero():
    x = torch.tensor([-0.0, 0.0, -1e-300, 2.0], dtype=torch.float64)
    assert tr.fsign1(x).tolist() == [1.0, 1.0, -1.0, 1.0]
    assert tr.coef3_of(_cfg("small", "float32")) == float(np.float32(2.14))


@pytest.mark.parametrize("size,variant", [
    (size, v) for size in ("mid", "multigroup") for v in EXACT
    # the JAX pallas_onehot needs nedges % 128 == 0
    if (size, v) != ("multigroup", "pallas_onehot")])
def test_variant_matches_jax_f64(size, variant):
    cfg = _cfg(size)
    out = _port_out(variant, cfg, _data(size)[0])
    assert out.shape == (cfg.nedges, cfg.nvertlevels)
    _assert_errtol(out, _jax_out(variant, size))


def test_onehot_matches_jax_cell_blocked():
    """K12's port against the JAX kernel run with several cell blocks
    (tests/test_cke.py:136-155: 128 x 700 x 12, 256-cell blocks)."""
    from cdk_tpu.kernels.cke import pallas_onehot as jpo

    cfg = with_overrides(CkeConfig(), nedges=128, ncells=700, nvertlevels=12)
    t, j = tp.init_data(cfg), jp.init_data(_jcfg(cfg))
    want = jpo._run(j.adv_cells, j.adv_coefs, j.adv_coefs3, j.tracer,
                    j.cell_mask, j.ntf, j.adv_mask, cfg.coef3rdorder, 64, True,
                    "highest", 256)
    _assert_errtol(_port_out("pallas_onehot", cfg, t), _np(want))


@pytest.mark.parametrize("variant", EXACT)
def test_variant_matches_jax_f32(variant):
    cfg = _cfg("mid", "float32")
    out = _port_out(variant, cfg, _data("mid", "float32")[0])
    assert out.dtype == torch.float32
    assert rel_l1(out, _jax_out(variant, "mid", "float32")) < 1e-6


@pytest.mark.parametrize("variant", BF16)
def test_bf16_variants_at_the_loose_gate(variant):
    cfg = _cfg("mid", "float32")
    data = _data("mid", "float32")[0]
    out = _port_out(variant, cfg, data)
    assert rel_l1(out, _jax_out(variant, "mid", "float32")) < 1e-2
    assert rel_l1(out, tr.make_reference(cfg)(data)) < 1e-2
    assert treg.get("cke", variant).fast_math


@pytest.mark.parametrize("variant", ["gather_peradv", "onehot_mxu",
                                     "pallas_onehot", "pallas_rows"])
def test_duplicate_cells_accumulate(variant):
    """Two identical (edge, i) entries contribute twice (the reference
    accumulates, nested.F90:545-550)."""
    cfg = _cfg("small")
    t, j = _data("small")
    dup = t.adv_cells.clone()
    dup[:, 1] = dup[:, 0]
    d2 = dataclasses.replace(t, adv_cells=dup)
    j2 = dataclasses.replace(j, adv_cells=jp.jnp.asarray(dup.numpy()))
    oracle = oracle_edge_flux(d2, cfg.coef3rdorder)
    out = _port_out(variant, cfg, d2)
    _assert_errtol(out, oracle)
    _assert_errtol(out, _np(jr.make_reference(_jcfg(cfg))(j2)))


@pytest.mark.parametrize("variant", ["pallas_rows", "staged_consume",
                                     "pallas_onehot", "pallas_lanegather"])
@pytest.mark.parametrize("size", ["ragged", "multigroup"])
def test_kernel_variants_take_ragged_shapes(variant, size):
    """130 and 300 edges, 21 levels (no multiple of 8 or 128 anywhere),
    700 cells."""
    cfg = _cfg(size)
    t, j = _data(size)
    out = _port_out(variant, cfg, t)
    _assert_errtol(out, _np(jr.make_reference(_jcfg(cfg))(j)))
    _assert_errtol(out, tr.make_reference(cfg)(t))


def test_shipped_size_parity():
    """The shipped nested.nml size at f64: the port's reference and
    champion against the JAX package's, per point at errTol."""
    cfg = _cfg("shipped")
    t = _data("shipped")[0]
    for variant in ("reference_jnp", "gather_peradv"):
        _assert_errtol(_port_out(variant, cfg, t), _jax_out(variant, "shipped"))


def test_loop_feeds_the_masked_tracer_back():
    cfg = _cfg("mid")
    t, j = _data("mid")
    spec = get_spec("cke")
    step2, aux, _ = treg._materialize(treg.get("cke", "pallas_rows"), cfg, t)
    from cdk_tpu.harness.specs import get_spec as jget_spec

    jstep2, jaux, _ = jreg._materialize(jreg.get("cke", "reference_jnp"),
                                        _jcfg(cfg), j)
    for n in (0, 1, 3):
        got = spec.loop_runner(step2, aux, n)(t)
        want = _np(jget_spec("cke").scan_runner(jstep2, jaux, n)(j))
        if n == 0:
            assert not got.any() and not want.any()
        else:
            _assert_errtol(got, want)


def test_wrappers_on_the_cpu_run_plain_and_check_inputs():
    cfg = _cfg("small")
    d = _data("small")[0]
    c3 = tr.coef3_of(cfg)
    t = d.tracer * d.cell_mask
    args = (d.adv_cells, d.adv_coefs, d.adv_coefs3, t, d.ntf, d.adv_mask)
    before = (trows.cke_rows.launches, toh.cke_onehot.launches,
              tst.cke_staged.launches, tlg.cke_lanegather.launches)
    ref = trows.cke_rows_plain(*args, c3)
    assert torch.equal(trows.cke_rows(*args, c3), ref)
    assert rel_l1(toh.cke_onehot(*args, c3), ref) < 1e-14
    buf = torch.empty((cfg.nadv, cfg.nedges, cfg.nvertlevels),
                      dtype=torch.float64)
    staged = tst.stage_slots(t, d.adv_cells, buf)
    assert staged is buf
    assert torch.equal(tst.cke_staged(staged, *args[1:3], *args[4:], c3), ref)
    trans = (d.adv_cells.T.contiguous(), d.adv_coefs.T.contiguous(),
             d.adv_coefs3.T.contiguous(), t.T.contiguous(),
             (d.ntf * d.adv_mask).T.contiguous(),
             tr.fsign1(d.ntf).T.contiguous())
    assert torch.equal(tlg.cke_lanegather(*trans, c3).T, ref)
    assert before == (trows.cke_rows.launches, toh.cke_onehot.launches,
                      tst.cke_staged.launches, tlg.cke_lanegather.launches)
    with pytest.raises(TypeError, match="int32"):
        trows.cke_rows(d.adv_cells.long(), *args[1:], c3)
    with pytest.raises(ValueError, match="shape"):
        trows.cke_rows(*args[:4], d.ntf[:-1], d.adv_mask, c3)
    with pytest.raises(TypeError, match="float32 or float64"):
        trows.cke_rows(args[0], *(x.to(torch.bfloat16) for x in args[1:]), c3)
    with pytest.raises(TypeError, match="float32 form"):
        toh.cke_onehot(*args, c3, True)


def test_dense_guards_match_jax():
    """The applicability guards sit at the JAX thresholds, so both packages
    run the same variants at each config."""
    import cdk_tpu.kernels  # noqa: F401
    from cdk_tpu.core.registry import UnsupportedConfigError as JUnsupported

    prod = with_overrides(_cfg("shipped"), nedges=256000, ncells=28000,
                          dtype="float32")
    for cfg in (_cfg("shipped"), prod):
        for name in ("onehot_mxu", "onehot_mxu_bf16", "staged_consume",
                     "pallas_onehot", "pallas_onehot_bf16"):
            try:
                jreg.get("cke", name).fn(_jcfg(cfg))
                j_ok = True
            except JUnsupported:
                j_ok = False
            try:
                treg.get("cke", name).fn(cfg)
                t_ok = True
            except treg.UnsupportedConfigError:
                t_ok = False
            assert t_ok == j_ok == (cfg is not prod), name
