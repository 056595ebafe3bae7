"""The port's core (cdk_torch.core, harness gates, registry) against the JAX
package's: bitwise-equal input streams, equal norms and gates, the same
config fields, presets and variant flags, and no jax at import time."""

import dataclasses
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from cdk_torch.core import build as tbuild
from cdk_torch.core import config as tconfig
from cdk_torch.core import frng as tfrng
from cdk_torch.core import norms as tnorms
from cdk_torch.core import registry as treg
from cdk_torch.core.platform import resolve_device
from cdk_torch.core.timer import slope_time_detail
from cdk_tpu.core import config as jconfig
from cdk_tpu.core import frng as jfrng
from cdk_tpu.core import norms as jnorms

ROOT = Path(__file__).resolve().parents[1]


def test_frng_streams_bitwise():
    a, b = tfrng.Lcg(), jfrng.Lcg()
    assert np.array_equal(a.draw(1000), b.draw(1000))
    assert np.array_equal(a.fill_fortran((4, 4, 3, 2)),
                          b.fill_fortran((4, 4, 3, 2)))
    assert a.state == b.state
    assert np.array_equal(tfrng.HostRng(100).uniform((7, 11)),
                          jfrng.HostRng(100).uniform((7, 11)))


def test_norms_equal():
    rng = np.random.default_rng(5)
    x, ref = rng.standard_normal((2, 64, 9))
    ref[3, 4] = 0.0
    x32 = torch.from_numpy(x).float()
    for fn in ("rel_l2", "rel_l1"):
        want = getattr(jnorms, fn)(x, ref)
        assert getattr(tnorms, fn)(x, ref) == want
        assert getattr(tnorms, fn)(torch.from_numpy(x), torch.from_numpy(ref)) == want
        assert getattr(tnorms, fn)(x32, ref) == getattr(jnorms, fn)(
            x32.numpy(), ref)
        assert getattr(tnorms, fn)(np.zeros(3), np.zeros(3)) == 0.0
    y = ref * (1 + 1e-9)
    y[0, 0] = np.nan
    assert tnorms.pointwise_check(y, ref, 1e-10) == jnorms.pointwise_check(
        y, ref, 1e-10)


@pytest.mark.parametrize("name", ["BiharmonicConfig", "MpdataConfig",
                                  "CkeConfig"])
def test_config_fields_match(name):
    tc, jc = getattr(tconfig, name)(), getattr(jconfig, name)()
    assert ([(f.name, f.default) for f in dataclasses.fields(tc)]
            == [(f.name, f.default) for f in dataclasses.fields(jc)])
    assert tc.grid_points == jc.grid_points
    assert tc.torch_dtype == torch.float64
    t32 = tconfig.with_overrides(tc, dtype="float32")
    assert t32.torch_dtype == torch.float32 and tc.dtype == "float64"
    assert tconfig.torch_dtype("bfloat16") == torch.bfloat16
    with pytest.raises(ValueError, match="unknown config fields"):
        tconfig.with_overrides(tc, nonsense=1)


def test_production_presets_match():
    for kernel in ("biharmonic", "biharmonic_dss", "biharmonic_dss2d",
                   "mpdata", "cke"):
        assert (dataclasses.asdict(tconfig.production_config(kernel))
                == dataclasses.asdict(jconfig.production_config(kernel)))
    cfg = tconfig.production_config("biharmonic")
    assert (cfg.nelemd, cfg.ncol, cfg.dtype, cfg.device_init) == (
        5400, 720, "float32", True)
    cfg = tconfig.production_config("cke")
    assert (cfg.nedges, cfg.ncells, cfg.dtype, cfg.device_init) == (
        256000, 28000, "float32", True)


def test_read_namelist_matches(tmp_path):
    nml = ROOT / "configs" / "nested.nml"
    assert tconfig.read_namelist(nml) == jconfig.read_namelist(nml)
    assert (dataclasses.asdict(tconfig.cke_config_from_namelist(nml, nadv=4))
            == dataclasses.asdict(jconfig.cke_config_from_namelist(nml, nadv=4)))
    bad = tmp_path / "bad.nml"
    bad.write_text("&other\n x = 1\n/\n")
    with pytest.raises(ValueError, match="not found"):
        tconfig.read_namelist(bad)


def test_registry_factory_forms():
    """The three factory forms of _materialize: step(data),
    (prepare, step2) and {"step", "prepare", "loop"}."""
    data = torch.arange(4.0)
    plain = treg.Variant("k", "plain", lambda cfg: (lambda d: d + cfg))
    step2, aux, loop = treg._materialize(plain, 1.0, data)
    assert aux == () and loop is None
    assert torch.equal(step2(aux, data), data + 1)

    pair = treg.Variant("k", "pair",
                        lambda cfg: (lambda d: d * 2, lambda a, d: a + d))
    step2, aux, loop = treg._materialize(pair, None, data)
    assert torch.equal(aux, data * 2) and loop is None
    assert torch.equal(treg.make_step(pair, None, data)(data), data * 3)

    full = treg.Variant("k", "full", lambda cfg: {
        "prepare": lambda d: d.sum(), "step": lambda a, d: d - a,
        "loop": lambda d, n: d * n})
    step2, aux, loop = treg._materialize(full, None, data)
    assert float(aux) == 6.0
    assert torch.equal(step2(aux, data), data - 6)
    assert torch.equal(loop(data, 3), data * 3)


def test_registered_flags_match_jax():
    """The port registers every (kernel, variant) name of the JAX package,
    all 49 of them, each with the flags of the JAX variant of the same
    name, and beside them its own cubed-sphere family and its two
    variants, which the JAX package has not: 51 in all."""
    import cdk_torch.kernels  # noqa: F401
    import cdk_tpu.kernels  # noqa: F401
    from cdk_tpu.core import registry as jreg

    names = {k: sorted(treg.variants(k)) for k in treg.kernels()}
    jax_names = {k: sorted(jreg.variants(k)) for k in jreg.kernels()}
    assert {k: names[k] for k in jax_names} == jax_names
    assert sum(map(len, jax_names.values())) == 49
    own = {k: v for k, v in names.items() if k not in jax_names}
    assert own == {"biharmonic_dss_cube": ["fused_operator_cube_sq_x3",
                                           "reference_jnp"]}
    assert sum(map(len, names.values())) == 51
    assert names["mpdata"] == [
        "pallas_fused", "pallas_hoisted", "pallas_lanes", "pallas_packed",
        "pallas_packed_bf16", "pallas_resident", "pallas_xmajor",
        "reference_jnp"]
    flags = ("supports_f64", "fast_math", "experimental", "verify_tol",
             "requires_tpu")
    for kernel, vs in jax_names.items():
        for name in vs:
            tv, jv = treg.get(kernel, name), jreg.get(kernel, name)
            assert [getattr(tv, f) for f in flags] == [
                getattr(jv, f) for f in flags], (kernel, name)
    cube = treg.get("biharmonic_dss_cube", "fused_operator_cube_sq_x3")
    assert [getattr(cube, f) for f in flags] == [False, False, False, 5e-5,
                                                 False]


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_verify_gates_match_jax(dtype):
    """The port's verify functions give the JAX package's verdicts and
    metrics on the same outputs."""
    from cdk_torch.harness import specs as ts
    from cdk_tpu.harness import specs as js

    rng = np.random.default_rng(9)
    ref = rng.random((3, 16, 8)) + 0.5
    for scale in (1e-15, 1e-9, 1e-6, 1e-3):
        out = ref * (1 + scale * rng.standard_normal(ref.shape))
        for tfn, jfn, cfg in (
            (ts._verify_biharmonic, js._verify_biharmonic,
             tconfig.BiharmonicConfig(dtype=dtype)),
            (ts._verify_biharmonic_dss, js._verify_biharmonic_dss,
             tconfig.BiharmonicConfig(dtype=dtype)),
            (ts._verify_cke, js._verify_cke, tconfig.CkeConfig(dtype=dtype)),
        ):
            for loose, tol in ((False, None), (True, None), (False, 5e-5)):
                a = tfn(cfg, torch.from_numpy(out), ref, loose=loose, tol=tol)
                b = jfn(cfg, out, ref, loose=loose, tol=tol)
                assert (a.ok, a.metrics) == (b.ok, b.metrics)
        pair = (torch.from_numpy(out), torch.from_numpy(out[:, 0]))
        a = ts._verify_mpdata(tconfig.MpdataConfig(dtype=dtype), pair,
                              (ref, ref[:, 0]))
        b = js._verify_mpdata(jconfig.MpdataConfig(dtype=dtype),
                              (out, out[:, 0]), (ref, ref[:, 0]))
        assert (a.ok, a.metrics) == (b.ok, b.metrics)


def test_port_imports_no_jax():
    code = ("import cdk_torch, cdk_torch.cli, cdk_torch.kernels, "
            "cdk_torch.harness.driver, cdk_torch.dist.mpdata, "
            "cdk_torch.dist.biharmonic, "
            "cdk_torch.harness.distbench, cdk_torch.harness.scaling, sys; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'cdk_tpu'))]; assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT,
                   timeout=120)


def test_port_sources_import_no_jax():
    """No module of the port and not chip_smoke.py names jax or the JAX
    package in an import statement (chip_smoke.py cannot run here)."""
    import ast

    for path in [ROOT / "chip_smoke.py", *sorted((ROOT / "cdk_torch").rglob("*.py"))]:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            bad = [m for m in mods if m.split(".")[0] in ("jax", "cdk_tpu")]
            assert not bad, (path.name, bad)


def test_slope_timer_median_band():
    """A runner whose cost is ~1 ms per step reads ~1 ms per step; the
    headline is the median of the trial-pair slopes in the band."""

    def make_runner(n):
        return lambda data: time.sleep(n * 1e-3)

    sec, band = slope_time_detail(make_runner, None, torch.device("cpu"),
                                  n1=2, n2=16, trials=3)
    assert sec == band["median"]
    assert band["min"] <= band["median"] <= band["max"]
    assert band["n_samples"] == 6
    assert 0.8e-3 < sec < 5e-3


def test_resolve_device():
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError):
        resolve_device("meta")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device("cuda")


def test_build_names_and_refuses_without_nvcc(tmp_path, monkeypatch):
    """The library is named by a hash of the sources; with no nvcc the
    build raises instead of falling back."""
    cu = sorted(tbuild.CSRC.glob("*.cu"))
    assert [p.name for p in cu] == ["biharmonic_dss2d_resident.cu",
                                    "biharmonic_dss2d_rowchain.cu",
                                    "biharmonic_dss_cube.cu",
                                    "biharmonic_dss_resident.cu",
                                    "biharmonic_fused.cu",
                                    "biharmonic_resident.cu", "cke_group.cu",
                                    "cke_lanegather.cu",
                                    "cke_onehot.cu", "cke_rows.cu",
                                    "cke_staged.cu", "mpdata_lanes.cu",
                                    "mpdata_masked.cu", "mpdata_resident.cu"]
    assert tbuild._digest(cu) == tbuild._digest(list(cu))
    assert tbuild._digest(cu) != tbuild._digest(cu[:1])
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        tbuild.build(tmp_path / "build")
    assert not (tmp_path / "build").exists()


def test_build_compiles_each_source_then_links(tmp_path, monkeypatch):
    """One nvcc per csrc/*.cu with -c, then one link of the objects into
    the hashed library; the objects are removed and a second build reuses
    the library.  A stand-in nvcc records its arguments."""
    log = tmp_path / "calls.txt"
    fake = tmp_path / "nvcc"
    fake.write_text(
        "#!" + sys.executable + "\n"
        "import sys\n"
        f"open({str(log)!r}, 'a').write(' '.join(sys.argv[1:]) + '\\n')\n"
        "out = sys.argv[sys.argv.index('-o') + 1]\n"
        "open(out, 'w').write('built')\n")
    fake.chmod(0o755)
    monkeypatch.setenv("PATH", str(tmp_path))
    built = tbuild.build(tmp_path / "build")
    calls = log.read_text().splitlines()
    cu = sorted(tbuild.CSRC.glob("*.cu"))
    compiles = [c for c in calls if " -c " in c]
    assert len(compiles) == len(cu) == len(calls) - 1
    assert sorted(c.split()[-1] for c in compiles) == sorted(map(str, cu))
    assert all("arch=compute_90a,code=sm_90a" in c for c in calls)
    assert "-shared" in calls[-1] and calls[-1].count(".o") == len(cu)
    assert built.path.read_text() == "built" and built.seconds > 0
    assert sorted(p.name for p in (tmp_path / "build").iterdir()) == [
        built.path.name]
    assert tbuild.build(tmp_path / "build") == tbuild.Built(built.path, 0.0, "")
    assert len(log.read_text().splitlines()) == len(calls)
