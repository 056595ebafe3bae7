"""The port's main path as a whole, on the CPU: init -> stage -> reference
-> variants -> verify -> time through cdk_torch.harness.driver, the
champions' outputs against the JAX package's champions on the same shipped
inputs (within the family gate), and the CLI."""

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from cdk_torch.core.config import (
    BiharmonicConfig,
    CkeConfig,
    MpdataConfig,
    with_overrides,
)
from cdk_torch.core.registry import get, make_step, variants
from cdk_torch.harness.driver import run_kernel
from cdk_torch.harness.specs import get_spec
from cdk_tpu.core import config as jconfig
from cdk_tpu.core import registry as jreg

ROOT = Path(__file__).resolve().parents[1]

SMALL = {
    "biharmonic": with_overrides(BiharmonicConfig(), nelemd=8, nlev=4, qsize=2),
    # a ring of 6 elements; a 4x3 torus (odd ey)
    "biharmonic_dss": with_overrides(BiharmonicConfig(), nelemd=6, nlev=4,
                                     qsize=2),
    "biharmonic_dss2d": with_overrides(BiharmonicConfig(), nelemd=12, nlev=4,
                                       qsize=2),
    "mpdata": with_overrides(MpdataConfig(), nslices=4, nx=8, nz=12),
    "cke": with_overrides(CkeConfig(), nedges=130, ncells=40, nvertlevels=21,
                          nadv=6),
}


def _jax_output(kernel, name, cfg, data):
    """A JAX variant's single-step output as numpy arrays."""
    out = jreg.make_step(jreg.get(kernel, name), cfg, data)(data)
    if isinstance(out, tuple):
        return tuple(np.asarray(o) for o in out)
    return np.asarray(out)


EXPECTED = {
    ("biharmonic", "float64"): ["reference_jnp", "fused_operator_bd8_resident"],
    ("biharmonic", "float32"): ["reference_jnp", "fused_operator_bd8_resident",
                                "fused_operator_bd8_resident_x3"],
    ("biharmonic_dss", "float64"): [
        "reference_jnp", "fused_operator", "fused_operator_f32",
        "fused_operator_bd8", "fused_operator_bd8_resident",
        "fused_operator_bd8_resident_sq"],
    ("biharmonic_dss", "float32"): [
        "reference_jnp", "fused_operator", "fused_operator_f32",
        "fused_operator_bf16", "fused_operator_bd8",
        "fused_operator_bd8_resident", "fused_operator_bd8_resident_x3",
        "fused_operator_bd8_resident_sq", "fused_operator_bd8_resident_sq_x3"],
    ("biharmonic_dss2d", "float64"): [
        "reference_jnp", "fused_operator", "fused_operator_f32",
        "fused_operator_bd8", "fused_operator_bd8_resident",
        "fused_operator_rowchain", "fused_operator_rowchain_sq"],
    ("biharmonic_dss2d", "float32"): [
        "reference_jnp", "fused_operator", "fused_operator_f32",
        "fused_operator_bf16", "fused_operator_bd8",
        "fused_operator_bd8_resident", "fused_operator_bd8_resident_x3",
        "fused_operator_rowchain",
        "fused_operator_rowchain_x3", "fused_operator_rowchain_sq",
        "fused_operator_rowchain_sq_x3"],
    ("mpdata", "float64"): ["reference_jnp", "pallas_xmajor"],
    ("mpdata", "float32"): ["reference_jnp", "pallas_xmajor"],
    # the experimental pallas_rows and pallas_lanegather run only when
    # requested; the bf16 forms have no f64
    ("cke", "float64"): ["reference_jnp", "gather_peradv", "gather_selfold",
                         "onehot_mxu", "pallas_onehot", "staged_consume"],
    ("cke", "float32"): ["reference_jnp", "gather_peradv", "gather_selfold",
                         "onehot_mxu", "onehot_mxu_bf16", "pallas_onehot",
                         "pallas_onehot_bf16", "staged_consume"],
}


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("kernel", ["biharmonic", "biharmonic_dss",
                                    "biharmonic_dss2d", "mpdata", "cke"])
def test_run_kernel_every_variant_ok(kernel, dtype):
    cfg = with_overrides(SMALL[kernel], dtype=dtype)
    results = run_kernel(kernel, cfg, iters=2, trials=1, quiet=True,
                         device="cpu")
    assert [r.variant for r in results] == EXPECTED[kernel, dtype]
    for r in results:
        assert r.ok, (r.variant, r.metrics, r.note)
        assert 0 < r.seconds_per_call < float("inf")
        assert r.grid_points_per_s == pytest.approx(
            cfg.grid_points / r.seconds_per_call)
        assert r.metrics["slope_min"] <= r.metrics["slope_median"]


def test_run_kernel_cke_every_registered_variant():
    """Requested explicitly, the experimental variants run too (and verify),
    and the bf16 forms are skipped at f64."""
    names = list(variants("cke"))
    results = run_kernel("cke", SMALL["cke"], variants=names, iters=2,
                         trials=1, quiet=True, device="cpu")
    assert [r.variant for r in results] == [
        n for n in names if not n.endswith("_bf16")]
    assert all(r.ok for r in results), [(r.variant, r.metrics) for r in results]


def test_run_kernel_device_init():
    cfg = with_overrides(SMALL["mpdata"], dtype="float32", device_init=True)
    results = run_kernel("mpdata", cfg, variants=["pallas_xmajor"], iters=2,
                         trials=1, quiet=True, device="cpu")
    assert [(r.variant, r.ok) for r in results] == [("pallas_xmajor", True)]


@pytest.mark.parametrize("kernel,champion,dtype", [
    ("biharmonic", "fused_operator_bd8_resident", "float64"),
    ("biharmonic", "fused_operator_bd8_resident_x3", "float32"),
    ("mpdata", "pallas_xmajor", "float64"),
    ("cke", "gather_peradv", "float64"),
])
def test_champion_matches_jax_champion(kernel, champion, dtype):
    """Shipped size: the port's champion output against the JAX package's
    champion output (Pallas interpret mode) on the same host inputs, judged
    by the family's own verification gate."""
    spec = get_spec(kernel)
    cfg = with_overrides(spec.default_config(), dtype=dtype)
    jcfg = getattr(jconfig, type(cfg).__name__)(**dataclasses.asdict(cfg))
    import cdk_tpu.kernels  # noqa: F401  (registers the JAX variants)
    from cdk_tpu.harness.specs import get_spec as jget_spec

    jdata = jget_spec(kernel).init(jcfg)
    want = _jax_output(kernel, champion, jcfg, jdata)
    data = spec.init(cfg, "cpu")
    got = make_step(get(kernel, champion), cfg, data)(data)
    check = spec.verify(cfg, got, want)
    assert check.ok, check.lines


def test_cli_run_mpdata_exits_zero():
    proc = subprocess.run(
        [sys.executable, "-m", "cdk_torch", "run", "mpdata", "--device", "cpu",
         "--set", "nslices=4", "--set", "nx=8", "--set", "nz=12",
         "--iters", "2", "--trials", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "pallas_xmajor" in proc.stdout and "FAILED" not in proc.stdout


@pytest.fixture(scope="module")
def listed():
    """`python -m cdk_torch list` as {kernel: [variant, ...]}."""
    proc = subprocess.run([sys.executable, "-m", "cdk_torch", "list"],
                          cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    out: dict[str, list[str]] = {}
    for line in proc.stdout.splitlines():
        if line.startswith("  "):
            out[kernel].append(line.split()[0])
        else:
            kernel = line.rstrip(":")
            out[kernel] = []
    return out


def test_cli_list_prints_the_five_variants(listed):
    """The biharmonic and mpdata variants, five in all."""
    assert listed["biharmonic"] + listed["mpdata"] == [
        "reference_jnp", "fused_operator_bd8_resident",
        "fused_operator_bd8_resident_x3", "reference_jnp", "pallas_xmajor"]


def test_cli_list_shows_the_cke_variants(listed):
    assert list(listed) == ["biharmonic", "biharmonic_dss",
                            "biharmonic_dss2d", "cke", "mpdata"]
    assert listed["cke"] == [
        "reference_jnp", "gather_peradv", "gather_selfold", "onehot_mxu",
        "onehot_mxu_bf16", "pallas_lanegather", "pallas_onehot",
        "pallas_onehot_bf16", "pallas_rows", "staged_consume"]


def test_cli_list_shows_33_variants_and_the_dss_families(listed):
    """35 variants in all: the 33 first listed and the two torus resident
    forms (K19)."""
    assert sum(map(len, listed.values())) == 35
    assert listed["biharmonic_dss"] == [
        "reference_jnp", "fused_operator", "fused_operator_f32",
        "fused_operator_bf16", "fused_operator_bd8",
        "fused_operator_bd8_resident", "fused_operator_bd8_resident_x3",
        "fused_operator_bd8_resident_sq", "fused_operator_bd8_resident_sq_x3"]
    assert listed["biharmonic_dss2d"] == [
        "reference_jnp", "fused_operator", "fused_operator_f32",
        "fused_operator_bf16", "fused_operator_bd8",
        "fused_operator_bd8_resident", "fused_operator_bd8_resident_x3",
        "fused_operator_rowchain",
        "fused_operator_rowchain_x3", "fused_operator_rowchain_sq",
        "fused_operator_rowchain_sq_x3"]


def test_cli_run_biharmonic_dss2d_exits_zero():
    proc = subprocess.run(
        [sys.executable, "-m", "cdk_torch", "run", "biharmonic_dss2d",
         "--device", "cpu", "--set", "nelemd=12", "--set", "nlev=4",
         "--set", "qsize=2", "--iters", "2", "--trials", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "fused_operator_rowchain_sq" in proc.stdout
    assert "FAILED" not in proc.stdout


def test_cli_run_cke_with_namelist_exits_zero():
    proc = subprocess.run(
        [sys.executable, "-m", "cdk_torch", "run", "cke", "--namelist",
         "configs/nested.nml", "--set", "nedges=130", "--set", "ncells=40",
         "--set", "nvertlevels=21", "--device", "cpu", "--iters", "2",
         "--trials", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "gather_peradv" in proc.stdout and "FAILED" not in proc.stdout


def test_cli_namelist_is_for_cke_alone(capsys):
    from cdk_torch import cli

    nml = str(ROOT / "configs" / "nested.nml")
    for argv in (["run", "mpdata", "--namelist", nml],
                 ["run", "cke", "--namelist", nml, "--preset", "production"]):
        with pytest.raises(SystemExit):
            cli.main(argv)
    assert "--namelist" in capsys.readouterr().err


def test_cli_json_and_device_refusal(tmp_path, monkeypatch):
    from cdk_torch import cli

    out = tmp_path / "r.json"
    rc = cli.main(["run", "biharmonic", "--device", "cpu", "--set", "nelemd=3",
                   "--set", "nlev=4", "--set", "qsize=2", "--dtype", "float32",
                   "--variant", "fused_operator_bd8_resident_x3",
                   "--iters", "2", "--trials", "1", "--json", str(out)])
    assert rc == 0
    rows = json.loads(out.read_text())["kernels"]["biharmonic"]
    assert [(r["variant"], r["ok"]) for r in rows] == [
        ("fused_operator_bd8_resident_x3", True)]
    # a CUDA run on a machine without a Hopper card is refused, never
    # quietly moved to the CPU
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["run", "mpdata", "--set", "nslices=2"])
