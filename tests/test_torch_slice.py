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
from cdk_torch.core.norms import rel_l1
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
    ("biharmonic", "float64"): ["reference_jnp", "fused_operator",
                                "fused_operator_bd", "fused_operator_bd8",
                                "fused_operator_pallas",
                                "fused_operator_bd8_resident"],
    ("biharmonic", "float32"): ["reference_jnp", "fused_operator",
                                "fused_operator_bd", "fused_operator_bf16",
                                "fused_operator_bd8", "fused_operator_pallas",
                                "fused_operator_bd8_resident",
                                "fused_operator_bd8_resident_x3",
                                "pallas_fused", "pallas_fused_bf16"],
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
    # the experimental pallas_packed_bf16 and pallas_lanes run only when
    # requested
    ("mpdata", "float64"): ["reference_jnp", "pallas_fused", "pallas_packed",
                            "pallas_resident", "pallas_hoisted",
                            "pallas_xmajor"],
    ("mpdata", "float32"): ["reference_jnp", "pallas_fused", "pallas_packed",
                            "pallas_resident", "pallas_hoisted",
                            "pallas_xmajor"],
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


@pytest.mark.parametrize("kernel,names", [
    ("biharmonic", ["fused_operator_bd8_bf16"]),
    ("mpdata", ["pallas_packed_bf16", "pallas_lanes"]),
])
def test_run_kernel_experimental_variants_when_requested(kernel, names):
    """The experimental forms verify through the driver at f32 when
    requested (the bf16 ones at the loose gate)."""
    cfg = with_overrides(SMALL[kernel], dtype="float32")
    results = run_kernel(kernel, cfg, variants=names, iters=2, trials=1,
                         quiet=True, device="cpu")
    assert [(r.variant, r.ok) for r in results] == [(n, True) for n in names]


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
    """The biharmonic and mpdata variants: the first five ported, now with
    the rest of both families (19 in all)."""
    assert listed["biharmonic"] == [
        "reference_jnp", "fused_operator", "fused_operator_bd",
        "fused_operator_bf16", "fused_operator_bd8", "fused_operator_bd8_bf16",
        "fused_operator_pallas", "fused_operator_bd8_resident",
        "fused_operator_bd8_resident_x3", "pallas_fused", "pallas_fused_bf16"]
    assert listed["mpdata"] == [
        "reference_jnp", "pallas_fused", "pallas_packed", "pallas_packed_bf16",
        "pallas_resident", "pallas_lanes", "pallas_hoisted", "pallas_xmajor"]


def test_cli_list_shows_the_cke_variants(listed):
    assert list(listed) == ["biharmonic", "biharmonic_dss",
                            "biharmonic_dss2d", "biharmonic_dss_cube", "cke",
                            "mpdata"]
    assert listed["cke"] == [
        "reference_jnp", "gather_peradv", "gather_selfold", "onehot_mxu",
        "onehot_mxu_bf16", "pallas_lanegather", "pallas_onehot",
        "pallas_onehot_bf16", "pallas_rows", "staged_consume"]


def test_cli_list_shows_33_variants_and_the_dss_families(listed):
    """51 variants in all: the JAX package's 49 (the DSS families as
    before, and the 14 biharmonic and mpdata variants ported since) and the
    port's own cubed-sphere family's two."""
    assert sum(map(len, listed.values())) == 51
    assert sum(len(v) for k, v in listed.items()
               if k != "biharmonic_dss_cube") == 49
    assert listed["biharmonic_dss_cube"] == [
        "reference_jnp", "fused_operator_cube_sq_x3"]
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


def test_cli_integrate_matches_jax_integrate(tmp_path):
    """`integrate mpdata --variant pallas_fused --steps 3 --dtype float64`
    writes the JAX CLI's state within the f64 gate."""
    from cdk_torch import cli
    from cdk_tpu import cli as jcli

    args = ["integrate", "mpdata", "--variant", "pallas_fused", "--steps", "3",
            "--dtype", "float64", "--set", "nslices=6"]
    mine, theirs = tmp_path / "torch.npz", tmp_path / "jax.npz"
    assert cli.main(args + ["--out", str(mine), "--device", "cpu"]) == 0
    assert jcli.main(args + ["--out", str(theirs)]) == 0
    got, want = np.load(mine), np.load(theirs)
    assert sorted(got) == sorted(want) == ["out0", "out1"]
    assert got["out0"].shape == (6, 38, 57) and got["out0"].dtype == np.float64
    for key in want:
        assert rel_l1(got[key], want[key]) < 1e-13


def test_cli_integrate_without_a_loop_chains_steps(capsys):
    """A variant with no loop of its own runs the spec's chained steps."""
    from cdk_torch import cli

    assert cli.main(["integrate", "biharmonic", "--steps", "2", "--set",
                     "nelemd=3", "--set", "nlev=4", "--set", "qsize=2",
                     "--variant", "fused_operator_bd", "--device", "cpu"]) == 0
    assert "biharmonic/fused_operator_bd x2: out0 shape=(3, 2, 4, 4, 4)" in (
        capsys.readouterr().out)


def test_cli_verify_runs_the_port_tests(monkeypatch):
    """`verify` hands the port's test files to pytest and returns its
    exit code; without jax, only the card's tests with --noconftest."""
    from cdk_torch import cli

    calls = []

    def fake_run(cmd, cwd):
        calls.append(cmd)
        return subprocess.CompletedProcess(cmd, 3)

    monkeypatch.setattr(cli.subprocess, "run", fake_run)
    assert cli.main(["verify"]) == 3
    files = [Path(a).name for a in calls[0] if a.endswith(".py")]
    assert calls[0][1:4] == ["-m", "pytest", "-q"]
    assert files == sorted(p.name for p in (ROOT / "tests").glob("test_torch_*.py"))
    monkeypatch.setitem(sys.modules, "jax", None)  # import jax raises
    assert cli.main(["verify"]) == 3
    assert "--noconftest" in calls[1] and calls[1][-1].endswith("test_torch_gpu.py")
