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
    MpdataConfig,
    with_overrides,
)
from cdk_torch.core.registry import get, make_step
from cdk_torch.harness.driver import run_kernel
from cdk_torch.harness.specs import get_spec
from cdk_tpu.core import config as jconfig
from cdk_tpu.core import registry as jreg

ROOT = Path(__file__).resolve().parents[1]

SMALL = {
    "biharmonic": with_overrides(BiharmonicConfig(), nelemd=8, nlev=4, qsize=2),
    "mpdata": with_overrides(MpdataConfig(), nslices=4, nx=8, nz=12),
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
    ("mpdata", "float64"): ["reference_jnp", "pallas_xmajor"],
    ("mpdata", "float32"): ["reference_jnp", "pallas_xmajor"],
}


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("kernel", ["biharmonic", "mpdata"])
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


def test_run_kernel_device_init():
    cfg = with_overrides(SMALL["mpdata"], dtype="float32", device_init=True)
    results = run_kernel("mpdata", cfg, variants=["pallas_xmajor"], iters=2,
                         trials=1, quiet=True, device="cpu")
    assert [(r.variant, r.ok) for r in results] == [("pallas_xmajor", True)]


@pytest.mark.parametrize("kernel,champion,dtype", [
    ("biharmonic", "fused_operator_bd8_resident", "float64"),
    ("biharmonic", "fused_operator_bd8_resident_x3", "float32"),
    ("mpdata", "pallas_xmajor", "float64"),
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


def test_cli_list_prints_the_five_variants():
    proc = subprocess.run([sys.executable, "-m", "cdk_torch", "list"],
                          cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    names = [line.split()[0] for line in proc.stdout.splitlines()
             if line.startswith("  ")]
    assert names == ["reference_jnp", "fused_operator_bd8_resident",
                     "fused_operator_bd8_resident_x3", "reference_jnp",
                     "pallas_xmajor"]


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
