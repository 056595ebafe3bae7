"""Benchmark/verification driver: the reference miniapps' run protocol as
one reusable harness (the port of ``cdk_tpu.harness.driver``).

Protocol per kernel (biharmonic:545-580, advect…F90:48-67):

  1. deterministic init, then `.to(device)` — timed together as staging
     (like `timerData`, nested.F90:163-182),
  2. run the trusted reference variant → save output,
  3. for every other registered variant: run, verify against the saved
     reference output with the kernel's own norm, time by two-point slope
     (median of trial pairs), print a reference-style report line,
  4. return machine-readable results.

Variant timing excludes host↔device transfers (the mpdata convention,
`!$acc wait` before system_clock, advect…F90:109-110)."""

from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field
from typing import Any

from cdk_torch.core import registry
from cdk_torch.core.platform import (
    describe,
    exact_fp32,
    resolve_device,
    synchronize,
)
from cdk_torch.core.timer import Timer, slope_time_detail
from cdk_torch.harness.specs import get_spec

REFERENCE_VARIANT = "reference_jnp"


@dataclass
class VariantResult:
    kernel: str
    variant: str
    ok: bool
    seconds_per_call: float
    grid_points_per_s: float
    metrics: dict[str, float] = field(default_factory=dict)
    note: str = ""
    fast_math: bool = False  # intentionally-lower-precision speed point


def run_kernel(
    kernel: str,
    cfg=None,
    variants: list[str] | None = None,
    iters: int = 10,
    trials: int = 3,
    quiet: bool = False,
    min_delta: float = 5e-3,
    device="cuda",
) -> list[VariantResult]:
    import cdk_torch.kernels  # noqa: F401  (registers variants)

    spec = get_spec(kernel)
    cfg = cfg or spec.default_config()
    dev = resolve_device(device)
    exact_fp32()  # references and variants compare in true f32 (no TF32)
    say = (lambda *a: None) if quiet else print

    say(f"== {kernel} ({describe(dev)}, dtype={cfg.dtype}) ==")
    stage = Timer("data staging")
    stage.start()
    data = spec.init(cfg, dev).to(dev)
    stage.stop(dev)
    say(stage.report())

    reg = registry.variants(kernel)
    if REFERENCE_VARIANT not in reg:
        raise RuntimeError(f"no {REFERENCE_VARIANT} registered for {kernel}")
    names = variants or list(reg)
    gp = spec.grid_points(cfg)

    ref_out = reg[REFERENCE_VARIANT].fn(cfg)(data)
    synchronize(dev)

    results: list[VariantResult] = []
    for name in names:
        var = reg[name]
        if cfg.dtype == "float64" and not var.supports_f64:
            say(f" {name:<22s}: skipped (no f64 support)")
            continue
        if var.experimental and variants is None:
            say(f" {name:<22s}: skipped (experimental; request explicitly)")
            continue
        try:
            step2, aux, vloop = registry._materialize(var, cfg, data)
            out = step2(aux, data)
            synchronize(dev)
        except registry.UnsupportedConfigError as e:
            say(f" {name:<22s}: skipped (unsupported here: {e})")
            continue
        except Exception as e:
            # a variant that crashes is a FAILED result, not a silent skip
            # (a regression must turn the run red, not shrink it)
            msg = f"{type(e).__name__}: {str(e)[:300]}"
            say(f" {name:<22s}: ERROR {msg}  ** FAILED **")
            results.append(VariantResult(
                kernel, name, False, float("inf"), 0.0, {},
                note=f"run error: {msg}", fast_math=var.fast_math,
            ))
            continue
        check = spec.verify(cfg, out, ref_out, loose=var.fast_math,
                            tol=var.verify_tol)
        # per-step time by two-point slope over n-step runs; variants with
        # a loop of their own (the resident kernels) are timed through it
        if vloop is not None:
            make_runner = lambda n: (lambda d: vloop(d, n))
        else:
            make_runner = lambda n: spec.loop_runner(step2, aux, n)
        sec, band = slope_time_detail(make_runner, data, dev, n1=iters,
                                      n2=8 * iters, trials=trials,
                                      min_delta=min_delta)
        metrics = dict(check.metrics)
        metrics.update({f"slope_{k}": v for k, v in band.items()})
        res = VariantResult(
            kernel, name, check.ok, sec, gp / sec, metrics,
            fast_math=var.fast_math,
        )
        results.append(res)
        status = "" if check.ok else "  ** VERIFY FAILED **"
        say(
            f" {name:<30s}: {sec * 1e6:12.3f} us/step "
            f"({res.grid_points_per_s / 1e9:9.4f} G pts/s){status}"
        )
        for line in check.lines:
            say(line)
    return results


def run_all(iters: int = 10, trials: int = 3, dtype: str | None = None,
            quiet: bool = False, device="cuda") -> dict[str, Any]:
    from cdk_torch.core.config import with_overrides
    from cdk_torch.harness.specs import all_specs

    dev = resolve_device(device)
    out: dict[str, Any] = {"device": describe(dev), "kernels": {}}
    for kernel, spec in all_specs().items():
        cfg = spec.default_config()
        if dtype:
            cfg = with_overrides(cfg, dtype=dtype)
        results = run_kernel(kernel, cfg, iters=iters, trials=trials,
                             quiet=quiet, device=dev)
        out["kernels"][kernel] = [asdict(r) for r in results]
    return out


def to_json(results: dict[str, Any]) -> str:
    return json.dumps(results, indent=2, default=float)
