#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (cdk_torch) on one Hopper card.

    python3 chip_smoke.py        # from the repository root; needs one sm_90 card

Phases, each printing its result; the first failure exits non-zero:

  1. device   require CUDA and compute capability 9.0; print the card's
              name and power limit (nvidia-smi)
  2. build    compile cdk_torch/csrc/*.cu with nvcc (sm_90a)
  3. kernels  each hand-written kernel against its plain PyTorch version on
              the card, at the main path's shapes (shipped and production),
              f32 and f64, n = 1 and 4 steps, with the family's gate; both
              timed with CUDA events
  4. main     cdk_torch.harness.driver.run_kernel for biharmonic and mpdata:
              shipped size with host init at f64 (every variant against the
              in-process reference at 1e-13), and the production preset with
              device init at f32 (reference and champion)
  5. counts   every kernel's launch counter rose during phase 4

Then one JSON line describing the kernels, and as the last line
{"ok": true, "device": {...}}.  It imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

REPS = 20  # timed launches per phase-3 measurement, after two warm-ups


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def timed_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of fn() over `reps` calls, by CUDA events,
    after two warm-up calls."""
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def errors(out, ref, norm: str) -> tuple[float, float, float]:
    """(relative L2 or L1 error, max abs error, max |ref|) in float64 on
    the device; the last shows the comparison is not between zeros."""
    d = out.double() - ref.double()
    r = ref.double()
    if norm == "l2":
        den = (r * r).sum()
        rel = (d * d).sum() / den if den > 0 else (d * d).sum()
        rel = rel.sqrt()
    else:
        den = r.abs().sum()
        rel = d.abs().sum() / den if den > 0 else d.abs().sum()
    return float(rel), float(d.abs().max()), float(r.abs().max())


def phase_device():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    from cdk_torch.core.platform import resolve_device

    dev = resolve_device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[dev.index]
    print(f"[1 device] {torch.cuda.get_device_name(dev)} "
          f"(capability {torch.cuda.get_device_capability(dev)}), "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(card)
    return dev, card


def phase_build():
    from cdk_torch.core import build

    built = build.build()
    print(f"[2 build] {built.path.name}: nvcc {built.seconds:.1f} s")
    print(built.log.strip(), file=sys.stderr)


def phase_kernels(dev, card):
    """K1 and K2 against their plain versions; returns the JSON rows."""
    import torch

    from cdk_torch.core.config import BiharmonicConfig, MpdataConfig
    from cdk_torch.kernels.biharmonic import problem as bp
    from cdk_torch.kernels.biharmonic.operator import build_element_operator
    from cdk_torch.kernels.biharmonic.resident import (
        bd8_resident,
        bd8_resident_plain,
    )
    from cdk_torch.kernels.mpdata import problem as mp
    from cdk_torch.kernels.mpdata.resident import (
        advect_resident,
        advect_resident_plain,
    )

    rows = {}
    gate = {torch.float32: 2e-5, torch.float64: 1e-13}
    for label, (nelemd, qsize) in (("shipped", (16, 40)),
                                   ("production", (5400, 10))):
        cfg = BiharmonicConfig(nelemd=nelemd, qsize=qsize, dtype="float64",
                               device_init=True)
        data = bp.init_data(cfg, dev)
        # rrearth = 1: with the real radius every application scales q by
        # ~rrearth^2, and a 4-step f32 chain would sink below f32's range
        L64 = build_element_operator(data.dvv, data.dinv, data.spheremp,
                                     data.tensorvisc, 1.0)
        q64 = bp.to_lane_layout(data.qtens)
        for dtype, prec in ((torch.float32, "highest"),
                            (torch.float32, "bf16x3"),
                            (torch.float64, "highest")):
            L, q = L64.to(dtype), q64.to(dtype)
            for n in (1, 4):
                out = bd8_resident(L, q, n, prec)
                ref = bd8_resident_plain(L, q, n, prec)
                torch.cuda.synchronize()
                rel, mae, big = errors(out, ref, "l2")
                ms = timed_ms(lambda: bd8_resident(L, q, n, prec), REPS)
                plain_ms = timed_ms(lambda: bd8_resident_plain(L, q, n, prec), REPS)
                ok = (rel < gate[dtype] and big > 0
                      and bool(torch.isfinite(out).all()))
                print(f"[3 K1] {label:10s} e={nelemd} ncol={cfg.ncol} "
                      f"{str(dtype)[6:]:7s} {prec:7s} n={n}: rel_l2 {rel:.3e} "
                      f"(gate {gate[dtype]:g}) max_abs {mae:.3e} of {big:.3e}; kernel "
                      f"{ms:.4f} ms, plain {plain_ms:.4f} ms [{card}]")
                if not ok:
                    fail(f"K1 {label} {dtype} {prec} n={n}: rel_l2 {rel:.3e}")
                if (label, dtype, prec, n) == ("production", torch.float32,
                                               "bf16x3", 1):
                    rows["K1"] = dict(max_abs_err=mae, ms=ms, plain_ms=plain_ms)
        del data, L64, q64, L, q

    gate_f = {torch.float32: 1e-6, torch.float64: 1e-13}
    gate_flux = {torch.float32: 1e-5, torch.float64: 1e-13}
    for label, nslices in (("shipped", 48), ("production", 8192)):
        for dtype in (torch.float32, torch.float64):
            cfg = MpdataConfig(nslices=nslices, dtype=str(dtype)[6:],
                               device_init=True)
            d = mp.init_data(cfg, dev)
            args = (d.f, d.u, d.w, d.rho, d.rhow, d.adz, d.flux)
            for n in (1, 4):
                f_k, flux_k = advect_resident(*args, n)
                f_p, flux_p = advect_resident_plain(*args, n)
                torch.cuda.synchronize()
                ef, mae_f, big_f = errors(f_k, f_p, "l1")
                efl, mae_fl, big_fl = errors(flux_k, flux_p, "l1")
                ms = timed_ms(lambda: advect_resident(*args, n), REPS)
                plain_ms = timed_ms(lambda: advect_resident_plain(*args, n), REPS)
                ok = (ef < gate_f[dtype] and efl < gate_flux[dtype]
                      and big_f > 0 and big_fl > 0
                      and bool(torch.isfinite(f_k).all())
                      and bool(torch.isfinite(flux_k).all()))
                print(f"[3 K2] {label:10s} S={nslices} nx=32 nz=58 "
                      f"{str(dtype)[6:]:7s} n={n}: rel_l1 f {ef:.3e} flux "
                      f"{efl:.3e} (gates {gate_f[dtype]:g}/{gate_flux[dtype]:g})"
                      f" max_abs {max(mae_f, mae_fl):.3e} of {max(big_f, big_fl):.3e};"
                      f" kernel {ms:.4f} ms, "
                      f"plain {plain_ms:.4f} ms [{card}]")
                if not ok:
                    fail(f"K2 {label} {dtype} n={n}: rel_l1 f {ef:.3e} "
                         f"flux {efl:.3e}")
                if (label, dtype, n) == ("production", torch.float32, 1):
                    rows["K2"] = dict(max_abs_err=max(mae_f, mae_fl), ms=ms,
                                      plain_ms=plain_ms)
            del d, args
    return rows


def phase_main(dev, card):
    from cdk_torch.core.config import (
        BiharmonicConfig,
        MpdataConfig,
        production_config,
    )
    from cdk_torch.harness.driver import run_kernel

    legs = (
        ("biharmonic", "shipped f64", BiharmonicConfig(dtype="float64"), None),
        ("mpdata", "shipped f64", MpdataConfig(dtype="float64"), None),
        ("biharmonic", "production f32", production_config("biharmonic"),
         ["reference_jnp", "fused_operator_bd8_resident_x3"]),
        ("mpdata", "production f32", production_config("mpdata"),
         ["reference_jnp", "pallas_xmajor"]),
    )
    for kernel, label, cfg, variants in legs:
        t0 = time.perf_counter()
        results = run_kernel(kernel, cfg, variants=variants, device=dev)
        wall = time.perf_counter() - t0
        if not results:
            fail(f"{kernel} {label}: no variant ran")
        for r in results:
            print(f"[4 main] {kernel} {label}: {r.variant} "
                  f"{'ok' if r.ok else 'FAILED'} {r.seconds_per_call * 1e6:.3f} "
                  f"us/step, {r.grid_points_per_s / 1e9:.4f} G pts/s "
                  f"[{card}] ({wall:.1f} s leg)")
            if not r.ok:
                fail(f"{kernel} {label} {r.variant}: {r.metrics} {r.note}")


def main() -> int:
    dev, card = phase_device()
    phase_build()
    rows = phase_kernels(dev, card)

    from cdk_torch.kernels.biharmonic.resident import bd8_resident
    from cdk_torch.kernels.mpdata.resident import advect_resident

    wrappers = {"K1": bd8_resident, "K2": advect_resident}
    for w in wrappers.values():
        w.launches = 0
    phase_main(dev, card)
    launches = {k: w.launches for k, w in wrappers.items()}
    print(f"[5 counts] kernel launches during the main path: {launches}")
    for k, n in launches.items():
        if n <= 0:
            fail(f"{k} was never launched by the main path")

    import torch

    meta = {
        "K1": dict(name="biharmonic_resident", source="cdk_torch/csrc/biharmonic_resident.cu",
                   replaces="cdk_tpu/kernels/biharmonic/pallas_bd8.py:56"),
        "K2": dict(name="mpdata_resident", source="cdk_torch/csrc/mpdata_resident.cu",
                   replaces="cdk_tpu/kernels/mpdata/pallas_xmajor.py:122"),
    }
    kernels = [dict(name=meta[k]["name"], route="cuda", source=meta[k]["source"],
                    replaces=meta[k]["replaces"], launches=launches[k], **rows[k])
               for k in ("K1", "K2")]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
