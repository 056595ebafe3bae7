"""Command-line driver: `python -m cdk_torch <cmd> ...`.

  python -m cdk_torch list
  python -m cdk_torch run biharmonic|biharmonic_dss|biharmonic_dss2d|mpdata|cke|all [--dtype float32]
         [--iters N] [--trials N] [--variant NAME ...] [--json out.json]
         [--set key=value ...] [--preset production] [--device-init]
         [--namelist nested.nml] [--device cuda|cpu]

`--namelist` reads a reference-format nested.nml (cke only); `--set`
overrides apply on top of it.

`run` exits 1 if any variant fails its verification or crashes.
"""

from __future__ import annotations

import argparse
import sys


def _parse_set(kvs):
    out = {}
    for kv in kvs or []:
        k, v = kv.split("=", 1)
        for cast in (int, float):
            try:
                v = cast(v)
                break
            except ValueError:
                continue
        out[k] = v
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="cdk_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    sub.add_parser("list", help="list kernels and registered variants")

    runp = sub.add_parser("run", help="run a kernel benchmark + verification")
    runp.add_argument("kernel", choices=["biharmonic", "biharmonic_dss",
                                        "biharmonic_dss2d", "mpdata", "cke",
                                        "all"])
    # the kernels take float32 and float64
    runp.add_argument("--dtype", default=None, choices=["float32", "float64"])
    runp.add_argument("--iters", type=int, default=10)
    runp.add_argument("--trials", type=int, default=3)
    runp.add_argument("--variant", action="append", default=None)
    runp.add_argument("--json", dest="json_out", default=None)
    runp.add_argument("--set", dest="sets", action="append", default=None,
                      metavar="key=value", help="config field override")
    runp.add_argument("--namelist", default=None, metavar="PATH",
                      help="reference-format nested.nml (cke only)")
    runp.add_argument("--preset", default=None, choices=["production"],
                      help="use the production-scale config preset")
    runp.add_argument("--device-init", action="store_true",
                      help="generate inputs on the device (torch.Generator)")
    runp.add_argument("--device", default="cuda", choices=["cuda", "cpu"])

    args = p.parse_args(argv)
    if args.cmd == "run" and args.namelist:
        if args.kernel != "cke":
            p.error("--namelist is for the cke kernel only")
        if args.preset:
            p.error("--namelist and --preset each give the whole config")

    import cdk_torch.kernels  # noqa: F401  (registers variants)
    from cdk_torch.core import registry

    if args.cmd == "list":
        for kernel in registry.kernels():
            print(f"{kernel}:")
            for name, var in registry.variants(kernel).items():
                print(f"  {name:<32s} {var.description}")
        return 0

    from dataclasses import asdict

    from cdk_torch.core.config import (
        cke_config_from_namelist,
        production_config,
        with_overrides,
    )
    from cdk_torch.harness import driver
    from cdk_torch.harness.specs import get_spec

    overrides = _parse_set(args.sets)
    if args.dtype:
        overrides["dtype"] = args.dtype
    if args.device_init:
        overrides["device_init"] = True

    if args.kernel == "all":
        results = driver.run_all(iters=args.iters, trials=args.trials,
                                 dtype=args.dtype, device=args.device)
    else:
        if args.namelist:
            cfg = cke_config_from_namelist(args.namelist, **overrides)
        elif args.preset == "production":
            cfg = with_overrides(production_config(args.kernel), **overrides)
        else:
            cfg = with_overrides(get_spec(args.kernel).default_config(),
                                 **overrides)
        res = driver.run_kernel(args.kernel, cfg, variants=args.variant,
                                iters=args.iters, trials=args.trials,
                                device=args.device)
        results = {"kernels": {args.kernel: [asdict(r) for r in res]}}

    if args.json_out:
        with open(args.json_out, "w") as fh:
            fh.write(driver.to_json(results))
        print(f"wrote {args.json_out}")
    failed = [
        r["variant"]
        for rs in results["kernels"].values()
        for r in rs
        if not r["ok"]
    ]
    if failed:
        print(f"FAILED variants: {', '.join(failed)}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
