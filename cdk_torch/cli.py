"""Command-line driver: `python -m cdk_torch <cmd> ...`.

  python -m cdk_torch list
  python -m cdk_torch run biharmonic|biharmonic_dss|biharmonic_dss2d|biharmonic_dss_cube|
         mpdata|cke|all [--dtype float32]
         [--iters N] [--trials N] [--variant NAME ...] [--json out.json]
         [--set key=value ...] [--preset production] [--device-init]
         [--namelist nested.nml] [--device cuda|cpu]
  python -m cdk_torch integrate mpdata --steps N --variant pallas_fused
         [--dtype float32|float64] [--out state.npz] [--set key=value ...]
         [--device cuda|cpu]
  python -m cdk_torch scaling mpdata|biharmonic [--devices 1,2,4,8]
         [--nx-per-device N] [--nelemd-per-device N] [--steps N]
         [--no-overlap] [--overlap-gain] [--kstep K] [--device cuda|cpu]
  python -m cdk_torch verify

`--namelist` reads a reference-format nested.nml (cke only); `--set`
overrides apply on top of it.

`run` exits 1 if any variant fails its verification or crashes.
`integrate` runs N steps of one variant from the host init (its `loop`
where it has one) and saves the final state as out0, out1, ... in an npz.
`scaling mpdata` runs the decomposed MPDATA sweeps on a mesh of that many
shards on one device (`dist/mesh.py`): x-decomposed weak scaling (the split
step unless --no-overlap), the slice-batch sweep, and with --overlap-gain
and --kstep the serialized-vs-split step and the per-step vs the kstep
loop at the largest shard count.  `scaling biharmonic` runs the DSS sweeps
likewise: ring weak scaling (the overlap step unless --no-overlap), torus
weak scaling on most-square 2-D meshes, and with --overlap-gain and
--kstep the serialized-vs-overlap ring step and the per-step vs the kstep
loops of the ring and the rowchain.  The cke sweeps are not ported yet:
`scaling cke|all` exits 2.
`verify` runs the port's tests with pytest and exits with pytest's code:
tests/test_torch_*.py where jax imports (they compare with the JAX
package), else tests/test_torch_gpu.py alone, which imports no jax.
"""

from __future__ import annotations

import argparse
import importlib.util
import subprocess
import sys
from pathlib import Path

KERNELS = ["biharmonic", "biharmonic_dss", "biharmonic_dss2d",
           "biharmonic_dss_cube", "mpdata", "cke"]


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
    sub.add_parser("verify", help="run the port's tests (pytest)")

    runp = sub.add_parser("run", help="run a kernel benchmark + verification")
    runp.add_argument("kernel", choices=KERNELS + ["all"])
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

    intp = sub.add_parser(
        "integrate", help="run an N-step integration of a kernel with a "
        "chosen variant and save the final state (npz)")
    intp.add_argument("kernel", choices=KERNELS)
    intp.add_argument("--steps", type=int, default=100)
    intp.add_argument("--variant", default="reference_jnp")
    intp.add_argument("--dtype", default="float32",
                      choices=["float32", "float64"])
    intp.add_argument("--out", default=None, help="output .npz path")
    intp.add_argument("--set", dest="sets", action="append", default=None,
                      metavar="key=value")
    intp.add_argument("--device", default="cuda", choices=["cuda", "cpu"])

    scalep = sub.add_parser(
        "scaling", help="scaling sweeps of the dist steps on a mesh of "
        "shards on one device (mpdata, biharmonic)")
    scalep.add_argument("kernel", nargs="?", default="all",
                        choices=["mpdata", "biharmonic", "cke", "all"])
    scalep.add_argument("--devices", default="1,2,4,8",
                        help="shard counts (shards on one device)")
    scalep.add_argument("--nx-per-device", type=int, default=64)
    scalep.add_argument("--nelemd-per-device", type=int, default=16)
    scalep.add_argument("--steps", type=int, default=20)
    scalep.add_argument("--no-overlap", action="store_true")
    scalep.add_argument("--overlap-gain", action="store_true",
                        help="also time the serialized against the split step")
    scalep.add_argument("--kstep", type=int, default=0,
                        help="also time the communication-avoiding kstep "
                        "loop against the per-step loop")
    scalep.add_argument("--device", default="cuda", choices=["cuda", "cpu"])

    args = p.parse_args(argv)
    if args.cmd == "verify":
        return verify()
    if args.cmd == "scaling":
        return scaling(args)
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

    if args.cmd == "integrate":
        return integrate(args.kernel, args.variant, args.steps, args.dtype,
                         _parse_set(args.sets), args.out, args.device)

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


def integrate(kernel: str, variant: str, steps: int, dtype: str,
              overrides: dict, out: str | None, device: str) -> int:
    """`steps` steps of one variant from the host init; prints each
    output's shape and |x|max as the JAX CLI does, saves them to `out`."""
    import numpy as np

    from cdk_torch.core import registry
    from cdk_torch.core.config import with_overrides
    from cdk_torch.core.platform import resolve_device, synchronize
    from cdk_torch.harness.specs import get_spec

    spec = get_spec(kernel)
    dev = resolve_device(device)
    cfg = with_overrides(spec.default_config(), **{**overrides, "dtype": dtype})
    data = spec.init(cfg, dev).to(dev)
    step2, aux, vloop = registry._materialize(registry.get(kernel, variant),
                                              cfg, data)
    if vloop is not None:
        res = vloop(data, steps)
    else:
        res = spec.loop_runner(step2, aux, steps)(data)
    synchronize(dev)
    leaves = {f"out{i}": t.cpu().numpy() for i, t in
              enumerate(res if isinstance(res, tuple) else (res,))}
    for name, arr in leaves.items():
        print(f" {kernel}/{variant} x{steps}: {name} shape={arr.shape} "
              f"|x|max={np.abs(arr).max():.6e}")
    if out:
        np.savez(out, **leaves)
        print(f"wrote {out}")
    return 0


def scaling(args) -> int:
    """`scaling mpdata|biharmonic`; the cke sweeps wait for `dist/cke.py`."""
    if args.kernel not in ("mpdata", "biharmonic"):
        print(f"scaling {args.kernel}: not ported yet (mpdata, biharmonic)",
              file=sys.stderr)
        return 2
    from cdk_torch.harness import scaling as sc

    shards = tuple(int(x) for x in args.devices.split(","))
    if args.kernel == "biharmonic":
        return _scaling_biharmonic(sc, args, shards)
    sc.weak_scaling_mpdata(device_counts=shards,
                           nx_per_device=args.nx_per_device,
                           n_steps=args.steps, overlap=not args.no_overlap,
                           device=args.device)
    sc.weak_scaling_mpdata_slices(device_counts=shards, n_steps=args.steps,
                                  device=args.device)
    if args.overlap_gain:
        sc.overlap_gain_mpdata(n_devices=shards[-1],
                               nx_per_device=args.nx_per_device,
                               n_steps=args.steps, device=args.device)
    if args.kstep:
        sc.comm_avoid_gain_mpdata(n_devices=shards[-1],
                                  nx_per_device=args.nx_per_device,
                                  kstep=args.kstep, n_steps=args.steps,
                                  device=args.device)
    return 0


def _scaling_biharmonic(sc, args, shards) -> int:
    from cdk_torch.dist.mesh import make_mesh2d

    per = args.nelemd_per_device
    sc.weak_scaling_biharmonic(device_counts=shards, nelemd_per_device=per,
                               n_steps=args.steps, overlap=not args.no_overlap,
                               device=args.device)
    # each shard count as its most-square 2-D mesh
    meshes = tuple(make_mesh2d(n, device=args.device).shape for n in shards)
    sc.weak_scaling_dss2d(mesh_shapes=meshes,
                          nelemd_per_device=per, n_steps=args.steps,
                          device=args.device)
    if args.overlap_gain:
        sc.overlap_gain_biharmonic(n_devices=shards[-1], nelemd_per_device=per,
                                   n_steps=args.steps, device=args.device)
    if args.kstep:
        sc.comm_avoid_gain_dss(n_devices=shards[-1], nelemd_per_device=per,
                               kstep=args.kstep, n_steps=args.steps,
                               device=args.device)
        sc.comm_avoid_gain_dss2d(n_devices=shards[-1], kstep=args.kstep,
                                 n_steps=args.steps, device=args.device)
    return 0


def verify() -> int:
    """The port's tests under pytest; returns pytest's exit code."""
    root = Path(__file__).resolve().parents[1]
    if importlib.util.find_spec("jax") is not None:
        cmd = sorted(map(str, (root / "tests").glob("test_torch_*.py")))
    else:  # without jax, only the tests that need none
        cmd = ["--noconftest", "-p", "no:cacheprovider",
               str(root / "tests" / "test_torch_gpu.py")]
    return subprocess.run([sys.executable, "-m", "pytest", "-q", *cmd],
                          cwd=root).returncode


if __name__ == "__main__":
    sys.exit(main())
