#!/usr/bin/env python3
"""The benchmark's two HOMME loops at their cells' size on one card: their
outputs as digests, and the times of their first kernels from either
layout.

    python3 scripts/torch_natural_loads.py --seed 7 [--times] [--reps 20]

Run from the root of a checkout (an older tree too: its cdkbench and
cdk_torch are the ones imported).  For homme.hv_elem and homme.hv_torus the
cell's inputs are made from --seed and its loop built as cdkbench/run.py
makes and builds them; one interval runs, and the line of each cell gives
sha256 digests of its output and of qtens before and after it, so two
trees' lines compare the outputs bit for bit.  With --times (a tree whose
K1 and K15 take the state's own layout) the line adds the median of --reps
CUDA-event times, in ms, of one interval; of the `to_lane_layout` copy;
of the cell's first kernel from that copy (K1 for hv_elem, exact, at the
interval's 6 steps; K15 for hv_torus, bf16x3) and from the state where it
lies, with those two outputs' digests.  Prints one JSON line a cell, then
the card's name and power limit.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path.cwd()
CELLS = ("homme.hv_elem", "homme.hv_torus")


def digest(t) -> str:
    return hashlib.sha256(t.detach().cpu().contiguous().numpy().tobytes()).hexdigest()


def timed_ms(fn, reps: int) -> float:
    import torch

    for _ in range(3):
        fn()
    ms = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ms.append(a.elapsed_time(b))
    return statistics.median(ms)


def first_kernel(traffic: dict, pcfg, aux):
    """The cell's first kernel as a function of its q input."""
    from cdk_torch.kernels.biharmonic import dss2d_rowchain as rc
    from cdk_torch.kernels.biharmonic import resident as bres

    n = traffic["interval_steps"]
    prec = "bf16x3" if traffic["variant"].endswith("x3") else "highest"
    if traffic["family"] == "biharmonic":
        return lambda q: bres.bd8_resident(aux[0], q, n, prec)
    ex, ey = rc.torus_shape(pcfg.nelemd)
    return lambda q: rc.rowchain_bridge_in(aux[0], q, ex, ey, prec)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--times", action="store_true")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from cdk_torch.core import registry
    from cdkbench import run
    from cdk_torch.kernels.biharmonic import problem as bp

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    dev = torch.device("cuda")
    for name in CELLS:
        cfg, traffic = run.cell_files(run.cell_of(name, bench))
        raw, path = run.build(cfg, traffic, args.seed, dev)
        qtens = raw["qtens"]
        line = {"cell": name, "seed": args.seed, "qtens": digest(qtens)}
        out = path.interval()
        torch.cuda.synchronize()
        line.update(out=digest(out), qtens_after=digest(qtens))
        if args.times:
            pcfg, data = path._problem.to_program(cfg, raw)
            variant = registry.get(traffic["family"], traffic["variant"])
            _, aux, _ = registry._materialize(variant, pcfg, data)
            k = first_kernel(traffic, pcfg, aux)
            lane = bp.to_lane_layout(qtens)
            line.update(
                interval_ms=timed_ms(path.interval, args.reps),
                copy_ms=timed_ms(lambda: bp.to_lane_layout(qtens), args.reps),
                lane_ms=timed_ms(lambda: k(lane), args.reps),
                natural_ms=timed_ms(lambda: k(qtens), args.reps),
                lane_out=digest(k(lane)), natural_out=digest(k(qtens)))
            del lane
        print(json.dumps(line), flush=True)
        del raw, path, out
        torch.cuda.empty_cache()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(card.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
