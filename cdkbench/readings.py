#!/usr/bin/env python3
"""The readings a cell's limits are set from (not part of a benchmark run).

    python3 cdkbench/readings.py --workload mmf.slices --seeds 1-12 \
        --control-seeds 101-103 [--age 200] [--out FILE]

For every seed of --seeds: the cell's timed path built as run.py builds it,
run for --age intervals (which, carried, move its state on as a window
does), then one more interval held against the float64 reference run from
that interval's input: the program's readings.  For every seed of
--control-seeds: the same path and age, and then the reference computed in
the control's precision (reference/<family>.py CONTROL) from the same input
in the program's place: the control's readings.  One JSON line a seed on
stdout (and appended to --out).  On a CUDA card unless --device cpu.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def seeds(text: str) -> list:
    """'1-3,7' -> [1, 2, 3, 7]."""
    out = []
    for part in filter(None, text.split(",")):
        lo, _, hi = part.partition("-")
        out += range(int(lo), int(hi or lo) + 1)
    return out


def readings(cell: dict, seed: int, control: bool, device, overrides=None,
             age: int = 1):
    """The readings of the program (or, with control, of the control) on
    one seed, after `age` intervals: the cell's numbers against the float64
    reference; `overrides` as run.cell_files takes them."""
    import torch

    from cdkbench import check as chk
    from cdkbench.run import build, cell_files, load

    cfg, traffic = cell_files(cell, overrides)
    family, steps = traffic["family"], traffic["interval_steps"]
    ref_mod = load("reference", family)
    raw, path = build(cfg, traffic, seed, device)
    for _ in range(age):
        path.interval()
    inp = path.inputs() if path.carry else raw
    if control:
        outs = ref_mod.interval(cfg, inp, steps, ref_mod.CONTROL)
    else:
        outs = path.outputs(path.interval())
    del path
    if device.type == "cuda":
        torch.cuda.synchronize()
    ref = ref_mod.interval(cfg, inp, steps, "float64")
    return chk.readings(ref_mod.NORM, outs, ref)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--age", type=int, default=1,
                    help="intervals run before the one read")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from cdkbench.run import cell_of

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = cell_of(args.workload, bench)
    device = torch.device(args.device)
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    for control, group in ((False, args.seeds), (True, args.control_seeds)):
        for seed in seeds(group):
            got = readings(cell, seed, control, device, age=args.age)
            line = json.dumps({"workload": cell["name"], "seed": seed,
                               "side": "control" if control else "program",
                               "age": args.age,
                               "device": kind, "readings": got})
            print(line, flush=True)
            if args.out:
                with open(args.out, "a") as fh:
                    fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
