#!/usr/bin/env python3
"""The benchmark of the PyTorch and CUDA port (`cdk_torch`): one cell of
BENCHMARK.json on one card.

    python3 cdkbench/run.py --workload homme.hv_torus --seed 7 --seconds 15 --trace 0

A cell is a configuration (configs/<config>.json: the deployment's sizes
and how its inputs are drawn) under a traffic (traffic/<traffic>.json: the
entry kind of paths/<path>.py, the variant, the steps of an interval and
where an interval starts).  The run makes the inputs on the card from --seed
(problems/<problem>.py), builds the cell's path, warms it, then runs
intervals of `interval_steps` steps back to back, each ending in
torch.cuda.synchronize(), for --seconds.  A "carried" traffic starts each
interval from the state the previous one produced, a "seeded" one from the
seeded state.  With --trace 1 the window runs under torch.profiler and the
per-layer metrics are read from the trace, the program's spans and the
program's counters (`cdk_torch.core.trace.counts()` before and after it).

CHECKED intervals of the window, drawn from the seed, keep their outputs
(and, carried, a copy of their inputs); after the window each is held
against the benchmark's plain float64 reference (reference/<family>.py) run
from that interval's input, with the limits of limits/<cell>.json.  Every
number compared is printed beside its limit as the last lines on stderr
and under "checks", the last key of the result line, which is the last line
on stdout.  Without a CUDA card, or with fewer cards than the cell asks
for, it prints no result and exits 2; where the process holds JAX or the
JAX package (FORBIDDEN) once the window has closed, it names the modules
on stderr, prints no result and exits 3.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import sys  # noqa: E402
from contextlib import nullcontext  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# the intervals of a window held against the reference
CHECKED = 4
# intervals warmed before the window, kept as the window keeps them, so the
# window's allocations find cached blocks
WARM = CHECKED + 2
# a traced window ends after this many intervals or steps, if --seconds has
# not ended it first, so the trace stays small enough to read in seconds
TRACE_MAX_INTERVALS = 500
TRACE_MAX_STEPS = 6000
# top-level modules the process that prints a result may not hold: the
# benchmark measures the port alone, never JAX or the JAX package
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "cdk_tpu"})


def load(kind: str, name: str):
    """The module cdkbench/<kind>/<name>.py (`kind` may be a path, such as
    "tests/faults")."""
    path = HERE / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"cdkbench_{kind.replace('/', '_')}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_json(*parts) -> dict:
    return json.loads(HERE.joinpath(*parts).read_text())


def cell_of(name: str, bench: dict) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def forbidden_loaded(modules=None) -> list:
    """The names in `modules` (sys.modules) whose top-level name, whole, is
    in FORBIDDEN: `cdk_tpu.x` is, `cdk_torch` is not."""
    modules = sys.modules if modules is None else modules
    return sorted(m for m in list(modules) if m.split(".")[0] in FORBIDDEN)


def metrics_for(bench: dict, cell: str, trace: bool) -> list:
    """The cell's metric entries: end-to-end without trace, per-layer with."""
    return [m for m in bench["per_layer" if trace else "end_to_end"]
            if cell in m.get("workloads", [cell])]


class Clock:
    """Interval times: CUDA events on the card's clock (perf_counter on the
    CPU, where the tests drive the harness)."""

    def __init__(self, device):
        import torch

        self.cuda = device.type == "cuda"
        self.torch = torch
        if self.cuda:
            self.a = torch.cuda.Event(enable_timing=True)
            self.b = torch.cuda.Event(enable_timing=True)

    def sync(self):
        if self.cuda:
            self.torch.cuda.synchronize()

    def start(self):
        if self.cuda:
            self.a.record()
        else:
            self.t = time.perf_counter()

    def stop(self):
        if self.cuda:
            self.b.record()

    def ms(self) -> float:
        """The last interval's milliseconds (after sync)."""
        if self.cuda:
            return self.a.elapsed_time(self.b)
        return (time.perf_counter() - self.t) * 1e3


class Keeper:
    """CHECKED intervals drawn uniformly from the window by reservoir
    sampling from the seed.  Whether an interval is kept is drawn before it
    runs, so a carried path copies only the inputs of kept intervals; a
    kept output is copied too where the next interval starts from it."""

    def __init__(self, seed: int):
        self.rng = random.Random(seed)
        self.kept: list = []
        self.n = 0

    def draw(self):
        """The slot of the next interval, or None if it is not kept."""
        n, self.n = self.n, self.n + 1
        if n < CHECKED:
            return n
        j = self.rng.randrange(n + 1)
        return j if j < CHECKED else None

    def put(self, slot: int, item):
        if slot == len(self.kept):
            self.kept.append(item)
        else:
            self.kept[slot] = item


def no_span(name: str):
    return nullcontext()


def one(path, clock: Clock, keeper: Keeper, span) -> float:
    """One interval, kept if the keeper draws it -> its milliseconds."""
    slot = keeper.draw()
    inp = path.inputs() if slot is not None and path.carry else None
    with span("interval"):
        clock.start()
        with span("path.loop"):
            out = path.interval()
        clock.stop()
        with span("sync"):
            clock.sync()
    if slot is not None:
        outs = path.outputs(out)
        if path.carry:
            outs = {k: v.clone() for k, v in outs.items()}
        keeper.put(slot, (inp, outs))
    return clock.ms()


def window(path, seconds: float, clock: Clock, keeper: Keeper, prof=None):
    """Intervals back to back until the next would end past `seconds` (or,
    traced, after TRACE_MAX_INTERVALS or TRACE_MAX_STEPS). -> (wall
    seconds, interval ms).
    The spans are recorded only under the profiler."""
    from torch.profiler import record_function

    span = record_function if prof is not None else no_span
    ms = []
    t_start = t = time.perf_counter()
    while True:
        t_prev = t
        ms.append(one(path, clock, keeper, span))
        t = time.perf_counter()
        if prof is not None and len(ms) >= min(
                TRACE_MAX_INTERVALS, TRACE_MAX_STEPS // path.steps):
            break
        if t - t_start + (t - t_prev) > seconds:
            break
    return t - t_start, ms


def cell_files(cell: dict, overrides: dict | None = None):
    """-> (config, traffic) of the cell, with `overrides` ({"config":
    {...}, "traffic": {...}}) replacing keys: the tests' small sizes."""
    over = overrides or {}
    cfg = {**read_json("configs", f"{cell['config']}.json"),
           **over.get("config", {})}
    traffic = {**read_json("traffic", f"{cell['traffic']}.json"),
               **over.get("traffic", {})}
    return cfg, traffic


def build(cfg: dict, traffic: dict, seed: int, device):
    """-> (the seeded inputs, the cell's timed path over them)."""
    problem = load("problems", cfg["problem"])
    raw = problem.make(cfg, seed, device)
    return raw, load("paths", traffic["path"]).build(problem, cfg, traffic,
                                                     raw, device)


def run_cell(cell: dict, bench: dict, seed: int, seconds: float, trace: bool,
             device, overrides: dict | None = None):
    """Run one cell on `device` -> (result dict, check lines); `overrides`
    as cell_files takes them."""
    import torch

    from cdkbench import check as chk
    from cdkbench import trace as tr

    cfg, traffic = cell_files(cell, overrides)
    limits = read_json("limits", f"{cell['name']}.json")["limits"]
    family, steps = traffic["family"], traffic["interval_steps"]
    raw, path = build(cfg, traffic, seed, device)
    state = [t.clone() for t in path.state]
    clock = Clock(device)
    warm = Keeper(seed)
    for _ in range(WARM):
        one(path, clock, warm, no_span)
    del warm
    keeper = Keeper(seed)
    setup_s = time.perf_counter() - T0

    if trace:
        from torch.profiler import ProfilerActivity, profile

        from cdk_torch.core.trace import counts

        before = counts()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _, ms = window(path, seconds, clock, keeper, prof)
        after = counts()
        summary, breakdown = tr.reduce(prof, tr.csrc_kernels(
            ROOT / "cdk_torch" / "csrc"))
        del prof
        # what the program counted in the traced window
        summary["counts"] = {k: v - before.get(k, 0) for k, v in after.items()
                             if v != before.get(k, 0)}
        summary["least_s"] = load("work", family).least(cfg, steps)["least_s"]
    else:
        wall, ms = window(path, seconds, clock, keeper)
        summary = dict(setup_s=setup_s, window_s=wall, interval_ms=ms,
                       intervals=len(ms))
    summary["steps"] = summary["intervals"] * steps
    intervals = len(ms)
    # the peak of the fullest card the cell uses
    mem = (max(torch.cuda.max_memory_allocated(i) for i in range(cell["chips"]))
           if device.type == "cuda" else 0)

    # the check: after the window, the program's state freed but for the
    # kept intervals, the reference from each kept interval's input (once
    # for all where every interval starts from the seeded state)
    kept = keeper.kept
    changed = sum(not torch.equal(a, b) for a, b in zip(path.state, state))
    del path, keeper, state
    reference = load("reference", family)
    seeded = None if traffic["state"] == "carried" else reference.interval(
        cfg, raw, steps, "float64")
    per = []
    for inp, outs in kept:
        ref = seeded if seeded is not None else reference.interval(
            cfg, inp, steps, "float64")
        per.append(chk.readings(reference.NORM, outs, ref))
        del ref
    got = {**chk.worst(per), "state_changed": float(changed)}
    checks = chk.judge(got, {**limits, "state_changed": 0.0})
    failed = sum(not chk.passed(chk.judge(r, limits)) for r in per)
    correct = chk.passed(checks)

    metrics = {}
    for m in metrics_for(bench, cell["name"], trace):
        value = load("metrics", m["name"]).read(summary)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": cell["chips"], "memory_peak_bytes": int(mem)}
    if trace:
        dev.update(busy_s=summary["busy_s"], window_s=summary["window_s"])
    result = {"correct": correct, "attempted": intervals, "failed": failed,
              "metrics": metrics, "device": dev}
    if trace:
        result["breakdown"] = breakdown
    big = sys.float_info.max
    result["checks"] = {k: {"value": min(c["value"], big), "limit": c["limit"]}
                        for k, c in checks.items()}
    lines = [f"check {k}: {c['value']:.6e} (limit {c['limit']:.6e}) "
             f"{'ok' if c['value'] <= c['limit'] else 'FAILED'}"
             for k, c in checks.items()]
    lines.append(f"correct: {correct} ({len(per)} outputs of {intervals} "
                 f"intervals against the float64 reference)")
    return result, lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every cache the run writes stays at a fixed place inside the checkout
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(ROOT / "build" / "cdkbench" / sub)
    sys.path.insert(0, str(ROOT))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = cell_of(args.workload, bench)
    import torch

    from cdk_torch.core.platform import resolve_device

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"cdkbench: {args.workload} needs {cell['chips']} CUDA card(s); "
              f"torch sees {torch.cuda.device_count()}: no result",
              file=sys.stderr)
        return 2

    result, lines = run_cell(cell, bench, args.seed, args.seconds,
                             bool(args.trace), resolve_device("cuda"))
    loaded = forbidden_loaded()
    if loaded:
        print(f"cdkbench: the run's process holds {', '.join(loaded)} once the "
              f"window has closed; the benchmark measures the port alone: "
              f"no result", file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
