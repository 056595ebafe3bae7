#!/usr/bin/env python3
"""What the program's spans and counters (cdk_torch/core/trace.py) say about
one benchmark cell, read from a traced window on one card.

    python3 scripts/torch_trace_spans.py --workload homme.hv_torus --seed 7 [--seconds 15] [--out FILE]

Run from the root of a checkout (an older tree too: its cdkbench and
cdk_torch are the ones imported).  The cell is built and warmed as
cdkbench/run.py builds it; then one untraced window of --seconds and one
window under torch.profiler (CPU and CUDA, ended as run.py ends it) run on
the same path, and the counters are read around the traced one.  Prints
one JSON line: cdkbench/trace.py's summary and breakdown of the trace as
run.py computes them, the same with the device-side copies of the `cdk.`
spans taken out (equal where the benchmark's reduction leaves them out),
and, per `cdk.` span name, the host seconds (the union of its intervals),
the device seconds of the activities launched under it (the profiler's
correlation link gives each call its activities, `kernels`; a call counts
for its innermost enclosing `cdk.` span) and of its device-side copies; the idle time by the
innermost span the host was in, the program's spans included; the
counters' difference; the step time of each window; and the readings a
benchmark metric of these spans would give, with the set-up's hit share
beside the operator builds (none where a span or counter is absent, as on
a tree without core/trace.py).  No reference check runs.
"""

from __future__ import annotations

import argparse
import bisect
import json
import sys
import time
from pathlib import Path

ROOT = Path.cwd()


def _union_s(intervals) -> float:
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > max(a, end):
            total += b - max(a, end)
            end = b
    return total * 1e-6


def _segments(spans, w0, w1):
    """[(start, end, name)] covering [w0, w1]: each piece named by the
    innermost host span open over it (spans on one thread nest), or
    "harness" where none is."""
    segs, stack, t = [], [], w0

    def emit(x, y, name):
        x, y = max(x, w0), min(y, w1)
        if y > x:
            segs.append((x, y, name))

    for a, b, n in sorted(spans, key=lambda s: (s[0], -s[1])):
        while stack and stack[-1][0] <= a:
            end, nm = stack.pop()
            emit(t, end, nm)
            t = max(t, end)
        emit(t, a, stack[-1][1] if stack else "harness")
        t = max(t, a)
        stack.append((b, n))
    while stack:
        end, nm = stack.pop()
        emit(t, end, nm)
        t = max(t, end)
    emit(t, w1, "harness")
    return segs


def program_spans(events, bench_spans) -> dict:
    """The `cdk.` spans of a traced window (profiler events) -> the new
    keys, from the first `interval` span to the end of the last."""
    from torch.autograd import DeviceType

    host, annot, dev, launching = {}, {}, [], []
    named = []  # every benchmark and program span: (start, end, name)
    for e in events:
        a, b = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CPU:
            # the activities the profiler linked to this call by correlation
            ks = [k.duration for k in getattr(e, "kernels", ())
                  if not k.name.startswith("cdk.") and k.name not in bench_spans]
            if ks:
                launching.append((e, sum(ks)))
            if e.name.startswith("cdk."):
                host.setdefault(e.name, []).append((a, b))
                named.append((a, b, e.name))
            elif e.name in bench_spans:
                named.append((a, b, e.name))
        elif e.device_type == DeviceType.CUDA:
            if e.name.startswith("cdk."):
                annot.setdefault(e.name, []).append((a, b))
            elif e.name not in bench_spans and not getattr(
                    e, "is_user_annotation", False):
                dev.append(e)
    iv = sorted((a, b) for a, b, n in named if n == "interval")
    w0, w1 = iv[0][0], iv[-1][1]
    clip = lambda a, b: (max(a, w0), min(b, w1))

    busy = [clip(e.time_range.start, e.time_range.end) for e in dev]
    busy = [(a, b) for a, b in busy if b > a]
    # each linked activity to the innermost `cdk.` span around its call
    device_s, outside = {}, 0.0
    for e, us in launching:
        if not w0 <= e.time_range.start <= w1:
            continue
        op = e
        while op is not None and not op.name.startswith("cdk."):
            op = op.cpu_parent
        if op is None:
            outside += us
        else:
            device_s[op.name] = device_s.get(op.name, 0.0) + us

    # idle: the window less the union of the device activities, cut by the
    # innermost span the host was in
    busy.sort()
    idle_iv, t = [], w0
    for a, b in busy:
        if a > t:
            idle_iv.append((t, a))
        t = max(t, b)
    if w1 > t:
        idle_iv.append((t, w1))
    segs = _segments(named, w0, w1)
    starts = [s[0] for s in segs]
    idle = {}
    for a, b in idle_iv:
        i = max(bisect.bisect_right(starts, a) - 1, 0)
        while i < len(segs) and segs[i][0] < b:
            x, y, n = segs[i]
            lo, hi = max(a, x), min(b, y)
            if hi > lo:
                idle[n] = idle.get(n, 0.0) + (hi - lo)
            i += 1
    return {
        "host_s": {n: _union_s([clip(a, b) for a, b in v])
                   for n, v in sorted(host.items())},
        "device_s": {n: s * 1e-6 for n, s in sorted(device_s.items())},
        "device_outside_s": outside * 1e-6,
        "device_total_s": sum(b - a for a, b in busy) * 1e-6,
        "annotation_s": {n: _union_s([clip(a, b) for a, b in v])
                         for n, v in sorted(annot.items())},
        "idle_gaps": [[n, s * 1e-6] for n, s in
                      sorted(idle.items(), key=lambda kv: -kv[1])],
    }


def counter_readings(delta, intervals: int) -> dict:
    """The counters' difference over a window of `intervals` intervals ->
    operator builds and set-up reuses an interval, and the hit share
    reuses / (reuses + builds); all None without counters (a tree without
    core/trace.py), the share None where neither counted."""
    if delta is None:
        return dict.fromkeys(("operator_builds_per_interval",
                              "prepare_reuses_per_interval",
                              "prepare_hit_share"))
    builds = delta.get("operator_builds", 0)
    reuses = delta.get("prepare_reuses", 0)
    return {"operator_builds_per_interval": builds / intervals,
            "prepare_reuses_per_interval": reuses / intervals,
            "prepare_hit_share": (reuses / (reuses + builds)
                                  if reuses + builds else None)}


class _Without:
    """A profiler's events less the device-side copies of `cdk.` spans."""

    def __init__(self, prof):
        from torch.autograd import DeviceType

        self._events = [e for e in prof.events()
                        if not (e.device_type == DeviceType.CUDA
                                and e.name.startswith("cdk."))]

    def events(self):
        return self._events


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--out", help="also write the JSON line to this file")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    from torch.profiler import ProfilerActivity, profile

    from cdkbench import run
    from cdkbench import trace as tr

    try:
        from cdk_torch.core.trace import counts
    except ImportError:  # a tree without the program's counters
        counts = None
    if not torch.cuda.is_available():
        print("torch_trace_spans: no CUDA card", file=sys.stderr)
        return 2
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = run.cell_of(args.workload, bench)
    cfg, traffic = run.cell_files(cell)
    device = torch.device("cuda")
    _, path = run.build(cfg, traffic, args.seed, device)
    clock = run.Clock(device)
    warm = run.Keeper(args.seed)
    for _ in range(run.WARM):
        run.one(path, clock, warm, run.no_span)
    wall, ms = run.window(path, args.seconds, clock, run.Keeper(args.seed))
    untraced_us = wall / (len(ms) * path.steps) * 1e6
    before = counts() if counts else None
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, tms = run.window(path, args.seconds, clock,
                            run.Keeper(args.seed), prof)
        traced_wall = time.perf_counter() - t0
    after = counts() if counts else None
    kernels = tr.csrc_kernels(ROOT / "cdk_torch" / "csrc")
    summary, breakdown = tr.reduce(prof, kernels)
    summary_wo, breakdown_wo = tr.reduce(_Without(prof), kernels)
    spans = program_spans(prof.events(), tr.SPANS)
    steps = summary["intervals"] * path.steps
    delta = ({k: v - before.get(k, 0) for k, v in after.items()
              if v != before.get(k, 0)} if counts else None)

    def per_step(d, name):
        return None if name not in d else d[name] / steps * 1e6

    readings = {
        "prepare_us_per_step": per_step(spans["host_s"], "cdk.prepare"),
        **counter_readings(delta, summary["intervals"]),
        "layout_us_per_step": per_step(spans["device_s"], "cdk.layout"),
        "exchange_us_per_step": per_step(spans["device_s"],
                                         "cdk.dist.exchange"),
        "shard_gather_us_per_step": per_step(spans["device_s"],
                                             "cdk.dist.gather"),
    }
    out = {"workload": args.workload, "seed": args.seed,
           "card": torch.cuda.get_device_name(device),
           "untraced_step_us": untraced_us, "untraced_intervals": len(ms),
           "traced_step_us": traced_wall / (len(tms) * path.steps) * 1e6,
           "traced_intervals": len(tms), "steps": steps,
           "readings": readings, "counts": delta,
           "summary": summary, "breakdown": breakdown,
           "summary_equal_without_annotations": (
               summary == summary_wo and breakdown == breakdown_wo),
           "summary_without_annotations": summary_wo, **spans}
    line = json.dumps(out)
    if args.out:
        Path(args.out).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
