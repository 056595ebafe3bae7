"""The reduction of a traced window (torch.profiler) to the summary the
per-layer readers take, and the breakdown the result line carries.

The device activities are the trace's kernels, copies and fills.  A kernel
is one of the port's hand-written kernels when its name carries one of the
`__global__` functions of `cdk_torch/csrc`; everything else on the card is
glue.  The benchmark's own spans (`interval`, `path.loop`, `sync`) mark what
the host was doing; the card's idle time is named by the innermost of them
the host was in, or `harness` between intervals.
"""

from __future__ import annotations

import bisect
import re
from pathlib import Path

SPANS = ("interval", "path.loop", "sync")
_GLOBAL = re.compile(
    r"__global__\s+void\s+(?:__launch_bounds__\((?:[^()]|\([^()]*\))*\)\s*)?"
    r"(\w+)\s*\(")


def csrc_kernels(csrc: Path) -> frozenset:
    """The names of the `__global__` functions of the sources in `csrc`."""
    names = set()
    for src in sorted(csrc.glob("*.cu*")):
        names.update(_GLOBAL.findall(src.read_text()))
    return frozenset(names)


def is_csrc(name: str, kernels: frozenset) -> bool:
    """Whether the (demangled) kernel name is one of `kernels`."""
    if "at::" in name:
        return False
    return any(re.search(rf"(?:^|[\s:]){k}\s*[<(]", name) for k in kernels)


def _short(name: str) -> str:
    """A kernel's name without its trailing parameter list, cut to 160
    characters."""
    name = name.removeprefix("void ")
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, 0, -1):
            depth += (name[i] == ")") - (name[i] == "(")
            if depth == 0:
                name = name[:i].rstrip()
                break
    return name[:160]


def _union(intervals: list) -> list:
    """Merged [start, end] intervals of a list sorted by start."""
    out = []
    for a, b in intervals:
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _events(prof) -> tuple[list, dict]:
    """(the device activities as (name, start_us, end_us) sorted by start,
    and the host spans as name -> sorted [(start_us, end_us)]); the
    device-side copies of the benchmark's spans are not activities."""
    from torch.autograd import DeviceType

    evs, spans = [], {k: [] for k in SPANS}
    for e in prof.events():
        if e.device_type == DeviceType.CPU:
            if e.name in spans:
                spans[e.name].append((e.time_range.start, e.time_range.end))
        elif (e.device_type == DeviceType.CUDA and e.name not in spans
              and not getattr(e, "is_user_annotation", False)):
            evs.append((e.name, e.time_range.start, e.time_range.end))
    evs.sort(key=lambda t: t[1])
    for v in spans.values():
        v.sort()
    return evs, spans


def _span_at(spans: dict, t: float) -> str:
    """The innermost benchmark span on the host at time t."""
    for name in ("sync", "path.loop", "interval"):
        v = spans[name]
        i = bisect.bisect_right(v, (t, float("inf"))) - 1
        if i >= 0 and v[i][0] <= t <= v[i][1]:
            return name
    return "harness"


def reduce(prof, kernels: frozenset) -> tuple[dict, dict]:
    """-> (summary, breakdown) of the traced window: from the start of the
    first `interval` span to the end of the last."""
    evs, spans = _events(prof)
    if not spans["interval"]:
        raise RuntimeError("the trace holds no interval span")
    w0, w1 = spans["interval"][0][0], spans["interval"][-1][1]
    evs = [(n, max(a, w0), min(b, w1)) for n, a, b in evs
           if b > w0 and a < w1]
    by_name: dict = {}
    for n, a, b in evs:
        by_name[n] = by_name.get(n, 0.0) + (b - a)
    kernel_us = sum(us for n, us in by_name.items() if is_csrc(n, kernels))
    glue_us = sum(by_name.values()) - kernel_us
    busy = _union([[a, b] for _, a, b in evs])
    # each idle gap cut where a span starts or ends, each piece named by
    # the span the host was in
    cuts = sorted({t for v in spans.values() for iv in v for t in iv})
    idle: dict = {}
    edges = [w0] + [t for iv in busy for t in iv] + [w1]
    for a, b in zip(edges[::2], edges[1::2]):
        lo, hi = bisect.bisect_right(cuts, a), bisect.bisect_left(cuts, b)
        pts = [a, *cuts[lo:hi], b]
        for x, y in zip(pts, pts[1:]):
            if y > x:
                name = _span_at(spans, (x + y) / 2)
                idle[name] = idle.get(name, 0.0) + (y - x)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    summary = dict(window_s=(w1 - w0) * 1e-6,
                   busy_s=sum(b - a for a, b in busy) * 1e-6,
                   device_ops=len(evs), kernel_s=kernel_us * 1e-6,
                   glue_s=glue_us * 1e-6, intervals=len(spans["interval"]))
    breakdown = {
        "device_ops": [[_short(n), us * 1e-6] for n, us in top],
        "idle_gaps": [[n, us * 1e-6] for n, us in
                      sorted(idle.items(), key=lambda kv: -kv[1])[:10]],
    }
    return summary, breakdown
