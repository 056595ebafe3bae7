"""The reduction of a traced window (torch.profiler) to the summary the
per-layer readers take, and the breakdown the result line carries.

The device activities are the trace's kernels, copies and fills.  A kernel
is one of the port's hand-written kernels when its name carries one of the
`__global__` functions of `cdk_torch/csrc`; everything else on the card is
glue.  The benchmark's own spans (`interval`, `path.loop`, `sync`) and the
program's (`cdk.…`, `cdk_torch/core/trace.py`) mark what the host was
doing; the card's idle time is named by the innermost of them the host was
in, or `harness` outside every one.  Each `cdk.` span gets its host time
and the device time of the activities the profiler links by correlation to
the calls inside it (`FunctionEvent.kernels`), each activity counted for
the innermost `cdk.` span around its call.  The device-side copies of
either kind of span are not activities.
"""

from __future__ import annotations

import bisect
import re
from pathlib import Path

SPANS = ("interval", "path.loop", "sync")
# the prefix of the program's spans
PROGRAM = "cdk."
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


def _is_span(name: str) -> bool:
    """Whether `name` is one of the benchmark's spans or the program's."""
    return name in SPANS or name.startswith(PROGRAM)


def _events(prof) -> tuple[list, dict, dict, list]:
    """(the device activities as (name, start_us, end_us) sorted by start;
    the benchmark's spans as name -> sorted [(start_us, end_us)]; the same
    of the program's `cdk.` spans; and the host calls the profiler linked
    activities to, as (call, linked device us))."""
    from torch.autograd import DeviceType

    evs, spans, program, linked = [], {k: [] for k in SPANS}, {}, []
    for e in prof.events():
        if e.device_type == DeviceType.CPU:
            iv = (e.time_range.start, e.time_range.end)
            if e.name in spans:
                spans[e.name].append(iv)
            elif e.name.startswith(PROGRAM):
                program.setdefault(e.name, []).append(iv)
            us = sum(k.duration for k in getattr(e, "kernels", ())
                     if not _is_span(k.name))
            if us:
                linked.append((e, us))
        elif (e.device_type == DeviceType.CUDA and not _is_span(e.name)
              and not getattr(e, "is_user_annotation", False)):
            evs.append((e.name, e.time_range.start, e.time_range.end))
    evs.sort(key=lambda t: t[1])
    for v in (*spans.values(), *program.values()):
        v.sort()
    return evs, spans, program, linked


def _segments(named: list, w0: float, w1: float) -> list:
    """[(start, end, name)] covering [w0, w1] end to end: each piece named
    by the innermost span of `named` ((start, end, name, depth); spans on
    one thread nest, `depth` orders those of equal start and end) open
    over it, or "harness" where none is."""
    segs, stack, t = [], [], w0

    def emit(x, y, name):
        x, y = max(x, w0), min(y, w1)
        if y > x:
            segs.append((x, y, name))

    for a, b, name, _ in sorted(named, key=lambda s: (s[0], -s[1], s[3])):
        while stack and stack[-1][0] <= a:
            end, outer = stack.pop()
            emit(t, end, outer)
            t = max(t, end)
        emit(t, a, stack[-1][1] if stack else "harness")
        t = max(t, a)
        stack.append((b, name))
    while stack:
        end, outer = stack.pop()
        emit(t, end, outer)
        t = max(t, end)
    emit(t, w1, "harness")
    return segs


def _program_spans(program: dict, linked: list, w0: float, w1: float) -> dict:
    """name -> {"host_s", "device_s"} of every `cdk.` span that ran in the
    window [w0, w1]: the union of its host intervals, clipped to the window,
    and the device time linked to calls made in the window whose innermost
    `cdk.` span it is (0.0 where it linked none)."""
    out = {}
    for name, ivs in sorted(program.items()):
        clipped = [[max(a, w0), min(b, w1)] for a, b in ivs]
        clipped = [iv for iv in clipped if iv[1] >= iv[0]]
        if clipped:
            out[name] = {"host_s": sum(b - a for a, b in _union(clipped)) * 1e-6,
                         "device_s": 0.0}
    for e, us in linked:
        if not w0 <= e.time_range.start <= w1:
            continue
        op = e
        while op is not None and not op.name.startswith(PROGRAM):
            op = getattr(op, "cpu_parent", None)
        if op is not None and op.name in out:
            out[op.name]["device_s"] += us * 1e-6
    return out


def reduce(prof, kernels: frozenset) -> tuple[dict, dict]:
    """-> (summary, breakdown) of the traced window: from the start of the
    first `interval` span to the end of the last."""
    evs, spans, program, linked = _events(prof)
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
    # each idle gap cut into the pieces of the innermost span the host was
    # in, the benchmark's outside the program's
    named = [(a, b, n, 0 if n == "interval" else 1)
             for n, v in spans.items() for a, b in v]
    named += [(a, b, n, 2) for n, v in program.items() for a, b in v]
    segs = _segments(named, w0, w1)
    starts = [x for x, _, _ in segs]
    idle: dict = {}
    edges = [w0] + [t for iv in busy for t in iv] + [w1]
    for a, b in zip(edges[::2], edges[1::2]):
        i = max(bisect.bisect_right(starts, a) - 1, 0)
        while i < len(segs) and segs[i][0] < b:
            x, y, name = segs[i]
            lo, hi = max(a, x), min(b, y)
            if hi > lo:
                idle[name] = idle.get(name, 0.0) + (hi - lo)
            i += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    summary = dict(window_s=(w1 - w0) * 1e-6,
                   busy_s=sum(b - a for a, b in busy) * 1e-6,
                   device_ops=len(evs), kernel_s=kernel_us * 1e-6,
                   glue_s=glue_us * 1e-6, intervals=len(spans["interval"]),
                   spans=_program_spans(program, linked, w0, w1))
    breakdown = {
        "device_ops": [[_short(n), us * 1e-6] for n, us in top],
        "idle_gaps": [[n, us * 1e-6] for n, us in
                      sorted(idle.items(), key=lambda kv: -kv[1])[:10]],
    }
    return summary, breakdown
