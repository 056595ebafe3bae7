"""The port's spans and launch counters, one scheme for every module.

`span(name)` marks a stretch of host work for `torch.profiler`: while a
profiler records it is `torch.profiler.record_function(name)`, whose span
lands in the same trace as the card's activities, on one clock; otherwise
it is one shared `contextlib.nullcontext()`, so a span costs a flag test
and allocates nothing when no one traces.  Spans may nest, a name inside
itself too; a reader takes the union of a name's intervals.

    cdk.prepare        the set-up a loop runs before its first launch: the
                       element operator (`operator.build_element_operator`),
                       A² (`precompose_operator`), the DSS weights
                       (`dss.dss_weights`, `dss2d.dss2d_weights`), the
                       variants' `prepare` (the lookup of a reused one
                       too) and the MPDATA invariants
    cdk.layout         the layout turns: `problem.to_lane_layout` /
                       `from_lane_layout`, `lanes.to_xzs` / `from_xzs`,
                       `mesh.shard_x` / `gather_x`
    cdk.kernel         every `counted` wrapper's call: validation, the
                       ctypes call and the launch
    cdk.dist.exchange  the halo exchange: `mesh.exchange`,
                       `exchange_strips`, `ring_strips`, `ring_exchange`
    cdk.dist.gather    the shards' outputs stacked and their partials
                       summed (`dist/mpdata.py`, `dist/biharmonic.py`)

`counted(fn)` gives a kernel wrapper its `launches` and `steps`, to which
the wrapper adds where it launches its kernel and nowhere else, registers
it, and runs each call inside `span("cdk.kernel")`.  `count(name)` is a
plain process-wide counter:

    operator_builds    calls of `operator.build_element_operator`
    prepare_reuses     calls of a HOMME form's set-up that returned the
                       result built from the same element fields
                       (`operator.reuse_prepare`); with operator_builds
                       the hit share reuses / (reuses + builds)
    natural_loads      calls of K1's or K15's wrapper (`bd8_resident`,
                       `rowchain_bridge_in`) given the state in its own
                       (e, q, k, i, j) layout, which the kernel then reads
                       where it lies, with no lane copy before it

`counts()` is a snapshot of both, so a caller reads what a stretch of work
did as the difference of two snapshots.
"""

from __future__ import annotations

import contextlib
import functools

import torch
import torch.autograd.profiler as _profiler

_OFF = contextlib.nullcontext()
_WRAPPERS: list = []
_COUNTS: dict = {}


def span(name: str):
    """A context manager marking host work as `name` in a profiler's trace
    (`record_function`), or the shared null context when none records."""
    if _profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _OFF


def counted(fn):
    """`fn`, a kernel wrapper, with its launch count, to which it adds one
    where it launches its kernel and nowhere else, and its step count, to
    which it adds the steps that launch ran; registered for `counts()` and
    called inside `span("cdk.kernel")`."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with span("cdk.kernel"):
            return fn(*args, **kwargs)

    wrapper.launches = 0  # kernel launches in this process
    wrapper.steps = 0  # steps those launches ran
    _WRAPPERS.append(wrapper)
    return wrapper


def count(name: str, k: int = 1) -> None:
    """Add k to the process-wide counter `name`."""
    _COUNTS[name] = _COUNTS.get(name, 0) + k


def counts() -> dict:
    """Every registered wrapper's `<name>.launches` and `<name>.steps`, and
    every named counter, as they stand now."""
    out = {}
    for w in _WRAPPERS:
        out[f"{w.__name__}.launches"] = w.launches
        out[f"{w.__name__}.steps"] = w.steps
    return {**out, **_COUNTS}
