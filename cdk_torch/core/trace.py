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
                       too), the MPDATA invariants and K3g's tile map
                       (`kernels/cke/group.py` `tiles`, built or looked up)
    cdk.cube.map       the cubed sphere's assembly map built from its mesh
                       (`cube.build_map`), inside the cube loop's
                       `cdk.prepare`
    cdk.layout         the layout turns: `problem.to_lane_layout` /
                       `from_lane_layout`, `lanes.to_xzs` / `from_xzs`,
                       `mesh.shard_x` / `gather_x`
    cdk.kernel         every `counted` wrapper's call: validation, the
                       ctypes call and the launch (`build.launch`)
    cdk.dist.exchange  the halo exchange: `mesh.exchange`,
                       `exchange_strips`, `ring_strips`, `ring_exchange`
    cdk.dist.gather    the shards' outputs stacked and their partials
                       summed (`dist/mpdata.py`, `dist/biharmonic.py`)
    cdk.cke.mask       K3's masked tracer table, tracer · cellMask, one a
                       tracer (`kernels/cke/rows.py`, the `pallas_rows`
                       step); it runs only on the per-tracer path: K3g
                       folds the mask into its stage

`counted(fn)` gives a kernel wrapper its `launches` and `steps`, registers
it, and runs each call inside `span("cdk.kernel")`; `build.launch`, the
one way a wrapper launches its kernel, adds each launch and its steps to
them, so a CPU call, which runs the plain version, counts nothing.
`count(name)` is a plain process-wide counter:

    operator_builds    calls of `operator.build_element_operator`
    prepare_reuses     calls of a HOMME form's set-up that returned the
                       result built from the same element fields
                       (`operator.reuse_prepare`); with operator_builds
                       the hit share reuses / (reuses + builds)
    natural_loads      calls of K1's or K15's wrapper (`bd8_resident`,
                       `rowchain_bridge_in`) given the state in its own
                       (e, q, k, i, j) layout, which the kernel then reads
                       where it lies, with no lane copy before it
    cke_mesh_passes    a CKE step's passes over the edge fields
                       (connectivity, coefficients, ntf, advMask): one a
                       tracer table, or one for a whole group that K3g
                       takes (`kernels/cke/problem.py` `each_tracer`,
                       `kernels/cke/rows.py` `pallas_rows`' step)
    cube_state_passes  the cube chain's passes over the state: one for K1's
                       bridge-in in the loop, one a call of K26's wrapper
                       (`kernels/biharmonic/dss_cube.py`), on either device
    cke_group_launches a group step taken whole by K3g (one launch on the
                       card, its plain version on the CPU) where its tile
                       map fits: the steps where the group mechanism
                       engaged (`pallas_rows`' step)

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
    """`fn`, a kernel wrapper, with its launch count and its step count,
    to which `build.launch(wrapper, steps, ...)` adds one and the steps
    that launch ran each time it launches the kernel; registered for
    `counts()` and called inside `span("cdk.kernel")`."""

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
