"""CPU tests of what a traced run reads from the program: its `cdk.` spans
(`trace.reduce`'s `spans`, and the idle time named by the innermost span
the host was in) and its counters (`run.py`'s `counts`), and the per-layer
metrics read from them.

    python -m pytest cdkbench/tests -q
"""

from __future__ import annotations

import importlib.util
from types import SimpleNamespace

import pytest
import torch
from torch.autograd import DeviceType

from cdkbench import run
from cdkbench import trace as tr
from cdkbench.tests.test_harness import BENCH, CELLS, ROOT, cell, tiny

CUDA = DeviceType.CUDA
OLD_KEYS = ("window_s", "busy_s", "device_ops", "kernel_s", "glue_s",
            "intervals")


def _ev(name, a, b, dev=DeviceType.CPU, parent=None, kernels=(),
        annotation=False):
    """A profiler event; `kernels` the (name, us) of the activities the
    profiler linked to a call."""
    return SimpleNamespace(
        name=name, time_range=SimpleNamespace(start=a, end=b), device_type=dev,
        cpu_parent=parent, is_user_annotation=annotation,
        kernels=[SimpleNamespace(name=n, duration=us) for n, us in kernels])


def _timeline(program=True) -> list:
    """Two intervals, [0, 100] and [120, 220] us.  The first: cdk.prepare
    [5, 40] with a cdk.prepare [10, 20] inside, which links nothing;
    cdk.layout [50, 60], whose copy runs [55, 75]; cdk.kernel [70, 80],
    whose kernel runs [80, 95].  The second: cdk.dist.exchange [130, 140],
    whose cat runs [136, 141]; cdk.dist.gather [150, 190] holding a
    cdk.kernel [155, 165], whose kernel runs [160, 190], and a stack, whose
    copy runs [190, 200].  Before the window a cdk.prepare and a cdk.build
    whose fill runs [-45, -42]; across its end a cdk.layout [218, 230].  Device-side copies of both kinds of span,
    with and without the annotation flag.  Without `program`, the same
    with no `cdk.` span on either side."""
    i1, i2 = _ev("interval", 0, 100), _ev("interval", 120, 220)
    l1, l2 = _ev("path.loop", 0, 90, parent=i1), _ev("path.loop", 120, 200, parent=i2)
    early = _ev("cdk.prepare", -50, -40)
    build = _ev("cdk.build", -30, -20)
    prep = _ev("cdk.prepare", 5, 40, parent=l1)
    layout = _ev("cdk.layout", 50, 60, parent=l1)
    kern = _ev("cdk.kernel", 70, 80, parent=l1,
               kernels=[("void step_kernel<float>(float*)", 15), ("cdk.kernel", 15)])
    exch = _ev("cdk.dist.exchange", 130, 140, parent=l2)
    gather = _ev("cdk.dist.gather", 150, 190, parent=l2)
    kern2 = _ev("cdk.kernel", 155, 165, parent=gather,
                kernels=[("void step_kernel<float>(float*)", 30)])
    spans = [early, build, prep, _ev("cdk.prepare", 10, 20, parent=prep), layout,
             kern, exch, gather, kern2, _ev("cdk.layout", 218, 230)]
    calls = [_ev("aten::fill_", -29, -25, parent=build, kernels=[("fill", 3)]),
             _ev("aten::copy_", 52, 58, parent=layout,
                 kernels=[("elementwise copy", 20), ("cdk.layout", 20)]),
             _ev("aten::cat", 131, 135, parent=exch, kernels=[("cat", 5)]),
             _ev("aten::stack", 170, 180, parent=gather,
                 kernels=[("Memcpy DtoD (Device -> Device)", 10)])]
    device = [_ev("fill", -45, -42, CUDA),
              _ev("elementwise copy", 55, 75, CUDA),
              _ev("void step_kernel<float>(float*)", 80, 95, CUDA),
              _ev("cat", 136, 141, CUDA),
              _ev("void step_kernel<float>(float*)", 160, 190, CUDA),
              _ev("Memcpy DtoD (Device -> Device)", 190, 200, CUDA),
              _ev("interval", 0, 100, CUDA),
              _ev("sync", 90, 100, CUDA, annotation=True)]
    copies = [_ev("cdk.layout", 55, 75, CUDA, annotation=True),
              _ev("cdk.dist.gather", 160, 200, CUDA)]
    bench = [i1, l1, _ev("sync", 90, 100, parent=i1), i2, l2,
             _ev("sync", 200, 220, parent=i2)]
    if not program:
        for c in calls:
            c.cpu_parent = None
        return bench + calls + device
    return bench + spans + calls + device + copies


def _reduce(events):
    return tr.reduce(SimpleNamespace(events=lambda: events),
                     frozenset({"step_kernel"}))


def _flat(spans: dict) -> dict:
    return {(n, k): v for n, d in spans.items() for k, v in d.items()}


def test_reduce_keeps_the_program_spans():
    s, _ = _reduce(_timeline())
    assert _flat(s["spans"]) == pytest.approx(_flat({
        "cdk.prepare": {"host_s": 35e-6, "device_s": 0.0},
        "cdk.layout": {"host_s": 12e-6, "device_s": 20e-6},
        "cdk.kernel": {"host_s": 20e-6, "device_s": 45e-6},
        "cdk.dist.exchange": {"host_s": 10e-6, "device_s": 5e-6},
        "cdk.dist.gather": {"host_s": 40e-6, "device_s": 10e-6}}))
    # cdk.build ran before the window only, and its fill counts nowhere
    assert "cdk.build" not in s["spans"]


def test_old_keys_alike_with_and_without_program_spans():
    """The program's spans leave every earlier key and the device
    operations as they were; the idle time, now cut by them too, sums to
    the same."""
    s, b = _reduce(_timeline())
    s0, b0 = _reduce(_timeline(program=False))
    assert {k: s[k] for k in OLD_KEYS} == {k: s0[k] for k in OLD_KEYS}
    assert s0["spans"] == {} and b["device_ops"] == b0["device_ops"]
    assert s["window_s"] == pytest.approx(220e-6)
    assert s["busy_s"] == pytest.approx(80e-6) and s["device_ops"] == 5
    assert s["kernel_s"] == pytest.approx(45e-6) and s["glue_s"] == pytest.approx(35e-6)
    idle = s["window_s"] - s["busy_s"]
    assert sum(v for _, v in b["idle_gaps"]) == pytest.approx(idle)
    assert sum(v for _, v in b0["idle_gaps"]) == pytest.approx(idle)
    assert dict(b0["idle_gaps"]) == pytest.approx(
        {"path.loop": 95e-6, "sync": 25e-6, "harness": 20e-6})
    assert dict(b["idle_gaps"]) == pytest.approx(
        {"path.loop": 34e-6, "cdk.prepare": 35e-6, "cdk.layout": 7e-6,
         "cdk.kernel": 10e-6, "sync": 23e-6, "harness": 20e-6,
         "cdk.dist.exchange": 6e-6, "cdk.dist.gather": 5e-6})


def test_idle_named_by_the_innermost_of_equal_spans():
    """A path.loop as long as its interval, and a cdk. span as long as
    its path.loop, name the idle time inside them."""
    evs = [_ev("interval", 0, 100), _ev("path.loop", 0, 100),
           _ev("void step_kernel<float>(float*)", 40, 60, CUDA)]
    _, b = _reduce(evs)
    assert dict(b["idle_gaps"]) == pytest.approx({"path.loop": 80e-6})
    _, b = _reduce([*evs, _ev("cdk.layout", 0, 100)])
    assert dict(b["idle_gaps"]) == pytest.approx({"cdk.layout": 80e-6})


def _script():
    spec = importlib.util.spec_from_file_location(
        "torch_trace_spans", ROOT / "scripts" / "torch_trace_spans.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_reduce_agrees_with_the_span_script():
    """On the same events, `reduce`'s spans read what
    scripts/torch_trace_spans.py's `program_spans` reads: host seconds of
    every span in the window, device seconds where it linked any (0.0
    where it linked none), and the idle time by the innermost span."""
    events = _timeline()
    s, b = _reduce(events)
    got = _script().program_spans(events, tr.SPANS)
    assert set(s["spans"]) <= set(got["host_s"])
    assert {n: v["host_s"] for n, v in s["spans"].items()} == pytest.approx(
        {n: got["host_s"][n] for n in s["spans"]})
    assert {n: v["device_s"] for n, v in s["spans"].items()} == pytest.approx(
        {n: got["device_s"].get(n, 0.0) for n in s["spans"]})
    assert dict(b["idle_gaps"]) == pytest.approx(dict(got["idle_gaps"]))


PROGRAM_READERS = ("layout_us_per_step.homme", "prepare_us_per_step.homme",
                   "operator_builds_per_interval.homme", "prepare_hit_share.homme",
                   "exchange_us_per_step", "shard_gather_us_per_step")


def _read(name, s):
    return run.load("metrics", name).read(s)


def test_program_readers_on_a_summary():
    s = dict(steps=600, intervals=100,
             spans={"cdk.layout": {"host_s": 0.01, "device_s": 0.12},
                    "cdk.prepare": {"host_s": 0.003, "device_s": 0.0},
                    "cdk.dist.exchange": {"host_s": 0.04, "device_s": 0.0006},
                    "cdk.dist.gather": {"host_s": 0.06, "device_s": 0.03}},
             counts={"prepare_reuses": 300, "operator_builds": 2,
                     "bd8_resident.launches": 100})
    assert {n: _read(n, s) for n in PROGRAM_READERS} == pytest.approx({
        "layout_us_per_step.homme": 200.0, "prepare_us_per_step.homme": 5.0,
        "operator_builds_per_interval.homme": 0.02,
        "prepare_hit_share.homme": 300 / 302,
        "exchange_us_per_step": 1.0, "shard_gather_us_per_step": 50.0})
    # nothing to read: a span that did not run, counters that did not count
    bare = dict(steps=600, intervals=100, spans={}, counts={})
    assert {n: _read(n, bare) for n in PROGRAM_READERS} == {
        **dict.fromkeys(PROGRAM_READERS), "operator_builds_per_interval.homme": 0.0}
    assert _read("prepare_hit_share.homme", {**bare, "counts": {"operator_builds": 3}}) == 0.0
    untraced = dict(steps=600, intervals=100)
    assert all(_read(n, untraced) is None for n in PROGRAM_READERS)


# the program's metrics each of the first four cells reports, what they
# read on the CPU at TINY (no device time is linked there; each HOMME loop
# builds its operator in set-up and reuses it in every interval), and what
# the program counts an interval there (no kernel launches on the CPU)
PROGRAM_METRICS = {
    "homme.hv_torus": {"layout_us_per_step.homme": 0.0,
                       "operator_builds_per_interval.homme": 0.0,
                       "prepare_hit_share.homme": 1.0},
    "homme.hv_elem": {"layout_us_per_step.homme": 0.0,
                      "operator_builds_per_interval.homme": 0.0,
                      "prepare_hit_share.homme": 1.0},
    "mmf.slices": {},
    "mmf.xsplit": {"exchange_us_per_step": 0.0, "shard_gather_us_per_step": 0.0},
}
COUNTS_PER_INTERVAL = {"homme.hv_torus": {"prepare_reuses": 1},
                       "homme.hv_elem": {"prepare_reuses": 1},
                       "mmf.slices": {}, "mmf.xsplit": {}}


@pytest.mark.parametrize("name", CELLS)
def test_traced_run_carries_spans_and_counts(name, monkeypatch):
    """A traced run's summary carries the program's spans and the non-zero
    differences of its counters over the window; every per-layer metric of
    the cell reads a number (but the port's kernels' roofline: no kernel
    of the port runs on the CPU)."""
    seen = []
    real = tr.reduce

    def reduce(prof, kernels):
        out = real(prof, kernels)
        seen.append(out[0])
        return out

    monkeypatch.setattr(tr, "reduce", reduce)
    res, _ = run.run_cell(cell(name), BENCH, 2**31 + 41, 0.3, True,
                          torch.device("cpu"), tiny(name))
    (s,) = seen
    assert all(isinstance(v, int) and v for v in s["counts"].values())
    assert s["spans"] and all(v["host_s"] > 0.0 and v["device_s"] == 0.0
                              for v in s["spans"].values())
    for m in run.metrics_for(BENCH, name, True):
        if not m["name"].startswith("kernel_roofline_pct"):
            assert isinstance(res["metrics"][m["name"]]["value"], float), m["name"]
    if name in PROGRAM_METRICS:
        got = {k: v["value"] for k, v in res["metrics"].items() if k in PROGRAM_READERS}
        want = PROGRAM_METRICS[name]
        assert {k: got.pop(k) for k in want} == want
        # the set-up's host time, the one reading that is not fixed here
        assert list(got) == ["prepare_us_per_step.homme"] * bool(got)
        assert all(v > 0.0 for v in got.values())
        assert s["counts"] == {k: v * s["intervals"]
                               for k, v in COUNTS_PER_INTERVAL[name].items()}
