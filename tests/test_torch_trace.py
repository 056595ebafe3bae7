"""The port's spans and counters (cdk_torch/core/trace.py) on the CPU: the
null context when no profiler records, the spans a HOMME loop and the dist
MPDATA loop record under torch.profiler, the operator-build and set-up
reuse counters, every kernel wrapper registered with its `launches` and
`steps`, and the reductions of `scripts/torch_trace_spans.py` on a fixed
timeline and on fixed counters."""

import importlib.util
from contextlib import nullcontext
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import cdk_torch.kernels  # noqa: F401  (registers the variants)
from cdk_torch.core import build, registry, trace
from cdk_torch.core.config import BiharmonicConfig, MpdataConfig, with_overrides
from cdk_torch.dist import mesh as meshmod
from cdk_torch.dist import mpdata as dist_mp
from cdk_torch.kernels.biharmonic import dss2d_rowchain as rc
from cdk_torch.kernels.biharmonic import problem as bp
from cdk_torch.kernels.biharmonic.dss2d_resident import dss2d_resident
from cdk_torch.kernels.biharmonic.dss_cube import dss_cube_step
from cdk_torch.kernels.biharmonic.dss_resident import (
    dss_resident,
    dss_resident_window,
)
from cdk_torch.kernels.biharmonic.fused import fused_laplace
from cdk_torch.kernels.biharmonic.resident import (
    apply_operator_pallas,
    bd8_resident,
)
from cdk_torch.kernels.cke.group import cke_group
from cdk_torch.kernels.cke.lanegather import cke_lanegather
from cdk_torch.kernels.cke.onehot import cke_onehot
from cdk_torch.kernels.cke.rows import cke_rows
from cdk_torch.kernels.cke.staged import cke_staged
from cdk_torch.kernels.mpdata import masked, staged
from cdk_torch.kernels.mpdata import problem as mp
from cdk_torch.kernels.mpdata.lanes import advect_lanes
from cdk_torch.kernels.mpdata.resident import (
    advect_hoisted_resident,
    advect_resident,
)

ROOT = Path(__file__).resolve().parents[1]
# the benchmark's tiny HOMME and MMF sizes, in float32 as its cells run
HOMME = with_overrides(BiharmonicConfig(), nelemd=12, nlev=4, qsize=2,
                       dtype="float32")
MMF = with_overrides(MpdataConfig(), nslices=4, nx=8, nz=12, dtype="float32")
HOMME_LOOPS = [("biharmonic_dss2d", "fused_operator_rowchain_sq_x3"),
               ("biharmonic", "fused_operator_bd8_resident")]
# chip_smoke.py's two wrapper lists and the two rowchain step wrappers:
# K16/K18 and K16p/K18p are one wrapper each, at depth 1 and deeper
WRAPPERS = {"K1": bd8_resident, "K2": advect_resident, "K3": cke_rows,
            "K3g": cke_group, "K4": fused_laplace, "K5": apply_operator_pallas,
            "K6": staged.advect_fused, "K7": staged.advect_packed,
            "K8": staged.advect_staged_resident,
            "K9": advect_hoisted_resident, "K10": advect_lanes,
            "K11": cke_staged, "K12": cke_onehot, "K13": cke_lanegather,
            "K14": dss_resident, "K14w": dss_resident_window,
            "K15": rc.rowchain_bridge_in, "K16": rc.rowchain_step,
            "K16p": rc.rowchain_step_padded, "K17": rc.rowchain_bridge_out,
            "K17p": rc.rowchain_bridge_out_padded, "K18": rc.rowchain_step,
            "K18p": rc.rowchain_step_padded, "K19": dss2d_resident,
            "K20": masked.masked_step_pallas,
            "K21": masked.masked_step_pallas_packed,
            "K22": masked.masked_step_xmajor,
            "K23": masked.masked_step_xmajor_split,
            "K24": masked.masked_kloop_xmajor,
            "K25": masked.masked_kloop_xmajor_split, "K26": dss_cube_step}


def _host_spans(prof) -> dict:
    """name -> count of the CPU events named `cdk.*` in a trace."""
    out = {}
    for e in prof.events():
        if e.device_type == DeviceType.CPU and e.name.startswith("cdk."):
            out[e.name] = out.get(e.name, 0) + 1
    return out


def _homme_loop(family, name):
    data = bp.init_data(HOMME)
    _, _, loop = registry._materialize(registry.get(family, name), HOMME, data)
    return lambda: loop(data, 3)


def test_span_is_the_shared_null_context_when_nothing_records():
    a, b = trace.span("cdk.prepare"), trace.span("cdk.kernel")
    assert a is b
    assert type(a).__name__ == "nullcontext"
    with a:
        pass


def test_span_records_under_the_profiler():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("cdk.prepare"):
            with trace.span("cdk.layout"):
                torch.ones(3).sum()
    assert _host_spans(prof) == {"cdk.prepare": 1, "cdk.layout": 1}
    assert trace.span("cdk.layout") is trace.span("cdk.prepare")


@pytest.mark.parametrize("family,name", HOMME_LOOPS)
def test_homme_loop_records_prepare_layout_and_kernel(family, name):
    run = _homme_loop(family, name)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
    spans = _host_spans(prof)
    for want in ("cdk.prepare", "cdk.layout", "cdk.kernel"):
        assert spans.get(want, 0) >= 1, (want, spans)
    assert not any(n.startswith("cdk.dist.") for n in spans)


def _builds_and_reuses():
    c = trace.counts()
    return c.get("operator_builds", 0), c.get("prepare_reuses", 0)


@pytest.mark.parametrize("family,name", HOMME_LOOPS)
def test_operator_builds_once_per_element_fields(family, name):
    """_materialize builds; later loop calls on the same fields reuse; an
    in-place write to one field makes the next call build again."""
    data = bp.init_data(HOMME)
    b0, r0 = _builds_and_reuses()
    _, _, loop = registry._materialize(registry.get(family, name), HOMME, data)
    assert _builds_and_reuses() == (b0 + 1, r0)
    for k in (1, 2):
        loop(data, 3)
        assert _builds_and_reuses() == (b0 + 1, r0 + k)
    data.spheremp.mul_(1.5)
    loop(data, 3)
    assert _builds_and_reuses() == (b0 + 2, r0 + 2)


def test_dist_mpdata_loop_records_exchange_and_gather():
    data = mp.init_data(MMF)
    mesh = meshmod.make_mesh(2, "cpu")
    shard_inputs, _, gather_f = dist_mp.make_dist_step(MMF, mesh,
                                                       kernel="xmajor")
    loop = dist_mp.make_dist_loop(MMF, mesh, kernel="xmajor")
    f_s, u_s, w_s, aux = shard_inputs(data)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        f_s, _ = loop(f_s, u_s, w_s, aux, 2)
        gather_f(f_s)
    spans = _host_spans(prof)
    # u and w once, f each step; the stack and sum each step; a launch a
    # shard a step; the gather of f for the caller
    assert spans["cdk.dist.exchange"] >= 2 + 2
    assert spans["cdk.dist.gather"] == 2
    assert spans["cdk.kernel"] == 2 * 2
    assert spans["cdk.layout"] == 1


@pytest.mark.parametrize("k", sorted(WRAPPERS, key=lambda k: (
    int(k[1:].rstrip("pwg")), k)))
def test_wrapper_is_registered_with_launches_and_steps(k):
    w = WRAPPERS[k]
    c = trace.counts()
    assert c[f"{w.__name__}.launches"] == w.launches
    assert c[f"{w.__name__}.steps"] == w.steps
    assert w in trace._WRAPPERS
    if k in ("K16", "K18", "K16p", "K18p"):
        assert isinstance(w.depth_launches, dict)


def test_counted_runs_in_a_kernel_span_and_counts_only_launches(monkeypatch):
    """A call counts only where it launches, through `build.launch`, which
    adds the launch and its steps to the wrapper it names; a launch whose
    entry reports an error raises and counts nothing.  The library and
    the stream are stand-ins, so no card is needed."""
    calls = []
    entries = {"cdk_probe": (lambda *a: calls.append(a) or 0, (0, 1)),
               "cdk_fails": (lambda *a: 700, (0, 1))}
    monkeypatch.setattr(build, "library", lambda: entries)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda index: 99, raising=False)
    monkeypatch.setattr(torch.cuda, "device", lambda device: nullcontext())

    @trace.counted
    def probe(x, launch=None):
        if launch:
            build.launch(probe, 3, "probe", launch, x.device, x, None, 5)
        return x + 1

    try:
        assert "probe.launches" in trace.counts()
        x = torch.ones(2)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            probe(x)
            probe(x, launch="cdk_probe")
        assert _host_spans(prof) == {"cdk.kernel": 2}
        assert calls == [(x.data_ptr(), None, 5, 99)]
        assert (probe.launches, probe.steps) == (1, 3)
        assert trace.counts()["probe.steps"] == 3
        with pytest.raises(RuntimeError, match="probe: CUDA error 700"):
            probe(x, launch="cdk_fails")
        assert (probe.launches, probe.steps) == (1, 3)
        trace.count("probe_counter", 2)
        assert trace.counts()["probe_counter"] == 2
    finally:
        trace._WRAPPERS.remove(probe)
        trace._COUNTS.pop("probe_counter", None)


# ------------------------------------------------ the script's reduction
def _script():
    spec = importlib.util.spec_from_file_location(
        "torch_trace_spans", ROOT / "scripts" / "torch_trace_spans.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ev(name, a, b, dev=DeviceType.CPU, parent=None, kernels=(),
        annotation=False):
    """A profiler event; `kernels` the (name, us) of the activities linked
    to a call."""
    return SimpleNamespace(
        name=name, time_range=SimpleNamespace(start=a, end=b), device_type=dev,
        cpu_parent=parent, is_user_annotation=annotation,
        kernels=[SimpleNamespace(name=n, duration=us) for n, us in kernels])


def test_script_reduction_on_a_known_timeline():
    """One interval [0, 100] us: path.loop [0, 90] holding cdk.prepare
    [5, 40] with a nested cdk.prepare [10, 20], and cdk.layout [50, 60]
    whose aten::copy_ launches a copy running [55, 75]; a cdk.kernel
    [70, 80] launching a kernel [80, 95]; sync [90, 100]; the device-side
    copies of the cdk spans are not activities."""
    red = _script().program_spans
    CUDA = DeviceType.CUDA
    interval, loop = _ev("interval", 0, 100), _ev("path.loop", 0, 90)
    prep = _ev("cdk.prepare", 5, 40, parent=loop)
    inner = _ev("cdk.prepare", 10, 20, parent=prep)
    layout = _ev("cdk.layout", 50, 60, parent=loop)
    copy = _ev("aten::copy_", 52, 58, parent=layout,
               kernels=[("elementwise copy", 20)])
    kern = _ev("cdk.kernel", 70, 80, parent=loop,
               kernels=[("step_kernel", 15), ("cdk.kernel", 15)])
    sync = _ev("sync", 90, 100, parent=interval)
    events = [interval, loop, prep, inner, layout, copy, kern, sync,
              _ev("elementwise copy", 55, 75, CUDA),
              _ev("step_kernel", 80, 95, CUDA),
              _ev("cdk.layout", 55, 75, CUDA, annotation=True),
              _ev("cdk.kernel", 80, 95, CUDA, annotation=True)]
    out = red(events, ("interval", "path.loop", "sync"))
    assert out["host_s"] == pytest.approx({"cdk.prepare": 35e-6,
                                           "cdk.layout": 10e-6,
                                           "cdk.kernel": 10e-6})
    assert out["device_s"] == pytest.approx({"cdk.layout": 20e-6,
                                             "cdk.kernel": 15e-6})
    assert out["device_outside_s"] == 0
    assert out["device_total_s"] == pytest.approx(35e-6)
    assert out["annotation_s"] == pytest.approx({"cdk.layout": 20e-6,
                                                 "cdk.kernel": 15e-6})
    # idle: [0, 55), [75, 80) and [95, 100): the loop's own [0, 5) and
    # [40, 50), cdk.prepare [5, 40] once though nested, cdk.layout [50, 55),
    # cdk.kernel [75, 80), sync [95, 100)
    gaps = dict(out["idle_gaps"])
    assert gaps == pytest.approx({"cdk.prepare": 35e-6, "path.loop": 15e-6,
                                  "cdk.layout": 5e-6, "cdk.kernel": 5e-6,
                                  "sync": 5e-6})


@pytest.mark.parametrize("delta,want", [
    (None, (None, None, None)),
    ({}, (0.0, 0.0, None)),
    ({"operator_builds": 4}, (0.5, 0.0, 0.0)),
    ({"prepare_reuses": 8, "cdk_x.launches": 3}, (0.0, 1.0, 1.0)),
    ({"operator_builds": 2, "prepare_reuses": 6}, (0.25, 0.75, 0.75)),
])
def test_script_counter_readings(delta, want):
    """Builds and reuses an interval over 8 intervals, and the hit share;
    None without counters or, for the share, where neither counted."""
    got = _script().counter_readings(delta, 8)
    assert got == dict(zip(("operator_builds_per_interval",
                            "prepare_reuses_per_interval",
                            "prepare_hit_share"), want))
