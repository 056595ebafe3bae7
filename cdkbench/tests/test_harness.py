"""CPU tests of the benchmark harness: the files a cell is found by, the
shape of BENCHMARK.json, the metrics of each cell, the least time over the
peaks (each family's counts against chip_smoke.py's: test_work_<family>.py),
the trace reduction, the refusal without a card, and the result line.

Every fact about a family, problem, path kind, configuration or cell comes
from the files that bring it, never from a name held here, so a new one
runs these tests as new files alone.

    python -m pytest cdkbench/tests -q
"""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path
from types import ModuleType, SimpleNamespace

import pytest
import torch

from cdkbench import peaks, run
from cdkbench import trace as tr

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [c["name"] for c in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def cell(name):
    return run.cell_of(name, BENCH)


def tiny(name, **traffic):
    """The cell's CPU overrides: its problem's TINY sizes, and `traffic`."""
    cfg, _ = run.cell_files(cell(name))
    return {"config": run.load("problems", cfg["problem"]).TINY,
            "traffic": traffic}


def cells_of(family):
    """The cells whose traffic runs `family`."""
    return [n for n in CELLS if run.cell_files(cell(n))[1]["family"] == family]


def test_benchmark_json_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["cdkbench"] and 1 <= BENCH["run_seconds"] <= 51
    assert BENCH["command"][1].startswith("cdkbench/")
    entries = BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"] + BENCH["per_layer"]
    names = [e["name"] for e in entries]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for e in entries:
        for key in ("why", "layer"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and not re.search(r"[\n\t]", e[key])
    assert {m["name"] for m in BENCH["end_to_end"]} >= {"setup_s"}
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    moved = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in moved and set(m["workloads"]) <= set(CELLS)


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["configs"]])
def test_config_file_states_its_changes(name):
    entry = next(c for c in BENCH["configs"] if c["name"] == name)
    cfg = json.loads((ROOT / entry["file"]).read_text())
    assert cfg["name"] == name and cfg["source"] == entry["source"]
    assert sorted(cfg["reduced"]) == sorted(entry["reduced"])
    assert all(k in cfg for k in entry["reduced"])
    assert any(c["config"] == name for c in BENCH["workloads"])


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_found_by_name(name):
    c = cell(name)
    cfg, traffic = run.cell_files(c)
    assert c["chips"] in (1, 4)
    for kind, mod in (("problems", cfg["problem"]), ("paths", traffic["path"]),
                      ("work", traffic["family"]), ("reference", traffic["family"])):
        assert (ROOT / "cdkbench" / kind / f"{mod}.py").is_file(), (kind, mod)
    work_test = ROOT / "cdkbench" / "tests" / f"test_work_{traffic['family']}.py"
    assert work_test.is_file(), f"family {traffic['family']!r} brings no {work_test}"
    assert run.load("reference", traffic["family"]).NORM in ("rel_l2", "rel_l1")
    assert set(run.load("problems", cfg["problem"]).TINY) <= set(cfg)
    limits = json.loads((ROOT / "cdkbench" / "limits" / f"{name}.json").read_text())
    outputs = run.load("problems", cfg["problem"]).OUTPUTS
    assert {k.split(".")[0] for k in limits["limits"]} == set(outputs)
    for m in run.metrics_for(BENCH, name, False) + run.metrics_for(BENCH, name, True):
        assert callable(run.load("metrics", m["name"]).read)


@pytest.mark.parametrize("name", CELLS)
def test_metrics_of_each_cell(name):
    """The cell reports setup_s and one step time, an end-to-end metric
    that lists the cell; every per-layer metric of the cell moves it, and
    there is at least one."""
    e2e = {m["name"]: m for m in run.metrics_for(BENCH, name, False)}
    layer = run.metrics_for(BENCH, name, True)
    moved = {m["moves"] for m in layer}
    assert "setup_s" in e2e and layer and len(moved) == 1, (name, moved)
    step = moved.pop()
    assert name in e2e[step].get("workloads", []), (name, step)


# the metrics of the first four cells as they stand: a check that none of
# them loses a metric or gains a misplaced one (the HOMME cells, paced by
# the host, report `step_us.homme` and no interval tail); a metric added
# later that lists one of them may stand anywhere beside these
_MMF = (["setup_s", "step_us", "interval_ms_p95"],
        ["launches_per_step", "glue_us_per_step", "kernel_roofline_pct",
         "idle_pct", "step_roofline_pct"])
_HOMME = (["setup_s", "step_us.homme"],
          [f"{m}.homme" for m in _MMF[1]])
FIRST_CELLS = {"homme.hv_torus": _HOMME, "mmf.slices": _MMF,
               "homme.hv_elem": _HOMME, "mmf.xsplit": _MMF}


def in_order(part, whole) -> bool:
    """Every item of `part` in `whole`, in the same order."""
    rest = iter(whole)
    return all(item in rest for item in part)


@pytest.mark.parametrize("name", FIRST_CELLS)
def test_metrics_of_the_first_cells(name):
    e2e, layer = FIRST_CELLS[name]
    got_e2e = [m["name"] for m in run.metrics_for(BENCH, name, False)]
    got_layer = [m["name"] for m in run.metrics_for(BENCH, name, True)]
    assert in_order(e2e, got_e2e) and in_order(layer, got_layer)
    # no other step time and no interval tail beside the pinned ones
    assert [n for n in got_e2e if n.startswith(("step_us", "interval_ms"))] == \
        [n for n in e2e if n.startswith(("step_us", "interval_ms"))]


@pytest.mark.parametrize("name", CELLS)
def test_least_time_is_the_slowest_unit(name):
    """The interval's least time is the largest of its bytes, f32 and
    tensor-core operations over peaks.py's peaks, and a share of a peak
    reads 100 % at that time; each family's counts are held to
    chip_smoke.py's in test_work_<family>.py."""
    cfg, traffic = run.cell_files(cell(name))
    got = run.load("work", traffic["family"]).least(cfg, traffic["interval_steps"])
    assert got["least_s"] > 0 and got["least_s"] == max(
        got["bytes"] / peaks.HBM_BYTES_PER_S, got["f32_ops"] / peaks.F32_OPS_PER_S,
        got["tc_ops"] / peaks.BF16_TC_OPS_PER_S)
    at_least = dict(least_s=got["least_s"], intervals=10, steps=10 * traffic["interval_steps"],
                    window_s=10 * got["least_s"], busy_s=10 * got["least_s"],
                    kernel_s=10 * got["least_s"], glue_s=0.0, device_ops=10)
    for m in run.metrics_for(BENCH, name, True):
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert run.load("metrics", m["name"]).read(at_least) == pytest.approx(100.0)


def test_peaks_are_chip_smokes():
    """peaks.py copied chip_smoke.py's peaks."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    assert (peaks.HBM_BYTES_PER_S, peaks.F32_OPS_PER_S, peaks.BF16_TC_OPS_PER_S) == (
        cs.HBM_BYTES_PER_S, cs.F32_OPS_PER_S, cs.BF16_OPS_PER_S)


def test_csrc_kernel_names():
    names = tr.csrc_kernels(ROOT / "cdk_torch" / "csrc")
    assert {"bd8_resident_kernel", "step_kernel", "mpdata_sweep_kernel"} <= names
    assert tr.is_csrc("void (anonymous namespace)::step_kernel<float, true, "
                      "false, 24, 0>(float const*, int)", names)
    assert not tr.is_csrc("void at::native::elementwise_kernel<128, 2>(int)", names)
    assert not tr.is_csrc("Memcpy DtoD (Device -> Device)", names)


def _ev(name, dev, a, b):
    from torch.autograd import DeviceType

    return SimpleNamespace(name=name, time_range=SimpleNamespace(start=a, end=b),
                           device_type=DeviceType.CUDA if dev else DeviceType.CPU)


def test_trace_reduce_on_a_known_timeline():
    """Two intervals of 100 us: a hand-written kernel, a torch copy, idle
    gaps under path.loop, sync and between the intervals."""
    evs = [_ev("interval", 0, 0, 100), _ev("path.loop", 0, 0, 40),
           _ev("sync", 0, 40, 100), _ev("interval", 0, 120, 220),
           _ev("path.loop", 0, 120, 160), _ev("sync", 0, 160, 220),
           _ev("interval", 1, 0, 100),  # the span's device-side copy
           _ev("void step_kernel<float>(float*)", 1, 10, 60),
           _ev("Memcpy DtoD (Device -> Device)", 1, 60, 70),
           _ev("void step_kernel<float>(float*)", 1, 130, 180)]
    prof = SimpleNamespace(events=lambda: evs)
    s, b = tr.reduce(prof, frozenset({"step_kernel"}))
    assert s["intervals"] == 2 and s["device_ops"] == 3
    assert s["window_s"] == pytest.approx(220e-6)
    assert s["busy_s"] == pytest.approx(110e-6)
    assert s["kernel_s"] == pytest.approx(100e-6)
    assert s["glue_s"] == pytest.approx(10e-6)
    assert dict(b["idle_gaps"]) == pytest.approx(
        {"path.loop": 20e-6, "sync": 70e-6, "harness": 20e-6})
    assert b["device_ops"][0] == ["step_kernel<float>", pytest.approx(100e-6)]


def test_readers_on_a_summary():
    s = dict(setup_s=9.0, window_s=2.0, steps=1000, intervals=100,
             interval_ms=[20.0] * 95 + [30.0] * 5, busy_s=1.5, device_ops=3000,
             kernel_s=1.2, glue_s=0.3, least_s=0.004)
    read = {n: run.load("metrics", n).read(s) for n in
            ("setup_s", "step_us", "interval_ms_p95", "launches_per_step",
             "glue_us_per_step", "kernel_roofline_pct", "idle_pct",
             "step_roofline_pct")}
    assert read == pytest.approx(dict(
        setup_s=9.0, step_us=2000.0, interval_ms_p95=29.5, launches_per_step=3.0,
        glue_us_per_step=300.0, kernel_roofline_pct=100 * 0.4 / 1.2,
        idle_pct=25.0, step_roofline_pct=20.0))
    assert run.load("metrics", "kernel_roofline_pct").read({**s, "kernel_s": 0}) is None
    # a metric `<base>.<suffix>` whose reader is `<base>`'s, re-exported,
    # reads as `<base>` does; `<base>`'s reader is found by its name
    copies = 0
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        base, _, suffix = m["name"].partition(".")
        reader = run.load("metrics", m["name"]).read
        if suffix and reader.__module__ == f"cdkbench.metrics.{base}":
            assert reader(s) == pytest.approx(run.load("metrics", base).read(s))
            copies += 1
    assert copies >= 1


def test_keeper_draws_from_the_seed():
    def kept(seed):
        k = run.Keeper(seed)
        for i in range(50):
            slot = k.draw()
            if slot is not None:
                k.put(slot, i)
        return k.kept

    assert kept(2**31 + 5) == kept(2**31 + 5)
    assert len(kept(3)) == run.CHECKED and kept(3) != list(range(run.CHECKED))


@pytest.mark.parametrize("name", CELLS)
def test_interval_starts_where_its_traffic_says(name):
    """Carried, an interval starts from the state the previous one produced
    and inputs() copies it; seeded, from the seeded state."""
    cfg, traffic = run.cell_files(cell(name), tiny(name))
    raw, path = run.build(cfg, traffic, 2**31 + 3, torch.device("cpu"))
    first = path.outputs(path.interval())
    inp = path.inputs() if path.carry else raw
    second = path.outputs(path.interval())
    problem = run.load("problems", cfg["problem"])
    for out, field in problem.STATE.items():
        want = first[out] if traffic["state"] == "carried" else raw[field]
        assert torch.equal(inp[field], want)
    assert any(not torch.equal(first[k], second[k]) for k in first) == path.carry


def test_no_card_no_result(tmp_path):
    """Without a CUDA card the command prints nothing on stdout and exits
    non-zero; so it does in a directory that holds only BENCHMARK.json and
    cdkbench/."""
    argv = ["--workload", CELLS[0], "--seed", "3000000001", "--seconds", "1"]
    p = subprocess.run([sys.executable, "cdkbench/run.py", *argv], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout == ""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "cdkbench", tmp_path / "cdkbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "cdkbench/run.py", *argv], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout == ""


@pytest.mark.parametrize("module", [None, "jax", "jaxlib.xla_extension",
                                    "flax.linen", "cdk_tpu.kernels"])
def test_no_result_with_jax_loaded(module, monkeypatch, capsys):
    """A run whose process holds JAX or the JAX package once the window has
    closed (here put there by the run) prints no result, exits non-zero and
    names it on stderr; without them the same run prints its result.  The
    names compare by their whole top-level part."""
    import cdk_torch.core.platform as platform

    assert run.forbidden_loaded(dict.fromkeys(
        ["cdk_torch.core", "cdk_tpux", "jaxtyping", "cdk_tpu", "flax.core"])) == [
        "cdk_tpu", "flax.core"]
    for var in ("TORCH_EXTENSIONS_DIR", "TRITON_CACHE_DIR", "CUDA_CACHE_PATH"):
        monkeypatch.setenv(var, "")  # main sets them; restored afterwards
    monkeypatch.setattr(sys, "path", list(sys.path))
    for m in run.forbidden_loaded():
        monkeypatch.delitem(sys.modules, m)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(platform, "resolve_device", lambda _: torch.device("cpu"))
    real = run.run_cell

    def run_cell(c, bench, seed, seconds, trace, device):
        out = real(c, bench, seed, seconds, trace, device, tiny(c["name"]))
        if module is not None:
            monkeypatch.setitem(sys.modules, module, ModuleType(module))
        return out

    monkeypatch.setattr(run, "run_cell", run_cell)
    rc = run.main(["--workload", CELLS[0], "--seed", str(2**31 + 21),
                   "--seconds", "0.3"])
    out, err = capsys.readouterr()
    if module is None:
        assert rc == 0 and json.loads(out.splitlines()[-1])["correct"] is True
    else:
        assert rc != 0 and out == "" and module in err


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", CELLS)
def test_result_line(name, trace):
    # untraced, a window of two intervals at least (the tail needs two)
    res, lines = run.run_cell(cell(name), BENCH, 2**31 + 99, 0.3 if trace else 1.0,
                              bool(trace), torch.device("cpu"), tiny(name))
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(res)[-1] == "checks" and ("breakdown" in res) == bool(trace)
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] >= 1
    want = {m["name"]: m["unit"] for m in run.metrics_for(BENCH, name, bool(trace))}
    got = {k: v["unit"] for k, v in res["metrics"].items()}
    # on the CPU no kernel of the port runs, so its roofline has nothing
    assert got == {k: u for k, u in want.items()
                   if not k.startswith("kernel_roofline_pct")}
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(res["device"])
    assert set(res["checks"]) == set(json.loads((ROOT / "cdkbench" / "limits" /
                                                 f"{name}.json").read_text())["limits"]) | {"state_changed"}
    assert lines[-1].startswith("correct: True")
    json.dumps(res, allow_nan=False)
