"""CPU tests of the benchmark harness: the files a cell is found by, the
shape of BENCHMARK.json, the least work against chip_smoke.py's counts, the
trace reduction, the refusal without a card, and the result line.

    python -m pytest cdkbench/tests -q
"""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from cdkbench import run
from cdkbench import trace as tr

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [c["name"] for c in BENCH["workloads"]]
# small sizes for the CPU: a 4 x 3 torus of 4-level, 2-tracer elements and
# 4 CRMs of 8 columns and 12 levels
TINY = {"homme_ne30_share": dict(nelemd=12, nlev=4, qsize=2),
        "mmf_crm_8192": dict(nslices=4, nx=8, nz=12)}
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def cell(name):
    return run.cell_of(name, BENCH)


def tiny(name, **traffic):
    return {"config": TINY[cell(name)["config"]], "traffic": traffic}


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
    assert c["chips"] == 1
    for kind, mod in (("problems", cfg["problem"]), ("paths", traffic["path"]),
                      ("work", traffic["family"]), ("reference", traffic["family"])):
        assert (ROOT / "cdkbench" / kind / f"{mod}.py").is_file(), (kind, mod)
    limits = json.loads((ROOT / "cdkbench" / "limits" / f"{name}.json").read_text())
    outputs = run.load("problems", cfg["problem"]).OUTPUTS
    assert {k.split(".")[0] for k in limits["limits"]} == set(outputs)
    for m in run.metrics_for(BENCH, name, False) + run.metrics_for(BENCH, name, True):
        assert callable(run.load("metrics", m["name"]).read)


def test_metrics_of_each_cell():
    """Every cell reports setup_s, its family's step time (step_us, or
    step_us.homme for the HOMME cells, whose host-paced loops spread too
    widely for step_us's bound) and every per-layer metric of that family,
    each moving that step time; the interval tail only the MMF cells, whose
    intervals the card paces."""
    for name in CELLS:
        step = "step_us.homme" if name.startswith("homme.") else "step_us"
        e2e = {m["name"] for m in run.metrics_for(BENCH, name, False)}
        assert {"setup_s", step} <= e2e
        assert ("interval_ms_p95" in e2e) == name.startswith("mmf.")
        layer = run.metrics_for(BENCH, name, True)
        assert {m["moves"] for m in layer} == {step}
        assert len(layer) == 5


@pytest.mark.parametrize("name", CELLS)
def test_least_work_matches_chip_smoke(name):
    """The interval's counts at the cell's own sizes against chip_smoke.py's
    functions, which the benchmark copied."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    cfg, traffic = run.cell_files(cell(name))
    steps = traffic["interval_steps"]
    got = run.load("work", traffic["family"]).least(cfg, steps)
    if traffic["family"] == "mpdata":
        s, nx, nzm = cfg["nslices"], cfg["nx"], cfg["nz"] - 1
        assert got["f32_ops"] == cs.mpdata_ops(s, nx, nzm, steps, True)
        # the bytes of one K2 launch in chip_smoke's bound: every field in
        # and f, flux out
        assert got["bytes"] == 4 * (2 * s * (nx + 6) * nzm + s * (nx + 5) * nzm
                                    + s * (nx + 4) * cfg["nz"] + 2 * s * nzm
                                    + 3 * s * cfg["nz"])
        assert got["bound_by"] == "f32 operations"
    else:
        cols = cfg["nelemd"] * cfg["qsize"] * cfg["nlev"]
        applies = 1 if traffic["family"] == "biharmonic" else steps + 1
        assert got["tc_ops"] == cs.apply_ops(cols, "bf16x3", applies)["bf16_ops"]
        dss = 0 if traffic["family"] == "biharmonic" else cols * steps * cs.TORUS_DSS
        assert got["f32_ops"] == dss
        assert got["bytes"] == 4 * (2 * cols * 16 + 16 + cfg["nelemd"] * 16 * 9)
    assert got["least_s"] == max(got["bytes"] / cs.HBM_BYTES_PER_S,
                                 got["f32_ops"] / cs.F32_OPS_PER_S,
                                 got["tc_ops"] / cs.BF16_OPS_PER_S)


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
    # a family's own copy of a metric reads as the metric
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        base, _, family = m["name"].partition(".")
        if family:
            assert run.load("metrics", m["name"]).read(s) == pytest.approx(read[base])


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
