"""A new family, problem, path kind, configuration and cell take new files
and new BENCHMARK.json entries alone.

The test plants a toy family, `planted` (x <- a * x + b elementwise, a
state carried from interval to interval), in a copy of BENCHMARK.json and
cdkbench/, beside a toy program that stands where cdk_torch stands for the
real cells.  It adds files and appends entries only, checks that every file
the copy had is still the repository's, runs the new cell with the copy's
`run.run_cell` on the CPU (it comes out correct), and runs the copy's own
parametrised tests on that cell, among them its planted faults, which must
make it `correct` false, and the copy's tests of the whole BENCHMARK.json
over every cell, with a new per-layer metric that lists an existing cell.
The toy program marks its step with the program's span scheme
(`cdk_torch.core.trace.span`) and counts it (`count`); two new metric
files read that span and that counter from a traced run's summary.

    python -m pytest cdkbench/tests -q
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import textwrap

from cdkbench.tests.test_harness import ROOT

CELL = "planted.axpy"

# the toy program, outside the benchmark as cdk_torch is: one step is a
# module-level function, looked up at each call, which a fault replaces
PROGRAM = {"planted_program.py": '''
    """A toy program: x <- a * x + b, elementwise, chained; each step under
    the span `cdk.planted` and counted as `planted_calls`, as the port marks
    and counts its own work."""

    from cdk_torch.core.trace import count, span


    def axpy(x, a, b):
        return a * x + b


    def loop(x, a, b, n):
        for _ in range(n):
            with span("cdk.planted"):
                x = axpy(x, a, b)
            count("planted_calls")
        return x
'''}

# the benchmark's new files: a file of each kind that a new family brings
FILES = {
    "cdkbench/problems/planted.py": '''
        """The toy problem: x, a, b uniform on their ranges, on the card from
        the seed."""

        import torch

        FIELDS = ("x", "a", "b")
        OUTPUTS = ("x",)
        STATE = {"x": "x"}
        TINY = dict(n=64)


        def make(cfg, seed, device):
            gen = torch.Generator(device=device)
            gen.manual_seed(seed)
            out = {}
            for name in FIELDS:
                lo, hi = cfg["inputs"][name]
                u = torch.rand(cfg["n"], generator=gen, device=device,
                               dtype=torch.float64)
                out[name] = (lo + (hi - lo) * u).to(torch.float32)
            return out


        def to_program(cfg, raw):
            return cfg, raw


        def named(result):
            return {"x": result}
    ''',
    "cdkbench/paths/planted_loop.py": '''
        """Entry kind `planted_loop`: the toy program's loop."""


        class Path:
            def __init__(self, problem, cfg, traffic, raw):
                import planted_program

                self._program, self._raw = planted_program, raw
                self._x = raw["x"]
                self.steps = traffic["interval_steps"]
                self.carry = traffic["state"] == "carried"
                self.state = list(raw.values())

            def interval(self):
                x = self._program.loop(self._x, self._raw["a"], self._raw["b"],
                                       self.steps)
                if self.carry:
                    self._x = x
                return x

            def inputs(self):
                return {**self._raw, "x": self._x.clone()}

            def outputs(self, result):
                return {"x": result}


        def build(problem, cfg, traffic, raw, device):
            return Path(problem, cfg, traffic, raw)
    ''',
    "cdkbench/work/planted.py": '''
        """x, a, b read once and x written once; two operations a point and
        step."""

        from cdkbench.peaks import least as _least


        def least(cfg, steps):
            return _least(4 * 4 * cfg["n"], f32_ops=2 * cfg["n"] * steps)
    ''',
    "cdkbench/reference/planted.py": '''
        """The toy's reference, in float64, and its control in bfloat16."""

        import torch

        CONTROL = "bfloat16"
        NORM = "rel_l2"


        def interval(cfg, raw, steps, precision):
            dtype = {"float64": torch.float64, "bfloat16": torch.bfloat16}[precision]
            x, a, b = (raw[k].to(dtype) for k in ("x", "a", "b"))
            for _ in range(steps):
                x = a * x + b
            return {"x": x}
    ''',
    "cdkbench/metrics/step_us.planted.py": '''
        """step_us.planted: `step_us` of the toy cell."""

        from cdkbench.metrics.step_us import read  # noqa: F401
    ''',
    "cdkbench/metrics/idle_pct.planted.py": '''
        """idle_pct.planted: `idle_pct` of the toy cell."""

        from cdkbench.metrics.idle_pct import read  # noqa: F401
    ''',
    # a metric of a new name, listing an existing cell as well, and the
    # family's copy of it
    "cdkbench/metrics/interval_ms_mean.py": '''
        """interval_ms_mean: the window over its intervals."""


        def read(s):
            return 1e3 * s["window_s"] / s["intervals"]
    ''',
    "cdkbench/metrics/interval_ms_mean.planted.py": '''
        """interval_ms_mean.planted: `interval_ms_mean` of the toy cell."""

        from cdkbench.metrics.interval_ms_mean import read  # noqa: F401
    ''',
    # metrics of the toy program's own span and counter, read from the
    # summary's `spans` and `counts`
    "cdkbench/metrics/planted_us_per_step.py": '''
        """planted_us_per_step: host time a step under the toy's span
        `cdk.planted`, in us."""


        def read(s):
            span = s.get("spans", {}).get("cdk.planted")
            return None if span is None else span["host_s"] / s["steps"] * 1e6
    ''',
    "cdkbench/metrics/planted_calls_per_step.py": '''
        """planted_calls_per_step: the toy's counter `planted_calls` a step."""


        def read(s):
            if "counts" not in s:
                return None
            return s["counts"].get("planted_calls", 0) / s["steps"]
    ''',
    "cdkbench/tests/faults/planted_steps.py": '''
        """Fault hooks of traffic `planted_steps`."""

        STEP = ("planted_program", "axpy")
        ANSWER = STEP


        def unchanged(x, a, b):
            return x
    ''',
    "cdkbench/tests/test_work_planted.py": '''
        """The toy family's least work by hand."""

        import pytest

        from cdkbench import run
        from cdkbench.tests.test_harness import cell, cells_of


        @pytest.mark.parametrize("name", cells_of("planted"))
        def test_least_work_by_hand(name):
            cfg, traffic = run.cell_files(cell(name))
            got = run.load("work", "planted").least(cfg, traffic["interval_steps"])
            assert got["bytes"] == 16 * cfg["n"]
            assert got["f32_ops"] == 2 * cfg["n"] * traffic["interval_steps"]
    ''',
    "cdkbench/configs/planted_small.json": json.dumps({
        "name": "planted_small", "problem": "planted",
        "source": "https://www.netlib.org/blas/", "reduced": {},
        "n": 4096, "dtype": "float32",
        "inputs": {"x": [0.0, 1.0], "a": [0.5, 1.0], "b": [0.0, 1.0]}}),
    "cdkbench/traffic/planted_steps.json": json.dumps({
        "name": "planted_steps", "path": "planted_loop", "family": "planted",
        "interval_steps": 8, "state": "carried"}),
    f"cdkbench/limits/{CELL}.json": json.dumps({
        "limits": {"x.rel_l2": 1e-5, "x.rel_linf": 1e-5}}),
}

# the new entries, appended to BENCHMARK.json's lists
ENTRIES = {
    "configs": [{"name": "planted_small", "source": "https://www.netlib.org/blas/",
                 "file": "cdkbench/configs/planted_small.json", "reduced": [],
                 "why": "a toy elementwise update"}],
    "workloads": [{"name": CELL, "config": "planted_small",
                   "traffic": "planted_steps", "chips": 1,
                   "why": "8-step intervals of the toy update, x carried"}],
    "end_to_end": [{"name": "step_us.planted", "unit": "us", "better": "lower",
                    "bound": 0.05, "source": "host_clock", "workloads": [CELL]}],
    "per_layer": [{"name": "idle_pct.planted", "unit": "%", "better": "lower",
                   "source": "device_trace", "layer": "device",
                   "moves": "step_us.planted", "workloads": [CELL]},
                  {"name": "interval_ms_mean", "unit": "ms", "better": "lower",
                   "source": "program_span", "layer": "whole step",
                   "moves": "step_us", "workloads": ["mmf.slices"]},
                  {"name": "interval_ms_mean.planted", "unit": "ms",
                   "better": "lower", "source": "program_span",
                   "layer": "whole step", "moves": "step_us.planted",
                   "workloads": [CELL]},
                  {"name": "planted_us_per_step", "unit": "us", "better": "lower",
                   "source": "program_span", "layer": "the toy's step",
                   "moves": "step_us.planted", "workloads": [CELL]},
                  {"name": "planted_calls_per_step", "unit": "1/step",
                   "better": "lower", "source": "program_counter",
                   "layer": "the toy's step", "moves": "step_us.planted",
                   "workloads": [CELL]}],
}

# the copy's tests that must pass: the planted cell's parametrised cases,
# its planted faults among them ...
CASES = [
    "test_harness.py::test_config_file_states_its_changes[planted_small]",
    f"test_harness.py::test_cell_files_found_by_name[{CELL}]",
    f"test_harness.py::test_metrics_of_each_cell[{CELL}]",
    f"test_harness.py::test_least_time_is_the_slowest_unit[{CELL}]",
    f"test_harness.py::test_interval_starts_where_its_traffic_says[{CELL}]",
    f"test_harness.py::test_result_line[{CELL}-0]",
    f"test_harness.py::test_result_line[{CELL}-1]",
    f"test_work_planted.py::test_least_work_by_hand[{CELL}]",
    f"test_faults.py::test_traffic_brings_its_fault_hooks[{CELL}]",
    f"test_faults.py::test_sound_run_is_correct[{CELL}]",
    f"test_faults.py::test_state_unchanged_is_caught[{CELL}]",
    f"test_faults.py::test_altered_answer_is_caught[{CELL}]",
    f"test_faults.py::test_stale_interval_is_caught[{CELL}]",
    f"test_faults.py::test_control_fails_where_the_program_passes[{CELL}]",
]
# ... and the tests of the whole BENCHMARK.json, over every cell and
# configuration of the copy, that need no run of the program
WHOLE = ["test_benchmark_json_keys_and_names", "test_readers_on_a_summary",
         "test_metrics_of_the_first_cells", "test_metrics_of_each_cell",
         "test_config_file_states_its_changes", "test_cell_files_found_by_name",
         "test_least_time_is_the_slowest_unit"]


def _whole_cases(bench) -> list:
    cells = [c["name"] for c in bench["workloads"]]
    first = [c for c in cells if c != CELL]
    by_test = {"test_metrics_of_the_first_cells": first,
               "test_config_file_states_its_changes": [c["name"] for c in bench["configs"]],
               "test_metrics_of_each_cell": cells,
               "test_cell_files_found_by_name": cells,
               "test_least_time_is_the_slowest_unit": cells}
    return [f"test_harness.py::{t}" + (f"[{n}]" if n else "")
            for t in WHOLE for n in by_test.get(t, [None])]


RUN_CELL = f"""
import json, sys, torch
from cdkbench import run
bench = json.load(open("BENCHMARK.json"))
res, lines = run.run_cell(run.cell_of({CELL!r}, bench), bench, 2**31 + 11, 0.5,
                          sys.argv[1] == "1", torch.device("cpu"))
print(json.dumps(res))
"""


def _plant(tmp_path) -> dict:
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "cdkbench", tmp_path / "cdkbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    had = sorted(p.relative_to(tmp_path) for p in tmp_path.rglob("*") if p.is_file())
    for rel, text in {**PROGRAM, **FILES}.items():
        path = tmp_path / rel
        assert not path.exists(), f"{rel} is not a new file"
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(textwrap.dedent(text).lstrip())
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    for key, entries in ENTRIES.items():
        bench[key] = bench[key] + entries
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench, indent=2))
    # every file the copy had is the repository's; BENCHMARK.json only
    # gained entries at the ends of its lists
    for rel in had:
        if rel.name != "BENCHMARK.json":
            assert (tmp_path / rel).read_bytes() == (ROOT / rel).read_bytes(), rel
    old = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(bench) == set(old)
    for key, value in old.items():
        assert bench[key] == (value + ENTRIES[key] if key in ENTRIES else value), key
    return bench


def test_a_new_family_is_new_files_alone(tmp_path):
    bench = _plant(tmp_path)
    env = {k: v for k, v in os.environ.items() if not k.startswith("PYTEST_")}
    # the copy first; the repository for cdk_torch, whose spans and
    # counters the toy program uses
    env["PYTHONPATH"] = os.pathsep.join([str(tmp_path), str(ROOT)])
    res = {}
    for trace in ("0", "1"):
        p = subprocess.run([sys.executable, "-c", RUN_CELL, trace], cwd=tmp_path,
                           env=env, capture_output=True, text=True, timeout=120)
        assert p.returncode == 0, p.stderr[-3000:]
        res[trace] = json.loads(p.stdout.splitlines()[-1])
        assert res[trace]["correct"] is True and res[trace]["failed"] == 0, res
    assert set(res["0"]["metrics"]) == {"setup_s", "step_us.planted"}
    # the toy's span and counter read by its two new metric files alone:
    # one call a step, and some host time under the span
    traced = {k: v["value"] for k, v in res["1"]["metrics"].items()}
    assert traced["planted_calls_per_step"] == 1.0
    assert traced["planted_us_per_step"] > 0.0

    p = subprocess.run(
        [sys.executable, "-m", "pytest", "cdkbench/tests", "-v",
         "-k", " or ".join(["planted", *WHOLE]),
         "-p", "no:cacheprovider", "-p", "no:xdist", "-p", "no:randomly",
         "--ignore", "cdkbench/tests/test_new_cell.py"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stdout[-3000:]
    for case in CASES + _whole_cases(bench):
        assert f"cdkbench/tests/{case} PASSED" in p.stdout, case
