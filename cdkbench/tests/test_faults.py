"""The check's power, on the CPU at a small size: a run with the timed path
broken underneath (the port's wrappers replaced for the run) must come out
`correct` false, once for each fault a cell can have:

  unchanged   a step that returns its state unchanged
  altered     one answer altered where it is produced (the largest value of
              the wrapper's output set to zero)
  exchange    the exchange between shards left out (the decomposed cell, on
              two shards, since one shard has no neighbour to hear from)
  stale       an interval that returns what the first one returned (a
              result kept across calls), where the state is carried

Where to plant each fault is the cell's traffic's to say, in
`faults/<traffic>.py`: STEP, the (module, attribute) of the program's
wrapper whose output is the state a step produces; `unchanged`, its
stand-in that hands that state back; ANSWER, the wrapper that produces the
interval's answer; and, where the traffic exchanges between shards,
EXCHANGE, its stand-in `no_exchange` and EXCHANGE_TRAFFIC, the traffic keys
under which a shard has a neighbour.  A cell whose traffic brings no such
file fails test_traffic_brings_its_fault_hooks.

The control, the benchmark's reference in the precision below the one the
configuration states, must fail a limit where the program passes them all.

    python -m pytest cdkbench/tests -q
"""

from __future__ import annotations

import functools
import importlib
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from cdkbench import check as chk
from cdkbench import run
from cdkbench.readings import readings
from cdkbench.tests.test_harness import BENCH, CELLS, cell, tiny

SEED = 2**31 + 7
FAULTS = Path(__file__).resolve().parent / "faults"


def _alter(x: torch.Tensor) -> torch.Tensor:
    x = x.clone()
    x.view(-1)[x.abs().argmax()] = 0.0
    return x


@functools.cache
def hooks(traffic):
    """The fault hooks faults/<traffic>.py, or None where the traffic brings
    none."""
    if not (FAULTS / f"{traffic}.py").is_file():
        return None
    return run.load("tests/faults", traffic)


def hooks_of(name):
    """The hooks of the cell's traffic; a cell without them fails."""
    traffic = cell(name)["traffic"]
    hook = hooks(traffic)
    if hook is None:
        pytest.fail(f"cell {name}: its traffic {traffic!r} brings no fault "
                    f"hooks (cdkbench/tests/faults/{traffic}.py)")
    return hook


def wrapper(where):
    """(module, attribute) -> (the imported module, attribute)."""
    module, attr = where
    return importlib.import_module(module), attr


def _run(name, overrides=None):
    res, _ = run.run_cell(cell(name), BENCH, SEED, 0.5, False,
                          torch.device("cpu"), overrides or tiny(name))
    return res


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    assert _run(name)["correct"] is True


@pytest.mark.parametrize("name", CELLS)
def test_traffic_brings_its_fault_hooks(name):
    hook = hooks_of(name)
    wheres = [hook.STEP, hook.ANSWER]
    if hasattr(hook, "EXCHANGE"):
        wheres.append(hook.EXCHANGE)
        assert callable(hook.no_exchange) and hook.EXCHANGE_TRAFFIC
    for where in wheres:
        mod, attr = wrapper(where)
        assert callable(getattr(mod, attr)), where
    assert callable(hook.unchanged)


@pytest.mark.parametrize("name", CELLS)
def test_state_unchanged_is_caught(name, monkeypatch):
    hook = hooks_of(name)
    monkeypatch.setattr(*wrapper(hook.STEP), hook.unchanged)
    res = _run(name)
    assert res["correct"] is False and res["failed"] >= 1


@pytest.mark.parametrize("name", CELLS)
def test_altered_answer_is_caught(name, monkeypatch):
    mod, attr = wrapper(hooks_of(name).ANSWER)
    real = getattr(mod, attr)

    def altered(*a, **k):
        out = real(*a, **k)
        if isinstance(out, tuple):
            return (_alter(out[0]), *out[1:])
        return _alter(out)

    monkeypatch.setattr(mod, attr, altered)
    assert _run(name)["correct"] is False


@pytest.mark.parametrize("name", [n for n in CELLS if run.cell_files(
    cell(n))[1]["state"] == "carried"])
def test_stale_interval_is_caught(name, monkeypatch):
    first = {}

    def build(problem, cfg, traffic, raw, device, _real=run.load(
            "paths", run.cell_files(cell(name))[1]["path"]).build):
        path = _real(problem, cfg, traffic, raw, device)
        real = path.interval

        def stale():
            out = real()
            return first.setdefault("out", out)

        path.interval = stale
        return path

    real_load = run.load
    monkeypatch.setattr(run, "load", lambda kind, mod: SimpleNamespace(
        build=build) if kind == "paths" else real_load(kind, mod))
    res = _run(name)
    assert res["correct"] is False and res["failed"] >= 1


def _exchanging():
    """The cells whose traffic's hooks name an exchange between shards."""
    return [n for n in CELLS if hasattr(hooks(cell(n)["traffic"]), "EXCHANGE")]


@pytest.mark.parametrize("name", _exchanging())
def test_exchange_left_out_is_caught(name, monkeypatch):
    hook = hooks_of(name)
    shards = tiny(name, **hook.EXCHANGE_TRAFFIC)
    assert _run(name, shards)["correct"] is True
    monkeypatch.setattr(*wrapper(hook.EXCHANGE), hook.no_exchange)
    assert _run(name, shards)["correct"] is False


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_where_the_program_passes(name):
    """The control's readings fail at least one of the cell's limits; the
    program's pass all of them, on the same seed."""
    limits = run.read_json("limits", f"{name}.json")["limits"]
    over = tiny(name)
    program = readings(cell(name), SEED, False, torch.device("cpu"), over)
    control = readings(cell(name), SEED, True, torch.device("cpu"), over)
    assert chk.passed(chk.judge(program, limits))
    assert not chk.passed(chk.judge(control, limits))
