"""The check's power over a tracer group, on the CPU at a small size: a run
of each cell of traffic `tracer_group` with one of the faults
faults/tracer_group.py plants must come out `correct` false:

  first_for_all   the group step returns tracer 0's flux for every tracer
  no_third_order  K3 drops the third-order term
  writes_state    the group step writes into the seeded tracers (where the
                  mask is 0, so only the state check can see it)

    python -m pytest cdkbench/tests -q
"""

from __future__ import annotations

import importlib

import pytest
import torch

from cdkbench import run
from cdkbench.tests.test_harness import BENCH, CELLS, cell, tiny

HOOKS = run.load("tests/faults", "tracer_group")
GROUP_CELLS = [n for n in CELLS if cell(n)["traffic"] == "tracer_group"]


def _run(name):
    res, _ = run.run_cell(cell(name), BENCH, 2**31 + 13, 0.3, False,
                          torch.device("cpu"), tiny(name))
    return res


@pytest.mark.parametrize("name", GROUP_CELLS)
def test_sound_group_is_correct(name):
    assert _run(name)["correct"] is True


@pytest.mark.parametrize("fault", sorted(HOOKS.FAULTS))
@pytest.mark.parametrize("name", GROUP_CELLS)
def test_group_fault_is_caught(name, fault, monkeypatch):
    (module, attr), make = HOOKS.FAULTS[fault]
    mod = importlib.import_module(module)
    monkeypatch.setattr(mod, attr, make(getattr(mod, attr)))
    res = _run(name)
    assert res["correct"] is False
    if fault == "writes_state":
        assert res["checks"]["state_changed"]["value"] == 1.0
