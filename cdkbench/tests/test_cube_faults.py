"""The check's power over the cubed sphere's assembly, on the CPU at a small
size (a cube of ne 2): a run of each cell of traffic `hv_cube` with one of
the mesh faults faults/hv_cube.py plants must come out `correct` false:

  corner_third_sharer_dropped  the 8 cube corners assembled over two of
                               their three sharers
  seams_unreversed             every seam between faces taken point for
                               point, also where its points run the other
                               way

    python -m pytest cdkbench/tests -q
"""

from __future__ import annotations

import importlib

import pytest
import torch

from cdkbench import run
from cdkbench.tests.test_harness import BENCH, CELLS, cell, tiny

HOOKS = run.load("tests/faults", "hv_cube")
CUBE_CELLS = [n for n in CELLS if cell(n)["traffic"] == "hv_cube"]


def _run(name):
    res, _ = run.run_cell(cell(name), BENCH, 2**31 + 17, 0.3, False,
                          torch.device("cpu"), tiny(name))
    return res


@pytest.mark.parametrize("name", CUBE_CELLS)
def test_sound_cube_is_correct(name):
    assert _run(name)["correct"] is True


@pytest.mark.parametrize("fault", sorted(HOOKS.FAULTS))
@pytest.mark.parametrize("name", CUBE_CELLS)
def test_mesh_fault_is_caught(name, fault, monkeypatch):
    (module, attr), make = HOOKS.FAULTS[fault]
    mod = importlib.import_module(module)
    monkeypatch.setattr(mod, attr, make(getattr(mod, attr)))
    res = _run(name)
    assert res["correct"] is False and res["failed"] >= 1
