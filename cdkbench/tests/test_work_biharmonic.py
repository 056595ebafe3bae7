"""The least work of family `biharmonic` (work/biharmonic.py) at each of its
cells' own sizes against chip_smoke.py's counts, which it copied.

    python -m pytest cdkbench/tests -q
"""

from __future__ import annotations

import sys

import pytest

from cdkbench import run
from cdkbench.tests.test_harness import ROOT, cell, cells_of


@pytest.mark.parametrize("name", cells_of("biharmonic"))
def test_least_work_matches_chip_smoke(name):
    """An element-local chain composes into one apply an element-column."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    cfg, traffic = run.cell_files(cell(name))
    got = run.load("work", "biharmonic").least(cfg, traffic["interval_steps"])
    cols = cfg["nelemd"] * cfg["qsize"] * cfg["nlev"]
    assert got["tc_ops"] == cs.apply_ops(cols, "bf16x3", 1)["bf16_ops"]
    assert got["f32_ops"] == 0
    assert got["bytes"] == 4 * (2 * cols * 16 + 16 + cfg["nelemd"] * 16 * 9)
