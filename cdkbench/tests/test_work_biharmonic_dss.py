"""The least work of family `biharmonic_dss` (work/biharmonic_dss.py) at
each of its cells' own sizes against chip_smoke.py's counts, which it
copied.

    python -m pytest cdkbench/tests -q
"""

from __future__ import annotations

import sys

import pytest

from cdkbench import run
from cdkbench.tests.test_harness import ROOT, cell, cells_of


@pytest.mark.parametrize("name", cells_of("biharmonic_dss"))
def test_least_work_matches_chip_smoke(name):
    """steps + 1 applies an element-column between the assemblies, and a
    ring DSS a step."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    cfg, traffic = run.cell_files(cell(name))
    steps = traffic["interval_steps"]
    got = run.load("work", "biharmonic_dss").least(cfg, steps)
    cols = cfg["nelemd"] * cfg["qsize"] * cfg["nlev"]
    assert got["tc_ops"] == cs.apply_ops(cols, "bf16x3", steps + 1)["bf16_ops"]
    assert got["f32_ops"] == cols * steps * cs.RING_DSS
    assert got["bytes"] == 4 * (2 * cols * 16 + 16 + cfg["nelemd"] * 16 * 9)
    assert got["bound_by"] == "bytes"
