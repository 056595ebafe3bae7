"""The least work of family `mpdata` (work/mpdata.py) at each of its cells'
own sizes against chip_smoke.py's counts, which it copied.

    python -m pytest cdkbench/tests -q
"""

from __future__ import annotations

import sys

import pytest

from cdkbench import run
from cdkbench.tests.test_harness import ROOT, cell, cells_of


@pytest.mark.parametrize("name", cells_of("mpdata"))
def test_least_work_matches_chip_smoke(name):
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    cfg, traffic = run.cell_files(cell(name))
    steps = traffic["interval_steps"]
    got = run.load("work", "mpdata").least(cfg, steps)
    s, nx, nzm = cfg["nslices"], cfg["nx"], cfg["nz"] - 1
    assert got["f32_ops"] == cs.mpdata_ops(s, nx, nzm, steps, True)
    # the bytes of one K2 launch in chip_smoke's bound: every field in and
    # f, flux out
    assert got["bytes"] == 4 * (2 * s * (nx + 6) * nzm + s * (nx + 5) * nzm
                                + s * (nx + 4) * cfg["nz"] + 2 * s * nzm
                                + 3 * s * cfg["nz"])
    assert got["bound_by"] == "f32 operations"
