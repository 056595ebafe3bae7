"""The least work of family `biharmonic_dss_cube` (work/biharmonic_dss_cube.py)
at each of its cells' own sizes, held to counts by hand.

    python -m pytest cdkbench/tests -q
"""

from __future__ import annotations

import pytest

from cdkbench import run
from cdkbench.tests.test_harness import cell, cells_of

WORK = run.load("work", "biharmonic_dss_cube")


@pytest.mark.parametrize("ne", [1, 2, 30])
def test_dss_ops_by_hand(ne):
    """A cube of E = 6 ne^2 elements has 4E interior points (no sum, one
    product), 4E unique edge points of 2 sharers (one sum, one product)
    and E + 2 vertices: 8 of 3 sharers (two sums) and E - 6 of 4 (three),
    one product each; 54 ne^2 + 2 unique points in all."""
    e = 6 * ne * ne
    sums, products = WORK.dss_ops(e)
    assert products == 4 * e + 4 * e + e + 2 == 54 * ne * ne + 2
    assert sums == 4 * e + 8 * 2 + (e - 6) * 3 == 7 * e - 2
    assert sums + products == 16 * e


@pytest.mark.parametrize("name", cells_of("biharmonic_dss_cube"))
def test_least_work_at_the_cell(name):
    """steps + 1 bf16x3 applies an element-column between the assemblies,
    a DSS a step, the state in and out once: bound by its bytes."""
    cfg, traffic = run.cell_files(cell(name))
    steps = traffic["interval_steps"]
    got = WORK.least(cfg, steps)
    cols = cfg["nelemd"] * cfg["qsize"] * cfg["nlev"]
    assert got["tc_ops"] == cols * (steps + 1) * 3 * 512
    assert got["f32_ops"] == cols * steps * 16
    assert got["bytes"] == 4 * (2 * cols * 16 + 16 + cfg["nelemd"] * 16 * 9)
    assert got["bound_by"] == "bytes"
    # the benchmark cell's sizes: 5,400 elements of 2,880 columns, 6 steps
    if (cfg["nelemd"], cfg["qsize"] * cfg["nlev"], steps) == (5400, 2880, 6):
        assert got["least_s"] == pytest.approx(1993766464 / 3.35e12)
