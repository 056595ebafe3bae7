"""The least work of family `cke` (work/cke.py) at each of its cells' own
sizes, against a count by hand.

    python -m pytest cdkbench/tests -q
"""

from __future__ import annotations

import pytest

from cdkbench import peaks, run
from cdkbench.tests.test_harness import cell, cells_of


@pytest.mark.parametrize("name", cells_of("cke"))
def test_least_work_by_hand(name):
    cfg, traffic = run.cell_files(cell(name))
    steps = traffic["interval_steps"]
    got = run.load("work", "cke").least(cfg, steps)
    t, c, e = cfg["ntracers"], cfg["ncells"], cfg["nedges"]
    k, a = cfg["nvertlevels"], cfg["nadv"]
    # in: T tracer tables and the cell mask (C, K); ntf and advMask
    # (E, K); advCoefs and advCoefs3rd (E, A) float32 and the cells (E, A)
    # int32, each once a step; out: the (T, E, K) flux
    tables = t * c * k * 4 + c * k * 4
    edges = 2 * e * k * 4 + 2 * e * a * 4 + e * a * 4
    assert got["bytes"] == steps * (tables + edges + t * e * k * 4)
    # per flux point 2 FMAs a slot, one joining FMA and a product; per
    # edge and level wgt and C sgn; per table point the mask product
    assert got["f32_ops"] == steps * (t * e * k * (4 * a + 3) + 2 * e * k
                                      + t * c * k)
    assert got["bound_by"] == "bytes"
    assert got["least_s"] == got["bytes"] / peaks.HBM_BYTES_PER_S


def test_least_work_of_the_ec30to60_group():
    """At mpaso_ec30to60's sizes a step moves 7.77 GB, 2.32 ms at the
    card's 3.35 TB/s."""
    cfg = run.read_json("configs", "mpaso_ec30to60.json")
    got = run.load("work", "cke").least(cfg, 1)
    assert got["bytes"] == pytest.approx(7.7700e9, rel=1e-4)
    assert got["least_s"] == pytest.approx(2.3194e-3, rel=1e-4)
