"""The least work of an interval of family `biharmonic_dss`: `steps` chained
steps A, DSS, A on the element ring (A the element's weak Laplacian).

Bytes as for `biharmonic`: the state in and out once and the constant
fields once per interval.  Operations: between two assemblies the two
adjacent applications compose into one of A^2, so the interval needs
steps + 1 applications to every element-column (A, then A^2 between the
assemblies, then A), each at bf16x3 on the tensor cores, and a DSS per
step in float32: RING_DSS operations per element-column (8 sums over the
two shared columns, 16 multiplies by the inverse mass), as chip_smoke.py
counts them.  Nothing can do less, so a share of this least time cannot
pass 100 %.
"""

from __future__ import annotations

from cdkbench.peaks import least as _least
from cdkbench.work.biharmonic import APPLY, X3_PRODUCTS, sizes

RING_DSS = 24


def least(cfg: dict, steps: int) -> dict:
    cols, state, consts = sizes(cfg)
    return _least(2 * state + consts,
                  f32_ops=cols * steps * RING_DSS,
                  tc_ops=cols * (steps + 1) * X3_PRODUCTS * APPLY)
