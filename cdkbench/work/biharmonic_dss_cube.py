"""The least work of an interval of family `biharmonic_dss_cube`: `steps`
chained steps A, DSS, A over the cubed sphere (A the element's weak
Laplacian).

Bytes as for `biharmonic`: the state in and out once and the constant
fields once per interval.  Operations: between two assemblies the two
adjacent applications compose into one of A^2, so the interval needs
steps + 1 applications to every element-column (A, then A^2 between the
assemblies, then A), each at bf16x3 on the tensor cores, and a DSS per
step in float32.  The DSS's least is counted from the cube's real sharer
counts (reference/biharmonic_dss_cube.py `sharers`): the assembled value of
a point of m sharers is one number, which takes at least m - 1 sums of the
sharers' contributions and one product by the inverse mass W, and a form
may form it once and hand it to every sharer.  So a step needs, for every
(tracer, level) column, the sum over the cube's unique points of m - 1
sums and one product: 7*nelemd - 2 sums and 9*nelemd + 2 products, 16
operations per element-column (the form K26 runs sums at every sharer,
20*nelemd - 24, and multiplies all 16 points, more than this least).
Nothing can do less, so a share of this least time cannot pass 100 %.
"""

from __future__ import annotations

from cdkbench.peaks import least as _least
from cdkbench.reference.biharmonic_dss_cube import sharers
from cdkbench.work.biharmonic import APPLY, X3_PRODUCTS, sizes


def dss_ops(nelemd: int) -> tuple[int, int]:
    """(sums, products) of one DSS of one (tracer, level) column: over the
    unique points, m - 1 sums and one product for a point of m sharers."""
    count = (sharers(nelemd) >= 0).sum(1)  # m, at each of the m sharers
    unique = int((1.0 / count.double()).sum().round())
    return count.numel() - unique, unique


def least(cfg: dict, steps: int) -> dict:
    cols, state, consts = sizes(cfg)
    sums, products = dss_ops(cfg["nelemd"])
    per_col = cfg["qsize"] * cfg["nlev"]
    return _least(2 * state + consts,
                  f32_ops=per_col * steps * (sums + products),
                  tc_ops=cols * (steps + 1) * X3_PRODUCTS * APPLY)
