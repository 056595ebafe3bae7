"""The least work of an interval of family `cke`: `steps` steps of the
high-order edge flux over a tracer group, each computing every tracer's
(E, K) flux from that tracer's own (C, K) table.

Bytes, per step: each input read once (the T tracer tables, the cell
mask, ntf and advMask, the connectivity and both coefficient tables) and
the (T, E, K) flux written once.  The edge fields count once a step, not
once a tracer, since a form within the gate could read them once for the
whole group.  Operations, float32 (an FMA counts two): per tracer, edge
and level, two FMAs a slot (the 2nd- and 3rd-order sums), one FMA that
joins them (s1 + (C sgn) s3) and the product by wgt; per edge and level,
wgt = ntf advMask and C sgn once a step; per tracer, cell and level, the
mask product.  Nothing can do less, so a share of this least time cannot
pass 100 %.
"""

from __future__ import annotations

from cdkbench.peaks import least as _least

ITEMSIZE = {"float32": 4}
# bytes of a cell index
INDEX = 4


def least(cfg: dict, steps: int) -> dict:
    t, c, e = cfg["ntracers"], cfg["ncells"], cfg["nedges"]
    k, a = cfg["nvertlevels"], cfg["nadv"]
    b = ITEMSIZE[cfg["dtype"]]
    inputs = (t * c * k + c * k + 2 * e * k + 2 * e * a) * b + e * a * INDEX
    flux = t * e * k * b
    ops = t * e * k * (4 * a + 3) + 2 * e * k + t * c * k
    return _least(steps * (inputs + flux), f32_ops=steps * ops)
