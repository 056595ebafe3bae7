"""The least work of an interval of family `biharmonic`: `steps` chained
applications of each element's weak Laplacian, a linear map L[e] of the 16
GLL points of every (tracer, level) column, with no assembly between.

Bytes: the state read once and written once, and each constant field
(dvv, dinv, spheremp, tensorvisc) read once, per interval.  Operations: an
element-local chain composes into one operator L[e]^steps, so the interval
needs one application of a 16 x 16 operator to every element-column, at
the fastest rate a form within the family's float32 gate can use: bf16x3,
three bf16 tensor-core products of APPLY operations (the precomposition
itself, 16^3 per element and step, is left out).  No implementation,
temporal blocking included, can do less, so a share of this least time
cannot pass 100 %.
"""

from __future__ import annotations

from cdkbench.peaks import least as _least

# operations of one 16 x 16 apply to one element-column (256 FMAs), and
# the bf16 products a bf16x3 apply takes
APPLY = 512
X3_PRODUCTS = 3
ITEMSIZE = {"float32": 4}


def sizes(cfg: dict) -> tuple[int, int, int]:
    """(element-columns, state bytes, constant-field bytes)."""
    n, e = cfg["np_gll"], cfg["nelemd"]
    b = ITEMSIZE[cfg["dtype"]]
    cols = e * cfg["qsize"] * cfg["nlev"]
    consts = n * n + e * n * n * (4 + 1 + 4)  # dvv; dinv, spheremp, tensorvisc
    return cols, cols * n * n * b, consts * b


def least(cfg: dict, steps: int) -> dict:
    cols, state, consts = sizes(cfg)
    return _least(2 * state + consts, tc_ops=cols * X3_PRODUCTS * APPLY)
