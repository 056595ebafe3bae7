"""HOMME biharmonic_wk over the cubed sphere: the inputs of a cell, made on
the card from the seed, as problems/homme.py makes them, for nelemd = 6 *
ne^2 elements.  The program lays the elements out on its cube
(cdk_torch/kernels/biharmonic/cube.py); the reference builds the same cube
its own way (reference/biharmonic_dss_cube.py); each refuses any other
count of elements.
"""

from __future__ import annotations

from cdkbench.problems.homme import (  # noqa: F401
    DTYPES,
    FIELDS,
    OUTPUTS,
    STATE,
    make,
    named,
    shapes,
    to_program,
)

# the CPU tests' sizes over the configuration's: a cube of ne 2 (24
# elements, every kind of point: 3- and 4-sharer vertices, rotated and
# reversed seams) of 4-level, 2-tracer elements
TINY = dict(nelemd=24, nlev=4, qsize=2)

