"""step_us.homme: `step_us` of the HOMME cells, read alike. A metric of its
own, since those cells' loops, paced by the host, spread their step time too
widely for the bound of `step_us` (PERF.md, section 2)."""

from cdkbench.metrics.step_us import read  # noqa: F401
