"""step_roofline_pct.homme: `step_roofline_pct` of the HOMME cells, read alike;
it moves `step_us.homme`, their step time."""

from cdkbench.metrics.step_roofline_pct import read  # noqa: F401
