"""kernel_roofline_pct.homme: `kernel_roofline_pct` of the HOMME cells, read
alike; it moves `step_us.homme`, their step time."""

from cdkbench.metrics.kernel_roofline_pct import read  # noqa: F401
