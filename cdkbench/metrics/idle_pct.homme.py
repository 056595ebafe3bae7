"""idle_pct.homme: `idle_pct` of the HOMME cells, read alike; it moves
`step_us.homme`, their step time."""

from cdkbench.metrics.idle_pct import read  # noqa: F401
