"""launches_per_step.homme: `launches_per_step` of the HOMME cells, read alike;
it moves `step_us.homme`, their step time."""

from cdkbench.metrics.launches_per_step import read  # noqa: F401
