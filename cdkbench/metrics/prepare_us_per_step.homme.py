"""prepare_us_per_step.homme: the host time a step under the program's
`cdk.prepare` span (a HOMME loop's set-up: its operator, weights and A²
built, or the lookup of the ones built before), in us; None where the span
did not run."""


def read(s: dict):
    span = s.get("spans", {}).get("cdk.prepare")
    return None if span is None else span["host_s"] / s["steps"] * 1e6
