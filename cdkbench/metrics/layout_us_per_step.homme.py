"""layout_us_per_step.homme: the device time a step of the activities
launched under the program's `cdk.layout` span (the layout turns of the
HOMME loops), in us; None where the span did not run."""


def read(s: dict):
    span = s.get("spans", {}).get("cdk.layout")
    return None if span is None else span["device_s"] / s["steps"] * 1e6
