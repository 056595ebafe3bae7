"""mask_us_per_step.cke: the device time a step of the activities launched
under the program's `cdk.cke.mask` span (each tracer's masked table,
tracer * cellMask), in us; None where the span did not run."""


def read(s: dict):
    span = s.get("spans", {}).get("cdk.cke.mask")
    return None if span is None else span["device_s"] / s["steps"] * 1e6
