"""exchange_us_per_step: the device time a step of the activities launched
under the program's `cdk.dist.exchange` span (the halo exchange between
shards), in us; None where the span did not run."""


def read(s: dict):
    span = s.get("spans", {}).get("cdk.dist.exchange")
    return None if span is None else span["device_s"] / s["steps"] * 1e6
