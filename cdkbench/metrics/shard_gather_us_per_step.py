"""shard_gather_us_per_step: the device time a step of the activities
launched under the program's `cdk.dist.gather` span (the shards' outputs
stacked and their partial fluxes summed), in us; None where the span did
not run."""


def read(s: dict):
    span = s.get("spans", {}).get("cdk.dist.gather")
    return None if span is None else span["device_s"] / s["steps"] * 1e6
