"""interval_ms_p95: the 95th percentile over every interval of the window of
its time on the card's clock: CUDA events recorded before its first launch
and after its last, so launch waits inside the interval count and the
host's clock, which errs by about half a millisecond, does not."""

import statistics


def read(s: dict):
    ms = s["interval_ms"]
    return statistics.quantiles(ms, n=20)[18] if len(ms) >= 2 else None
