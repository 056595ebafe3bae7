"""idle_pct: the share of the traced window in which no operation ran on the
card."""


def read(s: dict):
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])
