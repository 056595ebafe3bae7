"""step_roofline_pct: the intervals' least time (work/<family>.py) over their
wall time in the traced window: the whole step's share of the card's
peak."""


def read(s: dict):
    return 100.0 * s["least_s"] * s["intervals"] / s["window_s"]
