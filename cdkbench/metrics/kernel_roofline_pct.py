"""kernel_roofline_pct: the intervals' least time (work/<family>.py) over the
device time of the port's hand-written kernels in them; nothing where none
ran."""


def read(s: dict):
    if s["kernel_s"] <= 0:
        return None
    return 100.0 * s["least_s"] * s["intervals"] / s["kernel_s"]
