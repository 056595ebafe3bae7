"""step_us: the window's wall time over every step its intervals completed,
each interval ending in a synchronisation; stalls count (host clock over
the whole window)."""


def read(s: dict):
    return s["window_s"] / s["steps"] * 1e6 if s["steps"] else None
