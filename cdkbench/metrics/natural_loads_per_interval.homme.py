"""natural_loads_per_interval.homme: the program's counter `natural_loads`
(calls of K1's or K15's wrapper given the state in its own (e, q, k, i, j)
layout, read where it lies with no lane copy) over the traced window's
intervals; None without the program's counters."""


def read(s: dict):
    if "counts" not in s:
        return None
    return s["counts"].get("natural_loads", 0) / s["intervals"]
