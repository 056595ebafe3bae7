"""operator_builds_per_interval.homme: the program's counter
`operator_builds` (calls of `operator.build_element_operator`) over the
traced window's intervals; None without the program's counters."""


def read(s: dict):
    if "counts" not in s:
        return None
    return s["counts"].get("operator_builds", 0) / s["intervals"]
