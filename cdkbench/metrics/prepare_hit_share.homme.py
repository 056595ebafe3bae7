"""prepare_hit_share.homme: of the HOMME loops' set-ups in the traced
window, the share served from the one built before (the program's counters
`prepare_reuses` over `prepare_reuses` + `operator_builds`); None where
neither counted."""


def read(s: dict):
    counts = s.get("counts", {})
    reuses = counts.get("prepare_reuses", 0)
    builds = counts.get("operator_builds", 0)
    return reuses / (reuses + builds) if reuses + builds else None
