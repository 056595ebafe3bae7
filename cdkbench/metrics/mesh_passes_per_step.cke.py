"""mesh_passes_per_step.cke: the program's counter `cke_mesh_passes` (a CKE
step's passes over the edge fields: connectivity, coefficients, ntf and
advMask, one a tracer table today) over the traced window's steps; a
kernel that took the whole tracer group in one pass would read 1.  None
without the program's counters."""


def read(s: dict):
    if "counts" not in s or not s["steps"]:
        return None
    return s["counts"].get("cke_mesh_passes", 0) / s["steps"]
