"""state_passes_per_step.cube: the program's counter `cube_state_passes`
(the passes of the cube chain's launches over the state: one for K1's
bridge-in, one for each K26 step) over the traced window's steps; a 6-step
interval makes 7.  None where the program did not count it."""


def read(s: dict):
    passes = s.get("counts", {}).get("cube_state_passes")
    if passes is None or not s["steps"]:
        return None
    return passes / s["steps"]
