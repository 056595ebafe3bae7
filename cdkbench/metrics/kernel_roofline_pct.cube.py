"""kernel_roofline_pct.cube: the cube chain's kernels' device time against
one pass of the state in and out for each pass they make: 100 * least_s *
cube_state_passes / kernel_s, least_s the interval's least time
(work/biharmonic_dss_cube.py, bound by its bytes: the state in and out and
the constant fields, which every pass moves at least), so the share cannot
pass 100 %.  None where no kernel of the port ran (on the CPU) or the
summary carries no count of the passes."""


def read(s: dict):
    if s["kernel_s"] <= 0:
        return None
    passes = s.get("counts", {}).get("cube_state_passes")
    if passes is None:
        return None
    return 100.0 * s["least_s"] * passes / s["kernel_s"]
