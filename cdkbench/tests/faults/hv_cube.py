"""Fault hooks of traffic `hv_cube` (test_faults.py, test_cube_faults.py): K26,
whose launch hands the state on each step and whose last launch produces
the interval's answer, and the cube's mesh (cdk_torch/kernels/biharmonic/
cube.py), whose assembly map the loop's set-up builds."""

import torch

# (module, attribute) of the wrapper whose output is the state a step
# produces, and of the wrapper that produces the interval's answer
STEP = ("cdk_torch.kernels.biharmonic.dss_cube", "dss_cube_step")
ANSWER = STEP
MESH = "cdk_torch.kernels.biharmonic.cube"


def unchanged(op, amap, w, t):
    """STEP's stand-in: the state handed back unchanged."""
    return t


def corner_third_sharer_dropped(real):
    """`assembly_map`'s stand-in: at the 8 cube corners, whose vertices
    have three sharers (two others in the map), the last of them left
    out, in the DSS and in W alike."""

    def assembly_map(nbr, nedge, rev):
        amap = real(nbr, nedge, rev).clone()
        cube_corner = (amap[..., 1] >= 0) & (amap[..., 2] < 0)
        amap[..., 1] = torch.where(cube_corner, -1, amap[..., 1])
        return amap

    return assembly_map


def seams_unreversed(real):
    """`neighbours`' stand-in: every edge taken point for point, also the
    seams between faces whose points run the other way."""

    def neighbours(ne, device=None, order=None):
        nbr, nedge, rev = real(ne, device, order)
        return nbr, nedge, torch.zeros_like(rev)

    return neighbours


# the faults test_cube_faults.py plants: name -> ((module, attribute),
# stand-in made from the real attribute)
FAULTS = {"corner_third_sharer_dropped": ((MESH, "assembly_map"),
                                          corner_third_sharer_dropped),
          "seams_unreversed": ((MESH, "neighbours"), seams_unreversed)}
