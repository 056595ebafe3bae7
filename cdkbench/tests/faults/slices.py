"""Fault hooks of traffic `slices` (test_faults.py): the MPDATA sweep K2,
whose one launch runs the interval's steps and produces f and flux."""

# (module, attribute) of the wrapper whose output is the state a step
# produces, and of the wrapper that produces the interval's answer
STEP = ("cdk_torch.kernels.mpdata.resident", "advect_resident")
ANSWER = STEP


def unchanged(f, u, w, rho, rhow, adz, flux, n, **k):
    """STEP's stand-in: the state handed back unchanged."""
    return f, flux
