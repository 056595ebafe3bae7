"""Fault hooks of traffic `hv_ring` (test_faults.py): the resident ring
kernel K14, whose one launch chains the interval's steps and produces its
answer."""

# (module, attribute) of the wrapper whose output is the state a step
# produces, and of the wrapper that produces the interval's answer
STEP = ("cdk_torch.kernels.biharmonic.dss_resident", "dss_resident")
ANSWER = STEP


def unchanged(L, w, q_lane, *a, **k):
    """STEP's stand-in: the state handed back unchanged."""
    return q_lane
