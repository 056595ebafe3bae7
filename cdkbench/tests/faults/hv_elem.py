"""Fault hooks of traffic `hv_elem` (test_faults.py): the resident kernel K1,
whose one launch chains the interval's steps and produces its answer."""

# (module, attribute) of the wrapper whose output is the state a step
# produces, and of the wrapper that produces the interval's answer
STEP = ("cdk_torch.kernels.biharmonic.resident", "bd8_resident")
ANSWER = STEP


def unchanged(L, q, *a, **k):
    """STEP's stand-in: the state handed back unchanged."""
    return q
