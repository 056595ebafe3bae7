"""Fault hooks of traffic `hv_torus` (test_faults.py): the rowchain champion,
whose step K16/K18 hands the state on and whose bridge out K17 produces the
interval's answer."""

# (module, attribute) of the wrapper whose output is the state a step
# produces, and of the wrapper that produces the interval's answer
STEP = ("cdk_torch.kernels.biharmonic.dss2d_rowchain", "rowchain_step")
ANSWER = ("cdk_torch.kernels.biharmonic.dss2d_rowchain", "rowchain_bridge_out")


def unchanged(F, w, t, *a, **k):
    """STEP's stand-in: the state handed back unchanged."""
    return t
