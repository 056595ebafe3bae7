"""glue_us_per_step: device time per step outside the port's hand-written
kernels (`cdk_torch/csrc`): layout copies, torch's element-wise kernels,
matrix products and copies, told apart by kernel name."""


def read(s: dict):
    return s["glue_s"] / s["steps"] * 1e6 if s["steps"] else None
