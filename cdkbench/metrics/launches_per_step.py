"""launches_per_step: device activities (kernels, copies, fills) of the
traced window per step: the host path's work."""


def read(s: dict):
    return s["device_ops"] / s["steps"] if s["steps"] else None
