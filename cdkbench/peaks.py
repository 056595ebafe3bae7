"""The card's peaks for the least time of an interval (NVIDIA's H100 SXM data
sheet, dense rates, at the full 700 W): device-memory bytes/s, float32
operations/s outside the tensor cores (an FMA counts two), and bf16
tensor-core operations/s with float32 accumulation."""

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_TC_OPS_PER_S = 989e12


def least(nbytes: float, f32_ops: float = 0.0, tc_ops: float = 0.0) -> dict:
    """The least time the card could take for work that moves `nbytes`
    through device memory, runs `f32_ops` float32 operations and `tc_ops`
    bf16 tensor-core operations: the largest of the three, since the
    memory, the float32 units and the tensor cores can all run at once.
    `bound_by` names the one that sets it."""
    times = {"bytes": nbytes / HBM_BYTES_PER_S,
             "f32 operations": f32_ops / F32_OPS_PER_S,
             "tensor-core operations": tc_ops / BF16_TC_OPS_PER_S}
    by = max(times, key=times.get)
    return dict(bytes=float(nbytes), f32_ops=float(f32_ops),
                tc_ops=float(tc_ops), least_s=times[by], bound_by=by)
