"""What the four CKE kernel wrappers (K3, K11, K12, K13) share: the input
checks.  Each launches its `_f32` or `_f64` entry point (by the output's
dtype) through `core.build.launch`: its tensors' device pointers, then int
sizes, then coef3rdOrder as a double (a value of the working dtype) and,
for K12's f32 entry, the bf16 flag.
"""

from __future__ import annotations

import torch

FLOATS = (torch.float32, torch.float64)


def check_inputs(what: str, dtype: torch.dtype, device: torch.device,
                 **fields: tuple[torch.Tensor, tuple[int, ...]]) -> None:
    """Each field is (tensor, wanted shape).  Fields named `cells*` are
    int32 cell indices; the others share `dtype`, float32 or float64.  All
    lie on `device`; on a card they must be contiguous."""
    if dtype not in FLOATS:
        raise TypeError(f"{what} takes float32 or float64, not {dtype}")
    for name, (t, shape) in fields.items():
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{what}: {name} has shape {tuple(t.shape)}, "
                             f"want {tuple(shape)}")
        want = torch.int32 if name.startswith("cells") else dtype
        if t.dtype != want or t.device != device:
            raise TypeError(f"{what}: {name} is {t.dtype} on {t.device}; "
                            f"want {want} on {device}")
        if device.type == "cuda" and not t.is_contiguous():
            raise ValueError(f"{what} needs contiguous inputs ({name} is not)")
