"""Device selection.

The port runs on an sm_90 (Hopper) card, or on the CPU, where every kernel
wrapper takes its plain PyTorch version.  There is no emulation mode: a
CUDA request on a machine without a Hopper card is an error, never a
silent fall-back to the CPU.
"""

from __future__ import annotations

import torch

HOPPER = (9, 0)


def resolve_device(name: str | torch.device) -> torch.device:
    """`cpu` or `cuda[:i]` -> torch.device; a CUDA device must exist and
    be compute capability 9.0, else this raises RuntimeError."""
    dev = torch.device(name)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise RuntimeError(f"unsupported device {name!r} (cpu or cuda)")
    if not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch sees no CUDA "
                           "device")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    cap = torch.cuda.get_device_capability(dev)
    if cap != HOPPER:
        raise RuntimeError(
            f"{torch.cuda.get_device_name(dev)} has compute capability "
            f"{cap}; the kernels are built for sm_90a (Hopper)")
    return dev


def exact_fp32() -> None:
    """Keep float32 matrix products and convolutions in full float32 on the
    card (no TF32).  The kernels' plain versions and the driver (which runs
    the references) call this, so a comparison with a kernel is against
    true f32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def synchronize(device: torch.device) -> None:
    """Wait for the device's queued work (no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def describe(device: torch.device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"
