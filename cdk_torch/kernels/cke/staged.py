"""K11: the CKE edge flux consumed from pre-gathered slot rows.

Replaces cdk_tpu/kernels/cke/staged.py::_consumer under the same variant
name, `staged_consume`.  The per-slot gathers run outside the kernel, as in
the JAX package (XLA there): one `index_select` per slot writes slot i's
rows straight into slice i of one preallocated (A, E, K) buffer, so no
restack copies them again (the JAX package measured a restack as an extra
full materialization).  The kernel then reads each staged row once.

The CUDA kernel is csrc/cke_staged.cu.  Beside it here:
`cke_staged_plain`, the slot-order consumer in plain PyTorch (the CPU path,
and what the card's kernel is compared with: the two are bitwise equal),
and the wrapper `cke_staged`, which launches the kernel for CUDA tensors and
runs the plain version for CPU tensors.
"""

from __future__ import annotations

import torch

from cdk_torch.core import build
from cdk_torch.core.registry import UnsupportedConfigError, register
from cdk_torch.core.trace import counted
from cdk_torch.kernels.cke.launch import check_inputs
from cdk_torch.kernels.cke.problem import CkeData
from cdk_torch.kernels.cke.reference import coef3_of, slot_order_flux


def stage_slots(t: torch.Tensor, cells: torch.Tensor,
                out: torch.Tensor) -> torch.Tensor:
    """out[i] = t[cells[:, i]] for every slot i; out is (A, E, K)."""
    for i in range(cells.shape[1]):
        torch.index_select(t, 0, cells[:, i], out=out[i])
    return out


def cke_staged_plain(staged, c1, c3, ntf, adv_mask, coef3: float):
    """flx (E, K) from the staged slot rows (A, E, K), c1/c3 (E, A) and
    ntf/adv_mask (E, K), accumulated in slot order."""
    return slot_order_flux(staged, c1, c3, ntf, adv_mask, coef3)


@counted
def cke_staged(staged, c1, c3, ntf, adv_mask, coef3: float):
    """The flux of cke_staged_plain.  CUDA tensors launch the kernel (never
    anything else); CPU tensors run cke_staged_plain."""
    a, e, k = staged.shape
    check_inputs("cke_staged", staged.dtype, staged.device,
                 staged=(staged, (a, e, k)), c1=(c1, (e, a)),
                 c3=(c3, (e, a)), ntf=(ntf, (e, k)),
                 adv_mask=(adv_mask, (e, k)))
    if staged.device.type == "cpu":
        return cke_staged_plain(staged, c1, c3, ntf, adv_mask, coef3)
    out = torch.empty_like(ntf)
    build.launch(cke_staged, 1, "cke_staged", "cdk_cke_staged_f32"
                 if staged.dtype == torch.float32 else "cdk_cke_staged_f64",
                 staged.device, staged, c1, c3, ntf, adv_mask, out, e, a, k,
                 coef3)
    return out


@register(
    "cke",
    "staged_consume",
    "per-slot index_selects staged once into slices of one (nAdv, E, K) "
    "buffer + a single-pass consumer kernel with register accumulators "
    "(exact; each gathered row written once and read once)",
)
def make_staged_consume(cfg):
    c3 = coef3_of(cfg)
    # staging applicability, the JAX package's guard: past ~512 MiB of
    # (nAdv, E, 128-padded K) staging the JAX variant ran out of chip
    # memory at the production 256k-edge size; typed skip
    kpad = -(-cfg.nvertlevels // 128) * 128
    if cfg.nadv * cfg.nedges * kpad * 4 > 512 * 2**20:
        raise UnsupportedConfigError(
            f"staged_consume: (nAdv, E, K) staging would be "
            f"{cfg.nadv * cfg.nedges * kpad * 4 / 2**30:.2f} GiB; "
            f"use gather_peradv at this scale"
        )

    def prepare(data: CkeData):
        """The staging buffer, allocated once (untimed); every step
        overwrites it."""
        e, a = data.adv_cells.shape
        return torch.empty((a, e, data.ntf.shape[1]),
                           dtype=data.tracer.dtype, device=data.tracer.device)

    def step2(buf, data: CkeData) -> torch.Tensor:
        staged = stage_slots(data.tracer * data.cell_mask, data.adv_cells, buf)
        return cke_staged(staged, data.adv_coefs, data.adv_coefs3, data.ntf,
                          data.adv_mask, c3)

    return prepare, step2
