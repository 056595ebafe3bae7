"""K12: the CKE edge flux as a one-hot connectivity product, computed on
the card over the cells each edge names.

Replaces cdk_tpu/kernels/cke/pallas_onehot.py::_kernel under the same
variant names:

  pallas_onehot       exact f32/f64 products, accumulated in cell order
  pallas_onehot_bf16  weights and table rounded to bf16, f32 accumulation
                      (the TPU's default-precision pass; f32 only)

The CUDA kernel is csrc/cke_onehot.cu: one warp per edge merges the edge's
slots into its distinct cells (each weight summed in slot order, as the
one-hot matrix holds it) and accumulates weight times tracer row over them
in ascending cell order, the dense product's order without its zero
terms.  Beside it here: `cke_onehot_plain`, the same one-hot product in
plain PyTorch (dense connectivity matrices built by scatter-add, then
`torch.matmul` in full f32: the CPU path, and what the card's kernel is
compared with), and the wrapper `cke_onehot`, which launches the kernel
for CUDA tensors and runs the plain version for CPU tensors.  Both sum in
cell order, not slot order, so they agree with each other and with the
reference at the family gate, not bitwise.
"""

from __future__ import annotations

import torch

from cdk_torch.core import build
from cdk_torch.core.registry import UnsupportedConfigError, register
from cdk_torch.core.trace import counted
from cdk_torch.kernels.cke.launch import check_inputs
from cdk_torch.kernels.cke.onehot_mxu import (
    apply_onehot,
    build_connectivity_matrices,
)
from cdk_torch.kernels.cke.problem import CkeData
from cdk_torch.kernels.cke.reference import coef3_of


def cke_onehot_plain(cells, c1, c3, t, ntf, adv_mask, coef3: float,
                     bf16: bool = False):
    """flx (E, K) = the one-hot product of the connectivity weights of
    cells (E, A) / c1, c3 (E, A) with the masked tracer table t (C, K),
    with the edge factors of ntf/adv_mask (E, K) applied."""
    a1, a3 = build_connectivity_matrices(cells, c1, c3, t.shape[0])
    if bf16:
        a1, a3 = a1.to(torch.bfloat16), a3.to(torch.bfloat16)
    return apply_onehot(a1, a3, t, ntf, adv_mask, coef3)


@counted
def cke_onehot(cells, c1, c3, t, ntf, adv_mask, coef3: float,
               bf16: bool = False):
    """The flux of cke_onehot_plain.  CUDA tensors launch the kernel (never
    anything else); CPU tensors run cke_onehot_plain."""
    e, a = cells.shape
    c, k = t.shape
    check_inputs("cke_onehot", t.dtype, t.device, cells=(cells, (e, a)),
                 c1=(c1, (e, a)), c3=(c3, (e, a)), t=(t, (c, k)),
                 ntf=(ntf, (e, k)), adv_mask=(adv_mask, (e, k)))
    if bf16 and t.dtype != torch.float32:
        raise TypeError("cke_onehot: the bf16 form is a float32 form")
    if t.device.type == "cpu":
        return cke_onehot_plain(cells, c1, c3, t, ntf, adv_mask, coef3, bf16)
    out = torch.empty_like(ntf)
    args = (cells, c1, c3, t, ntf, adv_mask, out, e, c, a, k, coef3)
    if t.dtype == torch.float32:
        build.launch(cke_onehot, 1, "cke_onehot", "cdk_cke_onehot_f32", t.device,
                     *args, int(bf16))
    else:
        build.launch(cke_onehot, 1, "cke_onehot", "cdk_cke_onehot_f64", t.device,
                     *args)
    return out


def _make_pallas(cfg, bf16: bool):
    c3 = coef3_of(cfg)
    # in-kernel one-hot applicability, the JAX package's guard: the dense
    # product costs O(nedges*ncells*nvert) per iteration, and at the
    # production 256k x 28k size the JAX run ran out of memory; typed skip
    # (gather_peradv is the production exact form)
    if cfg.nedges * cfg.ncells > 200_000_000:
        raise UnsupportedConfigError(
            f"pallas_onehot: O(nedges*ncells) one-hot rebuild infeasible "
            f"at {cfg.nedges}x{cfg.ncells}; use gather_peradv"
        )

    def step(data: CkeData) -> torch.Tensor:
        return cke_onehot(data.adv_cells, data.adv_coefs, data.adv_coefs3,
                          data.tracer * data.cell_mask, data.ntf,
                          data.adv_mask, c3, bf16)

    return step


@register(
    "cke",
    "pallas_onehot",
    "fused one-hot kernel: each edge's connectivity weights merged on chip "
    "in slot order, times the masked-tracer rows of the cells it names, "
    "accumulated in ascending cell order (the one-hot product without its "
    "zero terms)",
)
def make_pallas_onehot(cfg):
    return _make_pallas(cfg, bf16=False)


@register(
    "cke",
    "pallas_onehot_bf16",
    "fused one-hot kernel with bf16 weights and table, f32 accumulation "
    "(speed point)",
    supports_f64=False,
    fast_math=True,
)
def make_pallas_onehot_bf16(cfg):
    return _make_pallas(cfg, bf16=True)
