"""One-hot-matmul CKE variant (the JAX package's
`cdk_tpu/kernels/cke/onehot_mxu.py`): the irregular gather recast as dense
matrix products.

The kernel is linear in tracerCur for fixed connectivity and weights, so
the whole per-edge gather-accumulate (nested.F90:533-552) collapses to two
dense matrices applied per iteration:

    A1[e, c] = Σ_i advCoefs(i,e)    · δ(advCellsForEdge(i,e) = c)
    A3[e, c] = Σ_i advCoefs3rd(i,e) · δ(advCellsForEdge(i,e) = c)
    flx      = wgt ⊙ (A1 @ T + coef3rdOrder · sgn ⊙ (A3 @ T)),
    T        = tracerCur ⊙ cellMask          (ncells, nvert)

A1/A3 are built once, untimed, by a scatter-add in which duplicate cells of
an edge accumulate; each iteration is two (nedges × ncells) · nvert
products.  In JAX these products are XLA dots outside any Pallas kernel,
so here they are plain `torch.matmul` calls (full f32 on the card:
`exact_fp32`).  The bf16 form stores A1/A3 in bf16 and multiplies bf16
operands with f32 accumulation, which is what the TPU's default-precision
pass computes.  Its plain helpers also serve as the plain version of K12
(`onehot.py`).
"""

from __future__ import annotations

import torch

from cdk_torch.core.platform import exact_fp32
from cdk_torch.core.registry import UnsupportedConfigError, register
from cdk_torch.kernels.cke.problem import CkeData
from cdk_torch.kernels.cke.reference import coef3_of, finish


def build_connectivity_matrices(adv_cells, adv_coefs, adv_coefs3, ncells):
    """-> (A1, A3), each (nedges, ncells): scatter-add of the per-(edge,i)
    weights onto their cell column (duplicate cells per edge accumulate,
    matching the reference's `flxTmp += …` loop, nested.F90:545-550)."""
    e, a = adv_cells.shape
    rows = torch.arange(e, device=adv_cells.device)[:, None].expand(e, a)
    cols = adv_cells.long()
    a1 = torch.zeros((e, ncells), dtype=adv_coefs.dtype,
                     device=adv_coefs.device)
    a3 = torch.zeros_like(a1)
    a1.index_put_((rows, cols), adv_coefs, accumulate=True)
    a3.index_put_((rows, cols), adv_coefs3, accumulate=True)
    return a1, a3


def apply_onehot(a1, a3, t, ntf, adv_mask, coef3rdorder):
    """flx from the connectivity matrices and the masked tracer t.  bf16
    matrices take t rounded to bf16 and accumulate in f32: the product of
    two bf16 values is exact in f32, so upcasting the operands and
    multiplying in full f32 is bf16-operand, f32-accumulate arithmetic."""
    exact_fp32()
    if a1.dtype == torch.bfloat16:
        t = t.to(torch.bfloat16).to(ntf.dtype)
        a1, a3 = a1.to(ntf.dtype), a3.to(ntf.dtype)
    s1 = torch.matmul(a1, t)
    s3 = torch.matmul(a3, t)
    return finish(s1, s3, ntf, adv_mask, coef3rdorder)


def _make_onehot(cfg, bf16: bool):
    c3 = coef3_of(cfg)
    # dense-recast applicability, the JAX package's guard: A1+A3 are
    # 2·nedges·ncells values, resident and streamed per iteration; at the
    # production 256k × 28k size that is ~57 GB, so past 2 GiB the variant
    # is a typed skip (gather_peradv is the production exact form)
    itemsize = 2 if bf16 else 4
    if 2 * cfg.nedges * cfg.ncells * itemsize > 2 * 2**30:
        raise UnsupportedConfigError(
            f"onehot_mxu: connectivity matrices would be "
            f"{2 * cfg.nedges * cfg.ncells * itemsize / 2**30:.1f} GiB; "
            f"use gather_peradv at this scale"
        )

    def prepare(data: CkeData):
        # untimed connectivity staging, the analog of cke_init's one-time
        # deep_copy (nested.F90:400-403 is under timerData)
        a1, a3 = build_connectivity_matrices(
            data.adv_cells, data.adv_coefs, data.adv_coefs3, cfg.ncells)
        if bf16:
            a1, a3 = a1.to(torch.bfloat16), a3.to(torch.bfloat16)
        return a1, a3

    def step2(aux, data: CkeData) -> torch.Tensor:
        a1, a3 = aux
        return apply_onehot(a1, a3, data.tracer * data.cell_mask, data.ntf,
                            data.adv_mask, c3)

    return prepare, step2


@register(
    "cke",
    "onehot_mxu",
    "gather recast as two dense (nedges x ncells) connectivity matmuls; "
    "connectivity matrices prebuilt untimed (the analog of cke_impl1's "
    "pack-SIMD flat form)",
)
def make_onehot_mxu(cfg):
    return _make_onehot(cfg, bf16=False)


@register(
    "cke",
    "onehot_mxu_bf16",
    "connectivity matmuls with bf16 operands and f32 accumulation: the "
    "explicit precision/throughput trade point",
    supports_f64=False,
    fast_math=True,
)
def make_onehot_mxu_bf16(cfg):
    return _make_onehot(cfg, bf16=True)
