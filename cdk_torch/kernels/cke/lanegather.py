"""K13: the CKE edge flux on a transposed, level-major tracer table.

Replaces cdk_tpu/kernels/cke/pallas_lanegather.py::_kernel under the same
variant name, `pallas_lanegather` (experimental, as in the JAX package).
The interface is the TPU kernel's: table (K, C), slot arrays (A, E), edge
factors and output (K, E), transposed back by the variant.  Its 128-cell
lane groups and select tree are not carried over.

The CUDA kernel is csrc/cke_lanegather.cu, two kernels behind one entry
point: a tiled transpose of the table into a cell-major (C, K) scratch that
the wrapper allocates, then a block per tile of 128 bytes of edges across
all levels, which reads the tile's slot arrays once, gathers whole rows of
levels with K3's core and turns its sums around in shared memory, so the
(K, E) reads and writes run along e.  Its bound is the bytes, each input
read once and the output written once (0.104 ms at the production size on
an H100); the gathered rows, E * A * K values from L2, set the floor a
gather can approach.  Beside it here: `cke_lanegather_plain`, the same
level-major slot-order accumulation in plain PyTorch (the CPU path, and
what the card's kernel is compared with: the two are bitwise equal), and
the wrapper `cke_lanegather`, which launches the kernel for CUDA tensors
and runs the plain version for CPU tensors.
"""

from __future__ import annotations

import torch

from cdk_torch.core import build
from cdk_torch.core.registry import register
from cdk_torch.core.trace import counted
from cdk_torch.kernels.cke.launch import check_inputs
from cdk_torch.kernels.cke.problem import CkeData
from cdk_torch.kernels.cke.reference import coef3_of, fsign1


def cke_lanegather_plain(cells_t, c1t, c3t, tm_t, ntfm_t, sgn_t,
                         coef3: float):
    """flx^T (K, E) from cells_t (A, E) int32, c1t/c3t (A, E), the
    transposed masked table tm_t (K, C), ntfm_t = (ntf·advMask)^T and
    sgn_t = sign(1, ntf)^T (K, E), accumulated in slot order."""
    s1 = torch.zeros_like(ntfm_t)
    s3 = torch.zeros_like(ntfm_t)
    for i in range(cells_t.shape[0]):
        g = torch.index_select(tm_t, 1, cells_t[i])  # (K, E)
        s1 = s1 + c1t[i] * g
        s3 = s3 + c3t[i] * g
    return ntfm_t * (s1 + coef3 * s3 * sgn_t)


@counted
def cke_lanegather(cells_t, c1t, c3t, tm_t, ntfm_t, sgn_t, coef3: float):
    """The flux of cke_lanegather_plain, (K, E).  CUDA tensors launch the
    kernel (never anything else); CPU tensors run cke_lanegather_plain.
    Cell indices lie in [0, C)."""
    a, e = cells_t.shape
    k, c = tm_t.shape
    check_inputs("cke_lanegather", tm_t.dtype, tm_t.device,
                 cells_t=(cells_t, (a, e)), c1t=(c1t, (a, e)),
                 c3t=(c3t, (a, e)), tm_t=(tm_t, (k, c)),
                 ntfm_t=(ntfm_t, (k, e)), sgn_t=(sgn_t, (k, e)))
    if tm_t.device.type == "cpu":
        return cke_lanegather_plain(cells_t, c1t, c3t, tm_t, ntfm_t, sgn_t,
                                    coef3)
    if (k + 31) // 32 > 65535:
        raise ValueError(f"cke_lanegather: nvert={k} exceeds the transpose "
                         f"grid's y extent (65535 tiles of 32 levels)")
    tab = torch.empty((c, k), dtype=tm_t.dtype, device=tm_t.device)
    out_t = torch.empty_like(ntfm_t)
    build.launch(cke_lanegather, 1, "cke_lanegather", "cdk_cke_lanegather_f32"
                 if tm_t.dtype == torch.float32 else "cdk_cke_lanegather_f64",
                 tm_t.device, cells_t, c1t, c3t, tm_t, ntfm_t, sgn_t, tab, out_t,
                 e, c, a, k, coef3)
    return out_t


@register(
    "cke",
    "pallas_lanegather",
    "level-major gather: transposed masked-tracer table (K, C), turned "
    "cell-major in the kernel, edge tiles across all levels gathering whole "
    "rows, slot-order accumulate, output (K, E) transposed back (exact)",
    experimental=True,
)
def make_pallas_lanegather(cfg):
    c3 = coef3_of(cfg)

    def prepare(data: CkeData):
        """The slot arrays and edge factors, transposed once (untimed)."""
        return (data.adv_cells.T.contiguous(), data.adv_coefs.T.contiguous(),
                data.adv_coefs3.T.contiguous(),
                (data.ntf * data.adv_mask).T.contiguous(),
                fsign1(data.ntf).T.contiguous())

    def step2(aux, data: CkeData) -> torch.Tensor:
        cells_t, c1t, c3t, ntfm_t, sgn_t = aux
        tm_t = (data.tracer * data.cell_mask).T.contiguous()
        out_t = cke_lanegather(cells_t, c1t, c3t, tm_t, ntfm_t, sgn_t, c3)
        return out_t.T.contiguous()

    return prepare, step2
