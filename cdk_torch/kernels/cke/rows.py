"""K3: the CKE edge flux by per-(edge, slot) row reads of the masked tracer
table, a block's threads over its edges' (edge, 16-byte level group) pairs.

Replaces cdk_tpu/kernels/cke/pallas_rows.py::_kernel under the same variant
name, `pallas_rows` (experimental, as in the JAX package).  The TPU kernel's
128-lane level padding and edge-block divisibility are not carried over.

The CUDA kernel is csrc/cke_rows.cu: a block loads its tile of edges'
cells and coefficients once into shared memory, and each thread gathers the
rows of one (edge, level group) pair with vector loads, all of an edge's
slot rows in flight before the slot-order accumulation, the table kept in
L2 and the other streams read and written evict-first.  Its bound is the
bytes, each input read once and the output written once (0.104 ms at the
production size on an H100); the gathered rows, E * A * K values from L2,
set the floor a gather can approach.  Beside it here: `cke_rows_plain`, the
slot-order gather-accumulate in plain PyTorch, which is the champion
`gather_peradv`'s own computation (the CPU path, and what the card's kernel
is compared with: the two are bitwise equal), and the wrapper `cke_rows`,
which launches the kernel for CUDA tensors and runs the plain version for
CPU tensors.  The variant's step takes a tracer group whole: one launch of
K3g (`group.py`) where the tile map its set-up made fits, K3 once a tracer
elsewhere.
"""

from __future__ import annotations

import torch

from cdk_torch.core import build
from cdk_torch.core.registry import register
from cdk_torch.core.trace import count, counted, span
from cdk_torch.kernels.cke import group
from cdk_torch.kernels.cke.gather_peradv import gather_flux as cke_rows_plain
from cdk_torch.kernels.cke.launch import check_inputs
from cdk_torch.kernels.cke.problem import CkeData, takes_group
from cdk_torch.kernels.cke.reference import coef3_of


@counted
def cke_rows(cells, c1, c3, t, ntf, adv_mask, coef3: float, out=None):
    """The flux of cke_rows_plain, written into `out` (E, K) where given
    (a tracer group's slice) and returned.  CUDA tensors launch the kernel
    (never anything else); CPU tensors run cke_rows_plain.  Cell indices
    lie in [0, C)."""
    e, a = cells.shape
    c, k = t.shape
    outs = {} if out is None else {"out": (out, (e, k))}
    check_inputs("cke_rows", t.dtype, t.device, cells=(cells, (e, a)),
                 c1=(c1, (e, a)), c3=(c3, (e, a)), t=(t, (c, k)),
                 ntf=(ntf, (e, k)), adv_mask=(adv_mask, (e, k)), **outs)
    if t.device.type == "cpu":
        flx = cke_rows_plain(cells, c1, c3, t, ntf, adv_mask, coef3)
        return flx if out is None else out.copy_(flx)
    if out is None:
        out = torch.empty_like(ntf)
    build.launch(cke_rows, 1, "cke_rows", "cdk_cke_rows_f32"
                 if t.dtype == torch.float32 else "cdk_cke_rows_f64", t.device,
                 cells, c1, c3, t, ntf, adv_mask, out, e, c, a, k, coef3)
    return out


@register(
    "cke",
    "pallas_rows",
    "per-(edge,slot) row reads of the masked tracer table, threads over "
    "(edge, level vector) pairs with an edge's slot rows in flight, "
    "slot-order accumulate (exact; the cke_impl2 team-scratch analog)",
    experimental=True,
)
def make_pallas_rows(cfg):
    """(prepare, step2): the set-up keeps K3g's tile map (`group.tiles`,
    built here for a group); step2 takes one table or a whole group
    (`problem.takes_group`).  A group whose map fits is one K3g launch
    (counters `cke_mesh_passes` and `cke_group_launches`); one table, or a
    group whose map does not fit, runs K3 once a table, each on its masked
    table built under span `cdk.cke.mask`, into its tracer's slice of the
    (T, E, K) flux (one `cke_mesh_passes` a table)."""
    c3 = coef3_of(cfg)

    def prepare(data: CkeData):
        get = group.tiles()
        if data.tracer.dim() == 3:
            get(data.adv_cells, data.tracer)
        return get

    def k3(data: CkeData, tracer, out=None) -> torch.Tensor:
        count("cke_mesh_passes")
        with span("cdk.cke.mask"):
            t = tracer * data.cell_mask
        return cke_rows(data.adv_cells, data.adv_coefs, data.adv_coefs3, t,
                        data.ntf, data.adv_mask, c3, out)

    @takes_group
    def step2(get, data: CkeData) -> torch.Tensor:
        if data.tracer.dim() == 2:
            return k3(data, data.tracer)
        _, c, k = data.tracer.shape
        tm = get(data.adv_cells, data.tracer)
        if group.fits(tm, c, k, data.adv_cells.shape[1], data.tracer.dtype):
            count("cke_mesh_passes")
            count("cke_group_launches")
            return group.cke_group(tm, data.adv_coefs, data.adv_coefs3,
                                   data.tracer, data.cell_mask, data.ntf,
                                   data.adv_mask, c3)
        out = data.ntf.new_empty((data.tracer.shape[0], *data.ntf.shape))
        for dst, tracer in zip(out, data.tracer):
            k3(data, tracer, dst)
        return out

    return prepare, step2
