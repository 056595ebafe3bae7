"""CKE (MPAS-Ocean nested-loop) problem data: shapes, deterministic init.

Reference semantics (nested_loops/nested.F90, nested_vars.F90), as in the
JAX package's `cdk_tpu/kernels/cke/problem.py`:
  - per-cell: minLevelCell=1, maxLevelCell random in [3, nVertLevels] with
    ~half at max depth (nested.F90:59-68); tracerCur = 15·rand inside
    [kmin, kmax] else 0, cellMask 1/0 (:71-83).
  - per-edge: advCellsForEdge random cell ids (worst-case gather locality
    by design, :51-57, 87-97); advCoefs = 20·rand, advCoefs3rd = 21·rand
    (:90-96); normalThicknessFlux = 15·(0.5 − rand), advMaskHighOrder = 1
    (:100-107).
  - the reference does not seed its RNG (:64); both packages draw from the
    same documented PCG64 stream, so host inputs are bitwise equal.

Layout is the JAX package's: C-order (nEdges, nAdv) / (nEdges, nVertLevels)
/ (nCells, nVertLevels) with the vertical column innermost, 0-based cell
indices.

Two settings of the port's own (CkeConfig's init-only `mesh` and
`ntracers`): on the "planar_hex" mesh advCellsForEdge is MPAS-Ocean's
stencil on that mesh (`mesh.py`) and its random draw is left out, every
other draw in the same order; with ntracers T > 1 the tracer is a group
(T, nCells, nVertLevels), each tracer's table contiguous as tracerCur is,
drawn in one call where the one table was.  A variant's step takes one
table, or a whole group where it is marked `takes_group`; the family's
loop runs it over a group with `each_tracer`, into (T, nEdges,
nVertLevels), every tracer's flux from its own table.
"""

from __future__ import annotations

from dataclasses import dataclass, fields, replace
from typing import Mapping

import numpy as np
import torch

from cdk_torch.core.config import CkeConfig
from cdk_torch.core.frng import HostRng
from cdk_torch.core.trace import count
from cdk_torch.kernels.cke import mesh as _mesh

_INT_FIELDS = ("adv_cells", "min_level", "max_level")


@dataclass
class CkeData:
    """Problem tensors, C-order, 0-based cell indices.

    adv_cells:   (nedges, nadv) int32 — contributing cell per (edge, i)
    adv_coefs:   (nedges, nadv)       — 2nd-order weights
    adv_coefs3:  (nedges, nadv)       — 3rd-order weights (× coef3rdOrder)
    tracer:      (ncells, nvert)      — zero outside [kmin, kmax]; a
                 group: (ntracers, ncells, nvert)
    cell_mask:   (ncells, nvert)      — 1 inside [kmin, kmax], else 0
    ntf:         (nedges, nvert)      — normalThicknessFlux
    adv_mask:    (nedges, nvert)      — advMaskHighOrder (all ones)
    min_level:   (ncells,) int32      — 0-based kmin (all zero)
    max_level:   (ncells,) int32      — 0-based kmax (inclusive)
    """

    adv_cells: torch.Tensor
    adv_coefs: torch.Tensor
    adv_coefs3: torch.Tensor
    tracer: torch.Tensor
    cell_mask: torch.Tensor
    ntf: torch.Tensor
    adv_mask: torch.Tensor
    min_level: torch.Tensor
    max_level: torch.Tensor

    def to(self, *args, **kwargs) -> "CkeData":
        """Tensor.to on the float fields (device and/or dtype); the integer
        fields only follow them to their device and stay int32, as the JAX
        package's `astype` leaves them."""
        moved = {f.name: getattr(self, f.name).to(*args, **kwargs)
                 for f in fields(self) if f.name not in _INT_FIELDS}
        dev = moved["tracer"].device
        moved.update({name: getattr(self, name).to(dev)
                      for name in _INT_FIELDS})
        return CkeData(**moved)


def takes_group(step2):
    """Marks `step2` as a step that takes a (T, C, K) tracer group whole,
    returns its (T, E, K) flux and counts its own `cke_mesh_passes`
    (`each_tracer`)."""
    step2.takes_group = True
    return step2


def each_tracer(step2, aux, data: CkeData) -> torch.Tensor:
    """One step of a CKE variant, `step2(aux, data)`, over data whose
    tracer is one (C, K) table or a group (T, C, K).  A step marked
    `takes_group` (`pallas_rows`') is handed the data as it is; any other
    takes one table and runs once per tracer, on that tracer's own table,
    its flux copied into the tracer's slice of (T, E, K).  Each run is
    one pass over the edge fields (connectivity, coefficients, ntf,
    advMask): counter `cke_mesh_passes`."""
    if getattr(step2, "takes_group", False):
        return step2(aux, data)
    if data.tracer.dim() == 2:
        count("cke_mesh_passes")
        return step2(aux, data)
    out = data.ntf.new_empty((data.tracer.shape[0], *data.ntf.shape))
    for dst, tracer in zip(out, data.tracer):
        count("cke_mesh_passes")
        dst.copy_(step2(aux, replace(data, tracer=tracer)))
    return out


def from_numpy(arrays: Mapping[str, np.ndarray], device="cpu",
               dtype: torch.dtype = torch.float64) -> CkeData:
    """CkeData from a mapping of field name -> array (e.g. the JAX
    package's problem arrays): the float fields cast to `dtype`, the
    integer fields int32, all placed on `device`."""
    out = {}
    for f in fields(CkeData):
        a = np.asarray(arrays[f.name])
        if f.name in _INT_FIELDS:
            out[f.name] = torch.from_numpy(a.astype(np.int32)).to(device)
        else:
            out[f.name] = torch.from_numpy(a.astype(np.float64)).to(
                device=device, dtype=dtype)
    return CkeData(**out)


def init_data(cfg: CkeConfig = CkeConfig(), device="cpu") -> CkeData:
    """Deterministic init.  Host path (default): one PCG64 stream in the
    JAX package's draw order depth, tracer, adv_cells, adv_coefs,
    adv_coefs3, ntf; the tensors stay on the CPU and the caller stages
    them.  With cfg.device_init the same structure is drawn on `device`
    from a seeded torch.Generator."""
    if cfg.device_init:
        return _init_data_device(cfg, torch.device(device))
    gen = HostRng(cfg.seed)
    c, e, kv, a = cfg.ncells, cfg.nedges, cfg.nvertlevels, cfg.nadv
    group = (cfg.ntracers,) if cfg.ntracers > 1 else ()

    # topography: depth = min(max(3, round(rand·2·nVert)), nVert)  (1-based)
    depth = np.minimum(
        np.maximum(3, np.rint(gen.uniform(c) * kv * 2.0).astype(np.int64)), kv
    )
    min_level = np.zeros(c, np.int32)
    max_level = (depth - 1).astype(np.int32)  # 0-based inclusive

    k_idx = np.arange(kv)[None, :]
    active = (k_idx >= min_level[:, None]) & (k_idx <= max_level[:, None])
    tracer = np.where(active, 15.0 * gen.uniform((*group, c, kv)), 0.0)
    cell_mask = active.astype(np.float64)

    if cfg.mesh == "planar_hex":
        adv_cells = _mesh.adv_cells_for_edge(
            _mesh.planar_hex(cfg.nx, cfg.ny)).numpy()
    else:
        adv_cells = np.minimum(
            (c * gen.uniform((e, a))).astype(np.int64), c - 1
        ).astype(np.int32)
    adv_coefs = 20.0 * gen.uniform((e, a))
    adv_coefs3 = 21.0 * gen.uniform((e, a))

    ntf = 15.0 * (0.5 - gen.uniform((e, kv)))
    adv_mask = np.ones((e, kv))
    return from_numpy(dict(
        adv_cells=adv_cells, adv_coefs=adv_coefs, adv_coefs3=adv_coefs3,
        tracer=tracer, cell_mask=cell_mask, ntf=ntf, adv_mask=adv_mask,
        min_level=min_level, max_level=max_level), dtype=cfg.torch_dtype)


def _init_data_device(cfg: CkeConfig, device: torch.device) -> CkeData:
    """float32 uniforms from one seeded generator, in the host draw order,
    cast to the working dtype: random topography depth, masked tracer(s),
    random connectivity (or the mesh's)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(cfg.seed)
    dt = cfg.torch_dtype
    c, e, kv, a = cfg.ncells, cfg.nedges, cfg.nvertlevels, cfg.nadv
    group = (cfg.ntracers,) if cfg.ntracers > 1 else ()

    def u(*shape):
        return torch.rand(shape, generator=gen, device=device,
                          dtype=torch.float32)

    depth = torch.clamp(torch.round(u(c) * kv * 2.0).to(torch.int32), 3, kv)
    min_level = torch.zeros(c, dtype=torch.int32, device=device)
    max_level = depth - 1
    k_idx = torch.arange(kv, device=device)[None, :]
    active = (k_idx >= min_level[:, None]) & (k_idx <= max_level[:, None])
    tracer = torch.where(active, 15.0 * u(*group, c, kv), 0.0).to(dt)
    cell_mask = active.to(dt)
    if cfg.mesh == "planar_hex":
        adv_cells = _mesh.adv_cells_for_edge(
            _mesh.planar_hex(cfg.nx, cfg.ny, device))
    else:
        adv_cells = torch.randint(0, c, (e, a), generator=gen, device=device,
                                  dtype=torch.int32)
    return CkeData(
        adv_cells,
        (20.0 * u(e, a)).to(dt),
        (21.0 * u(e, a)).to(dt),
        tracer,
        cell_mask,
        (15.0 * (0.5 - u(e, kv))).to(dt),
        torch.ones((e, kv), dtype=dt, device=device),
        min_level,
        max_level,
    )
