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
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Mapping

import numpy as np
import torch

from cdk_torch.core.config import CkeConfig
from cdk_torch.core.frng import HostRng

_INT_FIELDS = ("adv_cells", "min_level", "max_level")


@dataclass
class CkeData:
    """Problem tensors, C-order, 0-based cell indices.

    adv_cells:   (nedges, nadv) int32 — contributing cell per (edge, i)
    adv_coefs:   (nedges, nadv)       — 2nd-order weights
    adv_coefs3:  (nedges, nadv)       — 3rd-order weights (× coef3rdOrder)
    tracer:      (ncells, nvert)      — zero outside [kmin, kmax]
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

    # topography: depth = min(max(3, round(rand·2·nVert)), nVert)  (1-based)
    depth = np.minimum(
        np.maximum(3, np.rint(gen.uniform(c) * kv * 2.0).astype(np.int64)), kv
    )
    min_level = np.zeros(c, np.int32)
    max_level = (depth - 1).astype(np.int32)  # 0-based inclusive

    k_idx = np.arange(kv)[None, :]
    active = (k_idx >= min_level[:, None]) & (k_idx <= max_level[:, None])
    tracer = np.where(active, 15.0 * gen.uniform((c, kv)), 0.0)
    cell_mask = active.astype(np.float64)

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
    cast to the working dtype: random topography depth, masked tracer,
    random connectivity."""
    gen = torch.Generator(device=device)
    gen.manual_seed(cfg.seed)
    dt = cfg.torch_dtype
    c, e, kv, a = cfg.ncells, cfg.nedges, cfg.nvertlevels, cfg.nadv

    def u(*shape):
        return torch.rand(shape, generator=gen, device=device,
                          dtype=torch.float32)

    depth = torch.clamp(torch.round(u(c) * kv * 2.0).to(torch.int32), 3, kv)
    min_level = torch.zeros(c, dtype=torch.int32, device=device)
    max_level = depth - 1
    k_idx = torch.arange(kv, device=device)[None, :]
    active = (k_idx >= min_level[:, None]) & (k_idx <= max_level[:, None])
    tracer = torch.where(active, 15.0 * u(c, kv), 0.0).to(dt)
    cell_mask = active.to(dt)
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
