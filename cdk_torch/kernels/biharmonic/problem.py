"""Biharmonic_wk problem data: shapes, deterministic init, layouts.

Reference semantics (atmosphere/biharmonic_wk_kernel.F90):
  - fields: Dvv(np,np) derivative matrix; per element Dinv(np,np,2,2),
    spheremp(np,np), tensorVisc(np,np,2,2); state qtens(np,np,nlev,qsize,
    nelemd) (:19-33).
  - init: myrandom LCG with reset, filling in the exact order
    Dvv, then per element (Dinv, spheremp, tensorVisc), then qtens
    (:48-58). `init_data` reproduces that stream bit-exactly, so the host
    inputs are bitwise those of the JAX package.

Layouts are the JAX package's: trailing (np, np) GLL axes for the
reference, and the "lane layout" (e, npts, ncol) with the fused
(qsize, nlev) batch innermost for the operator kernel.
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Mapping

import numpy as np
import torch

from cdk_torch.core.config import BiharmonicConfig
from cdk_torch.core.frng import Lcg
from cdk_torch.core.trace import span


@dataclass
class BiharmonicData:
    """Problem tensors, C order.

    dvv:        (np, np)                — indexed [i, l] like Fortran Dvv(i,l)
    dinv:       (nelemd, np, np, 2, 2)  — [e, i, j, a, b] ≙ Dinv(i,j,a+1,b+1)
    spheremp:   (nelemd, np, np)
    tensorvisc: (nelemd, np, np, 2, 2)
    qtens:      (nelemd, qsize, nlev, np, np) — [e, q, k, i, j]
    """

    dvv: torch.Tensor
    dinv: torch.Tensor
    spheremp: torch.Tensor
    tensorvisc: torch.Tensor
    qtens: torch.Tensor

    def to(self, *args, **kwargs) -> "BiharmonicData":
        """Tensor.to on every field (device and/or dtype)."""
        return BiharmonicData(**{f.name: getattr(self, f.name).to(*args, **kwargs)
                                 for f in fields(self)})


def from_numpy(arrays: Mapping[str, np.ndarray], device="cpu",
               dtype: torch.dtype = torch.float64) -> BiharmonicData:
    """BiharmonicData from a mapping of field name -> array (e.g. the JAX
    package's problem arrays), cast to `dtype` and placed on `device`."""
    return BiharmonicData(**{
        f.name: torch.from_numpy(np.array(arrays[f.name], np.float64))
        .to(device=device, dtype=dtype)
        for f in fields(BiharmonicData)
    })


def init_data(cfg: BiharmonicConfig = BiharmonicConfig(),
              device="cpu") -> BiharmonicData:
    """Deterministic init.  Host path (default): bit-identical to the
    reference initialize_data (biharmonic_wk_kernel.F90:48-58) — LCG reset
    to seed 11, then Dvv, per-element (Dinv, spheremp, tensorVisc), then
    qtens, each traversed in Fortran column-major order; the tensors stay
    on the CPU and the caller stages them.

    With cfg.device_init the tensors are drawn on `device` from a
    torch.Generator (same shapes and distributions; production scale,
    where host generation and transfer would dominate)."""
    if cfg.device_init:
        return _init_data_device(cfg, torch.device(device))
    n = cfg.np_gll
    gen = Lcg()
    dvv = gen.fill_fortran((n, n))
    dinv = np.empty((cfg.nelemd, n, n, 2, 2))
    spheremp = np.empty((cfg.nelemd, n, n))
    tensorvisc = np.empty((cfg.nelemd, n, n, 2, 2))
    for e in range(cfg.nelemd):
        dinv[e] = gen.fill_fortran((n, n, 2, 2))
        spheremp[e] = gen.fill_fortran((n, n))
        tensorvisc[e] = gen.fill_fortran((n, n, 2, 2))
    # Fortran qtens(i,j,k,q,ie) -> ours [e,q,k,i,j]
    q_f = gen.fill_fortran((n, n, cfg.nlev, cfg.qsize, cfg.nelemd))
    qtens = np.ascontiguousarray(q_f.transpose(4, 3, 2, 0, 1))
    return from_numpy(dict(dvv=dvv, dinv=dinv, spheremp=spheremp,
                           tensorvisc=tensorvisc, qtens=qtens),
                      dtype=cfg.torch_dtype)


def _init_data_device(cfg: BiharmonicConfig,
                      device: torch.device) -> BiharmonicData:
    """float32 uniforms in [0, 1) from one seeded generator, then cast."""
    gen = torch.Generator(device=device)
    gen.manual_seed(11)
    n = cfg.np_gll

    def u(*shape):
        return torch.rand(shape, generator=gen, device=device,
                          dtype=torch.float32).to(cfg.torch_dtype)

    return BiharmonicData(
        u(n, n),
        u(cfg.nelemd, n, n, 2, 2),
        u(cfg.nelemd, n, n),
        u(cfg.nelemd, n, n, 2, 2),
        u(cfg.nelemd, cfg.qsize, cfg.nlev, n, n),
    )


def to_lane_layout(qtens: torch.Tensor) -> torch.Tensor:
    """(e, q, k, i, j) -> contiguous (e, npts, ncol): GLL points in rows,
    the fused (q, k) batch innermost."""
    e, q, k, n, _ = qtens.shape
    with span("cdk.layout"):
        return qtens.reshape(e, q * k, n * n).transpose(1, 2).contiguous()


def from_lane_layout(q_lane: torch.Tensor, cfg: BiharmonicConfig) -> torch.Tensor:
    """Inverse of to_lane_layout."""
    e = q_lane.shape[0]
    n = cfg.np_gll
    with span("cdk.layout"):
        return q_lane.transpose(1, 2).reshape(e, cfg.qsize, cfg.nlev, n, n)
