"""MPDATA advect_scalar2D problem data: shapes, halos, deterministic init.

Reference semantics (mmf-mpdata-tracer/advect_scalar2D_pushncols_openacc.F90):
  - fields (slice index first, j==1 dropped):
      f   (nslices, i=-2..nx+3, k=1..nzm)   scalar tracer, 2/3-wide x halo
      u   (nslices, i=-1..nx+3, k=1..nzm)   horizontal mass flux at x-faces
      w   (nslices, i=-1..nx+2, k=1..nz )   vertical mass flux at z-faces
      rho (nslices, k=1..nzm), rhow (nslices, k=1..nz), adz (nslices, k=1..nzm)
      flux(nslices, k=1..nz)                 domain-summed vertical flux
    (array bounds advect_scalar2D…F90:16-38)
  - init: one documented PCG64 stream (the JAX package's, so host inputs
    are bitwise equal across the two packages), u and w signed in
    [-0.5, 0.5), rho/rhow/adz in [0.5, 1.5).

Layout is the JAX package's canonical C-order (nslices, x, z), z innermost.
Python x-index conventions (0-based offsets from the Fortran lower bounds):
  f :  ix = i + 2   (i in [-2, nx+3], size nx+6)
  u :  ix = i + 1   (i in [-1, nx+3], size nx+5)
  w :  ix = i + 1   (i in [-1, nx+2], size nx+4)
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Mapping

import numpy as np
import torch

from cdk_torch.core.config import MpdataConfig
from cdk_torch.core.frng import HostRng


@dataclass
class MpdataData:
    """Problem tensors, C-order (nslices, x, z).

    f:    (nslices, nx+6, nzm)
    u:    (nslices, nx+5, nzm)
    w:    (nslices, nx+4, nz)
    rho:  (nslices, nzm)
    rhow: (nslices, nz)
    adz:  (nslices, nzm)
    flux: (nslices, nz)   — input values; a step overwrites k<nzm and
                            passes k=nz-1 through (the reference never
                            writes flux(:,nz), advect…F90:540-547)
    """

    f: torch.Tensor
    u: torch.Tensor
    w: torch.Tensor
    rho: torch.Tensor
    rhow: torch.Tensor
    adz: torch.Tensor
    flux: torch.Tensor

    def to(self, *args, **kwargs) -> "MpdataData":
        """Tensor.to on every field (device and/or dtype)."""
        return MpdataData(**{f.name: getattr(self, f.name).to(*args, **kwargs)
                             for f in fields(self)})


def from_numpy(arrays: Mapping[str, np.ndarray], device="cpu",
               dtype: torch.dtype = torch.float64) -> MpdataData:
    """MpdataData from a mapping of field name -> array (e.g. the JAX
    package's problem arrays), cast to `dtype` and placed on `device`."""
    return MpdataData(**{
        f.name: torch.from_numpy(np.array(arrays[f.name], np.float64))
        .to(device=device, dtype=dtype)
        for f in fields(MpdataData)
    })


def init_data(cfg: MpdataConfig = MpdataConfig(), device="cpu") -> MpdataData:
    """Deterministic init.  Host path (default): one PCG64 stream in the
    reference's draw order adz, f, u, w, rho, rhow, flux
    (advect…F90:654-660); the tensors stay on the CPU and the caller
    stages them.  With cfg.device_init the same shapes and distributions
    are drawn on `device` from a seeded torch.Generator."""
    if cfg.device_init:
        return _init_data_device(cfg, torch.device(device))
    gen = HostRng(cfg.seed)
    s, nx, nz, nzm = cfg.nslices, cfg.nx, cfg.nz, cfg.nzm
    adz = gen.uniform((s, nzm)) + 0.5
    f = gen.uniform((s, nx + 6, nzm))
    u = gen.uniform((s, nx + 5, nzm)) - 0.5
    w = gen.uniform((s, nx + 4, nz)) - 0.5
    rho = gen.uniform((s, nzm)) + 0.5
    rhow = gen.uniform((s, nz)) + 0.5
    flux = gen.uniform((s, nz))
    return from_numpy(dict(f=f, u=u, w=w, rho=rho, rhow=rhow, adz=adz,
                           flux=flux), dtype=cfg.torch_dtype)


def _init_data_device(cfg: MpdataConfig, device: torch.device) -> MpdataData:
    """float32 uniforms from one seeded generator, in the host draw order,
    cast to the working dtype and shifted like the host fields."""
    gen = torch.Generator(device=device)
    gen.manual_seed(cfg.seed)
    s, nx, nz, nzm = cfg.nslices, cfg.nx, cfg.nz, cfg.nzm

    def u(*shape, shift=0.0):
        x = torch.rand(shape, generator=gen, device=device,
                       dtype=torch.float32).to(cfg.torch_dtype)
        return x + shift if shift else x

    adz = u(s, nzm, shift=0.5)
    f = u(s, nx + 6, nzm)
    uu = u(s, nx + 5, nzm, shift=-0.5)
    w = u(s, nx + 4, nz, shift=-0.5)
    rho = u(s, nzm, shift=0.5)
    rhow = u(s, nz, shift=0.5)
    flux = u(s, nz)
    return MpdataData(f, uu, w, rho, rhow, adz, flux)
