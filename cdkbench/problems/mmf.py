"""SAM MPDATA advect_scalar2D: the inputs of a cell, made on the card from the
seed, and how they map onto the program's config and data.

Fields (C order, slice first): f (S, nx+6, nzm), the state; u (S, nx+5,
nzm); w (S, nx+4, nz); rho, adz (S, nzm); rhow, flux (S, nz).

u and w come from a streamfunction psi (S, nx+5, nz) that is zero on the
bottom and top interfaces: u = (psi[k+1] - psi[k]) / adz and w[i] = psi[i]
- psi[i+1].  Then every cell's upwind update of a constant field is zero
(u[i] - u[i-1] + (w[k+1] - w[k]) / adz = 0), so MPDATA, which is monotone,
keeps f inside its initial bounds over any number of steps.
"""

from __future__ import annotations

import torch

FIELDS = ("f", "u", "w", "rho", "rhow", "adz", "flux")
OUTPUTS = ("f", "flux")
# output -> the field of the program's data it becomes when an interval
# hands its state to the next
STATE = {"f": "f", "flux": "flux"}
# the CPU tests' sizes over the configuration's: 4 CRMs of 8 columns and 12
# levels
TINY = dict(nslices=4, nx=8, nz=12)
DTYPES = {"float32": torch.float32, "float64": torch.float64}


def make(cfg: dict, seed: int, device) -> dict:
    """One torch.Generator on `device` seeded by `seed`, in the order f,
    flux, rho, rhow, adz, psi; the arithmetic in float64, then the config's
    dtype."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    s, nx, nz = cfg["nslices"], cfg["nx"], cfg["nz"]
    nzm = nz - 1
    rng = cfg["inputs"]

    def u(name, *shape):
        lo, hi = rng[name]
        x = torch.rand(shape, generator=gen, device=device, dtype=torch.float64)
        return lo + (hi - lo) * x

    f, flux = u("f", s, nx + 6, nzm), u("flux", s, nz)
    rho, rhow, adz = u("rho", s, nzm), u("rhow", s, nz), u("adz", s, nzm)
    psi = u("psi", s, nx + 5, nz)
    psi[..., 0] = 0.0
    psi[..., -1] = 0.0
    uu = (psi[..., 1:] - psi[..., :-1]) / adz[:, None, :]
    w = psi[:, :-1] - psi[:, 1:]
    dtype = DTYPES[cfg["dtype"]]
    return {k: v.to(dtype).contiguous() for k, v in
            dict(f=f, u=uu, w=w, rho=rho, rhow=rhow, adz=adz, flux=flux).items()}


def to_program(cfg: dict, raw: dict):
    """-> (the program's MpdataConfig, its MpdataData) over the same
    tensors."""
    from cdk_torch.core.config import MpdataConfig
    from cdk_torch.kernels.mpdata.problem import MpdataData

    pcfg = MpdataConfig(nslices=cfg["nslices"], nz=cfg["nz"], nx=cfg["nx"],
                        dtype=cfg["dtype"], device_init=True)
    return pcfg, MpdataData(**{k: raw[k] for k in FIELDS})


def named(result) -> dict:
    """The program's loop result (f, flux) by output name."""
    f, flux = result
    return {"f": f, "flux": flux}
