"""HOMME biharmonic_wk: the inputs of a cell, made on the card from the seed,
and how they map onto the program's config and data.

Fields (C order): dvv (np, np); dinv, tensorvisc (nelemd, np, np, 2, 2);
spheremp (nelemd, np, np); qtens (nelemd, qsize, nlev, np, np), the state.
"""

from __future__ import annotations

import torch

FIELDS = ("dvv", "dinv", "spheremp", "tensorvisc", "qtens")
OUTPUTS = ("q",)
# output -> the field of the program's data it becomes when an interval
# hands its state to the next
STATE = {"q": "qtens"}
# the CPU tests' sizes over the configuration's: a 4 x 3 torus of 4-level,
# 2-tracer elements
TINY = dict(nelemd=12, nlev=4, qsize=2)
DTYPES = {"float32": torch.float32, "float64": torch.float64}


def shapes(cfg: dict) -> dict:
    n, e = cfg["np_gll"], cfg["nelemd"]
    return dict(dvv=(n, n), dinv=(e, n, n, 2, 2), spheremp=(e, n, n),
                tensorvisc=(e, n, n, 2, 2),
                qtens=(e, cfg["qsize"], cfg["nlev"], n, n))


def make(cfg: dict, seed: int, device) -> dict:
    """Each field uniform on its configured range, one torch.Generator on
    `device` seeded by `seed`, one call a field, in the config's dtype."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    dtype = DTYPES[cfg["dtype"]]
    out = {}
    for name, shape in shapes(cfg).items():
        lo, hi = cfg["inputs"][name]
        x = torch.rand(shape, generator=gen, device=device, dtype=torch.float64)
        out[name] = (lo + (hi - lo) * x).to(dtype)
    return out


def to_program(cfg: dict, raw: dict):
    """-> (the program's BiharmonicConfig, its BiharmonicData) over the same
    tensors."""
    from cdk_torch.core.config import BiharmonicConfig
    from cdk_torch.kernels.biharmonic.problem import BiharmonicData

    pcfg = BiharmonicConfig(np_gll=cfg["np_gll"], nlev=cfg["nlev"],
                            qsize=cfg["qsize"], nelemd=cfg["nelemd"],
                            rrearth=cfg["rrearth"], dtype=cfg["dtype"],
                            device_init=True)
    return pcfg, BiharmonicData(**{k: raw[k] for k in FIELDS})


def named(result) -> dict:
    """The program's loop result (qtens) by output name."""
    return {"q": result}
