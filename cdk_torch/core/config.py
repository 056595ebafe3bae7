"""Typed problem configuration (the port of ``cdk_tpu.core.config``).

One frozen dataclass per kernel, the reference's ``nested.nml`` namelist
reader, and the production-scale presets.  Field names, defaults and
presets are those of the JAX package, so a config means the same problem
in both; only the dtype names map to torch dtypes.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, fields, replace
from pathlib import Path
from typing import Any

import torch

_DTYPES = {
    "float32": torch.float32,
    "float64": torch.float64,
    "bfloat16": torch.bfloat16,
}


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


@dataclass(frozen=True)
class BiharmonicConfig:
    """HOMME biharmonic_wk problem (reference biharmonic_wk_kernel.F90:10-17).

    np_gll=4 GLL points per element side, nlev vertical levels, qsize
    tracers, nelemd spectral elements. rrearth is 1/earth-radius."""

    np_gll: int = 4
    nlev: int = 72
    qsize: int = 40
    nelemd: int = 16
    rrearth: float = 0.00000016666666666666
    dtype: str = "float64"
    # generate inputs on the device from a torch.Generator instead of
    # transferring host arrays (production scale; forfeits the bit-exact
    # Fortran LCG stream, which only the shipped size needs for parity)
    device_init: bool = False

    @property
    def npts(self) -> int:  # GLL points per element level
        return self.np_gll * self.np_gll

    @property
    def ncol(self) -> int:  # fused (nlev, qsize) batch, reference's len=2880
        return self.nlev * self.qsize

    @property
    def grid_points(self) -> int:
        return self.npts * self.ncol * self.nelemd

    @property
    def torch_dtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)


@dataclass(frozen=True)
class MpdataConfig:
    """SAM MPDATA advect_scalar2D problem (reference advect…F90:7-29).

    nslices batched CRM columns, nx horizontal columns, nz interface levels
    (nzm = nz-1 scalar levels). Halo widths follow the reference's array
    bounds: scalars i in [-2, nx+3], u in [-1, nx+3], w in [-1, nx+2]."""

    nslices: int = 48
    nz: int = 58
    nx: int = 32
    seed: int = 100
    dtype: str = "float64"
    device_init: bool = False

    @property
    def nzm(self) -> int:
        return self.nz - 1

    @property
    def grid_points(self) -> int:  # interior points updated per step
        return self.nslices * self.nx * self.nzm

    @property
    def torch_dtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)


@dataclass(frozen=True)
class CkeConfig:
    """MPAS-Ocean nested-loop (CKE) problem (reference nested.nml:1-7,
    nested_vars.F90:28-36).  Its kernels are not ported yet; the config is
    here for the namelist reader."""

    niters: int = 100
    nedges: int = 25600
    ncells: int = 2800
    nvertlevels: int = 100
    nadv: int = 10
    coef3rdorder: float = 2.14
    errtol: float = 1.0e-10
    seed: int = 20260816
    dtype: str = "float64"
    device_init: bool = False

    @property
    def grid_points(self) -> int:
        return self.nedges * self.nvertlevels

    @property
    def torch_dtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)


_NML_KEYMAP = {
    "niters": "niters",
    "nedges": "nedges",
    "ncells": "ncells",
    "nvertlevels": "nvertlevels",
    "nadv": "nadv",
}


def read_namelist(path: str | Path, group: str = "nested_nml") -> dict[str, Any]:
    """Parse a Fortran namelist file (the reference's nested.nml format:
    `&group / key = value ... /`). Returns a dict of lowercase keys."""
    text = Path(path).read_text()
    m = re.search(rf"&{group}\b(.*?)(?:^|\n)\s*/", text, re.S | re.I)
    if not m:
        raise ValueError(f"namelist group &{group} not found in {path}")
    out: dict[str, Any] = {}
    for line in m.group(1).splitlines():
        line = line.split("!")[0].strip().rstrip(",")
        if not line or "=" not in line:
            continue
        key, val = (s.strip() for s in line.split("=", 1))
        key = key.lower()
        try:
            parsed: Any = int(val)
        except ValueError:
            try:
                parsed = float(val.replace("d", "e").replace("D", "e"))
            except ValueError:
                parsed = val.strip("'\"")
        out[key] = parsed
    return out


def cke_config_from_namelist(path: str | Path, **overrides) -> CkeConfig:
    """Build a CkeConfig from a reference-format nested.nml file."""
    nml = read_namelist(path)
    kwargs = {_NML_KEYMAP[k]: v for k, v in nml.items() if k in _NML_KEYMAP}
    kwargs.update(overrides)
    return CkeConfig(**kwargs)


def with_overrides(cfg, **kw):
    """Return a copy of a frozen config dataclass with fields replaced."""
    valid = {f.name for f in fields(cfg)}
    bad = set(kw) - valid
    if bad:
        raise ValueError(f"unknown config fields for {type(cfg).__name__}: {bad}")
    return replace(cfg, **kw)


# Production-scale presets, the JAX package's: ne120 cubed-sphere =
# 6*120^2 = 86,400 spectral elements; 5,400 of them per device with the
# E3SM-production 10-tracer set.  The MMF preset batches 8,192 CRM slices
# (the per-node column count of an MMF run).
PRODUCTION = {
    "biharmonic": lambda: BiharmonicConfig(
        nelemd=5400, qsize=10, dtype="float32", device_init=True
    ),
    "mpdata": lambda: MpdataConfig(nslices=8192, dtype="float32",
                                   device_init=True),
}


def production_config(kernel: str):
    return PRODUCTION[kernel]()
