"""The comparison that decides `correct`.

Each output the timed path produced is held against the benchmark's plain
reference (float64) by the family gate's own norm, which the family's
reference names as `NORM` (relative L2 on the biharmonic state, relative L1
on MPDATA's f and flux: the port's `harness/specs.py` norms, copied here),
and by the relative largest pointwise error, which a single wrong value
moves.  A number that is not
finite reads infinity.  Every number has its own limit (`limits/<cell>.json`),
set from readings of the program and of the control; a reading passes at or
below its limit.
"""

from __future__ import annotations

import math

import torch

def _finite(x: float) -> float:
    return x if math.isfinite(x) else math.inf


def rel_l2(x: torch.Tensor, ref: torch.Tensor) -> float:
    """sqrt(sum((x - ref)^2) / sum(ref^2)), in float64 (the absolute norm
    where ref is all zero)."""
    d = x.double() - ref.double()
    num, den = float((d * d).sum()), float((ref.double() ** 2).sum())
    return _finite(math.sqrt(num / den if den > 0 else num))


def rel_l1(x: torch.Tensor, ref: torch.Tensor) -> float:
    """sum(|x - ref|) / sum(|ref|), in float64."""
    num = float((x.double() - ref.double()).abs().sum())
    den = float(ref.double().abs().sum())
    return _finite(num / den if den > 0 else num)


def rel_linf(x: torch.Tensor, ref: torch.Tensor) -> float:
    """max |x - ref| / max |ref|, in float64."""
    num = float((x.double() - ref.double()).abs().max())
    den = float(ref.double().abs().max())
    return _finite(num / den if den > 0 else num)


def readings(norm: str, outs: dict, ref: dict) -> dict:
    """name -> number for every output: `<output>.<norm>`, the gate norm
    (`rel_l2` or `rel_l1`, the family reference's NORM), and
    `<output>.rel_linf`."""
    gate = {"rel_l2": rel_l2, "rel_l1": rel_l1}[norm]
    got = {}
    for name, r in ref.items():
        x = outs[name]
        if x.shape != r.shape:
            got[f"{name}.{norm}"] = got[f"{name}.rel_linf"] = math.inf
            continue
        got[f"{name}.{norm}"] = gate(x, r)
        got[f"{name}.rel_linf"] = rel_linf(x, r)
    return got


def worst(many: list) -> dict:
    """The largest reading of each number over several outputs."""
    return {k: max(r[k] for r in many) for k in many[0]}


def judge(got: dict, limits: dict) -> dict:
    """name -> {"value", "limit"} for every limit; a number without a
    reading reads infinity."""
    return {k: {"value": got.get(k, math.inf), "limit": lim}
            for k, lim in limits.items()}


def passed(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())
