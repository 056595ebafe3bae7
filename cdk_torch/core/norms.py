"""Error norms used for variant-vs-reference verification.

Replicates the three verification idioms of the reference suite:
  - relative L2 norm (atmosphere `compute_l2norm`,
    biharmonic_wk_kernel.F90:69-73)
  - relative L1 error (mpdata `compare`, advect_scalar2D…F90:679-684)
  - per-point relative error with tolerance + violation reporting
    (nested_loops verification loops, nested.F90:267-287)

Inputs are numpy arrays or tensors (on any device); every norm is taken in
float64 on the host.
"""

from __future__ import annotations

import numpy as np
import torch


def to_numpy(x) -> np.ndarray:
    """float64 host copy of a tensor or array (bf16 has no numpy dtype, so
    tensors convert to float64 before they leave torch)."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float64).numpy()
    return np.asarray(x, dtype=np.float64)


def rel_l2(x, ref) -> float:
    """sqrt( sum((x - ref)^2) / sum(ref^2) )."""
    x = to_numpy(x)
    ref = to_numpy(ref)
    denom = float(np.sum(ref * ref))
    if denom == 0.0:
        return float(np.sqrt(np.sum((x - ref) ** 2)))
    return float(np.sqrt(np.sum((x - ref) ** 2) / denom))


def rel_l1(x, ref) -> float:
    """sum(|x - ref|) / sum(|ref|)."""
    x = to_numpy(x)
    ref = to_numpy(ref)
    denom = float(np.sum(np.abs(ref)))
    if denom == 0.0:
        return float(np.sum(np.abs(x - ref)))
    return float(np.sum(np.abs(x - ref)) / denom)


def pointwise_check(
    x, ref, tol: float, max_report: int = 10
) -> tuple[int, float, list[str]]:
    """Per-point relative error check with violation reporting.

    Returns (num_violations, max_rel_err, report_lines). Relative error is
    |x - ref| / |ref| where ref != 0, else absolute — exactly the reference's
    check (nested.F90:269-275). NaNs count as violations (the reference's
    isnan guard, nested.F90:427)."""
    x = to_numpy(x)
    ref = to_numpy(ref)
    err = np.abs(x - ref)
    rel = np.where(ref != 0.0, err / np.where(ref != 0.0, np.abs(ref), 1.0), err)
    bad = np.isnan(rel) | (rel > tol)
    n_bad = int(bad.sum())
    max_err = float(np.nanmax(rel)) if rel.size else 0.0
    lines = []
    if n_bad:
        idxs = np.argwhere(bad)[:max_report]
        for idx in idxs:
            t = tuple(int(v) for v in idx)
            lines.append(
                f" Error computing result at {t}: got {x[tuple(idx)]!r}, "
                f"expected {ref[tuple(idx)]!r}"
            )
    return n_bad, max_err, lines
