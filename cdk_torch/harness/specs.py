"""Per-kernel harness glue: how to init, which outputs to compare, and each
kernel's own verification idiom (the reference uses a different norm per
miniapp):

  biharmonic — relative L2 on qtens   (compute_l2norm, biharmonic:69-73)
  mpdata     — relative L1 on f, flux (compare, advect…F90:679-684)
  cke        — per-point relative err vs errTol (nested.F90:267-287)

The gates are the JAX package's (cdk_tpu/harness/specs.py), unchanged.
"""

from __future__ import annotations

from dataclasses import dataclass, replace as _dc_replace
from typing import Any, Callable

import numpy as np

from cdk_torch.core import config as cfgmod
from cdk_torch.core.norms import pointwise_check, rel_l1, rel_l2


@dataclass(frozen=True)
class CheckResult:
    ok: bool
    lines: list[str]  # stdout lines in the reference's report style
    metrics: dict[str, float]


@dataclass(frozen=True)
class KernelSpec:
    name: str
    default_config: Callable[[], Any]
    init: Callable[..., Any]            # (cfg, device) -> data
    verify: Callable[..., CheckResult]  # (cfg, out, ref_out, loose, tol)
    grid_points: Callable[[Any], int]
    # (step2, aux, n) -> fn(data) running n chained steps, for variants
    # that bring no loop of their own
    loop_runner: Callable[..., Callable]


def _tol(cfg, loose, f64_tol, f32_tol):
    if cfg.dtype == "bfloat16":
        return 1.0e-1 if loose else 3.0e-2
    if loose:
        return 1.0e-2
    return f64_tol if cfg.dtype == "float64" else f32_tol


def _verify_biharmonic(cfg, out, ref, loose=False, f32_tol=2e-5,
                       tol=None) -> CheckResult:
    l2 = rel_l2(out, ref)
    # a registered verify_tol (per-variant precision-policy gate) overrides
    # the family f32 default
    if tol is not None and cfg.dtype == "float32" and not loose:
        f32_tol = tol
    gate = _tol(cfg, loose, 1e-13, f32_tol)
    return CheckResult(
        ok=bool(np.isfinite(l2) and l2 < gate),
        lines=[f" L2 norm: {l2: .6E}  (tol {gate:g})"],
        metrics={"rel_l2": l2},
    )


def _verify_mpdata(cfg, out, ref, loose=False, tol=None) -> CheckResult:
    f_o, flux_o = out
    f_r, flux_r = ref
    e_f = rel_l1(f_o, f_r)
    e_flux = rel_l1(flux_o, flux_r)
    # f32 gates: f <= 1e-6, flux <= 1e-5
    tol = _tol(cfg, loose, 1e-13,
               tol if tol is not None and not loose else 1e-6)
    return CheckResult(
        ok=bool(np.isfinite(e_f) and np.isfinite(e_flux)
                and e_f < tol and e_flux < 10 * tol),
        lines=[
            f" Relative L1 Error - f    : {e_f: .6E}",
            f" Relative L1 Error - flux : {e_flux: .6E}",
        ],
        metrics={"rel_l1_f": e_f, "rel_l1_flux": e_flux},
    )


def _verify_cke(cfg, out, ref, loose=False, tol=None) -> CheckResult:
    """CKE's gate, for the family's port (its kernels are not ported yet)."""
    if cfg.dtype == "float64" and not loose:
        # the reference's own per-point check at errTol (nested.F90:267-287)
        n_bad, max_err, lines = pointwise_check(out, ref, cfg.errtol)
        return CheckResult(
            ok=n_bad == 0,
            lines=lines
            or [f" max relative error: {max_err: .6E} (tol {cfg.errtol:g})"],
            metrics={"n_violations": float(n_bad), "max_rel_err": max_err},
        )
    # f32: per-point relative error is dominated by cancellation at
    # near-zero flux points; use the aggregate norm
    tol = _tol(cfg, loose, cfg.errtol,
               tol if tol is not None and not loose else 1e-6)
    e = rel_l1(out, ref)
    return CheckResult(
        ok=bool(np.isfinite(e) and e < tol),
        lines=[f" Relative L1 Error - flx  : {e: .6E}  (tol {tol:g})"],
        metrics={"rel_l1": e},
    )


def _loop_biharmonic(step2, aux, n):
    """Chain n Laplacian applications (qtens feeds back)."""

    def run(data):
        q = data.qtens
        for _ in range(n):
            q = step2(aux, _dc_replace(data, qtens=q))
        return q

    return run


def _loop_mpdata(step2, aux, n):
    """n advection steps: f and flux feed back."""

    def run(data):
        f, flux = data.f, data.flux
        for _ in range(n):
            f, flux = step2(aux, _dc_replace(data, f=f, flux=flux))
        return f, flux

    return run


def _specs() -> dict[str, KernelSpec]:
    from cdk_torch.kernels.biharmonic import problem as bi_problem
    from cdk_torch.kernels.mpdata import problem as mp_problem

    return {
        "biharmonic": KernelSpec(
            "biharmonic", cfgmod.BiharmonicConfig, bi_problem.init_data,
            _verify_biharmonic, lambda c: c.grid_points, _loop_biharmonic,
        ),
        "mpdata": KernelSpec(
            "mpdata", cfgmod.MpdataConfig, mp_problem.init_data,
            _verify_mpdata, lambda c: c.grid_points, _loop_mpdata,
        ),
    }


def get_spec(name: str) -> KernelSpec:
    return _specs()[name]


def all_specs() -> dict[str, KernelSpec]:
    return _specs()
