"""Kernel-variant registry (the port of ``cdk_tpu.core.registry``).

Variants register under (kernel, variant-name) with the same flags as in
the JAX package, so a variant's name means the same computation and the
same verification gate in both packages.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

_REGISTRY: dict[str, dict[str, "Variant"]] = {}


class UnsupportedConfigError(NotImplementedError):
    """Raised by a variant factory or kernel wrapper whose stated
    applicability excludes the requested config (e.g. a slice whose
    working set does not fit one block's shared memory).  The driver
    reports it as an explicit typed SKIP with the reason; any other
    exception stays a FAILURE."""


@dataclass(frozen=True)
class Variant:
    kernel: str
    name: str
    fn: Callable
    description: str = ""
    requires_tpu: bool = False
    supports_f64: bool = True
    fast_math: bool = False  # intentionally-lower-precision variant
    experimental: bool = False  # skipped by default sweeps
    # per-variant f32 verification gate (None = the kernel family's default)
    verify_tol: float | None = None


def register(
    kernel: str,
    name: str,
    description: str = "",
    requires_tpu: bool = False,
    supports_f64: bool = True,
    fast_math: bool = False,
    experimental: bool = False,
    verify_tol: float | None = None,
):
    def deco(fn):
        _REGISTRY.setdefault(kernel, {})[name] = Variant(
            kernel, name, fn, description, requires_tpu, supports_f64,
            fast_math, experimental, verify_tol
        )
        return fn

    return deco


def variants(kernel: str) -> dict[str, "Variant"]:
    return dict(_REGISTRY.get(kernel, {}))


def get(kernel: str, name: str) -> "Variant":
    return _REGISTRY[kernel][name]


def kernels() -> list[str]:
    return sorted(_REGISTRY)


def _materialize(variant: "Variant", cfg, data):
    """-> (step2, aux, loop_or_None) with the canonical call form
    step2(aux, data).

    Variant factories return one of:
      step(data)
      (prepare, step2)            — prepare(data) builds untimed
                                    device-resident auxiliaries (the analog
                                    of the reference's untimed staging,
                                    nested.F90:400-403); step2(aux, data)
      {"step":…, "prepare":…, "loop":…}
                                  — `loop(data, n)` runs n steps with state
                                    kept in the variant's resident layout
                                    (the reference's `do n=1,nIters` over
                                    device-resident data, nested.F90:191-199)
    """
    made = variant.fn(cfg)
    loop = None
    if isinstance(made, dict):
        loop = made.get("loop")
        prepare = made.get("prepare")
        step2 = made["step"]
        made = (prepare, step2) if prepare else step2
    if isinstance(made, tuple):
        prepare, step2 = made
        aux = prepare(data)
        return step2, aux, loop

    def step2_plain(aux, d, _s=made):
        return _s(d)

    return step2_plain, (), loop


def make_step(variant: "Variant", cfg, data):
    """Materialize a variant into a plain step(data) callable."""
    step2, aux, _ = _materialize(variant, cfg, data)
    return lambda d: step2(aux, d)
