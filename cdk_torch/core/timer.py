"""Wall-clock timers and two-point slope timing.

Port of ``cdk_tpu.core.timer`` (reference: nested_loops/timerMod.f90:10-127).
CUDA launches return before the device finishes, so every reading of the
clock that covers device work comes after ``torch.cuda.synchronize()`` —
the analog of the reference's `!$acc wait` before `system_clock`
(advect_scalar2D…F90:109-110).
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import torch

from cdk_torch.core.platform import synchronize


@dataclass
class Timer:
    name: str
    start_time: float = 0.0
    elapsed: float = 0.0
    running: bool = False
    count: int = 0

    def start(self) -> "Timer":
        if not self.running:
            self.running = True
            self.start_time = time.perf_counter()
        return self

    def stop(self, device: torch.device | None = None) -> float:
        """Stop the timer, accumulating elapsed time; with `device`, wait
        for its queued work first."""
        if device is not None:
            synchronize(device)
        if self.running:
            self.elapsed += time.perf_counter() - self.start_time
            self.running = False
            self.count += 1
        return self.elapsed

    def report(self) -> str:
        return f" Timer {self.name:<28s}: {self.elapsed: .6f} s"


def _band(samples: list[float]) -> dict:
    s = sorted(samples)
    return {
        "min": s[0],
        "median": s[len(s) // 2],
        "max": s[-1],
        "n_samples": len(s),
    }


def slope_time_detail(make_runner, data, device: torch.device,
                      n1: int = 50, n2: int = 400, trials: int = 5,
                      min_delta: float = 5e-3,
                      max_n: int = 51200) -> tuple[float, dict]:
    """Per-step seconds by two-point slope: time an n1-step and an n2-step
    run (`make_runner(n)(data)`, each ending in a device synchronize) and
    take (t(n2) - t(n1)) / (n2 - n1) per trial pair, which cancels the
    constant launch and synchronize cost.  While the difference of the
    fastest trials is below `min_delta` seconds the step counts grow 4x;
    once it is above, one more scale at 2x is taken.

    Returns (median_seconds_per_step, band): the headline is the MEDIAN of
    every trial-pair slope of the accepted scales, and band carries
    {"min", "median", "max", "n_samples"} of those same samples."""

    def times_of(n):
        r = make_runner(n)
        r(data)  # warm: lazy builds, allocator, caches
        synchronize(device)
        ts = []
        for _ in range(trials):
            t0 = time.perf_counter()
            r(data)
            synchronize(device)
            ts.append(time.perf_counter() - t0)
        return ts

    samples: list[float] = []
    accepted = 0
    while True:
        t2s, t1s = times_of(n2), times_of(n1)
        pair = [(b - a) / (n2 - n1) for a, b in zip(t1s, t2s)]
        if min(t2s) - min(t1s) >= min_delta:
            samples += pair
            accepted += 1
            if accepted >= 2 or n2 * 2 > max_n:
                break
            n1 *= 2
            n2 *= 2
        elif n2 >= max_n:
            # never resolvable above the noise floor: report what the
            # largest scale saw
            samples = samples or pair
            break
        else:
            n1 *= 4
            n2 *= 4
    band = _band(samples)
    return max(band["median"], 1e-12), band
