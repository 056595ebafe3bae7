"""The check's power, on the CPU at a small size: a run with the timed path
broken underneath (the port's wrappers replaced for the run) must come out
`correct` false, once for each fault a cell can have:

  unchanged   a step that returns its state unchanged
  altered     one answer altered where it is produced (the largest value of
              the wrapper's output set to zero)
  exchange    the exchange between shards left out (the decomposed cell, on
              two shards, since one shard has no neighbour to hear from)
  stale       an interval that returns what the first one returned (a
              result kept across calls), where the state is carried

The control, the benchmark's reference in the precision below the one the
configuration states, must fail a limit where the program passes them all.

    python -m pytest cdkbench/tests -q
"""

from __future__ import annotations

from types import SimpleNamespace

import pytest
import torch

from cdkbench import check as chk
from cdkbench import run
from cdkbench.readings import readings
from cdkbench.tests.test_harness import BENCH, CELLS, cell, tiny

SEED = 2**31 + 7


def _alter(x: torch.Tensor) -> torch.Tensor:
    x = x.clone()
    x.view(-1)[x.abs().argmax()] = 0.0
    return x


def _wrappers():
    """cell -> (module, attribute) of the wrapper whose output is the state
    a step produces, and a function that returns that state unchanged."""
    from cdk_torch.kernels.biharmonic import dss2d_rowchain, resident
    from cdk_torch.kernels.mpdata import masked
    from cdk_torch.kernels.mpdata import resident as mp_resident

    return {
        "homme.hv_torus": (dss2d_rowchain, "rowchain_step",
                           lambda F, w, t, *a, **k: t),
        "homme.hv_elem": (resident, "bd8_resident", lambda L, q, *a, **k: q),
        "mmf.slices": (mp_resident, "advect_resident",
                       lambda f, u, w, rho, rhow, adz, flux, n, **k: (f, flux)),
        "mmf.xsplit": (masked, "masked_step_xmajor_split",
                       lambda f_loc, *a, **k: (f_loc, f_loc.new_zeros(
                           f_loc.shape[0], f_loc.shape[2]))),
    }


# the wrapper that produces each cell's answer, for the altered fault
PRODUCED = {"homme.hv_torus": "rowchain_bridge_out"}


def _run(name, overrides=None):
    res, _ = run.run_cell(cell(name), BENCH, SEED, 0.5, False,
                          torch.device("cpu"), overrides or tiny(name))
    return res


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    assert _run(name)["correct"] is True


@pytest.mark.parametrize("name", CELLS)
def test_state_unchanged_is_caught(name, monkeypatch):
    mod, attr, same = _wrappers()[name]
    monkeypatch.setattr(mod, attr, same)
    res = _run(name)
    assert res["correct"] is False and res["failed"] >= 1


@pytest.mark.parametrize("name", CELLS)
def test_altered_answer_is_caught(name, monkeypatch):
    mod, attr, _ = _wrappers()[name]
    attr = PRODUCED.get(name, attr)
    real = getattr(mod, attr)

    def altered(*a, **k):
        out = real(*a, **k)
        if isinstance(out, tuple):
            return (_alter(out[0]), *out[1:])
        return _alter(out)

    monkeypatch.setattr(mod, attr, altered)
    assert _run(name)["correct"] is False


@pytest.mark.parametrize("name", [n for n in CELLS if run.cell_files(
    cell(n))[1]["state"] == "carried"])
def test_stale_interval_is_caught(name, monkeypatch):
    first = {}

    def build(problem, cfg, traffic, raw, device, _real=run.load(
            "paths", run.cell_files(cell(name))[1]["path"]).build):
        path = _real(problem, cfg, traffic, raw, device)
        real = path.interval

        def stale():
            out = real()
            return first.setdefault("out", out)

        path.interval = stale
        return path

    real_load = run.load
    monkeypatch.setattr(run, "load", lambda kind, mod: SimpleNamespace(
        build=build) if kind == "paths" else real_load(kind, mod))
    res = _run(name)
    assert res["correct"] is False and res["failed"] >= 1


def test_exchange_left_out_is_caught(monkeypatch):
    from cdk_torch.dist import mesh

    two = tiny("mmf.xsplit", shards=2)
    assert _run("mmf.xsplit", two)["correct"] is True
    monkeypatch.setattr(mesh, "exchange_strips", lambda x, h, out=None: (
        torch.zeros_like(x[:, :, :h]), torch.zeros_like(x[:, :, :h])))
    assert _run("mmf.xsplit", two)["correct"] is False


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_where_the_program_passes(name):
    """The control's readings fail at least one of the cell's limits; the
    program's pass all of them, on the same seed."""
    limits = run.read_json("limits", f"{name}.json")["limits"]
    over = tiny(name)
    program = readings(cell(name), SEED, False, torch.device("cpu"), over)
    control = readings(cell(name), SEED, True, torch.device("cpu"), over)
    assert chk.passed(chk.judge(program, limits))
    assert not chk.passed(chk.judge(control, limits))
