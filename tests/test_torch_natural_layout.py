"""K1 (`bd8_resident`) and K15 (`rowchain_bridge_in`) take the state in its
own (e, q, k, i, j) layout as well as in the lane layout, on the CPU (their
plain versions, which turn it themselves): the same tensor from either, a
non-contiguous or wrongly shaped state refused, and the benchmark's HOMME
loops passing `data.qtens` as it lies, counted once a call by
`natural_loads`, with no call of `to_lane_layout` and the output bit for
bit that of the lane path.  No jax."""

import pytest
import torch

import cdk_torch.kernels  # noqa: F401  (registers the variants)
from cdk_torch.core import registry, trace
from cdk_torch.core.config import BiharmonicConfig, with_overrides
from cdk_torch.kernels.biharmonic import dss2d_rowchain as rc
from cdk_torch.kernels.biharmonic import problem as bp
from cdk_torch.kernels.biharmonic import resident as bres

# the tests' small HOMME size (a 4 x 3 torus) in float32 at rrearth 0.1, as
# the benchmark's cells run
SMALL = with_overrides(BiharmonicConfig(), nelemd=12, nlev=4, qsize=2,
                       dtype="float32", rrearth=0.1)
FORMS = [(torch.float32, "highest"), (torch.float32, "bf16x3"),
         (torch.float64, "highest")]
NATURAL_LOOPS = [("biharmonic", "fused_operator_bd8_resident"),
                 ("biharmonic", "fused_operator_bd8_resident_x3"),
                 ("biharmonic_dss2d", "fused_operator_rowchain"),
                 ("biharmonic_dss2d", "fused_operator_rowchain_x3"),
                 ("biharmonic_dss2d", "fused_operator_rowchain_sq"),
                 ("biharmonic_dss2d", "fused_operator_rowchain_sq_x3")]


def _natural_loads():
    return trace.counts().get("natural_loads", 0)


def _operands(e, nq, nlev, dtype, seed):
    """An operator L (e, 16, 16) and a state (e, nq, nlev, 4, 4)."""
    gen = torch.Generator().manual_seed(seed)
    L = torch.rand((e, 16, 16), generator=gen, dtype=torch.float64) / 4
    q = torch.rand((e, nq, nlev, 4, 4), generator=gen, dtype=torch.float64)
    return L.to(dtype), q.to(dtype)


def lane_loop(name, cfg, aux, qtens, n):
    """The loop of a natural-load variant as it ran before its kernels read
    the state where it lies: to_lane_layout, the lane-layout launches,
    from_lane_layout."""
    prec = "bf16x3" if name.endswith("x3") else "highest"
    q = bp.to_lane_layout(qtens)
    if "rowchain" not in name:
        return bp.from_lane_layout(bres.bd8_resident(aux[0], q, n, prec), cfg)
    L, w, F = aux
    ex, ey = rc.torus_shape(cfg.nelemd)
    t = rc.rowchain_bridge_in(L, q, ex, ey, prec)
    nt = n - 1
    while nt > 0:
        k = min(rc.loop_depth(prec, "_sq" in name), nt)
        t = rc.rowchain_step(F, w, t, ex, ey, k, prec, "_sq" in name)
        nt -= k
    return bp.from_lane_layout(rc.rowchain_bridge_out(L, w, t, ex, ey, prec), cfg)


@pytest.mark.parametrize("n", [0, 1, 6])
@pytest.mark.parametrize("dtype,prec", FORMS)
def test_bd8_resident_takes_either_layout(dtype, prec, n):
    L, q = _operands(5, 3, 11, dtype, n)
    before = _natural_loads()
    got = bres.bd8_resident(L, q, n, prec)
    assert _natural_loads() == before + 1
    want = bres.bd8_resident(L, bp.to_lane_layout(q), n, prec)
    assert _natural_loads() == before + 1
    assert got.shape == (5, 16, 33)
    assert torch.equal(got, want)


@pytest.mark.parametrize("exy", [(4, 3), (3, 1), (2, 5)])
@pytest.mark.parametrize("dtype,prec", FORMS)
def test_rowchain_bridge_in_takes_either_layout(dtype, prec, exy):
    ex, ey = exy
    L, q = _operands(ex * ey, 2, 5, dtype, ex * 10 + ey)
    before = _natural_loads()
    got = rc.rowchain_bridge_in(L, q, ex, ey, prec)
    assert _natural_loads() == before + 1
    want = rc.rowchain_bridge_in(L, bp.to_lane_layout(q), ex, ey, prec)
    assert _natural_loads() == before + 1
    assert got.shape == (ex * ey, 16, 10)
    assert torch.equal(got, want)


def _bad_states(q):
    e, nq, nlev = q.shape[:3]
    return {"not contiguous": q.transpose(1, 2),
            "np 3": torch.zeros((e, nq, nlev, 3, 3), dtype=q.dtype),
            "not square": torch.zeros((e, nq, nlev, 4, 2), dtype=q.dtype),
            "np 5": torch.zeros((e, nq, nlev, 5, 5), dtype=q.dtype)}


@pytest.mark.parametrize("bad", ["not contiguous", "np 3", "not square", "np 5"])
def test_k1_and_k15_refuse_a_bad_state(bad):
    ex, ey = 3, 2
    L, q = _operands(ex * ey, 2, 3, torch.float32, 1)
    x = _bad_states(q)[bad]
    before = _natural_loads()
    with pytest.raises(ValueError):
        bres.bd8_resident(L, x, 1)
    with pytest.raises(ValueError):
        rc.rowchain_bridge_in(L, x, ex, ey)
    assert _natural_loads() == before


def test_the_lane_only_kernels_refuse_the_state_layout():
    """K5, the rowchain step and bridge-out take the lane layout only."""
    ex, ey = 3, 2
    L, q = _operands(ex * ey, 2, 3, torch.float32, 2)
    w = torch.ones((ex * ey, 16))
    with pytest.raises(ValueError, match="lane layout"):
        bres.apply_operator_pallas(L, q)
    with pytest.raises(ValueError, match="torus"):
        rc.rowchain_step(L, w, q, ex, ey)
    with pytest.raises(ValueError, match="torus"):
        rc.rowchain_bridge_out(L, w, q, ex, ey)


@pytest.mark.parametrize("form", ["loop", "step"])
@pytest.mark.parametrize("family,name", NATURAL_LOOPS)
def test_loop_reads_the_state_where_it_lies(family, name, form, monkeypatch):
    """One call of the loop (or the step) counts one natural load, calls no
    to_lane_layout, leaves qtens as it was and gives bit for bit the lane
    path's output."""
    data = bp.init_data(SMALL)
    step, aux, loop = registry._materialize(registry.get(family, name), SMALL,
                                            data)
    n = 3 if form == "loop" else 1
    want = lane_loop(name, SMALL, aux, data.qtens, n)
    kept = data.qtens.clone()

    def no_copy(qtens):
        raise AssertionError("a lane copy of the state")

    monkeypatch.setattr(bp, "to_lane_layout", no_copy)
    monkeypatch.setattr(bres, "to_lane_layout", no_copy)
    before = _natural_loads()
    got = loop(data, n) if form == "loop" else step(aux, data)
    assert _natural_loads() == before + 1
    assert torch.equal(data.qtens, kept)
    assert got.shape == data.qtens.shape
    assert torch.equal(got, want)


def test_loop_takes_a_non_contiguous_state():
    """A loop given a state that is not contiguous still runs, on a
    contiguous copy, and gives the same output."""
    data = bp.init_data(SMALL)
    step, aux, loop = registry._materialize(
        registry.get("biharmonic", "fused_operator_bd8_resident"), SMALL, data)
    want = loop(data, 2)
    odd = data.qtens.transpose(1, 2).contiguous().transpose(1, 2)
    assert not odd.is_contiguous()
    data.qtens = odd
    assert torch.equal(loop(data, 2), want)


def test_k5_chain_counts_no_natural_load():
    """fused_operator_pallas chains K5 on a lane copy: natural_loads does
    not move under it."""
    data = bp.init_data(SMALL)
    _, _, loop = registry._materialize(
        registry.get("biharmonic", "fused_operator_pallas"), SMALL, data)
    before = _natural_loads()
    loop(data, 2)
    assert _natural_loads() == before
