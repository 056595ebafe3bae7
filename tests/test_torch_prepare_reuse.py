"""Each single-chip HOMME form's set-up (L, the DSS weights, A², the packed
element fields), built once per set of element fields
(`operator.reuse_prepare`): every variant of the biharmonic families with
a `loop` reuses it while dvv, dinv, spheremp and tensorvisc are the same
tensors unwritten, rebuilds after any change to them, and never keeps a
result: every output is held `torch.equal` to the same variant
materialised anew on the same data."""

import dataclasses

import pytest
import torch

import cdk_torch.kernels  # noqa: F401  (registers the variants)
from cdk_torch.core import registry, trace
from cdk_torch.core.config import BiharmonicConfig, with_overrides
from cdk_torch.kernels.biharmonic import problem as bp
from cdk_torch.kernels.biharmonic.operator import ELEMENT_FIELDS

# the tests' small HOMME size (a 4 x 3 torus), in float32 and at rrearth
# 0.1 as the benchmark's cells run (at the real radius a few f32 steps
# reach zero, and outputs of other inputs would compare equal)
SMALL = with_overrides(BiharmonicConfig(), nelemd=12, nlev=4, qsize=2,
                       dtype="float32", rrearth=0.1)
N = 3  # steps a loop call
LOOPS = [(family, name)
         for family in ("biharmonic", "biharmonic_dss", "biharmonic_dss2d")
         for name, v in registry.variants(family).items()
         if isinstance(made := v.fn(SMALL), dict) and "loop" in made]


def _loop(family, name, data):
    _, _, loop = registry._materialize(registry.get(family, name), SMALL,
                                       data)
    return loop


def _fresh(family, name, data):
    """The output of the variant materialised anew on `data`."""
    return _loop(family, name, data)(data, N)


def _reuses():
    return trace.counts().get("prepare_reuses", 0)


def _scaled(data, k):
    """New element fields, each times k; the same tracers."""
    return dataclasses.replace(data, **{
        f: getattr(data, f) * k for f in ELEMENT_FIELDS})


def test_every_biharmonic_form_with_a_loop_is_covered():
    assert len(LOOPS) == 27
    data = bp.init_data(SMALL)
    assert all(_fresh(f, n, data).abs().min() > 0 for f, n in LOOPS)
    assert ("biharmonic_dss2d", "fused_operator_rowchain_sq_x3") in LOOPS
    assert ("biharmonic", "fused_operator_bd8_resident") in LOOPS


@pytest.mark.parametrize("family,name", LOOPS)
def test_second_call_on_the_same_data_reuses(family, name):
    data = bp.init_data(SMALL)
    loop = _loop(family, name, data)
    first = loop(data, N)
    r = _reuses()
    second = loop(data, N)
    assert _reuses() == r + 1
    assert torch.equal(second, first)
    assert torch.equal(second, _fresh(family, name, data))


@pytest.mark.parametrize("family,name", LOOPS)
def test_new_tracers_reuse_and_the_output_follows_them(family, name):
    data = bp.init_data(SMALL)
    loop = _loop(family, name, data)
    before = loop(data, N)
    other = dataclasses.replace(data, qtens=0.5 * data.qtens + 0.25)
    r = _reuses()
    out = loop(other, N)
    assert _reuses() == r + 1
    assert not torch.equal(out, before)
    assert torch.equal(out, _fresh(family, name, other))
    assert torch.equal(loop(data, N), before)


@pytest.mark.parametrize("field", ELEMENT_FIELDS)
@pytest.mark.parametrize("family,name", LOOPS)
def test_in_place_write_to_a_field_rebuilds(family, name, field):
    data = bp.init_data(SMALL)
    loop = _loop(family, name, data)
    before = loop(data, N)
    getattr(data, field).mul_(1.5)
    r = _reuses()
    out = loop(data, N)
    assert _reuses() == r
    assert not torch.equal(out, before)
    assert torch.equal(out, _fresh(family, name, data))
    r = _reuses()
    assert torch.equal(loop(data, N), out)
    assert _reuses() == r + 1


@pytest.mark.parametrize("family,name", LOOPS)
def test_new_data_with_other_values_rebuilds(family, name):
    data = bp.init_data(SMALL)
    loop = _loop(family, name, data)
    before = loop(data, N)
    other = _scaled(data, 1.25)
    r = _reuses()
    out = loop(other, N)
    assert _reuses() == r
    assert not torch.equal(out, before)
    assert torch.equal(out, _fresh(family, name, other))


@pytest.mark.parametrize("family,name", LOOPS)
def test_inference_tensors_rebuild_every_call(family, name):
    with torch.inference_mode():
        data = _scaled(bp.init_data(SMALL), 1.0)
    assert all(getattr(data, f).is_inference() for f in ELEMENT_FIELDS)
    loop = _loop(family, name, data)
    r = _reuses()
    outs = [loop(data, N) for _ in range(2)]
    assert _reuses() == r
    want = _fresh(family, name, data)
    assert all(torch.equal(out, want) for out in outs)


def _kept():
    """registry.keep_last over a build of (x, y, n), keyed by its tensors
    (x, y) and its size n, counting `prepare_reuses`; with the builds made."""
    builds = []

    def build(x, y, n):
        builds.append((x, y, n))
        return object()

    return registry.keep_last(build, lambda x, y, n: ((x, y), (n,)),
                              "prepare_reuses"), builds


# a change after the first call -> whether the second call builds again
CHANGES = {
    "none": (lambda x, y, n: (x, y, n), False),
    "write": (lambda x, y, n: (x.add_(0), y, n), True),
    "other_tensor": (lambda x, y, n: (x, y.clone(), n), True),
    "other_size": (lambda x, y, n: (x, y, n + 1), True),
    "swapped": (lambda x, y, n: (y, x, n), True),
}


@pytest.mark.parametrize("change", sorted(CHANGES))
def test_keep_last_keeps_only_the_same_unwritten_tensors_at_the_same_sizes(change):
    kept, builds = _kept()
    x, y = torch.ones(3), torch.zeros(2)
    first = kept(x, y, 4)
    before = trace.counts().get("prepare_reuses", 0)
    alter, rebuilds = CHANGES[change]
    second = kept(*alter(x, y, 4))
    reused = trace.counts().get("prepare_reuses", 0) - before
    assert (second is not first) == rebuilds
    assert len(builds) == 1 + rebuilds
    assert reused == (not rebuilds)


def test_keep_last_rebuilds_inference_tensors_every_call():
    kept, builds = _kept()
    with torch.inference_mode():
        x, y = torch.ones(3), torch.zeros(2)
    assert kept(x, y, 4) is not kept(x, y, 4)
    assert len(builds) == 2
