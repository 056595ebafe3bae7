"""Entry kind `registry_loop`: a registered variant's own n-step loop, the
callable `python -m cdk_torch integrate` runs (its `loop`, or the family's
loop over its step where it brings none).

The traffic file names the family and the variant.  The variant name is
the user-facing API that a later change makes faster, so the cell pins it.
Its `state` says where an interval starts: "carried", from the state the
previous interval produced (the problem's STATE names the fields), or
"seeded", from the seeded state every time.
"""

from __future__ import annotations

import dataclasses


class Path:
    def __init__(self, problem, cfg: dict, traffic: dict, raw: dict):
        import cdk_torch.kernels  # noqa: F401  (registers the variants)
        from cdk_torch.core import registry
        from cdk_torch.harness.specs import get_spec

        pcfg, data = problem.to_program(cfg, raw)
        family, n = traffic["family"], traffic["interval_steps"]
        variant = registry.get(family, traffic["variant"])
        step2, aux, vloop = registry._materialize(variant, pcfg, data)
        if vloop is not None:
            self._run = lambda d: vloop(d, n)
        else:
            runner = get_spec(family).loop_runner(step2, aux, n)
            self._run = runner
        self._problem, self._raw, self._data = problem, raw, data
        self.carry = traffic["state"] == "carried"
        self.steps = n
        self.state = list(raw.values())

    def interval(self):
        """One interval: the loop over `steps` steps from the current state
        (carried) or the seeded one."""
        out = self._run(self._data)
        if self.carry:
            named = self._problem.named(out)
            self._data = dataclasses.replace(self._data, **{
                field: named[k] for k, field in self._problem.STATE.items()})
        return out

    def inputs(self) -> dict:
        """The fields the next interval starts from, by the problem's field
        names; the state fields copied."""
        return {**self._raw, **{field: getattr(self._data, field).clone()
                                for field in self._problem.STATE.values()}}

    def outputs(self, result) -> dict:
        return self._problem.named(result)


def build(problem, cfg: dict, traffic: dict, raw: dict, device) -> Path:
    return Path(problem, cfg, traffic, raw)
