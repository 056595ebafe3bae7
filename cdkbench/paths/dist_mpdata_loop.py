"""Entry kind `dist_mpdata_loop`: the x-decomposed MPDATA of
`cdk_torch/dist/mpdata.py` on a `dist/mesh.py` mesh of `shards` shards:
`make_dist_step` lays the fields out by shard (once, in set-up) and
`make_dist_loop(kernel=...)` runs the interval's steps (halo exchange, one
masked-core launch per shard, the ordered flux sum).  With `state`
"carried" each interval starts from the sharded f and the flux the previous
one produced; with "seeded", from the seeded ones.  f is gathered only for
the check.
"""

from __future__ import annotations


class Path:
    def __init__(self, problem, cfg: dict, traffic: dict, raw: dict, device):
        from cdk_torch.dist import mesh as meshmod
        from cdk_torch.dist import mpdata as dist_mp

        pcfg, data = problem.to_program(cfg, raw)
        mesh = meshmod.make_mesh(traffic["shards"], device)
        kernel, n = traffic["kernel"], traffic["interval_steps"]
        shard_inputs, _, self._gather_f = dist_mp.make_dist_step(
            pcfg, mesh, kernel=kernel)
        loop = dist_mp.make_dist_loop(pcfg, mesh, kernel=kernel)
        f_s, u_s, w_s, aux = shard_inputs(data)
        self._run = lambda f, a: loop(f, u_s, w_s, a, n)
        self._f_s, self._aux, self._raw = f_s, aux, raw
        self.carry = traffic["state"] == "carried"
        self.steps = n
        self.state = [f_s, u_s, w_s, *aux]

    def interval(self):
        """One interval: `steps` decomposed steps from the current sharded
        state (carried) or the seeded one."""
        f_s, flux = out = self._run(self._f_s, self._aux)
        if self.carry:
            self._f_s, self._aux = f_s, (*self._aux[:3], flux)
        return out

    def inputs(self) -> dict:
        """The fields the next interval starts from, gathered (copies)."""
        return {**self._raw, "f": self._gather_f(self._f_s).clone(),
                "flux": self._aux[3].clone()}

    def outputs(self, result) -> dict:
        f_s, flux = result
        return {"f": self._gather_f(f_s), "flux": flux}


def build(problem, cfg: dict, traffic: dict, raw: dict, device) -> Path:
    return Path(problem, cfg, traffic, raw, device)
