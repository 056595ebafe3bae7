"""The distributed production legs (the port of ``cdk_tpu.harness.distbench``).

Each leg builds a dist formulation on a 1-shard mesh, times its n-step loop
by two-point slope, verifies it against the same config's single-chip
champion loop, and reports us/step and grid points/s.  A leg that crashes
is reported as a failed leg; it does not stop the others.

The mesh is P logical shards on one card (`dist/mesh.py`).  The two MPDATA
legs and the two DSS legs (the kstep-8 ring on K14w, the row-sharded
rowchain on K15, K18p, K16p and K17p) are ported; the CKE leg waits for
`dist/cke.py`.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from cdk_torch.core.norms import rel_l1, rel_l2
from cdk_torch.core.timer import slope_time_detail


@dataclass
class DistLegResult:
    family: str
    path: str          # which dist formulation ran
    seconds_per_call: float
    slope_min: float
    slope_median: float
    slope_max: float
    grid_points_per_s: float
    err: float
    tol: float
    ok: bool
    note: str = ""


def _slope_loop(run_n, device, n1: int, n2: int, trials: int = 3):
    """Two-point slope timing of run_n(n) (one n-step loop) -> (min,
    median, max) s/step: `core.timer.slope_time_detail`'s trial-pair slopes
    and band; the median is the leg's value."""
    _, band = slope_time_detail(lambda n: (lambda _: run_n(n)), None, device,
                                n1=n1, n2=n2, trials=trials)
    return band["min"], band["median"], band["max"]


def _champion_loop(kernel: str, champ: str, cfg, data):
    """The single-chip champion's loop(data, n) in the family's canonical
    output layout (the dist result's comparison)."""
    import cdk_torch.kernels  # noqa: F401  (registers the variants)
    from cdk_torch.core.registry import _materialize, get
    from cdk_torch.harness.specs import get_spec

    step2, aux, vloop = _materialize(get(kernel, champ), cfg, data)
    if vloop is not None:
        return vloop
    spec = get_spec(kernel)
    return lambda d, n: spec.loop_runner(step2, aux, n)(d)


def _leg_mpdata(cfg, m, champ, trials):
    """The hoisted x-decomposed loop (u/w halos once per run, K23 per step)."""
    from cdk_torch.dist import mpdata as dist_mp
    from cdk_torch.kernels.mpdata import problem

    data = problem.init_data(cfg, m.device).to(m.device)
    si, _, gather_f = dist_mp.make_dist_step(cfg, m, kernel="xmajor")
    args = si(data)
    loop = dist_mp.make_dist_loop(cfg, m, kernel="xmajor")

    # 5 dist steps vs 5 champion steps: both exact-f32 forms of the same
    # staged arithmetic, apart from the champion's hoisting
    nv = 5
    f_d, flux_d = loop(*args, nv)
    f_r, flux_r = _champion_loop("mpdata", champ, cfg, data)(data, nv)
    err = max(rel_l1(gather_f(f_d), f_r), rel_l1(flux_d, flux_r))
    lo, med, hi = _slope_loop(lambda n: loop(*args, n), m.device, 20, 120,
                              trials)
    return "xmajor_split_hoisted_loop", lo, med, hi, float(err), 1e-5


def _leg_mpdata_slices(cfg, m, champ, trials):
    """The slice-batch data-parallel loop: each shard runs the single-chip
    champion kernel on its own slices, so this leg gates 'dist form ==
    champion'."""
    from cdk_torch.dist import mpdata as dist_mp
    from cdk_torch.kernels.mpdata import problem

    data = problem.init_data(cfg, m.device).to(m.device)
    si, loop = dist_mp.make_dist_loop_slices(cfg, m)
    args = si(data)

    nv = 3
    f_d, flux_d = loop(*args, nv)
    f_r, flux_r = _champion_loop("mpdata", champ, cfg, data)(data, nv)
    err = max(rel_l1(f_d, f_r), rel_l1(flux_d, flux_r))
    lo, med, hi = _slope_loop(lambda n: loop(*args, n), m.device, 20, 120,
                              trials)
    return "slice_batch_loop", lo, med, hi, float(err), 1e-5


def _leg_dss(cfg, m, champ, trials):
    """The communication-avoiding ring: kstep 8, K14w per shard."""
    from cdk_torch.dist import biharmonic as dist_bi
    from cdk_torch.kernels.biharmonic import problem

    data = problem.init_data(cfg, m.device).to(m.device)
    si, loop, gather = dist_bi.make_dist_loop_dss_kstep(cfg, m, kstep=8)
    q, aux = si(data)

    nv = 8
    out_d = gather(loop(q, aux, nv))
    out_r = _champion_loop("biharmonic_dss", champ, cfg, data)(data, nv)
    err = rel_l2(out_d, out_r)
    lo, med, hi = _slope_loop(lambda n: loop(q, aux, n), m.device, 16, 80,
                              trials)
    # two bf16x3 chains in other orders: the per-step rounding compounds
    # over nv steps; 5e-4 still catches a structural fault
    return "dss_kstep8_ring", lo, med, hi, float(err), 5e-4


def _leg_dss2d(cfg, m, champ, trials):
    """The row-sharded rowchain: k-step blocks (K18p), then K16p and K17p."""
    from cdk_torch.dist import biharmonic as dist_bi
    from cdk_torch.kernels.biharmonic import problem

    data = problem.init_data(cfg, m.device).to(m.device)
    si, loop, gather = dist_bi.make_dist_loop_dss2d_rowchain(cfg, m)
    q, aux = si(data)

    nv = 4
    out_d = gather(loop(q, aux, nv))
    out_r = _champion_loop("biharmonic_dss2d", champ, cfg, data)(data, nv)
    err = rel_l2(out_d, out_r)
    lo, med, hi = _slope_loop(lambda n: loop(q, aux, n), m.device, 10, 60,
                              trials)
    return "dss2d_rowchain_padk", lo, med, hi, float(err), 5e-4


# leg name -> (kernel family, leg function)
LEGS = {
    "mpdata": ("mpdata", _leg_mpdata),
    "mpdata_slices": ("mpdata", _leg_mpdata_slices),
    "biharmonic_dss": ("biharmonic_dss", _leg_dss),
    "biharmonic_dss2d": ("biharmonic_dss2d", _leg_dss2d),
}
# the DSS legs chain 8 and 4 steps: at f32 the real radius takes the state
# below f32's range within three applications (each scales it by about
# rrearth²), so that both sides would compare zeros; their production
# preset runs at rrearth 0.1, as chip_smoke.py's chains do
CHAIN_RREARTH = {"biharmonic_dss": 0.1, "biharmonic_dss2d": 0.1}


def run_dist_legs(champions: dict, production: bool = True,
                  trials: int = 3, quiet: bool = False,
                  configs: dict | None = None, device="cuda"):
    """Run the dist legs on a 1-shard mesh on `device`.

    champions: {family: single-chip champion variant} — each leg verifies
    against its family's champion loop; a leg whose family has none is
    skipped.  configs overrides the per-leg config (and then names the legs
    to run); without it each family runs its production preset (the DSS
    legs at CHAIN_RREARTH), or its default config at f32 with device init
    when production is False."""
    from cdk_torch.core.config import production_config, with_overrides
    from cdk_torch.dist import mesh as meshmod
    from cdk_torch.harness.specs import get_spec

    say = (lambda *a: None) if quiet else print
    m = meshmod.make_mesh(1, device)
    on = "one card" if m.device.type == "cuda" else "the CPU"
    results = []
    for leg, (family, build) in LEGS.items():
        spec = get_spec(family)
        if family not in champions:
            continue
        if configs is not None:
            if leg not in configs:
                continue
            cfg = configs[leg]
        else:
            cfg = (production_config(family) if production
                   else with_overrides(spec.default_config(),
                                       dtype="float32", device_init=True))
            if production and family in CHAIN_RREARTH:
                cfg = with_overrides(cfg, rrearth=CHAIN_RREARTH[family])
        try:
            path, lo, med, hi, err, tol = build(cfg, m, champions[family],
                                                trials)
        except Exception as e:  # a crashed leg fails, the others still run
            results.append(DistLegResult(
                leg, "<error>", 0.0, 0.0, 0.0, 0.0, 0.0,
                float("nan"), 0.0, False,
                note=f"{type(e).__name__}: {e}"))
            say(f"[dist] {leg:<16s} ERROR {type(e).__name__}: {e}")
            continue
        ok = bool(np.isfinite(err) and err < tol)
        results.append(DistLegResult(
            leg, path, med, lo, med, hi,
            spec.grid_points(cfg) / med, err, tol, ok,
        ))
        say(f"[dist] {leg:<16s} {path:<26s} {med * 1e6:10.3f} us/step "
            f"{spec.grid_points(cfg) / med / 1e9:8.4f} G pts/s "
            f"err={err:.2e} (tol {tol:g}) {'ok' if ok else 'VERIFY FAILED'} "
            f"(1 shard on {on})")
    return results
