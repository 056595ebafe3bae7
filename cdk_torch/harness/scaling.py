"""Scaling sweeps of the decomposed MPDATA and DSS biharmonic (the port of
the mpdata and biharmonic parts of ``cdk_tpu.harness.scaling``): grid
points/s as the shard count grows with the domain, the serialized-vs-split
(overlap) step, and the per-step vs the communication-avoiding loop.

The mesh is P logical shards on one device (`dist/mesh.py`), so a sweep
measures what the decomposition costs on one card: halo overcompute,
exchange copies and the extra launches.  `efficiency` is therefore the
share of the 1-shard throughput (grid points/s) kept at P shards; on one
card P shards do P times the work one after another, and a parallel
weak-scaling efficiency needs a multi-process mesh.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

from cdk_torch.core.config import BiharmonicConfig, MpdataConfig, with_overrides
from cdk_torch.core.platform import synchronize
from cdk_torch.dist import biharmonic as dist_bi
from cdk_torch.dist import mesh as meshmod
from cdk_torch.dist import mpdata as dist_mpdata
from cdk_torch.kernels.biharmonic import problem as bproblem
from cdk_torch.kernels.biharmonic.dss2d import torus_shape
from cdk_torch.kernels.mpdata import problem


@dataclass
class ScalePoint:
    n_shards: int
    nx_global: int          # or, for the slice-batch sweep, nslices
    seconds_per_step: float
    grid_points_per_s: float
    efficiency: float       # throughput vs the 1-shard point


def _on(mesh) -> str:
    return "one card" if mesh.device.type == "cuda" else "the CPU"


def _best_of(run, device, trials: int = 3) -> float:
    """Fastest of `trials` timed run() calls (after one warm call), each
    ending in a device synchronize; seconds."""
    run()
    synchronize(device)
    best = float("inf")
    for _ in range(trials):
        t0 = time.perf_counter()
        run()
        synchronize(device)
        best = min(best, time.perf_counter() - t0)
    return best


def _time_steps(step, args, n_steps: int, device, trials: int = 3) -> float:
    """Best-of seconds per step of n_steps chained step calls."""

    def run():
        f_s = args[0]
        for _ in range(n_steps):
            f_s, _ = step(f_s, *args[1:])

    return _best_of(run, device, trials) / n_steps


def _point(points, n, x, sec, pts):
    base = points[0].grid_points_per_s if points else pts
    points.append(ScalePoint(n, x, sec, pts, pts / base))
    return points[-1]


def weak_scaling_mpdata(device_counts=(1, 2, 4, 8), nx_per_device: int = 64,
                        nslices: int = 48, nz: int = 58,
                        dtype: str = "float32", n_steps: int = 20,
                        overlap: bool = True, quiet: bool = False,
                        device="cuda") -> list[ScalePoint]:
    """Grow the global x domain with the shard count and time the
    halo-exchange dist step (the split step with overlap=True)."""
    say = (lambda *a: None) if quiet else print
    points: list[ScalePoint] = []
    for n in device_counts:
        cfg = with_overrides(MpdataConfig(), nx=nx_per_device * n,
                             nslices=nslices, nz=nz, dtype=dtype)
        m = meshmod.make_mesh(n, device)
        shard_inputs, step_plain, _ = dist_mpdata.make_dist_step(cfg, m)
        step = (dist_mpdata.make_dist_step_overlap(cfg, m) if overlap
                else step_plain)
        args = shard_inputs(problem.init_data(cfg))
        sec = _time_steps(step, args, n_steps, m.device)
        p = _point(points, n, cfg.nx, sec, cfg.grid_points / sec)
        say(f" weak-scaling mpdata n={n:<2d} nx={cfg.nx:<5d} "
            f"{sec * 1e6:10.3f} us/step {p.grid_points_per_s / 1e6:10.1f} "
            f"M pts/s eff={p.efficiency * 100:5.1f}% ({n} shards on {_on(m)})")
    return points


def weak_scaling_mpdata_slices(device_counts=(1, 2, 4, 8),
                               nslices_per_device: int = 16, nx: int = 64,
                               nz: int = 58, dtype: str = "float32",
                               n_steps: int = 20, quiet: bool = False,
                               device="cuda") -> list[ScalePoint]:
    """Grow nslices with the shard count and time the zero-exchange
    slice-batch loop (dist.mpdata.make_dist_loop_slices)."""
    say = (lambda *a: None) if quiet else print
    points: list[ScalePoint] = []
    for n in device_counts:
        cfg = with_overrides(MpdataConfig(), nx=nx,
                             nslices=nslices_per_device * n, nz=nz,
                             dtype=dtype)
        m = meshmod.make_mesh(n, device)
        si, loop = dist_mpdata.make_dist_loop_slices(cfg, m)
        args = si(problem.init_data(cfg))
        sec = _best_of(lambda: loop(*args, n_steps), m.device) / n_steps
        p = _point(points, n, cfg.nslices, sec, cfg.grid_points / sec)
        say(f" weak-scaling mpdata-slices n={n:<2d} nslices={cfg.nslices:<5d} "
            f"{sec * 1e6:10.3f} us/step {p.grid_points_per_s / 1e6:10.1f} "
            f"M pts/s eff={p.efficiency * 100:5.1f}% ({n} shards on {_on(m)})")
    return points


def overlap_gain_mpdata(n_devices: int = 8, nx_per_device: int = 64,
                        n_steps: int = 20, dtype: str = "float32",
                        quiet: bool = False, device="cuda") -> dict:
    """The serialized step against the split (interior + strips) step at a
    fixed size.  On one card nothing overlaps, so the gain reads the cost
    of the split form's extra launches."""
    say = (lambda *a: None) if quiet else print
    n = n_devices
    cfg = with_overrides(MpdataConfig(), nx=nx_per_device * n, dtype=dtype)
    m = meshmod.make_mesh(n, device)
    shard_inputs, step_plain, _ = dist_mpdata.make_dist_step(cfg, m)
    step_ov = dist_mpdata.make_dist_step_overlap(cfg, m)
    args = shard_inputs(problem.init_data(cfg))
    t_plain = _time_steps(step_plain, args, n_steps, m.device)
    t_ov = _time_steps(step_ov, args, n_steps, m.device)
    gain = (t_plain - t_ov) / t_plain
    say(f" overlap n={n}: plain {t_plain * 1e6:10.3f} us/step, split "
        f"{t_ov * 1e6:10.3f} us/step, gain {gain * 100:5.1f}% "
        f"({n} shards on {_on(m)})")
    return {"n_shards": n, "plain_s": t_plain, "overlap_s": t_ov,
            "gain": gain}


def comm_avoid_gain_mpdata(n_devices: int = 8, nx_per_device: int = 64,
                           kstep: int = 4, n_steps: int = 16,
                           dtype: str = "float32", quiet: bool = False,
                           device="cuda") -> dict:
    """The per-step dist loop against the communication-avoiding kstep loop
    (a 3·kstep halo once per kstep steps in one launch per shard) at a
    fixed size; on one card only the overcompute side shows."""
    say = (lambda *a: None) if quiet else print
    n = n_devices
    n_steps = max(kstep, n_steps - n_steps % kstep)
    cfg = with_overrides(MpdataConfig(), nx=nx_per_device * n, dtype=dtype)
    m = meshmod.make_mesh(n, device)
    shard_inputs, _, _ = dist_mpdata.make_dist_step(cfg, m, kernel="xmajor")
    args = shard_inputs(problem.init_data(cfg))

    def time_loop(loop):
        return _best_of(lambda: loop(*args, n_steps), m.device) / n_steps

    t_step = time_loop(dist_mpdata.make_dist_loop(cfg, m, kernel="xmajor"))
    t_ca = time_loop(dist_mpdata.make_dist_loop(cfg, m, kernel="xmajor",
                                                kstep=kstep))
    gain = (t_step - t_ca) / t_step
    say(f" comm-avoid mpdata n={n} kstep={kstep}: per-step "
        f"{t_step * 1e6:10.3f} us/step, kloop {t_ca * 1e6:10.3f} us/step, "
        f"gain {gain * 100:5.1f}% ({n} shards on {_on(m)})")
    return {"n_shards": n, "kstep": kstep, "per_step_s": t_step,
            "kloop_s": t_ca, "gain": gain}


def _time_dss_steps(step, q_s, aux, n_steps: int, device) -> float:
    """Best-of seconds per step of n_steps chained DSS steps."""

    def run():
        q = q_s
        for _ in range(n_steps):
            q = step(q, aux)

    return _best_of(run, device) / n_steps


def comm_avoid_gain_dss(n_devices: int = 8, nelemd_per_device: int = 16,
                        kstep: int = 4, n_steps: int = 16, nlev: int = 8,
                        qsize: int = 2, dtype: str = "float32",
                        quiet: bool = False, device="cuda") -> dict:
    """The per-step dist ring DSS loop against the communication-avoiding
    kstep loop (kstep elements exchanged per side once per kstep steps of
    the window-fed K14) at a fixed size per shard."""
    say = (lambda *a: None) if quiet else print
    n = n_devices
    n_steps = max(kstep, n_steps - n_steps % kstep)
    cfg = with_overrides(BiharmonicConfig(), nelemd=nelemd_per_device * n,
                         nlev=nlev, qsize=qsize, dtype=dtype)
    m = meshmod.make_mesh(n, device)
    data = bproblem.init_data(cfg)

    def time_loop(shard_inputs, loop):
        q_s, aux = shard_inputs(data)
        return _best_of(lambda: loop(q_s, aux, n_steps), m.device) / n_steps

    t_step = time_loop(dist_bi.make_dist_step_dss(cfg, m)[0],
                       dist_bi.make_dist_loop_dss(cfg, m))
    si, loop_k, _ = dist_bi.make_dist_loop_dss_kstep(cfg, m, kstep=kstep)
    t_ca = time_loop(si, loop_k)
    gain = (t_step - t_ca) / t_step
    say(f" comm-avoid dss n={n} kstep={kstep}: per-step {t_step * 1e6:10.3f} "
        f"us/step, kloop {t_ca * 1e6:10.3f} us/step, gain {gain * 100:5.1f}% "
        f"({n} shards on {_on(m)})")
    return {"n_shards": n, "kstep": kstep, "per_step_s": t_step,
            "kloop_s": t_ca, "gain": gain}


def comm_avoid_gain_dss2d(n_devices: int = 4, kstep: int = 4,
                          n_steps: int = 16, nelemd: int | None = None,
                          nlev: int = 8, qsize: int = 2,
                          dtype: str = "float32", quiet: bool = False,
                          device="cuda") -> dict:
    """The per-step dist rowchain (one t row exchanged per side per step)
    against the communication-avoiding kstep rowchain (kstep rows once per
    kstep shrinking-window sub-steps) on the torus."""
    say = (lambda *a: None) if quiet else print
    n = n_devices
    if nelemd is None:
        nelemd = 4 * n * n * max(1, kstep // 2) ** 2
    ex, _ = torus_shape(nelemd)
    if ex % n or ex // n < kstep:
        raise ValueError(f"nelemd={nelemd} (ex={ex}) cannot host kstep={kstep} "
                         f"on {n} shards")
    # the kstep loop chains n-1 t-steps between the two bridges: make
    # (n_steps - 1) a kstep multiple so every chain is a full-kstep one
    n_steps = kstep * max(1, (n_steps - 1) // kstep) + 1
    cfg = with_overrides(BiharmonicConfig(), nelemd=nelemd, nlev=nlev,
                         qsize=qsize, dtype=dtype)
    m = meshmod.make_mesh(n, device)
    data = bproblem.init_data(cfg)

    def time_loop(factory):
        si, loop, _ = factory
        q_s, aux = si(data)
        return _best_of(lambda: loop(q_s, aux, n_steps), m.device) / n_steps

    t_step = time_loop(dist_bi.make_dist_loop_dss2d_rowchain(cfg, m))
    t_ca = time_loop(dist_bi.make_dist_loop_dss2d_rowchain_kstep(
        cfg, m, kstep=kstep))
    gain = (t_step - t_ca) / t_step
    say(f" comm-avoid dss2d n={n} kstep={kstep} nelemd={nelemd}: per-step "
        f"{t_step * 1e6:10.3f} us/step, kloop {t_ca * 1e6:10.3f} us/step, "
        f"gain {gain * 100:5.1f}% ({n} shards on {_on(m)})")
    return {"n_shards": n, "kstep": kstep, "per_step_s": t_step,
            "kloop_s": t_ca, "gain": gain}


def weak_scaling_biharmonic(device_counts=(1, 2, 4, 8),
                            nelemd_per_device: int = 16, nlev: int = 72,
                            qsize: int = 40, dtype: str = "float32",
                            n_steps: int = 10, overlap: bool = True,
                            quiet: bool = False,
                            device="cuda") -> list[ScalePoint]:
    """Grow the element ring with the shard count and time the ring-DSS
    dist step (two GLL boundary columns exchanged per step; the overlap
    form where a shard has two elements)."""
    say = (lambda *a: None) if quiet else print
    points: list[ScalePoint] = []
    for n in device_counts:
        cfg = with_overrides(BiharmonicConfig(), nelemd=nelemd_per_device * n,
                             nlev=nlev, qsize=qsize, dtype=dtype)
        m = meshmod.make_mesh(n, device)
        si, step, _ = dist_bi.make_dist_step_dss(
            cfg, m, overlap=overlap and nelemd_per_device >= 2)
        q_s, aux = si(bproblem.init_data(cfg))
        sec = _time_dss_steps(step, q_s, aux, n_steps, m.device)
        p = _point(points, n, cfg.nelemd, sec, cfg.grid_points / sec)
        say(f" weak-scaling biharmonic_dss n={n:<2d} nelemd={cfg.nelemd:<5d} "
            f"{sec * 1e6:10.3f} us/step {p.grid_points_per_s / 1e6:10.1f} "
            f"M pts/s eff={p.efficiency * 100:5.1f}% ({n} shards on {_on(m)})")
    return points


def weak_scaling_dss2d(mesh_shapes=((1, 1), (1, 2), (2, 2), (2, 4)),
                       nelemd_per_device: int = 16, nlev: int = 72,
                       qsize: int = 40, dtype: str = "float32",
                       n_steps: int = 10, quiet: bool = False,
                       device="cuda") -> list[ScalePoint]:
    """Grow the element torus with a 2-D mesh (both axes) and time the
    torus-DSS dist step (a column exchange along pj, then a row exchange of
    the j-summed field along pi).  Each shard keeps a fixed patch of the
    grid; a mesh whose grid does not factorise that way takes a
    2x2-per-shard patch of 4 elements each, or is skipped."""
    say = (lambda *a: None) if quiet else print
    points: list[ScalePoint] = []
    ex0, ey0 = torus_shape(nelemd_per_device)
    for pi, pj in mesh_shapes:
        n = pi * pj
        # grow the torus with the mesh, keeping torus_shape's factorization
        # consistent with it (ex a multiple of pi, ey of pj)
        nelemd = (ex0 * pi) * (ey0 * pj)
        ex, ey = torus_shape(nelemd)
        if ex % pi or ey % pj:
            nelemd = (2 * pi) * (2 * pj) * 4
            ex, ey = torus_shape(nelemd)
            if ex % pi or ey % pj:
                continue
        cfg = with_overrides(BiharmonicConfig(), nelemd=nelemd, nlev=nlev,
                             qsize=qsize, dtype=dtype)
        m = meshmod.make_mesh2d(shape=(pi, pj), device=device)
        si, step, _ = dist_bi.make_dist_step_dss2d(cfg, m)
        q_s, aux = si(bproblem.init_data(cfg))
        sec = _time_dss_steps(step, q_s, aux, n_steps, m.device)
        p = _point(points, n, cfg.nelemd, sec, cfg.grid_points / sec)
        say(f" weak-scaling biharmonic_dss2d mesh={pi}x{pj} "
            f"nelemd={cfg.nelemd:<5d} {sec * 1e6:10.3f} us/step "
            f"{p.grid_points_per_s / 1e6:10.1f} M pts/s "
            f"eff={p.efficiency * 100:5.1f}% ({n} shards on {_on(m)})")
    return points


def overlap_gain_biharmonic(n_devices: int = 8, nelemd_per_device: int = 16,
                            n_steps: int = 10, dtype: str = "float32",
                            quiet: bool = False, device="cuda") -> dict:
    """The serialized ring-DSS step against the overlap (edge-patch) form at
    a fixed size; on one card nothing overlaps, so the gain reads the cost
    of the patch's two extra element applications per shard."""
    say = (lambda *a: None) if quiet else print
    n = n_devices
    cfg = with_overrides(BiharmonicConfig(), nelemd=nelemd_per_device * n,
                         dtype=dtype)
    m = meshmod.make_mesh(n, device)
    data = bproblem.init_data(cfg)

    def time_step(overlap):
        si, step, _ = dist_bi.make_dist_step_dss(cfg, m, overlap=overlap)
        q_s, aux = si(data)
        return _time_dss_steps(step, q_s, aux, n_steps, m.device)

    t_plain = time_step(False)
    t_ov = time_step(True)
    gain = (t_plain - t_ov) / t_plain
    say(f" overlap biharmonic_dss n={n}: plain {t_plain * 1e6:10.3f} us/step, "
        f"overlapped {t_ov * 1e6:10.3f} us/step, gain {gain * 100:5.1f}% "
        f"({n} shards on {_on(m)})")
    return {"n_shards": n, "plain_s": t_plain, "overlap_s": t_ov,
            "gain": gain}
