"""Domain-decomposed MPDATA (the port of ``cdk_tpu.dist.mpdata``).

The global x axis is split into P contiguous owned chunks over a mesh
(`dist.mesh`: P shards on one device).  Each step every shard receives H
halo columns from its neighbours, runs the *masked-global* MPDATA core on
its extended (owned + 2H) columns and keeps the owned ones; the domain
flux sums become owned-column partial sums added over the shards.

Masked-global core: the single-device reference
(`kernels/mpdata/reference.advect_scalar2d`) applies the Fortran loops'
x-range restrictions by position, which cannot be cut at an arbitrary x.
`advect_scalar2d_masked` (the plain version of K20-K25, beside them in
`kernels/mpdata/masked.py`) computes every stage with uniform stencils
over all columns of a collocated layout (f, u, w on one x grid) and applies
each range restriction as a `where` on the column's GLOBAL Fortran index,
so a shard holding any window of global columns computes exactly the
global values for its owned region, provided H >= 3 (f_out(i) reads
f(i±3)).  Collocated layout: column ix holds Fortran index gi = ix - 2 of
f; u(gi) and w(gi) are stored at the same ix (zeros where undefined).

The step factories return plain Python callables over (P, S, chunk, ·) tensors;
each shard's core is one kernel launch (`kernels/mpdata/masked.py`, K20-K25,
or the single-chip K2 for the slice-batch loop).  The JAX `unroll` knob
schedules XLA scans and has no counterpart: the loops here are Python
loops of launches.
"""

from __future__ import annotations

import torch

from cdk_torch.core.trace import span
from cdk_torch.dist import mesh as meshmod
from cdk_torch.dist.mesh import Mesh
from cdk_torch.kernels.mpdata import masked
from cdk_torch.kernels.mpdata.masked import advect_scalar2d_masked
from cdk_torch.kernels.mpdata.problem import MpdataData
from cdk_torch.kernels.mpdata.resident import advect_resident

# Exchange halo width: the f -> f_out stencil dependency depth.
HALO = 3
# The JAX package runs its x-major core when nz fits one 64-lane segment
# (`pallas_packed.SEG`); the port keeps the rule so both run the same name.
XMAJOR_MAX_NZ = 64


def to_collocated(data: MpdataData):
    """-> (f, u_g, w_g) on the common x grid (S, nx+6, ·); u/w are padded
    with zeros at the collocated slots where they are undefined."""
    s, _, nzm = data.f.shape
    z = data.f.new_zeros((s, 1, nzm))
    zw = data.f.new_zeros((s, 1, nzm + 1))
    u_g = torch.cat([z, data.u], dim=1)            # gi >= -1
    w_g = torch.cat([zw, data.w, zw], dim=1)       # gi in [-1, nx+2]
    return data.f, u_g, w_g


def advect_masked_global(data: MpdataData):
    """Single-device entry: the masked core on the full global grid."""
    f, u_g, w_g = to_collocated(data)
    X = f.shape[1]
    gi = torch.arange(X, device=f.device) - 2
    owned = torch.ones(X, dtype=torch.bool, device=f.device)
    f_out, flux = advect_scalar2d_masked(
        f, u_g, w_g, data.rho, data.rhow, data.adz, gi, owned, X - 6)
    nzm = f.shape[-1]
    return f_out, torch.cat([flux, data.flux[:, nzm:]], dim=-1)


# ------------------------------------------------ the decomposed step forms
def _resolve_kernel(cfg, kernel):
    """AUTO (None) -> the x-major core where the JAX package runs it (nz <=
    64), else the z-on-lanes core; "packed" and "jnp" by name."""
    if kernel is not None:
        return kernel
    return "xmajor" if cfg.nz <= XMAJOR_MAX_NZ else "pallas"


def _make_core(cfg, kernel: str):
    """-> core(f_, u_, w_, rho, rhow, adz, gi0_, lo, hi): one masked step on
    a column window whose owned outputs are local columns [lo, hi); returns
    (f_out over the window, flux partial (S, nzm))."""
    nx, nzm = cfg.nx, cfg.nzm
    if kernel == "jnp":  # the plain masked core (the JAX package's XLA form)
        def core(f_, u_, w_, rho, rhow, adz, gi0_, lo, hi):
            return masked.masked_step_plain(f_, u_, w_, rho, rhow, adz, gi0_,
                                            nx, lo, hi)
        return core
    if kernel == "pallas":
        def core(f_, u_, w_, rho, rhow, adz, gi0_, lo, hi):
            return masked.masked_step_pallas(f_, u_, w_, rho, rhow, adz, gi0_,
                                             nx=nx, owned_lo=lo, owned_hi=hi)
        return core
    wrappers = {"packed": masked.masked_step_pallas_packed,
                "xmajor": masked.masked_step_xmajor}
    if kernel not in wrappers:
        raise ValueError(f"unknown masked core {kernel!r} "
                         f"(pallas, packed, xmajor or jnp)")
    wrapper = wrappers[kernel]

    def core(f_, u_, w_, rho, rhow, adz, gi0_, lo, hi):
        return wrapper(f_, u_, w_, rho, rhow, adz, gi0_, nx=nx, nzm=nzm,
                       owned_lo=lo, owned_hi=hi)
    return core


def _chunk(cfg, mesh: Mesh, halo: int) -> int:
    """Owned columns per shard: the global grid padded to P·chunk.  Raises
    where a shard's chunk cannot supply its neighbours' halo."""
    chunk = -(-(cfg.nx + 6) // mesh.size)
    if mesh.size > 1 and chunk < halo:
        raise ValueError(f"chunk={chunk} < halo={halo}: too many shards for "
                         f"nx={cfg.nx}")
    return chunk


def _flux_out(flux, flux_in, nzm):
    """flux(:, nz) is never written by the reference: it passes through."""
    return torch.cat([flux, flux_in[:, nzm:]], dim=-1)


def make_dist_step(cfg, mesh: Mesh, halo: int = HALO,
                   kernel: str | None = None):
    """Build (shard_inputs, step, gather_f) for x-decomposed MPDATA.

    shard_inputs(data) -> (f_s, u_s, w_s, aux): the collocated fields as
    (P, S, chunk, ·) on the mesh's device, aux = (rho, rhow, adz, flux);
    step(f_s, u_s, w_s, aux) -> (f_s_next, flux): one step, halo exchange
    then one masked-core launch per shard, with the flux partials summed
    over the shards; gather_f(f_s) -> f (S, nx+6, nzm).

    kernel: None (AUTO, see _resolve_kernel), "pallas" (K20), "packed"
    (K21), "xmajor" (K22) or "jnp" (the plain masked core).  All four are
    the same arithmetic on the same canonical layout, so shard_inputs and
    gather_f are shared by every kernel choice."""
    core = _make_core(cfg, _resolve_kernel(cfg, kernel))
    chunk = _chunk(cfg, mesh, halo)
    xg, nzm = cfg.nx + 6, cfg.nzm

    def shard_inputs(data: MpdataData):
        f, u_g, w_g = to_collocated(data)
        aux = tuple(t.to(mesh.device).contiguous()
                    for t in (data.rho, data.rhow, data.adz, data.flux))
        return (*(meshmod.shard_x(a, mesh, chunk) for a in (f, u_g, w_g)), aux)

    def step(f_s, u_s, w_s, aux):
        rho, rhow, adz, flux_in = aux
        f_ext, u_ext, w_ext = (meshmod.exchange(a, halo) for a in (f_s, u_s, w_s))
        f_w, flux = _run_shards(mesh, lambda p: core(
            f_ext[p], u_ext[p], w_ext[p], rho, rhow, adz,
            p * chunk - 2 - halo, halo, halo + chunk))
        return (f_w[:, :, halo:halo + chunk].contiguous(),
                _flux_out(flux, flux_in, nzm))

    def gather_f(f_s):
        return meshmod.gather_x(f_s)[:, :xg]

    return shard_inputs, step, gather_f


def make_dist_step_overlap(cfg, mesh: Mesh, halo: int = HALO,
                           kernel: str | None = None):
    """The decomposed step split as the JAX package splits it for
    comm/compute overlap: per shard, the masked core on the unextended
    chunk (valid for every column >= DEPTH = 3 from the shard's edges, and
    independent of the exchange), then on two thin strips (halo + DEPTH + 3
    columns) once the halos are there, whose DEPTH owned edge columns are
    patched over the interior result.  The same per-column arithmetic as
    make_dist_step, three column geometries per shard.

    On one card the shards run one after another on one stream, so there
    is no exchange to overlap: this form costs two extra launches per
    shard and keeps the JAX path's structure for a multi-process mesh.
    Uses make_dist_step's shard_inputs and gather_f."""
    core0 = _make_core(cfg, _resolve_kernel(cfg, kernel))
    nzm = cfg.nzm
    depth = 3            # stencil dependency depth of the masked core
    need = depth + 3     # strip columns needed beyond the patched region
    chunk = _chunk(cfg, mesh, max(halo, need))

    def step(f_s, u_s, w_s, aux):
        rho, rhow, adz, flux_in = aux
        strips = [meshmod.exchange_strips(a, halo) for a in (f_s, u_s, w_s)]
        outs, parts = [], []
        for p in range(mesh.size):
            gi0 = p * chunk - 2
            loc = (f_s[p], u_s[p], w_s[p])

            def core(arrs, gi0_, lo, hi):
                return core0(*arrs, rho, rhow, adz, gi0_, lo, hi)

            f_int, flux_int = core(loc, gi0, depth, chunk - depth)
            fl, flux_l = core([torch.cat([s[0][p], a[:, :need]], dim=1)
                               for s, a in zip(strips, loc)],
                              gi0 - halo, halo, halo + depth)
            fr, flux_r = core([torch.cat([a[:, -need:], s[1][p]], dim=1)
                               for s, a in zip(strips, loc)],
                              gi0 + chunk - need, need - depth, need)
            outs.append(torch.cat([fl[:, halo:halo + depth],
                                   f_int[:, depth:chunk - depth],
                                   fr[:, need - depth:need]], dim=1))
            parts.append(flux_int + flux_l + flux_r)
        with span("cdk.dist.gather"):
            flux = meshmod.psum(torch.stack(parts))
            f_s = torch.stack(outs)
        return f_s, _flux_out(flux, flux_in, nzm)

    return step


def make_dist_loop_slices(cfg, mesh: Mesh):
    """Slice-batch (data-parallel) distributed MPDATA, the scaling axis the
    reference itself uses (each node its own slice batch).  The slices are
    split into P contiguous ranges and each shard runs the single-chip
    resident kernel (K2, `resident.advect_resident`: the n-step loop in one
    launch) on its own slices.  There is no exchange and no collective:
    every field, flux included, is per slice.

    Returns (shard_inputs, loop): shard_inputs(data) -> (f, u, w, aux) in
    the canonical layout on the mesh's device, aux = (rho, rhow, adz,
    flux); loop(f, u, w, aux, n) -> (f, flux) after n steps, in the same
    global layout (a shard's slices are a contiguous range of it)."""
    s = cfg.nslices
    if mesh.size > s:
        raise ValueError(f"{mesh.size} shards for {s} slices")
    bounds = [(p * s // mesh.size, (p + 1) * s // mesh.size)
              for p in range(mesh.size)]

    def shard_inputs(data: MpdataData):
        f, u, w, rho, rhow, adz, flux = (
            t.to(mesh.device).contiguous() for t in
            (data.f, data.u, data.w, data.rho, data.rhow, data.adz, data.flux))
        return f, u, w, (rho, rhow, adz, flux)

    def loop(f, u, w, aux, n: int):
        rho, rhow, adz, flux = aux
        outs = [advect_resident(f[lo:hi], u[lo:hi], w[lo:hi], rho[lo:hi],
                                rhow[lo:hi], adz[lo:hi], flux[lo:hi], n)
                for lo, hi in bounds]
        return (torch.cat([o[0] for o in outs]),
                torch.cat([o[1] for o in outs]))

    return shard_inputs, loop


def make_dist_loop(cfg, mesh: Mesh, halo: int = HALO, overlap: bool = False,
                   kernel: str | None = None, kstep: int = 1,
                   split: bool = True):
    """n-step distributed integration: loop(f_s, u_s, w_s, aux, n) ->
    (f_s, flux) on make_dist_step's sharded layout.

    kstep > 1 (x-major only) is the communication-avoiding form: a
    3·kstep-deep halo is exchanged once per kstep steps, which run in one
    launch per shard (K25; K24 on a pre-built window with split=False);
    after k masked applications the owned chunk is still exact, as each
    shrinks the valid window by the stencil depth.  The default
    (kstep = 1, no overlap) exchanges the step-invariant u/w halos once per
    run and each step only f; with the x-major core the f window is
    assembled in the kernel from the strips (K23).  overlap=True chains
    make_dist_step_overlap.

    At n = 0 every form returns f and flux_in unchanged (the JAX x-major
    loop returns a zero flux there)."""
    if kstep > 1:
        return _make_dist_kloop(cfg, mesh, kstep, kernel, split=split)
    if not overlap:
        return _make_dist_loop_hoisted(cfg, mesh, halo, kernel)
    step = make_dist_step_overlap(cfg, mesh, halo, kernel=kernel)

    def loop(f_s, u_s, w_s, aux, n: int):
        if n < 0:
            raise ValueError(f"n must be >= 0 (got {n})")
        rho, rhow, adz, flux = aux
        for _ in range(n):
            f_s, flux = step(f_s, u_s, w_s, (rho, rhow, adz, flux))
        return f_s, flux

    return loop


def _run_shards(mesh: Mesh, launch):
    """launch(p) -> (f_out, flux partial) for each shard p, in order; ->
    (f stacked over the shards, the partials summed)."""
    outs = [launch(p) for p in range(mesh.size)]
    with span("cdk.dist.gather"):
        return (torch.stack([o[0] for o in outs]),
                meshmod.psum(torch.stack([o[1] for o in outs])))


def _make_dist_loop_hoisted(cfg, mesh: Mesh, halo: int, kernel: str | None):
    """Serialized dist loop with the step-invariant u/w halo exchange out of
    the step loop: each step exchanges only f and runs make_dist_step's
    masked core on the same window; the x-major core takes the f strips
    and the owned block apart (K23) and writes the owned columns only."""
    kernel = _resolve_kernel(cfg, kernel)
    core = None if kernel == "xmajor" else _make_core(cfg, kernel)
    split_step = masked.masked_step_xmajor_split
    nx, nzm = cfg.nx, cfg.nzm
    chunk = _chunk(cfg, mesh, halo)

    def loop(f_s, u_s, w_s, aux, n: int):
        if n < 0:
            raise ValueError(f"n must be >= 0 (got {n})")
        rho, rhow, adz, flux_in = aux
        if n == 0:
            return f_s, flux_in
        u_ext, w_ext = meshmod.exchange(u_s, halo), meshmod.exchange(w_s, halo)
        strips = None
        for _ in range(n):
            if core is None:
                strips = meshmod.exchange_strips(f_s, halo, out=strips)
                lh, rh = strips
                f_s, flux = _run_shards(mesh, lambda p: split_step(
                    f_s[p], lh[p], rh[p], u_ext[p], w_ext[p], rho, rhow, adz,
                    p * chunk - 2 - halo, nx=nx, nzm=nzm, halo=halo))
            else:
                f_ext = meshmod.exchange(f_s, halo)
                f_w, flux = _run_shards(mesh, lambda p: core(
                    f_ext[p], u_ext[p], w_ext[p], rho, rhow, adz,
                    p * chunk - 2 - halo, halo, halo + chunk))
                f_s = f_w[:, :, halo:halo + chunk].contiguous()
        return f_s, _flux_out(flux, flux_in, nzm)

    return loop


def _make_dist_kloop(cfg, mesh: Mesh, kstep: int, kernel: str | None,
                     split: bool = True):
    """Communication-avoiding dist loop (see make_dist_loop): x-major only;
    split=True assembles the deep f halo in the kernel (K25), split=False
    runs K24 on the exchanged window."""
    kernel = _resolve_kernel(cfg, kernel)
    if kernel != "xmajor":
        raise ValueError(f"kstep > 1 requires the x-major kernel "
                         f"(resolved {kernel!r})")
    h = 3 * kstep
    kloop, kloop_split = masked.masked_kloop_xmajor, masked.masked_kloop_xmajor_split
    nx, nzm = cfg.nx, cfg.nzm
    chunk = _chunk(cfg, mesh, h)

    def loop(f_s, u_s, w_s, aux, n: int):
        if n < 0 or n % kstep:
            raise ValueError(f"n={n} not a non-negative multiple of "
                             f"kstep={kstep}")
        rho, rhow, adz, flux_in = aux
        if n == 0:
            return f_s, flux_in
        u_ext, w_ext = meshmod.exchange(u_s, h), meshmod.exchange(w_s, h)
        strips = None
        for _ in range(n // kstep):
            if split:
                strips = meshmod.exchange_strips(f_s, h, out=strips)
                lh, rh = strips
                f_s, flux = _run_shards(mesh, lambda p: kloop_split(
                    f_s[p], lh[p], rh[p], u_ext[p], w_ext[p], rho, rhow, adz,
                    p * chunk - 2 - h, nx=nx, nzm=nzm, halo=h, nsteps=kstep))
            else:
                f_ext = meshmod.exchange(f_s, h)
                f_w, flux = _run_shards(mesh, lambda p: kloop(
                    f_ext[p], u_ext[p], w_ext[p], rho, rhow, adz,
                    p * chunk - 2 - h, nx=nx, nzm=nzm, owned_lo=h,
                    owned_hi=h + chunk, nsteps=kstep))
                f_s = f_w[:, :, h:h + chunk].contiguous()
        return f_s, _flux_out(flux, flux_in, nzm)

    return loop
