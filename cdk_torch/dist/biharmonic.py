"""Domain-decomposed biharmonic (the port of ``cdk_tpu.dist.biharmonic``).

The element-local biharmonic decomposes with no exchange (`shard_data`,
`make_dist_step`).  The DSS families exchange boundary data between shards
of a periodic domain (`dist/mesh.py`: P logical shards on one device,
`ring_strips`/`ring_exchange` in place of `lax.ppermute`):

- the ring (`make_dist_step_dss`, serial and overlap, and its loop): each
  step every shard receives one GLL boundary column from each neighbour;
  the applies are the per-element operator products in plain torch;
- the torus on a (pi, pj) mesh (`make_dist_step_dss2d` and its loop): the
  j-pass column exchange along pj, then the i-pass row exchange of the
  j-summed field along pi, so corners collect all four sharers;
- the row-sharded t-carry rowchain (`make_dist_loop_dss2d_rowchain`, serial
  with k-step blocks, and overlap; `make_dist_loop_dss2d_rowchain_kstep`):
  K15 on a shard's rows, then the padded modes of the rowchain kernels,
  K16p per step, K18p for a k-step block, K17p to finish;
- the communication-avoiding ring (`make_dist_loop_dss_kstep`): kstep
  elements exchanged per side once per kstep steps, run by the window-fed
  K14 (K14w) on each shard.

Sharded fields lead with the shard axis, (P, elements per shard, 16, ncol)
in the lane layout ((pi, pj, rows, columns, 16, ncol) on the 2-D mesh), so
each shard's block is contiguous for its launch; shards launch one after
another.  Each factory returns (shard_inputs, step or loop, gather) as the
JAX one does, with static per-shard aux (operators, inverse mass) built
once by shard_inputs; gather returns the global (e, q, k, np, np) qtens on
the mesh's device.  The JAX forms' 8-element grouping, centre-block size
`B`, `GEOM_BUDGET`, lane pad `ncolp` and the rowchain's row blocking `bi_d`
are TPU machinery and are not ported: K14w's halo counts elements, and
K18p is one cooperative launch over a shard's rows.
"""

from __future__ import annotations

import torch

from cdk_torch.core.trace import span
from cdk_torch.dist import mesh as meshmod
from cdk_torch.dist.mesh import Mesh, Mesh2d
from cdk_torch.kernels.biharmonic import dss2d_rowchain as rc
from cdk_torch.kernels.biharmonic.dss import dss_weights
from cdk_torch.kernels.biharmonic.dss2d import dss2d_weights, torus_shape
from cdk_torch.kernels.biharmonic.dss_resident import (
    MAX_STEPS,
    dss_resident_window,
)
from cdk_torch.kernels.biharmonic.operator import (
    apply_operator,
    build_element_operator,
    precompose_operator,
)
from cdk_torch.kernels.biharmonic.problem import (
    BiharmonicData,
    from_lane_layout,
    to_lane_layout,
)
from cdk_torch.kernels.biharmonic.reference import (
    biharmonic_wk_reference,
    rrearth_as,
)

NPG = 4
NPTS = NPG * NPG


def _shards(x: torch.Tensor, n: int) -> torch.Tensor:
    """(e, ...) -> (n, e/n, ...) contiguous: shard p owns a contiguous range."""
    return x.reshape(n, x.shape[0] // n, *x.shape[1:]).contiguous()


def _apply(L: torch.Tensor, q: torch.Tensor, precision: str) -> torch.Tensor:
    """Per-element operator products over any leading (shard, element)
    axes: L (..., 16, 16), q (..., 16, ncol)."""
    out = apply_operator(L.reshape(-1, NPTS, NPTS),
                         q.reshape(-1, NPTS, q.shape[-1]), precision)
    return out.reshape(q.shape)


def _lane_inputs(cfg, data: BiharmonicData, device):
    """The element operators L (e, 16, 16) and the lane-layout q (e, 16,
    ncol), built on `device`."""
    data = data.to(device)
    L = build_element_operator(data.dvv, data.dinv, data.spheremp,
                               data.tensorvisc, rrearth_as(cfg))
    return L, to_lane_layout(data.qtens)


def _gather(cfg):
    def gather(q_s: torch.Tensor) -> torch.Tensor:
        """(P, e/P, 16, ncol) -> the global qtens (e, q, k, np, np)."""
        return from_lane_layout(q_s.reshape(cfg.nelemd, NPTS, cfg.ncol), cfg)

    return gather


# ------------------------------------------------ element-local, no exchange
def shard_data(data: BiharmonicData, mesh: Mesh) -> BiharmonicData:
    """Per-element arrays as (P, e/P, ...) on the mesh's device; dvv
    replicated.  nelemd must be divisible by the mesh size."""
    e = data.qtens.shape[0]
    if e % mesh.size:
        raise ValueError(f"nelemd={e} not divisible by {mesh.size}")
    d = data.to(mesh.device)
    return BiharmonicData(d.dvv, *(_shards(t, mesh.size) for t in
                                   (d.dinv, d.spheremp, d.tensorvisc, d.qtens)))


def make_dist_step(cfg, mesh: Mesh):
    """The element-sharded step: each shard runs the plain reference on its
    elements, with no exchange.  step(shard_data(...)) -> the global
    (e, q, k, np, np) output."""
    rr = rrearth_as(cfg)

    def step(data: BiharmonicData) -> torch.Tensor:
        return torch.cat([biharmonic_wk_reference(
            data.qtens[p], data.dvv, data.dinv[p], data.spheremp[p],
            data.tensorvisc[p], rr) for p in range(mesh.size)])

    return step


# ------------------------------------------------ the ring DSS, per step
def make_dist_step_dss(cfg, mesh: Mesh, overlap: bool = False):
    """Element-sharded two-application biharmonic with the ring DSS between.

    Returns (shard_inputs, step, gather):
      shard_inputs(data) -> (q_s (P, e/P, 16, ncol), aux = (L, w)): the
        per-element operators (P, e/P, 16, 16) and the inverse assembled
        mass (P, e/P, 16) in lane order, static per problem;
      step(q_s, aux) -> the next q_s;
      gather(q_s) -> the global qtens.

    Each step every shard sends its first element's j=0 column to the left
    and its last element's j=np-1 column to the right.  overlap=True is the
    JAX full-batch-with-edge-patch form: both applications over the whole
    shard with the remote columns zeroed, then the shard's first and last
    elements recomputed with the exchanged columns and patched over, bit
    for bit the serial step (on one stream nothing overlaps)."""
    P = mesh.size
    if cfg.nelemd % P:
        raise ValueError(f"nelemd={cfg.nelemd} not divisible by {P}")
    e_loc = cfg.nelemd // P
    if overlap and e_loc < 2:
        raise ValueError("overlap form needs >= 2 elements per shard")
    precision = "highest" if cfg.dtype == "float64" else "high"
    ncol = cfg.ncol

    def shard_inputs(data: BiharmonicData):
        L, q = _lane_inputs(cfg, data, mesh.device)
        w = dss_weights(data.spheremp.to(mesh.device)).reshape(-1, NPTS)
        return _shards(q, P), (_shards(L, P), _shards(w, P))

    def edge_cols(s):
        """-> (j0, jl): every element's j=0 / j=np-1 columns (P, e, np, ncol)."""
        s5 = s.reshape(*s.shape[:2], NPG, NPG, ncol)
        return s5[:, :, :, 0], s5[:, :, :, -1]

    def dss(s, w, from_left, from_right):
        """The assembly of s (P, m, 16, ncol), times w; from_left/right
        (P, 1, np, ncol) are the columns beside its first element's j=0 and
        its last element's j=np-1 (the neighbour shards', or zeros)."""
        s5 = s.reshape(*s.shape[:2], NPG, NPG, ncol)
        j0, jl = edge_cols(s)
        left = torch.cat([from_left, jl[:, :-1]], 1)
        right = torch.cat([j0[:, 1:], from_right], 1)
        summed = torch.cat([(j0 + left)[:, :, :, None], s5[:, :, :, 1:-1],
                            (jl + right)[:, :, :, None]], 3)
        return summed.reshape(s.shape) * w[..., None]

    def exchange(j0, jl):
        """(from_left, from_right): the left neighbour's last j=np-1
        column, the right one's first j=0 column."""
        return meshmod.ring_strips(jl, 1)[0], meshmod.ring_strips(j0, 1)[1]

    def step_serial(q_s, aux):
        L, w = aux
        s = _apply(L, q_s, precision)
        return _apply(L, dss(s, w, *exchange(*edge_cols(s))), precision)

    def step_overlap(q_s, aux):
        L, w = aux
        s = _apply(L, q_s, precision)
        j0, jl = edge_cols(s)
        from_left, from_right = exchange(j0, jl)
        z = torch.zeros_like(from_left)
        out = _apply(L, dss(s, w, z, z), precision)
        first = dss(s[:, :1], w[:, :1], from_left, j0[:, 1:2])
        last = dss(s[:, -1:], w[:, -1:], jl[:, -2:-1], from_right)
        out[:, :1] = _apply(L[:, :1], first, precision)
        out[:, -1:] = _apply(L[:, -1:], last, precision)
        return out

    return shard_inputs, (step_overlap if overlap else step_serial), _gather(cfg)


def _chained(step):
    def loop(q_s, aux, n: int):
        if n < 0:
            raise ValueError(f"n must be >= 0 (got {n})")
        for _ in range(n):
            q_s = step(q_s, aux)
        return q_s

    return loop


def make_dist_loop_dss(cfg, mesh: Mesh, overlap: bool = False):
    """n chained make_dist_step_dss steps: loop(q_s, aux, n)."""
    return _chained(make_dist_step_dss(cfg, mesh, overlap=overlap)[1])


# ------------------------------------------------ the torus DSS, 2-D mesh
def make_dist_step_dss2d(cfg, mesh: Mesh2d):
    """The torus-DSS biharmonic on a (pi, pj) mesh splitting both element
    grid axes.

    Returns (shard_inputs, step, gather): shard_inputs(data) -> (q_s, aux =
    (L, w)) as (pi, pj, ex/pi, ey/pj, 16, ·); step(q_s, aux) -> the next
    q_s; gather(q_s) -> the global qtens.  The DSS runs as its two passes:
    the j-direction edge sum with one boundary column exchanged along pj,
    then the i-direction edge sum of the j-summed field with one boundary
    row exchanged along pi, which carries the corners' partial sums.  The
    applications are per-element products in plain torch."""
    pi, pj = mesh.shape
    ex, ey = torus_shape(cfg.nelemd)
    if ex % pi or ey % pj:
        raise ValueError(f"element grid {ex}x{ey} not divisible by mesh "
                         f"{pi}x{pj}")
    exl, eyl = ex // pi, ey // pj
    precision = "highest" if cfg.dtype == "float64" else "high"
    ncol = cfg.ncol

    def grid(x):
        """(e, ...) -> (pi, pj, exl, eyl, ...) contiguous."""
        x6 = x.reshape(pi, exl, pj, eyl, *x.shape[1:])
        return x6.transpose(1, 2).contiguous()

    def shard_inputs(data: BiharmonicData):
        L, q = _lane_inputs(cfg, data, mesh.device)
        w = dss2d_weights(data.spheremp.to(mesh.device), ex, ey)
        return grid(q), (grid(L), grid(w.reshape(-1, NPTS)))

    def step(q_s, aux):
        L, w = aux
        s = _apply(L, q_s, precision)
        s7 = s.reshape(pi, pj, exl, eyl, NPG, NPG, ncol)  # (.., a, b, i, j, c)
        # pass 1: j-direction edge sum, one column from each j neighbour
        j0, jl = s7[..., 0, :], s7[..., -1, :]            # (.., a, b, i, c)
        from_left = meshmod.ring_strips(jl, 1, shard_dim=1, dim=3)[0]
        from_right = meshmod.ring_strips(j0, 1, shard_dim=1, dim=3)[1]
        left = torch.cat([from_left, jl[:, :, :, :-1]], 3)
        right = torch.cat([j0[:, :, :, 1:], from_right], 3)
        t7 = torch.cat([(j0 + left)[..., None, :], s7[..., 1:-1, :],
                        (jl + right)[..., None, :]], 5)
        # pass 2: i-direction edge sum of the j-summed field
        i0, il = t7[:, :, :, :, 0], t7[:, :, :, :, -1]    # (.., a, b, j, c)
        from_up = meshmod.ring_strips(il, 1, shard_dim=0, dim=2)[0]
        from_down = meshmod.ring_strips(i0, 1, shard_dim=0, dim=2)[1]
        up = torch.cat([from_up, il[:, :, :-1]], 2)
        down = torch.cat([i0[:, :, 1:], from_down], 2)
        u7 = torch.cat([(i0 + up)[:, :, :, :, None], t7[:, :, :, :, 1:-1],
                        (il + down)[:, :, :, :, None]], 4)
        return _apply(L, u7.reshape(s.shape) * w[..., None], precision)

    def gather(q_s):
        q = q_s.transpose(1, 2).reshape(cfg.nelemd, NPTS, ncol)
        return from_lane_layout(q, cfg)

    return shard_inputs, step, gather


def make_dist_loop_dss2d(cfg, mesh: Mesh2d):
    """n chained make_dist_step_dss2d steps: loop(q_s, aux, n)."""
    return _chained(make_dist_step_dss2d(cfg, mesh)[1])


# ------------------------------------------------ the row-sharded rowchain
def _rowchain_geometry(cfg, mesh: Mesh):
    """(ex, ey, exl, precision) of the row-sharded rowchain; raises where
    the element rows do not split over the mesh."""
    ex, ey = torus_shape(cfg.nelemd)
    if ex % mesh.size:
        raise ValueError(f"element rows {ex} not divisible by {mesh.size}")
    # always the precomposed step (A² once per t-step), exact at f64 and
    # bf16x3 at f32, as the JAX dist rowchain
    precision = "highest" if cfg.dtype == "float64" else "bf16x3"
    return ex, ey, ex // mesh.size, precision


def _rowchain_io(cfg, mesh: Mesh):
    """shard_inputs(data) -> (q_s, aux = (L, w)), each (P, exl*ey, 16, ·):
    a shard owns exl whole element rows; and gather."""
    P = mesh.size

    def shard_inputs(data: BiharmonicData):
        ex, ey = torus_shape(cfg.nelemd)
        L, q = _lane_inputs(cfg, data, mesh.device)
        w = dss2d_weights(data.spheremp.to(mesh.device), ex, ey)
        return _shards(q, P), (_shards(L, P), _shards(w.reshape(-1, NPTS), P))

    return shard_inputs, _gather(cfg)


def ring_rows(x: torch.Tensor, ey: int, h: int) -> torch.Tensor:
    """(P, rows*ey, ...) extended by h periodic neighbour element rows on
    each side: (P, (rows+2h)*ey, ...)."""
    x5 = x.reshape(x.shape[0], -1, ey, *x.shape[2:])
    ext = meshmod.ring_exchange(x5, h)
    return ext.reshape(x.shape[0], -1, *x.shape[2:])


def _bridge_in(L, q_s, exl, ey, precision):
    outs = [rc.rowchain_bridge_in(L[p], q_s[p], exl, ey, precision)
            for p in range(q_s.shape[0])]
    with span("cdk.dist.gather"):
        return torch.stack(outs)


def _bridge_out(L, w, t, exl, ey, precision):
    tp = ring_rows(t, ey, 1)
    outs = [rc.rowchain_bridge_out_padded(L[p], w[p], tp[p], exl, ey, precision)
            for p in range(t.shape[0])]
    with span("cdk.dist.gather"):
        return torch.stack(outs)


def make_dist_loop_dss2d_rowchain(cfg, mesh: Mesh, overlap: bool = False):
    """The t-carry rowchain with element rows sharded over a 1-D mesh (the j
    direction stays whole per shard): bridge-in (K15) on a shard's rows,
    n - 1 t-steps on rows padded by exchanged ones, bridge-out (K17p).

    Serial: the t-steps run in blocks of kk (K18p, deepest first from 4 for
    the bf16x3 form or 3, down to 2, kk <= the shard's rows) that carry t
    in the kk-padded layout and refresh only its 2·kk halo rows per block,
    then one-row steps (K16p) for the remainder.  overlap=True runs every
    t-step as the edge-row patch form (the whole shard with zero halo rows,
    then its first and last rows again with the exchanged ones), bit for bit
    the serial loop.

    Returns (shard_inputs, loop, gather); loop(q_s, aux, n) for n >= 1."""
    ex, ey, exl, precision = _rowchain_geometry(cfg, mesh)
    if overlap and exl < 2:
        raise ValueError("overlap form needs >= 2 element rows per shard")
    P = mesh.size
    kmax = 4 if precision == "bf16x3" else 3
    depths = [kk for kk in range(kmax, 1, -1) if kk <= exl]
    shard_inputs, gather = _rowchain_io(cfg, mesh)

    def step(F, w, t):
        """One t-step of every shard, one exchanged row per side."""
        tp = ring_rows(t, ey, 1)
        out = torch.empty_like(t)
        for p in range(P):
            rc.rowchain_step_padded(F[p], w[p], tp[p], exl, ey, 1, precision,
                                    True, out=out[p])
        return out

    def step_overlap(F, w, t):
        up, dn = meshmod.ring_strips(t.reshape(P, exl, ey, *t.shape[2:]), 1)
        z = torch.zeros_like(t[0, :ey])
        out = torch.empty_like(t)
        for p in range(P):
            def run(tp, rows, lo, hi, o):
                rc.rowchain_step_padded(F[p, lo:hi], w[p, lo:hi], tp, rows, ey,
                                        1, precision, True, out=o)

            run(torch.cat([z, t[p], z]), exl, 0, exl * ey, out[p])
            run(torch.cat([up[p, 0], t[p, :2 * ey]]), 1, 0, ey, out[p, :ey])
            run(torch.cat([t[p, -2 * ey:], dn[p, 0]]), 1, (exl - 1) * ey,
                exl * ey, out[p, -ey:])
        return out

    def block(F_p, w_p, tp, kk, nblocks):
        """nblocks K18p launches of depth kk per shard on the kk-padded
        carry tp, the halo rows refreshed between them; -> the owned rows."""
        tq, tmp = torch.empty_like(tp), torch.empty_like(tp[0])
        rows = lambda x: x.reshape(P, exl + 2 * kk, ey, *x.shape[2:])
        for i in range(nblocks):
            if i:  # refresh the halo rows from the neighbours' owned ones
                t5 = rows(tp)
                meshmod.ring_strips(t5[:, kk:kk + exl], kk,
                                    out=(t5[:, :kk], t5[:, kk + exl:]))
            for p in range(P):
                rc.rowchain_step_padded(F_p[p], w_p[p], tp[p], exl, ey, kk,
                                        precision, True, padded_out=True,
                                        out=tq[p], tmp=tmp)
            tp, tq = tq, tp
        return tp[:, kk * ey:(kk + exl) * ey].contiguous()

    def loop(q_s, aux, n: int):
        if n < 1:
            raise ValueError(f"the rowchain loop takes n >= 1 steps (got {n})")
        L, w = aux
        F = precompose_operator(L.reshape(-1, NPTS, NPTS)).reshape(L.shape)
        t = _bridge_in(L, q_s, exl, ey, precision)
        nt = n - 1
        if not overlap:
            for kk in depths:
                if nt >= kk:
                    t = block(ring_rows(F, ey, kk - 1), ring_rows(w, ey, kk - 1),
                              ring_rows(t, ey, kk), kk, nt // kk)
                    nt %= kk
        for _ in range(nt):
            t = (step_overlap if overlap else step)(F, w, t)
        return _bridge_out(L, w, t, exl, ey, precision)

    return shard_inputs, loop, gather


def make_dist_loop_dss2d_rowchain_kstep(cfg, mesh: Mesh, kstep: int = 4):
    """The communication-avoiding rowchain: kstep t rows exchanged per side
    once per kstep t-steps, then a shrinking-window chain of K16p launches,
    each one row narrower per side; the operator and weight windows are
    extended by kstep rows once per loop call.  A trailing (n-1) % kstep
    remainder chain reads those windows at its offset into them.  Same
    contract as make_dist_loop_dss2d_rowchain."""
    ex, ey, exl, precision = _rowchain_geometry(cfg, mesh)
    if kstep < 1 or kstep > exl:
        # halo rows beyond the neighbour shard would need two hops
        raise ValueError(f"kstep={kstep} must be in [1, {exl}]")
    P = mesh.size
    shard_inputs, gather = _rowchain_io(cfg, mesh)

    def chain(F_e, w_e, t, k):
        """k t-steps on t extended by k rows per side; F_e/w_e are always
        extended by kstep, so a remainder chain (k < kstep) starts kstep - k
        rows in."""
        t_ext = ring_rows(t, ey, k)
        off = kstep - k
        for j in range(1, k + 1):
            rows = exl + 2 * (k - j)  # the rows sub-step j computes
            lo, hi = (off + j) * ey, (off + j + rows) * ey
            out = t.new_empty((P, rows * ey, *t.shape[2:]))
            for p in range(P):
                rc.rowchain_step_padded(F_e[p, lo:hi], w_e[p, lo:hi], t_ext[p],
                                        rows, ey, 1, precision, True, out=out[p])
            t_ext = out
        return t_ext

    def loop(q_s, aux, n: int):
        if n < 1:
            raise ValueError(f"the rowchain loop takes n >= 1 steps (got {n})")
        L, w = aux
        F = precompose_operator(L.reshape(-1, NPTS, NPTS)).reshape(L.shape)
        F_e, w_e = ring_rows(F, ey, kstep), ring_rows(w, ey, kstep)
        t = _bridge_in(L, q_s, exl, ey, precision)
        m, r = divmod(n - 1, kstep)
        for _ in range(m):
            t = chain(F_e, w_e, t, kstep)
        if r:
            t = chain(F_e, w_e, t, r)
        return _bridge_out(L, w, t, exl, ey, precision)

    return shard_inputs, loop, gather


# ------------------------------------------------ the communication-avoiding ring
def make_dist_loop_dss_kstep(cfg, mesh: Mesh, kstep: int = 8,
                             precision: str | None = None, split: bool = True):
    """Communication-avoiding dist ring DSS: kstep elements exchanged per
    side once per kstep steps, then the window-fed resident chain (K14w) on
    each shard's block, the precomposed d-carry form A·D·(A²·D)^(k-1)·A;
    its owned elements are exact after kstep steps, as each step consumes
    one element of halo per side.  Operators, A² and w are extended by
    kstep elements per side once per loop call.

    split=True hands K14w the exchanged strips and the owned block apart;
    split=False the views of one extended array, (P, e/P + 2·kstep, ...)
    built per call (the JAX padded-window form).  Both are the same launch
    and bit for bit equal.  precision: "highest" or "bf16x3" (default:
    "highest" at f64, "bf16x3" at f32).

    Returns (shard_inputs, loop, gather): loop(q_s, aux, n) with n a
    multiple of kstep; the layout is make_dist_step_dss's."""
    P = mesh.size
    if cfg.nelemd % P:
        raise ValueError(f"nelemd={cfg.nelemd} not divisible by {P}")
    e_loc = cfg.nelemd // P
    if kstep < 1 or kstep > e_loc:
        # a halo past the neighbour shard would need two hops
        raise ValueError(f"{e_loc} elements/shard cannot carry a kstep={kstep}"
                         f" halo: lower kstep or shards")
    if kstep > MAX_STEPS:
        raise ValueError(f"kstep={kstep} > {MAX_STEPS}, the most steps K14 "
                         f"takes in one launch")
    if precision is None:
        precision = "highest" if cfg.dtype == "float64" else "bf16x3"
    shard_inputs = make_dist_step_dss(cfg, mesh)[0]
    h = kstep

    def loop(q_s, aux, n: int):
        if n < 0 or n % kstep:
            raise ValueError(f"n={n} not a multiple of kstep={kstep}")
        L, w = aux
        L2 = precompose_operator(L.reshape(-1, NPTS, NPTS)).reshape(L.shape)
        L_e, L2_e, w_e = (meshmod.ring_exchange(x, h) for x in (L, L2, w))
        bufs = [torch.empty_like(q_s), torch.empty_like(q_s)]
        strips = None
        for i in range(n // kstep):
            out = bufs[i % 2]
            if split:
                strips = meshmod.ring_strips(q_s, h, out=strips)
                parts = [(strips[0][p], q_s[p], strips[1][p]) for p in range(P)]
            else:
                q_ext = meshmod.ring_exchange(q_s, h)
                parts = [(q_ext[p, :h], q_ext[p, h:h + e_loc], q_ext[p, h + e_loc:])
                         for p in range(P)]
            for p, (hl, q, hr) in enumerate(parts):
                dss_resident_window(L_e[p], w_e[p], hl, q, hr, kstep, precision,
                                    L2_e[p], out=out[p])
            q_s = out
        return q_s

    return shard_inputs, loop, _gather(cfg)
