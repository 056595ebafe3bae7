"""A CPU rehearsal of the torus-DSS kernels' schedules: K19's windows
(csrc/biharmonic_dss2d_resident.cu) and the rowchain bridges' row tiles
(the BRIDGE_IN and BRIDGE_OUT modes of step_kernel in
csrc/biharmonic_dss2d_rowchain.cu).

`x3_geometry` and `exact_geometry` mirror the launchers' window choice
(whole element rows where 2k+1 of them fit, else an 8 x 8 rectangle with k
halo elements on every side; the bf16x3 kernel at up to X3_WARPS warps a
block, two elements a warp),
`run_windows` runs a launch window by window in torch (gather, k steps with
the assembly confined to the window, scatter of the centres), and
`bridge_schedule` runs the bridges' persistent tile loop block by block
(slots, owned predicates, the j exchange through side buffers, the padded
rows).  The fragment-layout side buffers of bih::tc (put_jside/add_jside,
put_iside/add_iside) are rehearsed lane by lane for their points and their
banks.  No jax; sizes are tiny.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from cdk_torch.kernels.biharmonic import dss2d_resident as dr2
from cdk_torch.kernels.biharmonic import dss2d_rowchain as rc
from cdk_torch.kernels.biharmonic.operator import apply_operator

NP, NPTS = 4, 16
X3_WARPS = 32  # the most warps of a block of the bf16x3 K19 kernel
X3_TC = 16  # its columns a tile (two elements a warp, an m-tile each)
# the rowchain kernel: columns a tile; a tile's ELEMS (step_elems) by dtype,
# form and mode
TILE = 32
BRIDGE_IN, STEP, BRIDGE_OUT = rc.BRIDGE_IN, rc.STEP, rc.BRIDGE_OUT


def step_elems(dtype, x3, mode):
    if dtype == torch.float64:
        return 8
    return 24 if mode != BRIDGE_OUT else 22 if x3 else 16
SMS = 132
TORI = [(4, 4), (4, 3), (2, 2), (5, 1), (16, 10), (30, 21), (3, 25), (75, 72)]


# ---- K19's windows ---------------------------------------------------------

def _whole_rows(ex, ey, h, fit):
    rows = fit // ey
    if rows < 2 * h + 1:
        return None
    ci = min(rows - 2 * h, ex)
    return dict(rows=ci + 2 * h, cols=ey, h=h, ci=ci, hj=0, cj=ey, nbj=1)


def _rectangle(ex, ey, h, ri, rj):
    if 2 * h + 1 > ri or 2 * h + 1 > rj:
        return None
    ci, cj = min(ri - 2 * h, ex), min(rj - 2 * h, ey)
    return dict(rows=ci + 2 * h, cols=cj + 2 * h, h=h, ci=ci, hj=h, cj=cj,
                nbj=-(-ey // cj))


def _finish(g, ex, ey, tc, cap):
    """cap: the most window elements the kernel's block holds."""
    if g is None:
        return None
    return dict(g, ex=ex, ey=ey, tc=tc, cap=cap,
                nwin=-(-ex // g["ci"]) * g["nbj"])


def x3_geometry(ex, ey, k):
    """launch_x3: the window of a bf16x3 launch of k steps, or None where it
    cannot take k: whole rows in 2 * X3_WARPS elements, else 8 x 8."""
    g = _whole_rows(ex, ey, k, 2 * X3_WARPS) or _rectangle(ex, ey, k, 8, 8)
    return _finish(g, ex, ey, X3_TC, 2 * X3_WARPS)


def exact_geometry(ex, ey, k):
    """launch_exact: whole rows at 32 columns in 32 elements, else at 16 in
    64, else an 8 x 8 rectangle at 16 columns (a thread a column of an
    element, 1024 a block)."""
    g = _whole_rows(ex, ey, k, 32)
    if g is not None:
        return _finish(g, ex, ey, 32, 32)
    g = _whole_rows(ex, ey, k, 64) or _rectangle(ex, ey, k, 8, 8)
    return _finish(g, ex, ey, 16, 64)


def window_elems(g, win):
    """The torus element of each (r, c) of window win: (rows, cols)."""
    a0 = (win // g["nbj"]) * g["ci"] - g["h"]
    b0 = (win % g["nbj"]) * g["cj"] - g["hj"]
    r = torch.arange(g["rows"])[:, None]
    c = torch.arange(g["cols"])[None, :]
    return ((a0 + r) % g["ex"]) * g["ey"] + (b0 + c) % g["ey"]


def centre_mask(g, win):
    """Which (r, c) of window win the kernel stores."""
    a0 = (win // g["nbj"]) * g["ci"] - g["h"]
    b0 = (win % g["nbj"]) * g["cj"] - g["hj"]
    r = torch.arange(g["rows"])[:, None]
    c = torch.arange(g["cols"])[None, :]
    return ((r >= g["h"]) & (r < g["h"] + g["ci"]) & (a0 + r < g["ex"])
            & (c >= g["hj"]) & (c < g["hj"] + g["cj"]) & (b0 + c < g["ey"]))


def _geometries(ex, ey):
    """(k, label, geometry) of every form at every depth up to max_steps."""
    out = []
    for k in range(dr2.max_steps(ey) + 1):
        out.append((k, "x3", x3_geometry(ex, ey, k)))
        out.append((k, "exact", exact_geometry(ex, ey, k)))
    return out


@pytest.mark.parametrize("exy", TORI)
def test_windows_own_each_element_once_and_hold_its_cone(exy):
    """Both forms' windows at every depth up to max_steps(ey): the window
    fits its block, its centres own each torus element exactly once, and
    every centre element's k-step cone (the elements within k rows and k
    elements of it, corners included) lies in the window as the torus
    element it is, the j direction wrapping only across whole rows."""
    ex, ey = exy
    for k, label, g in _geometries(ex, ey):
        assert g["rows"] * g["cols"] <= g["cap"], (k, label)
        owned = torch.zeros(ex * ey, dtype=torch.long)
        for win in range(g["nwin"]):
            el, centre = window_elems(g, win), centre_mask(g, win)
            owned.index_add_(0, el[centre], torch.ones(int(centre.sum()), dtype=torch.long))
            whole = g["hj"] == 0
            for r, c in centre.nonzero().tolist():
                a, b = divmod(int(el[r, c]), ey)
                for di in range(-k, k + 1):
                    for dj in range(-k, k + 1):
                        rr, cc = r + di, c + dj
                        assert 0 <= rr < g["rows"], (k, label, r, di)
                        if whole:
                            cc %= g["cols"]
                        assert 0 <= cc < g["cols"], (k, label, c, dj)
                        assert int(el[rr, cc]) == ((a + di) % ex) * ey + (b + dj) % ey
        assert bool((owned == 1).all()), (k, label)


@pytest.mark.parametrize("exy", TORI)
def test_every_depth_has_a_window_and_no_deeper_one(exy):
    """The x3 and the exact geometry take every depth up to
    max_steps(ey) and refuse max_steps(ey) + 1, so `validate` and the
    kernels agree."""
    ex, ey = exy
    kmax = dr2.max_steps(ey)
    for k in range(kmax + 1):
        assert x3_geometry(ex, ey, k) is not None and exact_geometry(ex, ey, k) is not None
    assert x3_geometry(ex, ey, kmax + 1) is None
    assert exact_geometry(ex, ey, kmax + 1) is None


@pytest.mark.parametrize("ncol,exy,k", [
    (720, (75, 72), 1), (720, (75, 72), 3), (40, (4, 4), 2), (40, (4, 4), 7),
    (33, (16, 10), 3), (33, (30, 21), 1), (8, (3, 25), 2)])
def test_block_runs_cover_every_tile_once(ncol, exy, k):
    """The persistent blocks' contiguous runs of (window, column tile)
    tiles, column tile fastest, cover each tile once, and a run changes
    window at most (run length / column tiles) + 2 times."""
    g = x3_geometry(*exy, k)
    ctiles = -(-ncol // g["tc"])
    ntiles = g["nwin"] * ctiles
    blocks = min(ntiles, SMS)
    seen = torch.zeros(ntiles, dtype=torch.long)
    for b in range(blocks):
        first, last = ntiles * b // blocks, ntiles * (b + 1) // blocks
        seen[first:last] += 1
        wins = {t // ctiles for t in range(first, last)}
        assert len(wins) <= (last - first) // ctiles + 2
    assert bool((seen == 1).all())


def _window_step(qw, Lw, ww, whole, prec):
    """One step (apply, DSS confined to the window, apply) on a window's
    (rows, cols, 16, ncol) field: a neighbour outside the window adds
    nothing; whole rows wrap in j."""
    rows, cols = qw.shape[:2]
    ncol = qw.shape[-1]

    def apply(x):
        return apply_operator(Lw.reshape(-1, NPTS, NPTS), x.reshape(-1, NPTS, ncol),
                              prec).reshape(rows, cols, NP, NP, ncol)

    s = apply(qw)
    zero = torch.zeros_like(s[:, :1, :, :1])
    left = s[:, :, :, NP - 1:].roll(1, 1)
    right = s[:, :, :, :1].roll(-1, 1)
    if not whole:
        left = torch.cat([zero, left[:, 1:]], 1)
        right = torch.cat([right[:, :-1], zero], 1)
    s = torch.cat([s[:, :, :, :1] + left, s[:, :, :, 1:NP - 1],
                   s[:, :, :, NP - 1:] + right], 3)
    zero = torch.zeros_like(s[:1, :, :1])
    up = torch.cat([zero, s[:-1, :, NP - 1:]], 0)
    down = torch.cat([s[1:, :, :1], zero], 0)
    s = torch.cat([s[:, :, :1] + up, s[:, :, 1:NP - 1], s[:, :, NP - 1:] + down], 2)
    s = s * ww.reshape(rows, cols, NP, NP, 1)
    return apply(s)


def run_windows(L, w, q, g, k, prec):
    """A launch of k steps window by window: gather, k window steps,
    scatter the centres."""
    out = torch.full_like(q, float("nan"))
    ncol = q.shape[-1]
    for win in range(g["nwin"]):
        el = window_elems(g, win)
        qw = q[el].reshape(g["rows"], g["cols"], NP, NP, ncol)
        for _ in range(k):
            qw = _window_step(qw, L[el], w[el], g["hj"] == 0, prec)
        centre = centre_mask(g, win)
        out[el[centre]] = qw.reshape(g["rows"], g["cols"], NPTS, ncol)[centre]
    return out


def _operands(e, ncol, seed, dtype=torch.float64):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.standard_normal((e, NPTS, NPTS)) / 4).to(dtype),
            torch.from_numpy(rng.uniform(0.25, 0.5, (e, NPTS))).to(dtype),
            torch.from_numpy(rng.standard_normal((e, NPTS, ncol))).to(dtype))


@pytest.mark.parametrize("exy,ks", [((4, 4), (1, 2, 7)), ((4, 3), (1, 10)), ((2, 2), (1, 15)),
                                    ((5, 1), (1, 31)), ((16, 10), (1, 2, 3)),
                                    ((30, 21), (1, 3)), ((3, 25), (1, 2, 3))])
def test_window_chain_equals_the_plain_version(exy, ks):
    """Both forms' windows at depths up to max_steps, run window by window
    with the plain version's own apply, come out torch.equal to
    dss2d_resident_plain at f64 (each boundary point gains one neighbour
    value per pass, in the plain version's order)."""
    ex, ey = exy
    L, w, q = _operands(ex * ey, 3, ex * 100 + ey)
    for k in ks:
        want = dr2.dss2d_resident_plain(L, w, q, ex, ey, k)
        for label, g in (("x3", x3_geometry(ex, ey, k)), ("exact", exact_geometry(ex, ey, k))):
            assert torch.equal(run_windows(L, w, q, g, k, "highest"), want), (k, label)


def test_window_chain_at_production_rows():
    """The production rows (72 elements) in the 8 x 8 window, one step, on a
    9-row torus, f64 and exact f32."""
    ex, ey = 9, 72
    for dtype in (torch.float64, torch.float32):
        L, w, q = _operands(ex * ey, 2, 5, dtype)
        want = dr2.dss2d_resident_plain(L, w, q, ex, ey, 1)
        got = run_windows(L, w, q, x3_geometry(ex, ey, 1), 1, "highest")
        assert torch.equal(got, want), dtype


# ---- the fragment layout's side buffers ----------------------------------

def _pt(t, q):
    """bih::tc::pt: the point lane group t holds at fragment slot q."""
    return 2 * t + (q & 1) + 8 * (q >> 1)


def _put(kind, x, mem, stride, c16, t, base):
    """bih::tc::put_jside / put_iside for lane group t: x[4r + q] -> mem."""
    for r in range(2):
        for h in range(2):
            if kind == "j":
                row = (t >> 1) + 2 * h
                v = x[4 * r + 2 * h + 1] if t & 1 else x[4 * r + 2 * h]
            else:
                row = (t & 1) + 2 * h
                v = x[4 * r + 2 + h] if t >> 1 else x[4 * r + h]
            mem[base + row * stride + c16 + 8 * r] = v


def _add(kind, x, mem, stride, c16, t, base):
    """bih::tc::add_jside / add_iside for lane group t."""
    for r in range(2):
        for h in range(2):
            if kind == "j":
                k = 4 * r + 2 * h + (t & 1)
                x[k] += mem[base + ((t >> 1) + 2 * h) * stride + c16 + 8 * r]
            else:
                k = 4 * r + (2 if t >> 1 else 0) + h
                x[k] += mem[base + ((t & 1) + 2 * h) * stride + c16 + 8 * r]


def _addr(kind, stride, c16, r, h, t, base):
    row = (t >> 1) + 2 * h if kind == "j" else (t & 1) + 2 * h
    return base + row * stride + c16 + 8 * r


@pytest.mark.parametrize("layout,kind", [("K19", "j"), ("K19", "i"), ("rowchain", "j")])
def test_side_buffers_carry_each_boundary_point_to_its_neighbour(layout, kind):
    """Lane by lane, at the strides and side offsets of K19's bf16x3 kernel
    (a tile of 16 columns, 64 slots) and of the rowchain kernel's bf16x3 j
    exchange (32 columns, two m-tiles, ELEMS + 2 = 26 slots): rows of the
    tile + 8 values, side 1 side_len = slots*NP*stride + 16 values on.  The
    j pass (put_jside/add_jside) adds to each j = 0 / j = np-1 point the
    left / right element's j = np-1 / j = 0 point, the i pass
    (put_iside/add_iside) to each i = 0 / i = np-1 point the upper / lower
    element's i = np-1 / i = 0 point, and nothing else; the 32 lanes of
    each store and of each read hit 32 distinct banks."""
    tc, slots = (X3_TC, 2 * X3_WARPS) if layout == "K19" else (TILE, 26)
    stride = tc + 8
    side_len = slots * NP * stride + 16
    lanes = [(g, t) for g in range(8) for t in range(4)]

    def own(t):  # the side a lane's boundary points go to
        return t & 1 if kind == "j" else t >> 1

    for c16 in range(0, tc, 16):
        for r in range(2):
            for h in range(2):
                for el, other in ((0, 0), (5, 1)):  # a store; a read
                    banks = {_addr(kind, stride, c16 + g, r, h, t,
                                   (own(t) ^ other) * side_len + el * NP * stride) % 32
                             for g, t in lanes}
                    assert len(banks) == 32, (c16, r, h, other)
    # three elements in a line (j: left, centre, right; i: up, centre, down)
    rng = np.random.default_rng(7)
    field = rng.standard_normal((3, NPTS, tc))  # element, point, column
    mem = np.full(4 * side_len, np.nan)

    def frag(e, g, t, c16):
        return [field[e, _pt(t, k & 3), c16 + g + 8 * (k >> 2)] for k in range(8)]

    for c16 in range(0, tc, 16):
        for e in range(3):
            for g, t in lanes:
                _put(kind, frag(e, g, t, c16), mem, stride, c16 + g, t,
                     own(t) * side_len + e * NP * stride)
        for g, t in lanes:
            x = frag(1, g, t, c16)
            nb = 2 if own(t) else 0
            _add(kind, x, mem, stride, c16 + g, t,
                 (1 - own(t)) * side_len + nb * NP * stride)
            for k in range(8):
                p, col = _pt(t, k & 3), c16 + g + 8 * (k >> 2)
                i, j = divmod(p, NP)
                want = field[1, p, col]
                if kind == "j" and j == 0:
                    want += field[0, p + NP - 1, col]
                elif kind == "j" and j == NP - 1:
                    want += field[2, p - NP + 1, col]
                elif kind == "i" and i == 0:
                    want += field[0, p + NPTS - NP, col]
                elif kind == "i" and i == NP - 1:
                    want += field[2, p - NPTS + NP, col]
                assert x[k] == want, (kind, g, t, k)


# ---- the rowchain bridges' row tiles --------------------------------------

def bridge_schedule(mode, L, w, x, ex, ey, pad, dtype, x3):
    """step_kernel in `mode` (BRIDGE_IN or BRIDGE_OUT) block by block: the
    persistent blocks' tiles of (row, owned_elems elements, TILE columns),
    ct fastest; slot y of a tile is element b0 - FIRST + y mod ey; the
    slots that `need` compute their element's values, the owned ones store
    (with the j exchange through side buffers in bridge_in).  pad = 1 is
    the padded bridge_out: x holds ex + 2 rows and its i-neighbours are the
    rows beside, op and w the ex rows.  -> (out, writes), writes counting
    each (out row, element, column tile) stored."""
    elems = step_elems(dtype, x3, mode)
    own = elems + 2 if mode == BRIDGE_OUT else elems
    first = 0 if mode == BRIDGE_OUT else 1
    slots = elems + 2
    ncol = x.shape[-1]
    rows, r0 = ex, (1 if pad else 0)
    chunks, ctiles = -(-ey // own), -(-ncol // TILE)
    ntiles = rows * chunks * ctiles
    blocks = min(ntiles, SMS)
    out = torch.full((ex * ey, NPTS, ncol), float("nan"), dtype=dtype)
    writes = torch.zeros(ex, ey, ctiles, dtype=torch.long)
    xr = x.reshape(-1, ey, NP, NP, ncol)
    for blk in range(blocks):
        for tile in range(blk, ntiles, blocks):
            ct, rest = tile % ctiles, tile // ctiles
            b0, a = rest % chunks * own, r0 + rest // chunks
            n_own = min(ey - b0, own)
            cols = slice(ct * TILE, min((ct + 1) * TILE, ncol))
            vals, sides = {}, {}
            for y in range(slots):
                b = (b0 - first + y) % ey
                owned = first <= y < first + n_own
                need = y <= n_own + 1 if mode == BRIDGE_IN else owned
                if not need:
                    continue
                eo = (a - r0) * ey + b  # the operator's element
                # the element's every column, so that the product runs at
                # the plain version's shape; the tile's columns are kept
                v = xr[a, b].clone()
                if mode == BRIDGE_OUT:
                    au, ad = (a - 1, a + 1) if pad else ((a - 1) % ex, (a + 1) % ex)
                    v[0] = v[0] + xr[au, b, NP - 1]
                    v[NP - 1] = v[NP - 1] + xr[ad, b, 0]
                    v = v * w[eo].reshape(NP, NP, 1)
                v = apply_operator(L[eo:eo + 1], v.reshape(1, NPTS, ncol),
                                   "highest").reshape(NP, NP, ncol)[..., cols]
                vals[y] = (v, b, owned)
                sides[y] = (v[:, 0].clone(), v[:, NP - 1].clone())
            for y, (v, b, owned) in vals.items():
                if not owned:
                    continue
                if mode == BRIDGE_IN:
                    v = v.clone()
                    v[:, 0] = v[:, 0] + sides[y - 1][1]
                    v[:, NP - 1] = v[:, NP - 1] + sides[y + 1][0]
                ad = a - r0
                out[ad * ey + b, :, cols] = v.reshape(NPTS, -1)
                writes[ad, b, ct] += 1
    return out, writes


@pytest.mark.parametrize("dtype,x3", [(torch.float64, False), (torch.float32, False),
                                      (torch.float32, True)])
@pytest.mark.parametrize("exy,ncol", [((3, 1), 33), ((2, 2), 40), ((3, 5), 8),
                                      ((2, 17), 33), ((2, 18), 40), ((2, 23), 33),
                                      ((1, 24), 40), ((2, 25), 64), ((3, 26), 33),
                                      ((2, 27), 40), ((2, 72), 33)])
def test_bridge_tiles_write_each_owned_tile_once(dtype, x3, exy, ncol):
    """bridge_in and bridge_out (and bridge_out padded by the torus's own
    rows) at each form's tile width, on tiny tori (ey < ELEMS + 2, ey = 1),
    rows of one tile short, exact and over, and ragged column tiles: every
    owned (row, element, column tile) is written once, and the outputs are
    torch.equal to the plain versions (the padded one to bridge_out); the
    schedule's arithmetic is the exact form's at the form's dtype."""
    ex, ey = exy
    L, w, q = _operands(ex * ey, ncol, ex * 31 + ey, dtype)
    t, writes = bridge_schedule(BRIDGE_IN, L, None, q, ex, ey, 0, dtype, x3)
    assert bool((writes == 1).all())
    assert torch.equal(t, rc.rowchain_bridge_in_plain(L, q, ex, ey))
    out, writes = bridge_schedule(BRIDGE_OUT, L, w, t, ex, ey, 0, dtype, x3)
    assert bool((writes == 1).all())
    assert torch.equal(out, rc.rowchain_bridge_out_plain(L, w, t, ex, ey))
    tp = torch.cat([t[(ex - 1) * ey:], t, t[:ey]])  # own rows as the pad
    padded, writes = bridge_schedule(BRIDGE_OUT, L, w, tp, ex, ey, 1, dtype, x3)
    assert bool((writes == 1).all())
    assert torch.equal(padded, out)
    assert torch.equal(padded, rc.rowchain_bridge_out_padded_plain(L, w, tp, ex, ey))


def test_bridge_tiles_at_production_rows():
    """A production row (72 elements) at f32 is whole tiles in each bridge:
    bridge_in three of 24 owned with a halo element on each side, bridge_out
    three of 24 (bf16x3) or four of 18 (exact), no idle warp."""
    for x3 in (False, True):
        for mode, owned in ((BRIDGE_IN, 24), (BRIDGE_OUT, 24 if x3 else 18)):
            elems = step_elems(torch.float32, x3, mode)
            own = elems + 2 if mode == BRIDGE_OUT else elems
            assert own == owned and 72 % own == 0
            assert 32 * (elems + 2) <= 1024
