"""A CPU rehearsal of K10's addressing (the LANES mode of
csrc/mpdata_sweep.cuh, launched by csrc/mpdata_lanes.cu).

`lanes_step` runs the kernel's schedule on flat copies of the (x, z, s)
fields through the kernel's own index maps: blocks of W = warps / chunks
slices side by side (a ragged last block's warps sweep and store nothing),
thread t of a chunk copying slice t % W at levels t / W, t / W + 32, ...,
the tile pitch `lanes_pitch` with each lane's vector alignment, the
LANES_TILES tile rows of (f row r, u and w row r - 1), tile row
p + LANES_TILES issued at iteration p, one group of copies an iteration,
the ring of finished rows leaving four iterations
later, the x chunks with their three-row overlap and their flux rows summed
in x order by the first chunk, and the flux row out through the ring.  The
stages themselves are `Chain` of tests/test_torch_mpdata_sweep.py on the
(W, nzm) rows the warps read from the tile.  Shared memory is one flat
tensor of the size the launcher asks for, and every access is checked
against the barriers: nothing is read while a copy into it is in flight,
and nothing is written and read (or read and written) between the same two
barriers of its chunk.  f must come out `torch.equal` to
`advect_lanes_plain`, the flux within 1e-15 (its column sums run in x
order).  Sizes are tiny: nx 8-16, nzm 9 (one case at 70, four levels a
lane); the constants mirror csrc/.
"""

from __future__ import annotations

import pytest
import torch
from test_torch_mpdata_sweep import Chain

from cdk_torch.core.config import MpdataConfig, with_overrides
from cdk_torch.core.norms import rel_l1
from cdk_torch.kernels.mpdata import lanes
from cdk_torch.kernels.mpdata import problem as mp

LANES_WARPS, LANES_TILES, LANES_RING = 8, 2, 5  # csrc/mpdata_sweep.cuh


def lanes_pitch(L, W, esize):
    """csrc/mpdata_sweep.cuh's lanes_pitch."""
    words, vec = esize // 4, (L if L * esize < 16 else 16 // esize)
    pad = (32 // (W * words)) % (32 // words)
    pad = max(pad, vec)
    return 32 * L + (pad + vec - 1) // vec * vec


class Smem:
    """A block's shared memory with the barrier checks."""

    def __init__(self, n, dtype):
        self.m = torch.full((n,), float("nan"), dtype=dtype)
        self.wr = torch.zeros(n, dtype=torch.bool)      # written since the barrier
        self.rd = torch.zeros(n, dtype=torch.bool)      # read since the barrier
        self.flight = torch.zeros(n, dtype=torch.bool)  # a copy in flight
        self.group, self.groups = [], []

    def cp_async(self, idx, vals):
        assert not (self.rd[idx].any() or self.wr[idx].any() or self.flight[idx].any())
        self.flight[idx] = True
        self.group.append((idx, vals.clone()))

    def commit(self):
        self.groups.append(self.group)
        self.group = []

    def wait(self, pending):
        """cp.async.wait_group: all but the last `pending` groups land."""
        while len(self.groups) > pending:
            for idx, vals in self.groups.pop(0):
                self.m[idx] = vals
                self.flight[idx] = False
                self.wr[idx] = True

    def sync(self):
        self.wr[:] = False
        self.rd[:] = False

    def read(self, idx):
        assert not (self.wr[idx].any() or self.flight[idx].any()), "read races a write"
        self.rd[idx] = True
        return self.m[idx]

    def write(self, idx, vals):
        assert not (self.rd[idx].any() or self.flight[idx].any()), "write races a read"
        self.wr[idx] = True
        self.m[idx] = vals


class Tile:
    """One chunk's `Lanes`: its tile rows, its ring, its threads' copies."""

    def __init__(self, sm, c, W, P, L, s0, live, S, nzm, tiles, ring, esize):
        self.sm, self.W, self.P, self.L, self.s0, self.S, self.nzm = sm, W, P, L, s0, S, nzm
        self.tiles, self.ring_rows = tiles, ring
        self.buf = c * (3 * tiles + ring) * W * P
        self.ring = self.buf + 3 * tiles * W * P
        self.end = self.ring + ring * W * P
        # thread t of the chunk: slice t % W, levels t / W, t / W + 32, ...
        pairs = [(t % W, k) for t in range(W * 32) for k in range(t // W, nzm, 32)
                 if t % W < live]
        assert sorted(pairs) == [(j, k) for j in range(live) for k in range(nzm)]
        self.pj = torch.tensor([j for j, _ in pairs])
        self.pk = torch.tensor([k for _, k in pairs])
        # warp j, lane l: levels L l .. L l + L - 1 as one or more vectors
        self.wj = torch.arange(W)[:, None]
        self.wk = torch.arange(32 * L)[None, :]
        self.vec = L if L * esize < 16 else 16 // esize

    def _mine(self, idx):
        assert bool(((idx >= self.buf) & (idx < self.end)).all()), "outside the chunk"
        return idx

    def copy(self, dst, src, x, levels):
        g = (x * levels + self.pk) * self.S + self.s0 + self.pj
        self.sm.cp_async(self._mine(dst + self.pj * self.P + self.pk), src[g])

    def tile(self, r, field):
        return self.buf + ((r % self.tiles) * 3 + field) * self.W * self.P

    def fetch(self, r, last, rows, xu, xw, fields):
        """One group of copies: tile row r, if r <= last."""
        f, u, w = fields
        if r <= last:
            if r < rows:
                self.copy(self.tile(r, 0), f, r, self.nzm)
            if 1 <= r and r - 1 < xu:
                self.copy(self.tile(r, 1), u, r - 1, self.nzm)
            if 1 <= r and r - 1 < xw:
                self.copy(self.tile(r, 2), w, r - 1, self.nzm + 1)
        self.sm.commit()

    def ready(self, pending):
        self.sm.wait(pending)
        self.sm.sync()

    def row(self, r, field):
        """Every warp's levels of a field of tile row r: (W, nzm)."""
        base = self.tile(r, field) + self.wj * self.P
        lane0 = base + self.L * torch.arange(32)[None, :]
        assert bool((lane0 % self.vec == 0).all()), "a lane's vector is misaligned"
        return self.sm.read(self._mine(base + self.wk))[:, :self.nzm]

    def levels(self, rho, adz, rhow):
        self.copy(self.tile(0, 0), rho, 0, self.nzm)
        self.copy(self.tile(0, 1), adz, 0, self.nzm)
        self.copy(self.tile(0, 2), rhow, 0, self.nzm + 1)
        self.sm.commit()
        self.ready(0)
        out = [self.row(0, q) for q in range(3)]
        self.sm.sync()
        return out

    def put(self, r, x):
        """(W, nzm) rows into the ring; the lanes past nzm write garbage."""
        vals = torch.full((self.W, 32 * self.L), float("nan"), dtype=x.dtype)
        vals[:, :self.nzm] = x
        slot = self.ring + ((r % self.ring_rows) * self.W + self.wj) * self.P
        self.sm.write(self._mine(slot + self.wk), vals)

    def flush(self, r, dst, x):
        src = self.ring + ((r % self.ring_rows) * self.W + self.pj) * self.P + self.pk
        g = (x * self.nzm + self.pk) * self.S + self.s0 + self.pj
        dst[g] = self.sm.read(self._mine(src))


def lanes_step(f, u, w, rho, rhow, adz, flux, *, warps=LANES_WARPS, chunks=1,
               esize=8, tiles=LANES_TILES, ring=LANES_RING):
    """One step on (x, z, s) fields through K10's schedule: (f, flux) in
    (x, z, s).  `esize` sets the pitch (4: float32's, 8: float64's)."""
    rows, nzm, S = f.shape
    nx, nz = rows - 6, nzm + 1
    xu, xw = nx + 5, nx + 4
    L = 2 if nzm <= 64 else 4 if nzm <= 128 else 8
    W = warps // chunks
    P, NZP = lanes_pitch(L, W, esize), 32 * L
    R = rows - 6
    flo, NF = 1 - (-2), nx  # flux rows: gi in [1, nx]
    fields = [t.reshape(-1) for t in (f, u, w)]
    lev = [t.reshape(-1) for t in (rho, adz, rhow)]
    f_out = torch.full_like(fields[0], float("nan"))
    flux_out = torch.full_like(flux.reshape(-1), float("nan"))
    zero = f.new_zeros((W, nzm))
    for b in range((S + W - 1) // W):
        s0 = b * W
        live = min(W, S - s0)
        flux_base = chunks * (3 * tiles + ring) * W * P
        sm = Smem(flux_base + (2 * NF * W * NZP if chunks > 1 else 0), f.dtype)
        fl = None
        for c in range(chunks):
            io = Tile(sm, c, W, P, L, s0, live, S, nzm, tiles, ring, esize)
            q0, q1 = 3 + R * c // chunks, 3 + R * (c + 1) // chunks
            p0, p1 = q0 - 3, q1 + 2
            own_lo, own_hi = (0 if c == 0 else q0), (rows if c == chunks - 1 else q1)

            def owned(r):
                return own_lo <= r < own_hi

            def fluxed(r):
                return flo <= r < flo + NF and owned(r)

            lv_rho, lv_adz, lv_rhow = io.levels(*lev)
            chain = Chain(lv_rho, lv_rhow, lv_adz, hoist=False)
            for r in range(p0, p0 + tiles):
                io.fetch(r, p1, rows, xu, xw, fields)
            io.ready(tiles - 1)
            nf, nu, nw = io.row(p0, 0), zero, zero
            if p0 - 1 >= 0:
                nu, nw = io.row(p0, 1), io.row(p0, 2)
            fl1 = fl2 = zero
            for p in range(p0, p1 + 1):
                f_p, u_p, w_p = nf, nu, nw
                io.ready(tiles - 2)
                if p < p1:
                    nf = io.row(p + 1, 0)
                    if p < xu:
                        nu = io.row(p + 1, 1)
                    if p < xw:
                        nw = io.row(p + 1, 2)
                if p >= 4 and owned(p - 4):
                    io.flush(p - 4, f_out, p - 4)
                io.fetch(p + tiles, p1, rows, xu, xw, fields)
                fA, b1, g1, W3, fN = chain.step(p, f_p, u_p, w_p)
                for r, val, slot in ((p, b1, 0), (p - 2, W3, 1)):
                    if not fluxed(r):
                        continue
                    if chunks == 1:
                        fl1, fl2 = (fl1 + val, fl2) if slot == 0 else (fl1, fl2 + val)
                    else:
                        at = flux_base + (((slot * NF + r - flo) * W + io.wj) * NZP
                                          + torch.arange(nzm)[None, :])
                        sm.write(at, val)
                if p in (0, rows - 1) and owned(p):
                    io.put(p, fA)
                if p in (2, 3, nx + 4, nx + 5) and owned(p - 1):
                    io.put(p - 1, g1)
                if p >= 6 and owned(p - 3):
                    io.put(p - 3, fN)
            io.sm.sync()
            for r in range(max(p1 - 3, 0), p1 + 1):
                if owned(r):
                    io.flush(r, f_out, r)
            if c == 0:
                fl, first = (fl1, fl2), io
        if chunks > 1:  # the block's barrier, then the first chunk's sums
            sm.sync()
            fl1 = fl2 = zero
            for r in range(NF):
                k = torch.arange(nzm)[None, :]
                fl1 = fl1 + sm.read(flux_base + ((r * W + first.wj) * NZP + k))
                fl2 = fl2 + sm.read(flux_base + (((NF + r) * W + first.wj) * NZP + k))
            fl = (fl1, fl2)
        sm.sync()
        first.put(0, fl[0] + fl[1])
        sm.sync()
        first.flush(0, flux_out, 0)
        top = nzm * S + s0 + torch.arange(live)
        flux_out[top] = flux.reshape(-1)[top]  # flux(:, nz) passes through
    return f_out.reshape(f.shape), flux_out.reshape(nz, S)


def _fields(nslices, nx=10, nz=10):
    d = mp.init_data(with_overrides(MpdataConfig(), nslices=nslices, nx=nx, nz=nz,
                                    dtype="float64"))
    return [lanes.to_xzs(getattr(d, n)) for n in lanes.FIELDS]


def _check(got, want, gate=1e-15):
    assert torch.equal(got[0], want[0])
    assert rel_l1(got[1], want[1]) < gate


@pytest.mark.parametrize("nslices", [1, 3, 37, 48])
@pytest.mark.parametrize("warps", [8, 32])
@pytest.mark.parametrize("esize", [4, 8])
def test_lanes_blocks_match_the_plain_step(nslices, warps, esize):
    """Blocks of 8 and 32 slices (one warp a slice), the last one ragged
    but at 32 and 48 against 8, at float32's and float64's tile pitch."""
    xzs = _fields(nslices)
    _check(lanes_step(*xzs, warps=warps, esize=esize), lanes.advect_lanes_plain(*xzs))


@pytest.mark.parametrize("nslices,nx,chunks", [(3, 8, 2), (48, 12, 2), (37, 16, 4),
                                               (5, 32, 8)])
def test_lanes_split_slices_match_the_plain_step(nslices, nx, chunks):
    """A slice's x range split among 2, 4 and 8 warps of a block (4, 2 and
    1 slices a block): the three-row overlaps, each chunk's owned rows and
    its own barrier, the flux rows summed in x order by the first chunk;
    bit for bit the one-warp sweep, f and flux."""
    xzs = _fields(nslices, nx=nx)
    got = lanes_step(*xzs, chunks=chunks)
    _check(got, lanes.advect_lanes_plain(*xzs))
    whole = lanes_step(*xzs)
    assert torch.equal(got[0], whole[0]) and torch.equal(got[1], whole[1])


def test_lanes_four_levels_a_lane():
    """nzm 70: four levels a lane, 128-level tile rows."""
    xzs = _fields(5, nx=8, nz=71)
    _check(lanes_step(*xzs, esize=4), lanes.advect_lanes_plain(*xzs))


@pytest.mark.parametrize("chunks", [1, 2])
def test_lanes_three_tile_rows_in_flight(chunks):
    """A deeper tile (three rows: row p + 3 issued at iteration p, one
    group an iteration, empty past the chunk's last row) keeps the
    schedule."""
    xzs = _fields(11, nx=12)
    _check(lanes_step(*xzs, chunks=chunks, tiles=3), lanes.advect_lanes_plain(*xzs))


def test_lanes_barrier_checks_catch_a_short_ring():
    """The checks are live: a ring of four rows would overwrite the row
    that leaves it between the same two barriers."""
    xzs = _fields(3)
    with pytest.raises(AssertionError, match="races"):
        lanes_step(*xzs, ring=4)
