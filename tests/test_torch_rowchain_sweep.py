"""A CPU rehearsal of the rowchain step's row sweep (sweep_kernel in
csrc/biharmonic_dss2d_rowchain.cu: K16, K18, K16p, K18p).

`sweep_plan` mirrors launch_sweep's work order (the (column tile, row)
units of a step cut into `groups` contiguous ranges, each walked by the
j-chunks' blocks; a band is a range's run of rows in one column tile), and
`sweep_schedule` runs a launch block by block: the producer's ordered
loads (the row above's quarter, the rows' t stages a row ahead of their
operator stages, the row below's quarter) into rings of RING t stages and two operator stages,
started as soon as the stage they refill is released, and the consumers'
rows (the carry of the row above's i = np-1 points, the next stage's i = 0
points, F in place in the slot, the j exchange between two barriers, the
bulk stores of the owned slots, whose stage is released once they have
read it).  Its arithmetic is the exact form's, so a launch
is held torch.equal to the plain version; a stage read after it is
refilled, or never loaded, shows.  The bf16x3 consumers' fragment lanes
(the carry, the next row's points, the exchange, the 128-byte swizzle of a
slot) are rehearsed lane by lane for their points and their banks.  No jax;
sizes are tiny.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from cdk_torch.kernels.biharmonic import dss2d_rowchain as rc

NP, NPTS = 4, 16
TILE = 32
BAND = rc.STEP_BAND
SMS = 132
SMEM = 232448  # the shared memory a block can use


def elems(dtype):
    """step_elems of the step: the owned elements of a j-chunk."""
    return 8 if dtype == torch.float64 else rc.STEP_ELEMS


OP_RING = 2  # operator stages


def ring(dtype):
    """Sweep<T>::RING: as many t stages as the shared memory holds beside
    the operator stages and the carries, up to four."""
    size = 8 if dtype == torch.float64 else 4
    slots = elems(dtype) + 2
    fit = (SMEM - 1024 - 256 - slots * NP * TILE * size
           - OP_RING * size * slots * (NPTS * NPTS + NPTS)) // (size * slots * NPTS * TILE)
    return min(fit, 4)


def sweep_plan(ex, ey, ncol, dtype, pad=0, sms=SMS):
    """launch_sweep's chunks, ranges (groups) and blocks."""
    own = elems(dtype)
    chunks, ctiles = -(-ey // own), -(-ncol // TILE)
    units = ctiles * (ex + 2 * pad - 2 if pad else ex)
    groups = max(1, min(units // BAND, sms // chunks))
    return dict(own=own, chunks=chunks, ctiles=ctiles, groups=groups,
                blocks=min(groups * chunks, sms))


def bands(plan, rows, r0, item):
    """Item `item`'s first owned element and its bands (ct, a0, n) on a
    step's `rows` rows from r0: the column tiles j * groups + group whole,
    then the group's share of the rest, the rc column tiles left with their
    rows cut into nb bands, in (band, column tile, row) order."""
    groups, ctiles = plan["groups"], plan["ctiles"]
    b0, grp = item % plan["chunks"] * plan["own"], item // plan["chunks"]
    whole = ctiles // groups
    out = [(j * groups + grp, r0, rows) for j in range(whole)]
    rc = ctiles - whole * groups
    if rc == 0:
        return b0, out
    nb = min(-(-groups // rc), rows)
    rest = rc * rows
    u, hi = grp * rest // groups, (grp + 1) * rest // groups
    while u < hi:
        b = max(i for i in range(nb) if rc * (i * rows // nb) <= u)
        lo, len_ = b * rows // nb, (b + 1) * rows // nb - b * rows // nb
        v = u - rc * lo
        end = min(hi, rc * lo + (v // len_ + 1) * len_)
        out.append((whole * groups + v // len_, r0 + lo + v % len_, end - u))
        u = end
    return b0, out


def _pass(s, nsteps, ex, pad, out_pad, bufs):
    """pass_of: (src, dst, rows, r0, op_off, dst_off) of step s; bufs the
    in, out and tmp tensors."""
    t_in, out, tmp = bufs
    dst = out if (nsteps - 1 - s) % 2 == 0 else tmp
    src = t_in if s == 0 else (tmp if dst is out else out)
    rows = ex + 2 * (pad - 1 - s) if pad else ex
    return (src, dst, rows, s + 1 if pad else 0, 1 if pad else 0,
            pad if dst is out and not out_pad else 0)


class Block:
    """One block's rings and its producer's ordered loads, each started as
    soon as the stage it overwrites is released."""

    def __init__(self, nring, nop, slots, ncol, dtype):
        self.t = [torch.full((slots, NPTS, TILE), float("nan"), dtype=dtype)
                  for _ in range(nring)]
        self.op = [None] * max(nop, 1)
        self.nring, self.nop, self.ncol = nring, nop, ncol
        self.loads, self.started = [], 0
        self.t_started = self.op_started = 0
        self.t_free, self.op_free = set(), set()  # released stage counts

    def pump(self):
        """Start the loads in order while the next one's stage is free."""
        while self.started < len(self.loads):
            kind, fill = self.loads[self.started]
            n = self.t_started if kind == "t" else self.op_started
            depth = self.nring if kind == "t" else self.nop
            if n >= depth and n - depth not in (self.t_free if kind == "t" else self.op_free):
                return
            if kind == "t":
                stage = self.t[n % depth]
                stage.fill_(float("nan"))
                fill(stage)
                self.t_started += 1
            else:
                self.op[n % depth] = fill()
                self.op_started += 1
            self.started += 1

    def release(self, kind, n):
        (self.t_free if kind == "t" else self.op_free).add(n)
        self.pump()


def _full_apply(F, d, ncol, c0, cols):
    """F (slots, 16, 16) applied to d's tile columns at the element's full
    width (the plain version's shape), the tile columns kept."""
    full = torch.zeros(d.shape[0], NPTS, ncol, dtype=d.dtype)
    full[..., c0:c0 + cols] = d[..., :cols]
    out = torch.zeros_like(d)
    out[..., :cols] = torch.bmm(F, full)[..., c0:c0 + cols]
    return out


def sweep_schedule(F, w, t, ex, ey, nsteps=1, squared=False, pad=0,
                   padded_out=False, out=None, tmp=None, sms=SMS):
    """A launch of the step in the sweep's order (see the module doc), the
    exact form.  -> (out, writes): writes counts each (step, dst element,
    column tile) stored."""
    dtype, ncol = t.dtype, t.shape[-1]
    plan = sweep_plan(ex, ey, ncol, dtype, pad, sms)
    own, slots = plan["own"], plan["own"] + 2
    nring, nop = ring(dtype), OP_RING
    e_pad = (ex + 2 * pad) * ey if pad else ex * ey
    if out is None:
        out_shape = (e_pad if (pad and padded_out) else ex * ey, NPTS, ncol)
        out = torch.full(out_shape, float("nan"), dtype=dtype)
    if tmp is None and nsteps > 1:
        tmp = torch.full_like(t, float("nan"))
    out_pad = pad > 0 and out.shape[0] == t.shape[0]
    writes = {}
    for s in range(nsteps):
        src, dst, rows, r0, op_off, dst_off = _pass(s, nsteps, ex, pad, out_pad,
                                                    (t, out, tmp))
        for blk in range(plan["blocks"]):
            blocks = Block(nring, nop, slots, ncol, dtype)
            work = []
            for item in range(blk, plan["groups"] * plan["chunks"], plan["blocks"]):
                b0, bs = bands(plan, rows, r0, item)
                for ct, a0, n in bs:
                    work.append((b0, ct, a0, n))
                    _produce(blocks, src, F, w, ex, ey, pad, op_off, b0, ct, a0, n, slots,
                             own)
            blocks.pump()
            nt = no = 0
            for b0, ct, a0, n in work:
                nt, no = _consume(blocks, nt, no, dst, ex, ey, dst_off, b0, ct, a0, n,
                                  slots, own, squared, writes, s)
    return out, writes


def _elem(row, ey, b0, z):
    return row * ey + (b0 - 1 + z) % ey


def _produce(blk, src, F, w, ex, ey, pad, op_off, b0, ct, a0, n, slots, own):
    ncol = src.shape[-1]
    nslots = min(own, ey - b0) + 2
    c0 = ct * TILE
    cols = min(TILE, ncol - c0)

    def row_of(a):
        return a if pad else a % ex

    def t_stage(row, p0, npts):
        def fill(stage):
            for z in range(nslots):
                e = _elem(row, ey, b0, z)
                stage[z, :npts] = 0
                stage[z, :npts, :cols] = src[e, p0:p0 + npts, c0:c0 + cols]
        return ("t", fill)

    def op_stage(a):
        def fill():
            es = [(a - op_off) * ey + (b0 - 1 + z) % ey for z in range(nslots)]
            return a, F[es].clone(), w[es].clone()
        return ("op", fill)

    blk.loads.append(t_stage(row_of(a0 - 1), NPTS - NP, NP))
    blk.loads.append(t_stage(a0, 0, NPTS))
    for i in range(n):  # each row's t stage a row ahead of its operator stage
        blk.loads.append(t_stage(a0 + i + 1, 0, NPTS) if i + 1 < n
                          else t_stage(row_of(a0 + n), 0, NP))
        blk.loads.append(op_stage(a0 + i))


def _consume(blk, nt, no, dst, ex, ey, dst_off, b0, ct, a0, n, slots, own,
             squared, writes, s):
    ncol = dst.shape[-1]
    n_own = min(own, ey - b0)
    nslots = n_own + 2
    c0 = ct * TILE
    cols = min(TILE, ncol - c0)
    need = slice(0, nslots)

    def ready(kind, k):
        started = blk.t_started if kind == "t" else blk.op_started
        assert k < started, f"the consumers wait on {kind} stage {k}, never loaded"

    ready("t", nt)
    carry = blk.t[nt % blk.nring][need, :NP].clone()  # the row above's i = np-1 points
    assert not carry[..., :cols].isnan().any()
    blk.release("t", nt)
    nt += 1
    for i in range(n):
        a = a0 + i
        ready("t", nt), ready("t", nt + 1), ready("op", no)
        cur, nxt = blk.t[nt % blk.nring], blk.t[(nt + 1) % blk.nring]
        row_a, Fs, ws = blk.op[no % blk.nop]
        assert row_a == a, "the operator stage of another row"
        d = cur[need].clone()
        assert not d[..., :cols].isnan().any() and not nxt[need, :NP, :cols].isnan().any()
        raw_bottom = d[:, NPTS - NP:].clone()
        d[:, :NP] += carry
        d[:, NPTS - NP:] += nxt[need, :NP]
        carry = raw_bottom
        d = d * ws[..., None]
        for _ in range(1 if squared else 2):
            d = _full_apply(Fs, d, ncol, c0, cols)
        cur[need] = d  # in place
        blk.release("op", no)
        no += 1
        # barrier; the owned slots read their neighbours; barrier; write back
        sums = {}
        for y in range(1, n_own + 1):
            v = cur[y].clone()
            v[0::NP] += cur[y - 1][NP - 1::NP]
            v[NP - 1::NP] += cur[y + 1][0::NP]
            sums[y] = v
        for y, v in sums.items():
            cur[y] = v
            e = (a - dst_off) * ey + (b0 - 1 + y) % ey
            dst[e, :, c0:c0 + cols] = v[:, :cols]
            writes[(s, e, ct)] = writes.get((s, e, ct), 0) + 1
        blk.release("t", nt)  # once the bulk stores have read it
        nt += 1
    blk.release("t", nt)  # the row below, the last row's next
    return nt + 1, no


def _operands(e, ncol, seed, dtype=torch.float64):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.standard_normal((e, NPTS, NPTS)) / 4).to(dtype),
            torch.from_numpy(rng.uniform(0.25, 0.5, (e, NPTS))).to(dtype),
            torch.from_numpy(rng.standard_normal((e, NPTS, ncol))).to(dtype))


def _owned_writes(writes, nsteps, elems_of_step, ctiles):
    for s in range(nsteps):
        want = {(s, e, ct) for e in elems_of_step(s) for ct in range(ctiles)}
        got = {k for k in writes if k[0] == s}
        assert got == want, s
    assert set(writes.values()) == {1}


# ---- the work order ---------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("exy,ncol,pad", [((75, 72), 2880, 0), ((75, 72), 720, 0),
                                          ((15, 25), 40, 0), ((17, 3), 40, 0),
                                          ((35, 1), 8, 0), ((2, 24), 33, 0),
                                          ((19, 72), 2880, 4), ((5, 9), 40, 3)])
def test_ranges_cover_every_unit_once_per_chunk(dtype, exy, ncol, pad):
    """Each step's (column tile, row) units are walked once by each j-chunk:
    the items of the blocks tile them, each range at least BAND rows where
    the first step has them, bands whole rows of one column tile; no block
    beyond the SMs, and the chunks' blocks of a range side by side."""
    ex, ey = exy
    plan = sweep_plan(ex, ey, ncol, dtype, pad)
    assert plan["blocks"] <= SMS
    items = plan["groups"] * plan["chunks"]
    assert plan["blocks"] == min(items, SMS)
    for s in range(max(pad, 1)):
        rows = ex + 2 * (pad - 1 - s) if pad else ex
        r0 = s + 1 if pad else 0
        for chunk in range(plan["chunks"]):
            seen = []
            for grp in range(plan["groups"]):
                b0, bs = bands(plan, rows, r0, grp * plan["chunks"] + chunk)
                assert b0 == chunk * plan["own"]
                run = sum(n for _, _, n in bs)
                if s == 0 and plan["ctiles"] * rows >= BAND:
                    assert run >= BAND
                for ct, a0, n in bs:
                    assert r0 <= a0 and a0 + n <= r0 + rows and n >= 1
                    seen += [(ct, a) for a in range(a0, a0 + n)]
            assert sorted(seen) == [(ct, a) for ct in range(plan["ctiles"])
                                    for a in range(r0, r0 + rows)]


def test_production_ranges_fill_the_card_in_one_wave():
    """At the cells' torus (75 x 72, ncol 2880 at qsize 40) and the smoke
    test's (ncol 720) at f32: three chunks of 24, 44 ranges, 132 blocks, one
    item a block; each range 153 or 154 rows (the tail under one row in
    153), at most four bands, the quarters ~1 % of the rows read."""
    for ncol, runs in ((2880, (153, 154)), (720, (39, 40))):
        plan = sweep_plan(75, 72, ncol, torch.float32)
        assert (plan["chunks"], plan["groups"], plan["blocks"]) == (3, 44, 132)
        lens, quarters = set(), 0
        for grp in range(plan["groups"]):
            _, bs = bands(plan, 75, 0, grp * 3)
            lens.add(sum(n for _, _, n in bs))
            assert len(bs) <= 4 if ncol == 2880 else len(bs) <= 2
            quarters += 2 * len(bs)
        assert lens == set(runs)
        assert quarters * NP / NPTS / (75 * plan["ctiles"]) < (0.012 if ncol == 2880 else 0.04)
    f64 = sweep_plan(75, 72, 2880, torch.float64)
    assert (f64["chunks"], f64["groups"], f64["blocks"]) == (9, 14, 126)


def test_rings_fit_the_shared_memory():
    """Three t stages at f32 (26 slots of 2 KB), four at f64 (10 of 4 KB),
    beside two operator stages and the carries, with the swizzle's alignment
    and the barriers, within 227 KB; a producer warp beside consumer warps
    of two slots each (thirteen at f32, five at f64)."""
    for dtype, size, want in ((torch.float32, 4, 3), (torch.float64, 8, 4)):
        slots = elems(dtype) + 2
        assert ring(dtype) == want
        used = (1024 + 256 + want * size * slots * NPTS * TILE + slots * NP * TILE * size
                + OP_RING * size * slots * 272)
        assert used <= SMEM
        assert slots % 2 == 0 and TILE * (slots // 2 + 1) <= 1024


# ---- the launches against the plain version -----------------------------------

@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("squared", [False, True])
@pytest.mark.parametrize("exy,ncol", [((3, 1), 33), ((2, 2), 40), ((1, 5), 8),
                                      ((BAND - 1, 5), 40), ((BAND + 1, 3), 40),
                                      ((2 * BAND + 3, 2), 8), ((4, 26), 33),
                                      ((3, 72), 40)])
def test_sweep_equals_the_plain_step(dtype, squared, exy, ncol):
    """Depth 1 and 3 (ping-pong through out and tmp, both starting as NaN)
    on tori of one row, two, a band short, a band over and two bands and
    three, ey = 1 (the j neighbours are the element itself), rows of one
    chunk over and the production 72, ragged column tiles: torch.equal to
    rowchain_step_plain, each owned (row, element, column tile) stored once
    a step."""
    ex, ey = exy
    F, w, t = _operands(ex * ey, ncol, ex * 31 + ey, dtype)
    ctiles = -(-ncol // TILE)
    for k in (1, 3):
        got, writes = sweep_schedule(F, w, t, ex, ey, k, squared)
        assert torch.equal(got, rc.rowchain_step_plain(F, w, t, ex, ey, k, squared=squared))
        _owned_writes(writes, k, lambda s: range(ex * ey), ctiles)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("exy,ncol,k", [((4, 4), 40, 1), ((6, 3), 8, 2), ((5, 9), 40, 3),
                                        ((BAND - 3, 2), 40, 2), ((BAND - 1, 3), 33, 4)])
def test_padded_sweep_equals_the_plain_step(dtype, exy, ncol, k):
    """The padded mode (K16p, K18p): rows that shrink by one a side a step,
    no wrap, owned rows at their padded rows of out (and as ex rows at
    depth 1), ranges whose band edges move from step to step: torch.equal to
    rowchain_step_padded_plain, each step's rows stored once."""
    ex, ey = exy
    F, w, tp = _operands((ex + 2 * k) * ey, ncol, ex + 7 * ey, dtype)
    F, w = F[ey:len(F) - ey], w[ey:len(w) - ey]
    ref = rc.rowchain_step_padded_plain(F, w, tp, ex, ey, k)
    ctiles = -(-ncol // TILE)
    for padded_out in ((False, True) if k == 1 else (True,)):
        got, writes = sweep_schedule(F, w, tp, ex, ey, k, pad=k, padded_out=padded_out)
        own = got[k * ey:(k + ex) * ey] if padded_out else got
        assert torch.equal(own, ref)

        def rows_of(s):  # the dst elements step s writes
            rows = ex + 2 * (k - 1 - s)
            lo = (s + 1) * ey if (padded_out or s < k - 1) else 0
            return range(lo, lo + rows * ey)

        _owned_writes(writes, k, rows_of, ctiles)


def test_sweep_with_one_block():
    """One SM: a block walks every chunk of every range in turn, its rings
    carried from item to item and band to band."""
    ex, ey, ncol = 5, 30, 40
    F, w, t = _operands(ex * ey, ncol, 3)
    for k in (1, 2):
        got, _ = sweep_schedule(F, w, t, ex, ey, k, sms=1)
        assert torch.equal(got, rc.rowchain_step_plain(F, w, t, ex, ey, k))


# ---- the bf16x3 consumers' fragment lanes --------------------------------------

def _pt(t, q):
    """bih::tc::pt: the point lane group t holds at fragment slot q."""
    return 2 * t + (q & 1) + 8 * (q >> 1)


def at(p, col, swz=True):
    """at<SWZ>: value (p, col) of a t slot."""
    return p * TILE + ((((col >> 2) ^ p) & 7) << 2) + (col & 3) if swz else p * TILE + col


LANES = [(lane >> 2, lane & 3) for lane in range(32)]  # (gq, t)


def _frag(gq, t, m, k):
    return _pt(t, k & 3), 16 * m + 8 * (k >> 2) + gq


def test_swizzle_is_a_bijection_of_the_slot():
    """at<true> and at<false> each place the 16 x 32 values of a slot at 512
    distinct offsets, and at<true> keeps each 16-byte piece (4 columns of a
    row) together, as the 128-byte swizzle of a 128-byte row does."""
    for swz in (True, False):
        offs = {at(p, c, swz) for p in range(NPTS) for c in range(TILE)}
        assert offs == set(range(NPTS * TILE))
    for p in range(NPTS):
        for c in range(0, TILE, 4):
            base = at(p, c)
            assert base % 4 == 0 and [at(p, c + v) for v in range(4)] == list(
                range(base, base + 4))
            assert base // 4 % 8 == (c // 4) ^ (p % 8)


def test_fragment_lanes_cover_the_slot_and_hit_distinct_banks():
    """The 32 lanes' (m, k) fragment points cover a slot once; each read or
    write of one (m, k) hits 32 distinct banks, as do the carry reads (lanes
    t < 2), the next row's reads (lanes t >= 2), the exchange reads of a
    neighbour slot, a thread a column's reads (exact) and each quarter warp's
    16-byte pieces of the store."""
    cover = [_frag(gq, t, m, k) for gq, t in LANES for m in range(2) for k in range(8)]
    assert sorted(cover) == [(p, c) for p in range(NPTS) for c in range(TILE)]
    for m in range(2):
        for k in range(8):
            banks = [at(*_frag(gq, t, m, k)) % 32 for gq, t in LANES]
            assert len(set(banks)) == 32, (m, k)
            reads = {"carry": [], "next": [], "left": [], "right": []}
            for gq, t in LANES:
                p, col = _frag(gq, t, m, k)
                if (k & 3) < 2 and t < 2:
                    reads["carry"].append(at(NPTS - NP + p, col) % 32)
                if (k & 3) >= 2 and t >= 2:
                    reads["next"].append(at(p - (NPTS - NP), col) % 32)
                if (k & 1) == (t & 1):
                    side = "right" if t & 1 else "left"
                    reads[side].append(at(p - (NP - 1) if t & 1 else p + NP - 1, col) % 32)
            for name, b in reads.items():
                assert len(set(b)) == len(b), (m, k, name)
    for p in range(NPTS):
        assert len({at(p, lane) % 32 for lane in range(32)}) == 32
    for i in range(NPTS * TILE // 4 // 32):  # the store: 16-byte pieces, 8 a row
        for quarter in range(4):
            pieces = [i * 32 + quarter * 8 + lane for lane in range(8)]
            banks = set()
            for k in pieces:
                base = at(k // 8, k % 8 * 4)
                banks |= {(base + v) % 32 for v in range(4)}
            assert len(banks) == 32


def test_fragment_lanes_add_the_right_neighbour_points():
    """Lane by lane: each i = 0 point is some lane t < 2's (q = 0, 1), which
    adds the row above's i = np-1 point of its j and column; each i = np-1
    point some lane t >= 2's (q = 2, 3), which adds the next row's i = 0
    point; each j = 0 point an even lane group's even slot, which adds the
    left slot's j = np-1 point, each j = np-1 point an odd group's odd slot,
    which adds the right slot's j = 0 point; and the carry a lane reads from
    a row is what it adds on the next."""
    top, bottom, jlo, jhi = set(), set(), set(), set()
    for gq, t in LANES:
        for m in range(2):
            for k in range(8):
                p, col = _frag(gq, t, m, k)
                i, j = divmod(p, NP)
                if (k & 3) < 2 and t < 2:
                    assert i == 0 and divmod(NPTS - NP + p, NP) == (NP - 1, j)
                    top.add((p, col))
                    # the carry cy[4m + c] and what the band's quarter holds there
                    c = 2 * (k >> 2) + (k & 1)
                    assert (2 * t + (c & 1), 16 * m + 8 * (c >> 1) + gq) == (p, col)
                if (k & 3) >= 2 and t >= 2:
                    assert i == NP - 1 and divmod(p - (NPTS - NP), NP) == (0, j)
                    bottom.add((p, col))
                if (k & 1) == (t & 1):
                    if t & 1:
                        assert j == NP - 1 and divmod(p - (NP - 1), NP) == (i, 0)
                        jhi.add((p, col))
                    else:
                        assert j == 0 and divmod(p + NP - 1, NP) == (i, NP - 1)
                        jlo.add((p, col))
    cols = range(TILE)
    assert top == {(p, c) for p in range(NP) for c in cols}
    assert bottom == {(p, c) for p in range(NPTS - NP, NPTS) for c in cols}
    assert jlo == {(p, c) for p in range(0, NPTS, NP) for c in cols}
    assert jhi == {(p, c) for p in range(NP - 1, NPTS, NP) for c in cols}


def test_fragment_addresses_are_a_base_and_an_immediate():
    """The bf16x3 consumer's addresses in a swizzled slot, each z[2m + r][d]
    (per lane) plus an immediate, are at<true> of the points they mean: its
    fragment points, the carry's (rows 0..3 for lanes t < 2), the row 12
    above and the next row's for lanes t >= 2, and the exchange's own and
    neighbour points (p + 3 in the left slot where t is even, p - 3 in the
    right where t is odd)."""
    for gq, t in LANES:
        z = [[64 * t + 8 * (j ^ t) + 4 * ((gq >> 2) ^ d) + (gq & 3) for d in range(2)]
             for j in range(4)]
        for m in range(2):
            for k in range(8):
                d, h, r = k & 1, (k >> 1) & 1, k >> 2
                p, col = _frag(gq, t, m, k)
                base = z[2 * m + r][d]
                assert base + 32 * d + 256 * h == at(p, col)
                if h == 1 and t >= 2:
                    assert base + 32 * d - 128 + (16 if m else -16) == at(p - 12, col)
        for m in range(2):
            for r in range(2):
                for h in range(2):
                    z0, z1 = z[2 * m + r]
                    k = 4 * r + 2 * h + (t & 1)
                    p, col = _frag(gq, t, m, k)
                    if t & 1:
                        assert z1 + 32 + 256 * h == at(p, col)
                        assert z0 - 64 + 256 * h + (8 if r else -8) == at(p - 3, col)
                    else:
                        assert z0 + 256 * h == at(p, col)
                        assert z1 + 96 + 256 * h + (-8 if r else 8) == at(p + 3, col)
