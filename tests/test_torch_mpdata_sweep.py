"""A CPU rehearsal of the MPDATA x sweep (csrc/mpdata_sweep.cuh).

`sweep` below runs the kernel's row-by-row schedule in torch f64: one
sweep per slice chunk and step, iteration p loading f, u and w row p of
the collocated x grid, every stage a fixed lag behind the rows it reads
(uuu/www at p, f1 at p-1, uuu2 at p-1, www2 and the limiter ratios at p-2,
uuu3/www3 at p-2, the final f at p-3), the kb/kc level clamps, and in the
masked mode the window's x clamps (a stage's row -1 is its row 0, its row
X its row X-1), the gi predicates and the three-pointer window.  A row is
an (S, nzm) tensor, so the lanes' level split is not modelled; every
operation rounds as the kernel's _rn intrinsics do.  The same inputs go
through the plain versions, and f must come out bit for bit
(`torch.equal`), the flux within 1e-15 (its column sums run in x order).
Sizes are tiny: 3 slices, nx 8-12, nzm 9.
"""

from __future__ import annotations

import pytest
import torch

from cdk_torch.core.config import MpdataConfig, with_overrides
from cdk_torch.core.norms import rel_l1
from cdk_torch.dist import mesh as dmesh
from cdk_torch.dist import mpdata as dmp
from cdk_torch.kernels.mpdata import masked as mk
from cdk_torch.kernels.mpdata import problem as mp
from cdk_torch.kernels.mpdata.reference import EPS, kspan
from cdk_torch.kernels.mpdata.resident import advect_resident_plain
from cdk_torch.kernels.mpdata.staged import advect_staged_plain


def _kb(r):
    return torch.cat([r[:, :1], r[:, :-1]], 1)


def _kc(r):
    return torch.cat([r[:, 1:], r[:, -1:]], 1)


def _up0(r):  # the level above, zero over the top (www(nz) = 0)
    return torch.cat([r[:, 1:], torch.zeros_like(r[:, :1])], 1)


def _pp(y):
    return torch.clamp_min(y, 0.0)


def _pn(y):
    return -torch.clamp_max(y, 0.0)


def _min3(a, b, c):
    return torch.minimum(torch.minimum(a, b), c)


class Chain:
    """The sweep's stage chain over one slice chunk: step(p, f, u, w) takes
    iteration p's loaded rows (f row p, or None past a masked window's end;
    u and w row p of the collocated grid) and returns the rows the kernel
    stores and sums there: f row p, www[p], f1[p-1], www3[p-2] and the final
    f[p-3].  Rows are (S, nzm) tensors; masked = (gi0, nx, rows) or None."""

    def __init__(self, rho, rhow, adz, *, hoist, masked=None):
        nzm = rho.shape[1]
        self.hoist, self.masked = hoist, masked is not None
        self.gi0, self.nx, self.rows = masked if masked else (-2, None, None)
        span = kspan(nzm, rho)
        self.rho, self.irho, self.iadz = rho, 1.0 / rho, 1.0 / adz
        self.dd = 2.0 / span / adz
        self.irhow = 1.0 / (rhow[:, :nzm] * adz)
        zero = rho.new_zeros(rho.shape)
        self.one = torch.ones_like(zero)
        self.state = (zero,) * 30

    def step(self, p, f_p, u_p, w_p):
        hoist, masked, rows, nx = self.hoist, self.masked, self.rows, self.nx
        rho, irho, iadz, dd, irhow, one = (self.rho, self.irho, self.iadz, self.dd,
                                           self.irhow, self.one)

        def gi_in(x, a, b):
            return a <= self.gi0 + x <= b

        (fA, fB, fC, fkbB, u1, u2, u3, ukb3, w1, w2, w3, wkc3, a1, b1, b2, g1, g2, g3,
         gkb1, gkb2, gkb3, gkc1, gkc2, mxfP, mnfP, U2a, MXr, MNr, U3a, W3a) = self.state
        fC, fB = fB, fA
        fA = f_p if f_p is not None else fB  # f[X] := f[X-1]
        u3, u2, u1 = u2, u1, u_p
        w3, w2, w1 = w2, w1, w_p
        if masked and p == rows:
            u1 = u2                          # u[X] := u[X-1]
        if masked and p == 0:
            fB, w2 = fA, w1                  # f[-1], w[-1] := row 0
        # -- stage 2: uuu[p], www[p]
        fkbA = _kb(fA)
        b3, a2, b2 = b2, a1, b1
        a1 = _pp(u1) * fB - _pn(u1) * fA
        b1 = _pp(w1) * fkbA - _pn(w1) * fA
        if masked and p == rows:
            a1 = a2                          # uuu[X] := uuu[X-1]
        # -- stage 3: f1[p-1]
        g3, g2 = g2, g1
        g1 = fB - ((a1 - a2) + (_up0(b2) - b2) * iadz) * irho
        if masked and not gi_in(p - 1, -1, nx + 2):
            g1 = fB
        if masked and p - 1 == rows:
            g1 = g2                          # f1[X] := f1[X-1]
        gkb3, gkb2, gkb1 = gkb2, gkb1, _kb(g1)
        gkc2, gkc1 = gkc1, _kc(g1)
        if masked and p - 1 == 0:
            g2, gkb2, gkc2 = g1, gkb1, gkc1  # f1[-1] := f1[0]
        # -- stage 1: f's extrema at row p-1
        fkcB = _kc(fB)
        mxfN = torch.maximum(torch.maximum(torch.maximum(fC, fA),
                                           torch.maximum(fkbB, fkcB)), fB)
        mnfN = torch.minimum(torch.minimum(torch.minimum(fC, fA),
                                           torch.minimum(fkbB, fkcB)), fB)
        # -- stage 4: uuu2[p-1]
        wkc2 = _kc(w2)
        U2b = U2a
        coef = (torch.abs(u2) - (u2 * u2) * irho) * 0.5
        wsum = ((w3 + wkc3) + w2) + wkc2
        if hoist:
            across = (((0.03125 * u2) * wsum) * dd) * irho
            U2a = coef * (g1 - g2) - across * ((gkc2 + gkc1) - (gkb2 + gkb1))
        else:
            dz = dd * (((gkc2 + gkc1) - gkb2) - gkb1)
            U2a = coef * (g1 - g2) - (((0.03125 * u2) * wsum) * dz) * irho
        if masked and not gi_in(p - 1, 0, nx + 2):
            U2a = a2
        if masked and p - 1 == rows:
            U2a = U2b                        # uuu2[X] := uuu2[X-1]
        # www2[p-2], zero at k = 0
        ukb2 = _kb(u2)
        coef = (torch.abs(w3) - (w3 * w3) * irhow) * 0.5
        usum = ((ukb3 + u3) + u2) + ukb2
        if hoist:
            across = ((0.03125 * w3) * usum) * irho
            W2 = coef * (g2 - gkb2) - across * ((gkb1 - gkb3) + (g1 - g3))
        else:
            dx = ((gkb1 + g1) - gkb3) - g3
            W2 = coef * (g2 - gkb2) - (((0.03125 * w3) * usum) * dx) * irho
        if masked and not gi_in(p - 2, 0, nx + 1):
            W2 = b3
        W2 = torch.cat([torch.zeros_like(W2[:, :1]), W2[:, 1:]], 1)
        # -- stage 5a/5b: the ratios at row p-2
        W2kc = _kc(W2)
        MXrP, MNrP = MXr, MNr
        mx = torch.maximum(torch.maximum(torch.maximum(g3, g1),
                                         torch.maximum(gkb2, gkc2)),
                           torch.maximum(g2, mxfP))
        mn = torch.minimum(torch.minimum(torch.minimum(g3, g1),
                                         torch.minimum(gkb2, gkc2)),
                           torch.minimum(g2, mnfP))
        MXr = rho * (mx - g2) / (((_pn(U2a) + _pp(U2b))
                                  + iadz * (_pn(W2kc) + _pp(W2))) + EPS)
        MNr = rho * (g2 - mn) / (((_pp(U2a) + _pn(U2b))
                                  + iadz * (_pp(W2kc) + _pn(W2))) + EPS)
        if masked and p - 2 == 0:
            MXrP, MNrP = MXr, MNr            # ratios' row -1 := row 0
        # -- stage 5c: uuu3[p-2], www3[p-2]
        U3b, W3b = U3a, W3a
        U3a = (_pp(U2b) * _min3(one, MXr, MNrP)
               - _pn(U2b) * _min3(one, MXrP, MNr))
        W3 = (_pp(W2) * _min3(one, MXr, _kb(MNr))
              - _pn(W2) * _min3(one, _kb(MXr), MNr))
        W3a = W3
        if masked and not gi_in(p - 2, 1, nx + 1):
            U3a = U2b
        if masked and not gi_in(p - 2, 1, nx):
            W3a = W2
        if masked and p - 2 == rows:
            U3a = U3b                        # uuu3[X] := uuu3[X-1]
        # -- stage 6: the final f at row p-3
        fN = torch.clamp_min(
            g3 - ((U3a - U3b) + (_up0(W3b) - W3b) * iadz) * irho, 0.0)
        if masked and not gi_in(p - 3, 1, nx):
            fN = g3
        mxfP, mnfP, fkbB, wkc3, ukb3 = mxfN, mnfN, fkbA, wkc2, ukb2
        self.state = (fA, fB, fC, fkbB, u1, u2, u3, ukb3, w1, w2, w3, wkc3, a1, b1, b2,
                      g1, g2, g3, gkb1, gkb2, gkb3, gkc1, gkc2, mxfP, mnfP, U2a, MXr,
                      MNr, U3a, W3a)
        return fA, b1, g1, W3, fN


def sweep(f, u, w, rho, rhow, adz, nsteps, *, hoist, masked=None, chunks=1,
          strips=None):
    """The kernel's schedule.  Unmasked: f (S, nx+6, nzm), u (S, nx+5, nzm),
    w (S, nx+4, nz) as the resident step takes them; returns (f, flux
    (S, nz)).  masked = (gi0, nx, owned_lo, owned_hi): the collocated window,
    f (S, X, nzm) or, with strips = (left, right), the owned block between
    them; returns (f over the window or the owned block, flux (S, nzm))."""
    S, nzm = rho.shape
    rows = u.shape[1] if masked else f.shape[1]
    if masked:
        gi0, nx, lo, hi = masked
        uoff, u_rows, w_rows = 0, rows, rows
    else:
        nx = rows - 6
        gi0, lo, hi = -2, 0, rows
        uoff, u_rows, w_rows = 1, nx + 5, nx + 4
    halo = 0 if strips is None else strips[0].shape[1]
    window = f if strips is None else torch.cat([strips[0], f, strips[1]], 1)

    def gi_in(x, a, b):
        return a <= gi0 + x <= b

    def fmask(x):
        return lo <= x < hi and gi_in(x, 1, nx)

    zero = rho.new_zeros((S, nzm))
    # the flux rows, x in [flux_lo, flux_lo + nf) (a split slice's shared rows)
    flux_lo = max(lo, 1 - gi0)
    nf = max(0, min(hi, nx + 1 - gi0) - flux_lo)
    flux_rows = [[zero] * nf, [zero] * nf]
    buf = window.clone()  # f_out (K2, K24) or the window buffer (K25)
    for step in range(nsteps):
        src = window if step == 0 else buf
        # every chunk copies its neighbours' rows before any chunk writes
        parts, snaps = [], []
        for c in range(chunks):
            R = rows - 6
            q0, q1 = 3 + R * c // chunks, 3 + R * (c + 1) // chunks
            p0 = q0 - 3
            p1 = rows + 2 if masked and c == chunks - 1 else q1 + 2
            own = (0 if c == 0 else q0, rows if c == chunks - 1 else q1)
            parts.append((p0, p1, own))
            snaps.append({r: buf[:, r].clone() for r in range(p0, min(p1, rows - 1) + 1)
                          if step > 0 and not own[0] <= r < own[1]})
        out = buf.clone()
        for (p0, p1, (own_lo, own_hi)), snap in zip(parts, snaps):
            last = step == nsteps - 1

            def load_f(r):
                if r in snap:
                    return snap[r]
                if step == 0 and strips is not None:  # the three-pointer window
                    if r < halo:
                        return strips[0][:, r]
                    if r < rows - halo:
                        return f[:, r - halo]
                    return strips[1][:, r - rows + halo]
                return src[:, r]

            def load_u(r):
                j = r - uoff
                return u[:, j] if 0 <= j < u_rows else zero

            def load_w(r):
                j = r - uoff
                return w[:, j, :nzm] if 0 <= j < w_rows else zero

            chain = Chain(rho, rhow, adz, hoist=hoist,
                          masked=(gi0, nx, rows) if masked else None)
            fl1 = fl2 = zero
            for p in range(p0, p1 + 1):
                fA, b1, g1, W3, fN = chain.step(
                    p, load_f(p) if p < rows else None, load_u(p), load_w(p))
                # flux: www[p] and www3[p-2] over the owned flux rows
                for r, val, slot in ((p, b1, 0), (p - 2, W3, 1)):
                    if fmask(r) and own_lo <= r < own_hi:
                        if chunks == 1:
                            if slot == 0:
                                fl1 = fl1 + val
                            else:
                                fl2 = fl2 + val
                        elif last:
                            flux_rows[slot][r - flux_lo] = val
                # stores
                if masked:
                    if p - 3 >= 0 and own_lo <= p - 3 < own_hi:
                        out[:, p - 3] = fN
                else:
                    if p in (0, rows - 1) and own_lo <= p < own_hi:
                        out[:, p] = fA
                    if p in (2, 3, nx + 4, nx + 5) and own_lo <= p - 1 < own_hi:
                        out[:, p - 1] = g1
                    if p >= 6 and own_lo <= p - 3 < own_hi:
                        out[:, p - 3] = fN
            if chunks == 1:
                flux = fl1 + fl2
        buf = out
        if chunks > 1:
            s1, s2 = zero, zero
            for r in range(nf):
                s1, s2 = s1 + flux_rows[0][r], s2 + flux_rows[1][r]
            flux = s1 + s2
    if nsteps == 0:
        flux = zero
    f_out = buf if strips is None else buf[:, halo:rows - halo]
    if masked:
        return f_out, flux
    return f_out, torch.cat([flux, rho.new_zeros((S, 1))], 1)


def _data(nslices=3, nx=10, nz=10):
    return mp.init_data(with_overrides(MpdataConfig(), nslices=nslices, nx=nx,
                                       nz=nz, dtype="float64"))


def _check(got, want, gate=1e-15):
    assert torch.equal(got[0], want[0])
    assert rel_l1(got[1], want[1]) < gate


@pytest.mark.parametrize("nx", [8, 12])
@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("hoist", [False, True])
@pytest.mark.parametrize("chunks", [1, 2])
def test_sweep_matches_the_resident_and_staged_loops(nx, n, hoist, chunks):
    """The hoisted-order sweep (K2/K9) against advect_resident_plain and the
    staged one (K6-K8) against the staged reference, n = 1 and 2, one warp
    a slice and a slice split between two."""
    d = _data(nx=nx)
    args = (d.f, d.u, d.w, d.rho, d.rhow, d.adz)
    f, flux = sweep(*args, n, hoist=hoist, chunks=chunks)
    plain = advect_resident_plain if hoist else advect_staged_plain
    want = plain(*args, d.flux, n)
    flux = torch.cat([flux[:, :-1], d.flux[:, -1:]], 1)  # flux(:, nz) passes
    _check((f, flux), want)


def _shard_window(P, p, kstep):
    """Shard p of P's extended window (h = 3 kstep a side): (f, u, w), the
    owned block and its strips, the per-level fields, gi0 and the owned
    range."""
    d = _data()
    cfg = with_overrides(MpdataConfig(), nslices=3, nx=10, nz=10, dtype="float64")
    m = dmesh.make_mesh(P, "cpu")
    f_s, u_s, w_s, (rho, rhow, adz, _) = dmp.make_dist_step(cfg, m)[0](d)
    h = 3 * kstep
    chunk = f_s.shape[2]
    left, right = (s[p] for s in dmesh.exchange_strips(f_s, h))
    f_e, u_e, w_e = (dmesh.exchange(a, h)[p] for a in (f_s, u_s, w_s))
    return (f_e, u_e, w_e), (f_s[p], left, right), (rho, rhow, adz), \
        p * chunk - 2 - h, cfg.nx, (h, h + chunk)


@pytest.mark.parametrize("P,p,kstep", [(1, 0, 1), (4, 1, 1), (4, 3, 1),
                                        (1, 0, 2), (2, 0, 2), (2, 1, 2)])
@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("chunks", [1, 2])
def test_masked_sweep_matches_the_masked_steps(P, p, kstep, split, chunks):
    """The masked sweep on a shard's window, whole (K20-K22, K24) or from
    three pointers (K23, K25), against masked_step_plain (one staged-order
    step: the one shard of P = 1, an inner shard and the last shard of
    P = 4) and masked_kloop_plain (two hoisted steps: P = 1 and both shards
    of P = 2, whose chunks hold the deeper halo)."""
    (f_e, u_e, w_e), (own, left, right), aux, gi0, nx, (lo, hi) = \
        _shard_window(P, p, kstep)
    args = (f_e, u_e, w_e, *aux, gi0, nx, lo, hi)
    hoist = kstep > 1
    want = mk.masked_kloop_plain(*args, kstep) if hoist else mk.masked_step_plain(*args)
    if split:
        got = sweep(own, u_e, w_e, *aux, kstep, hoist=hoist, masked=(gi0, nx, lo, hi),
                    chunks=chunks, strips=(left, right))
        want = (want[0][:, lo:hi], want[1])
    else:
        got = sweep(f_e, u_e, w_e, *aux, kstep, hoist=hoist, masked=(gi0, nx, lo, hi),
                    chunks=chunks)
    _check(got, want)
