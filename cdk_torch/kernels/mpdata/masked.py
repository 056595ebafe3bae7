"""K20-K25: the masked-global MPDATA step that the domain-decomposed forms
(`dist/mpdata.py`) run on a shard's column window.

The six TPU kernels of cdk_tpu/kernels/mpdata/pallas_masked.py compute one
masked-global step (`advect_scalar2d_masked`, below) or its hoisted k-step
loop in TPU layouts:

  K20  _kernel                     one step, z on lanes     masked_step_pallas
  K21  _kernel_packed              one step, two slices     masked_step_pallas_packed
                                   per 128-lane row
  K22  _kernel_xmajor              one step, x-major tiles  masked_step_xmajor
  K23  _kernel_xmajor_split        K22 with the halo assembled in-kernel from
                                   (left, owned, right); owned columns written
                                                            masked_step_xmajor_split
  K24  _kernel_xmajor_kloop        nsteps hoisted steps on a deep-halo window
                                                            masked_kloop_xmajor
  K25  _kernel_xmajor_kloop_split  K24 with in-kernel halo assembly
                                                            masked_kloop_xmajor_split

The layouts (lane packing, 64-lane z segments, pad-lane masks, the kspan
input, the SMEM gi0 scalar, the block pickers and VMEM requests) are not
ported: every wrapper takes the canonical collocated layout, f and u
(S, X, nzm), w (S, X, nzm+1), rho and adz (S, nzm), rhow (S, nzm+1), and
returns the flux partial as (S, nzm).  One CUDA source serves all six
(csrc/mpdata_masked.cu); each wrapper keeps the JAX name and arguments
(without block/interpret) and its own launch count.  CUDA tensors launch
the kernel and nothing else; CPU tensors run the plain version:

  masked_step_plain   one call of advect_scalar2d_masked with
                      gi = gi0 + arange(X) and owned = [owned_lo, owned_hi)
  masked_kloop_plain  make_masked_invariants once, then nsteps
                      advect_masked_hoisted steps (the JAX ordering, which
                      reassociates ~1 ulp per step against the staged one)

and the split forms concatenate (left, owned, right) and return the owned
columns.  gi0 is the global Fortran index of the window's first column.
The kernel is the masked mode of the MPDATA x sweep (one warp a slice
sweeping the window's columns; csrc/mpdata_sweep.cuh): it takes a window
of any width and up to 256 levels, and raises UnsupportedConfigError past
that.  f is bit for bit the plain version's; the flux partial's column
sums run in x order.
"""

from __future__ import annotations

import torch

from cdk_torch.core import build
from cdk_torch.core.platform import exact_fp32
from cdk_torch.core.trace import counted
from cdk_torch.kernels.mpdata.launch import check_levels, check_warps
from cdk_torch.kernels.mpdata.reference import (
    EPS,
    _across,
    _andiff,
    _kb,
    _kc,
    _min3,
    _pn,
    _pp,
    kspan,
)


# ---------------------------------------------------------- plain versions
def _xl(a):
    """Left-neighbour read along x: out[ix] = a[ix-1] (clamped at 0)."""
    return torch.cat([a[:, :1], a[:, :-1]], dim=1)


def _xr(a):
    """Right-neighbour read along x: out[ix] = a[ix+1] (clamped at the end)."""
    return torch.cat([a[:, 1:], a[:, -1:]], dim=1)


def _shl0(a):
    """out[..., k] = a[..., k+1], and 0 above the top level."""
    return torch.cat([a[..., 1:], torch.zeros_like(a[..., :1])], dim=-1)


def advect_scalar2d_masked(f, u, w, rho, rhow, adz, gi, owned, nx):
    """Masked-global MPDATA step on collocated (S, X, ·) arrays.

    gi:    (X,) int — global Fortran i of each column
    owned: (X,) bool — columns whose outputs this shard owns (flux sums
           count only owned columns; f is returned for all columns but only
           owned ones are meaningful)
    Returns (f_out (S, X, nzm), flux_body (S, nzm) partial sum over owned).
    """
    nzm = f.shape[-1]
    gim = gi.reshape(1, -1, 1)
    ownedm = owned.reshape(1, -1, 1)

    def m(lo, hi):
        return (gim >= lo) & (gim <= hi)

    irho = (1.0 / rho)[:, None, :]
    iadz = (1.0 / adz)[:, None, :]
    dd = 2.0 / kspan(nzm, f).reshape(1, 1, nzm) / adz[:, None, :]
    irhow = (1.0 / (rhow[..., :nzm] * adz))[:, None, :]
    w_s = w[..., :nzm]
    one = torch.ones((), dtype=f.dtype, device=f.device)
    fmask = m(1, nx) & ownedm

    # stage 1: extrema (valid gi in [0, nx+1])
    lf, rf = _xl(f), _xr(f)
    mx = torch.maximum(torch.maximum(torch.maximum(lf, rf),
                                     torch.maximum(_kb(f), _kc(f))), f)
    mn = torch.minimum(torch.minimum(torch.minimum(lf, rf),
                                     torch.minimum(_kb(f), _kc(f))), f)

    # stage 2: upwind fluxes (uuu valid gi in [-1,nx+3], www in [-1,nx+2])
    uuu = _pp(u) * lf - _pn(u) * f
    www_k = _pp(w_s) * _kb(f) - _pn(w_s) * f
    flux = torch.sum(torch.where(fmask, www_k, 0.0), dim=1)

    # stage 3: upwind update (gi in [-1, nx+2]); www(:,nz) = 0 on top
    upd = (_xr(uuu) - uuu + (_shl0(www_k) - www_k) * iadz) * irho
    f1 = torch.where(m(-1, nx + 2), f - upd, f)

    # stage 4: antidiffusive velocities
    lf1, rf1 = _xl(f1), _xr(f1)
    lw = _xl(w_s)
    uuu2_b = _andiff(lf1, f1, u, irho) - _across(
        dd * (_kc(lf1) + _kc(f1) - _kb(lf1) - _kb(f1)),
        u,
        lw + _kc(lw) + w_s + _kc(w_s),
    ) * irho
    uuu2 = torch.where(m(0, nx + 2), uuu2_b, uuu)
    ru = _xr(u)
    www2_b = _andiff(_kb(f1), f1, w_s, irhow) - _across(
        _kb(rf1) + rf1 - _kb(lf1) - lf1,
        w_s,
        _kb(u) + u + ru + _kb(ru),
    ) * irho
    www2_k = torch.where(m(0, nx + 1), www2_b, www_k)
    www2_k[..., 0] = 0.0  # bottom boundary www(:,:,1) = 0 (:586)

    # stage 5a: second extrema with the updated f
    mx = torch.maximum(torch.maximum(torch.maximum(lf1, rf1),
                                     torch.maximum(_kb(f1), _kc(f1))),
                       torch.maximum(f1, mx))
    mn = torch.minimum(torch.minimum(torch.minimum(lf1, rf1),
                                     torch.minimum(_kb(f1), _kc(f1))),
                       torch.minimum(f1, mn))

    # stage 5b: in/out flux ratios (valid gi in [0, nx+1])
    ruuu2 = _xr(uuu2)
    wkc = _kc(www2_k)
    rho_b = rho[:, None, :]
    mxr = rho_b * (mx - f1) / (
        _pn(ruuu2) + _pp(uuu2) + iadz * (_pn(wkc) + _pp(www2_k)) + EPS)
    mnr = rho_b * (f1 - mn) / (
        _pp(ruuu2) + _pn(uuu2) + iadz * (_pp(wkc) + _pn(www2_k)) + EPS)

    # stage 5c: limit fluxes (uuu gi in [1, nx+1], www gi in [1, nx])
    lmxr, lmnr = _xl(mxr), _xl(mnr)
    uuu3 = torch.where(
        m(1, nx + 1),
        _pp(uuu2) * _min3(one, mxr, lmnr) - _pn(uuu2) * _min3(one, lmxr, mnr),
        uuu2,
    )
    www3_b = (_pp(www2_k) * _min3(one, mxr, _kb(mnr))
              - _pn(www2_k) * _min3(one, _kb(mxr), mnr))
    www3_k = torch.where(m(1, nx), www3_b, www2_k)
    flux = flux + torch.sum(torch.where(fmask, www3_b, 0.0), dim=1)

    # stage 6: final update with positive clip (gi in [1, nx])
    upd6 = (_xr(uuu3) - uuu3 + (_shl0(www3_k) - www3_k) * iadz) * irho
    f_out = torch.where(m(1, nx), torch.clamp_min(f1 - upd6, 0.0), f1)
    return f_out, flux


def _masks(X, gi0, owned_lo, owned_hi, device):
    li = torch.arange(X, device=device)
    return gi0 + li, (li >= owned_lo) & (li < owned_hi)


def masked_step_plain(f, u, w, rho, rhow, adz, gi0, nx, owned_lo, owned_hi):
    """One masked-global step on a window; -> (f_out, flux partial)."""
    exact_fp32()
    gi, owned = _masks(f.shape[1], gi0, owned_lo, owned_hi, f.device)
    return advect_scalar2d_masked(f, u, w, rho, rhow, adz, gi, owned, nx)


def make_masked_invariants(u, w, rho, rhow, adz, gi, owned, nx):
    """Step-invariant factors of the masked-global core: velocities,
    densities, grid metrics and the global-index masks are constant across
    the time loop.  The folding is the JAX package's
    (pallas_masked.make_masked_invariants)."""
    nzm = rho.shape[-1]
    gim = gi.reshape(1, -1, 1)

    def m(lo, hi):
        return (gim >= lo) & (gim <= hi)

    irho = (1.0 / rho)[:, None, :]
    dd = (2.0 / kspan(nzm, u).reshape(1, nzm) / adz)[:, None, :]
    irhow = (1.0 / (rhow[..., :nzm] * adz))[:, None, :]
    w_s = w[..., :nzm]
    lw = _xl(w_s)
    wsum_a = lw + _kc(lw) + w_s + _kc(w_s)
    ru = _xr(u)
    usum_b = _kb(u) + u + ru + _kb(ru)
    return dict(
        irho=irho, iadz=(1.0 / adz)[:, None, :], rho_b=rho[:, None, :],
        up=_pp(u), un=_pn(u), wp=_pp(w_s), wn=_pn(w_s),
        coefA=(torch.abs(u) - u * u * irho) * 0.5,
        acrossA=((0.03125 * u) * wsum_a) * dd * irho,
        coefB=(torch.abs(w_s) - w_s * w_s * irhow) * 0.5,
        acrossB=((0.03125 * w_s) * usum_b) * irho,
        fmask=m(1, nx) & owned.reshape(1, -1, 1),
        m_upd=m(-1, nx + 2), m_uu2=m(0, nx + 2), m_ww2=m(0, nx + 1),
        m_uu3=m(1, nx + 1), m_fin=m(1, nx),
    )


def advect_masked_hoisted(f, inv):
    """One masked-global step with hoisted invariants; the stages of
    advect_scalar2d_masked, with stage 4 from the pre-folded coefficients.
    Returns (f_out, flux partial)."""
    one = torch.ones((), dtype=f.dtype, device=f.device)
    irho, iadz, rho_b = inv["irho"], inv["iadz"], inv["rho_b"]

    # stage 1: extrema
    lf, rf = _xl(f), _xr(f)
    mx = torch.maximum(torch.maximum(torch.maximum(lf, rf),
                                     torch.maximum(_kb(f), _kc(f))), f)
    mn = torch.minimum(torch.minimum(torch.minimum(lf, rf),
                                     torch.minimum(_kb(f), _kc(f))), f)

    # stage 2: upwind fluxes
    uuu = inv["up"] * lf - inv["un"] * f
    www_k = inv["wp"] * _kb(f) - inv["wn"] * f
    flux = torch.sum(torch.where(inv["fmask"], www_k, 0.0), dim=1)

    # stage 3: upwind update
    upd = (_xr(uuu) - uuu + (_shl0(www_k) - www_k) * iadz) * irho
    f1 = torch.where(inv["m_upd"], f - upd, f)

    # stage 4: antidiffusive velocities (coefficients hoisted)
    lf1, rf1 = _xl(f1), _xr(f1)
    tmp_a = lf1 + f1
    uuu2_b = inv["coefA"] * (f1 - lf1) - inv["acrossA"] * (_kc(tmp_a) - _kb(tmp_a))
    uuu2 = torch.where(inv["m_uu2"], uuu2_b, uuu)
    dfc = rf1 - lf1
    www2_b = inv["coefB"] * (f1 - _kb(f1)) - inv["acrossB"] * (_kb(dfc) + dfc)
    www2_k = torch.where(inv["m_ww2"], www2_b, www_k)
    www2_k[..., 0] = 0.0

    # stage 5a: second extrema
    mx = torch.maximum(torch.maximum(torch.maximum(lf1, rf1),
                                     torch.maximum(_kb(f1), _kc(f1))),
                       torch.maximum(f1, mx))
    mn = torch.minimum(torch.minimum(torch.minimum(lf1, rf1),
                                     torch.minimum(_kb(f1), _kc(f1))),
                       torch.minimum(f1, mn))

    # stage 5b: in/out flux ratios
    ruuu2 = _xr(uuu2)
    wkc = _kc(www2_k)
    mxr = rho_b * (mx - f1) / (
        _pn(ruuu2) + _pp(uuu2) + iadz * (_pn(wkc) + _pp(www2_k)) + EPS)
    mnr = rho_b * (f1 - mn) / (
        _pp(ruuu2) + _pn(uuu2) + iadz * (_pp(wkc) + _pn(www2_k)) + EPS)

    # stage 5c: limit fluxes
    lmxr, lmnr = _xl(mxr), _xl(mnr)
    uuu3 = torch.where(
        inv["m_uu3"],
        _pp(uuu2) * _min3(one, mxr, lmnr) - _pn(uuu2) * _min3(one, lmxr, mnr),
        uuu2)
    www3_b = (_pp(www2_k) * _min3(one, mxr, _kb(mnr))
              - _pn(www2_k) * _min3(one, _kb(mxr), mnr))
    www3_k = torch.where(inv["m_fin"], www3_b, www2_k)
    flux = flux + torch.sum(torch.where(inv["fmask"], www3_b, 0.0), dim=1)

    # stage 6: final update with positive clip
    upd6 = (_xr(uuu3) - uuu3 + (_shl0(www3_k) - www3_k) * iadz) * irho
    f_out = torch.where(inv["m_fin"], torch.clamp_min(f1 - upd6, 0.0), f1)
    return f_out, flux


def masked_kloop_plain(f, u, w, rho, rhow, adz, gi0, nx, owned_lo, owned_hi,
                       nsteps):
    """nsteps hoisted masked steps on a window; -> (f_out, the last step's
    flux partial; zeros for nsteps = 0)."""
    exact_fp32()
    gi, owned = _masks(f.shape[1], gi0, owned_lo, owned_hi, f.device)
    inv = make_masked_invariants(u, w, rho, rhow, adz, gi, owned, nx)
    flux = f.new_zeros(f.shape[:1] + f.shape[2:])
    for _ in range(nsteps):
        f, flux = advect_masked_hoisted(f, inv)
    return f, flux


# ------------------------------------------------------------------ binding
_ENTRY = {torch.float32: "cdk_mpdata_masked_f32",
          torch.float64: "cdk_mpdata_masked_f64"}


def _validate(f, u, w, rho, rhow, adz, X, nzm, nsteps, owned_lo, owned_hi,
              strips=()):
    """Shapes, dtypes and devices of a window of X columns."""
    s = f.shape[0]
    if f.dim() != 3 or f.shape[2] != nzm:
        raise ValueError(f"f: shape {tuple(f.shape)}, want (S, ·, nzm={nzm})")
    if nsteps < 0:
        raise ValueError(f"nsteps must be >= 0 (got {nsteps})")
    if not 0 <= owned_lo <= owned_hi <= X:
        raise ValueError(f"owned [{owned_lo}, {owned_hi}) outside [0, {X})")
    want = dict(u=(s, X, nzm), w=(s, X, nzm + 1), rho=(s, nzm),
                rhow=(s, nzm + 1), adz=(s, nzm))
    fields = dict(u=u, w=w, rho=rho, rhow=rhow, adz=adz)
    for i, t in enumerate(strips):
        fields[f"strip{i}"] = t
        want[f"strip{i}"] = (s, (X - f.shape[1]) // 2, nzm)
    for name, t in fields.items():
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, want {want[name]}")
    for name, t in dict(f=f, **fields).items():
        if t.dtype != f.dtype or t.device != f.device:
            raise TypeError(f"{name}: {t.dtype} on {t.device}; every field "
                            f"must be {f.dtype} on {f.device}")
    if f.dtype not in _ENTRY:
        raise TypeError(f"the masked step takes float32 or float64, not {f.dtype}")
    if f.is_cuda:
        check_levels(nzm, "the masked step")


def _masked(wrapper, f, strips, u, w, rho, rhow, adz, gi0, nx, nzm,
            owned_lo, owned_hi, nsteps, hoist, warps):
    """The body of every wrapper: check, then the plain version for CPU
    tensors or one launch over all slices (counted on `wrapper`) for CUDA
    tensors.  strips is None for a pre-built window, else the (left,
    right) strips around the owned block f, whose owned columns alone are
    returned (the kernel writes only those, and a window-sized scratch
    buffer carries the steps before the last).  `warps` sets the kernel's
    warps a slice (1, 2, 4 or 8) where its own choice by slice count is
    not wanted, as a measurement of that choice does."""
    if f.shape[-1] != nzm:
        raise ValueError(f"nzm={nzm} but f has {f.shape[-1]} levels")
    X = u.shape[1]
    _validate(f, u, w, rho, rhow, adz, X, nzm, nsteps, owned_lo, owned_hi,
              strips or ())
    if f.device.type == "cpu":
        win = f if strips is None else torch.cat([strips[0], f, strips[1]], 1)
        args = (win, u, w, rho, rhow, adz, gi0, nx, owned_lo, owned_hi)
        f_o, flux = (masked_kloop_plain(*args, nsteps) if hoist
                     else masked_step_plain(*args))
        return (f_o, flux) if strips is None else (f_o[:, owned_lo:owned_hi], flux)
    fl, fr = strips or (None, None)
    halo = 0 if fl is None else fl.shape[1]
    s = u.shape[0]
    if not all(t is None or t.is_contiguous()
               for t in (fl, f, fr, u, w, rho, rhow, adz)):
        raise ValueError("the masked step kernel needs contiguous fields")
    f_out = torch.empty_like(f)
    flux_out = f.new_empty((s, nzm))
    win = u.new_empty((s, X, nzm)) if fl is not None and nsteps > 1 else None
    build.launch(wrapper, nsteps, "mpdata_masked", _ENTRY[f.dtype], f.device,
                 fl, f, fr, u, w, rho, rhow, adz, f_out, flux_out, win, s, X,
                 nzm, nx, int(gi0), owned_lo, owned_hi, halo, nsteps,
                 int(hoist), check_warps(warps))
    return f_out, flux_out


@counted
def masked_step_pallas(f, u, w, rho, rhow, adz, gi0, *, nx, owned_lo, owned_hi):
    """K20: one masked-global step on a window (S, X, nzm); returns (f_out
    (S, X, nzm), flux partial (S, nzm) over owned columns in [1, nx])."""
    return _masked(masked_step_pallas, f, None, u, w, rho, rhow, adz, gi0, nx,
                   f.shape[-1], owned_lo, owned_hi, 1, False, None)


@counted
def masked_step_pallas_packed(f, u, w, rho, rhow, adz, gi0, *, nx, nzm,
                              owned_lo, owned_hi):
    """K21: the same step as K20 (the JAX form packs two slices per row)."""
    return _masked(masked_step_pallas_packed, f, None, u, w, rho, rhow, adz,
                   gi0, nx, nzm, owned_lo, owned_hi, 1, False, None)


@counted
def masked_step_xmajor(f, u, w, rho, rhow, adz, gi0, *, nx, nzm, owned_lo,
                       owned_hi, warps=None):
    """K22: the same step as K20 (the JAX form is x-major, the AUTO core)."""
    return _masked(masked_step_xmajor, f, None, u, w, rho, rhow, adz, gi0, nx,
                   nzm, owned_lo, owned_hi, 1, False, warps)


@counted
def masked_step_xmajor_split(f_loc, f_left, f_right, u_ext, w_ext, rho, rhow,
                             adz, gi0, *, nx, nzm, halo, warps=None):
    """K23: one masked step on the window (f_left, f_loc, f_right) with u/w
    already extended; gi0 is the global index of the first halo column.
    Returns (f_out (S, chunk, nzm), owned columns only, and the flux
    partial)."""
    return _masked(masked_step_xmajor_split, f_loc, (f_left, f_right), u_ext,
                   w_ext, rho, rhow, adz, gi0, nx, nzm, halo,
                   u_ext.shape[1] - halo, 1, False, warps)


@counted
def masked_kloop_xmajor(f, u, w, rho, rhow, adz, gi0, *, nx, nzm, owned_lo,
                        owned_hi, nsteps, warps=None):
    """K24: nsteps hoisted masked steps on a deep-halo window in one launch.
    Returns (f_out over the whole window, only [owned_lo, owned_hi)
    meaningful after nsteps, and the last step's flux partial)."""
    return _masked(masked_kloop_xmajor, f, None, u, w, rho, rhow, adz, gi0, nx,
                   nzm, owned_lo, owned_hi, nsteps, True, warps)


@counted
def masked_kloop_xmajor_split(f_loc, f_left, f_right, u_ext, w_ext, rho, rhow,
                              adz, gi0, *, nx, nzm, halo, nsteps, warps=None):
    """K25: K24 on the window (f_left, f_loc, f_right), halo = 3·nsteps;
    returns (the owned columns, the last step's flux partial)."""
    return _masked(masked_kloop_xmajor_split, f_loc, (f_left, f_right), u_ext,
                   w_ext, rho, rhow, adz, gi0, nx, nzm, halo,
                   u_ext.shape[1] - halo, nsteps, True, warps)
