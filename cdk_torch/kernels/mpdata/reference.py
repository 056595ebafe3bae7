"""Trusted PyTorch reference of MPDATA advect_scalar2D (positive-definite
monotonic 2-D tracer advection with non-oscillatory FCT limiter).

A stage-by-stage port of the JAX package's staged reference
(`cdk_tpu/kernels/mpdata/reference.py`), which matches the reference CPU
kernel `advect_scalar2D_cpu` (advect_scalar2D_pushncols_openacc.F90:477-642):

  0. top boundary www(:,:,nz) = 0                         (:511)
  1. FCT extrema mx/mn over the 5-point (i±1, k±1) stencil (:513-526)
  2. first-order upwind fluxes uuu/www; flux(k) = Σ_i www  (:528-548)
  3. upwind update of f over the extended range i=-1..nx+2 (:550-560)
  4. MPDATA antidiffusive pseudo-velocities (andiff/across) (:561-585),
     bottom boundary www(:,:,1) = 0                        (:586)
  5. non-oscillatory limiter: extrema update, in/out flux ratios, flux
     limiting + flux accumulation                          (:588-628)
  6. final update with positive clip f = max(0, ·)         (:630-637)

Statement functions (advect…F90:95-98):
  andiff(x1,x2,a,b) = (|a| - a²b) · 0.5 · (x2-x1)
  across(x1,a1,a2)  = 0.03125 · a1 · a2 · x1
  pp(y) = max(0,y),  pn(y) = -min(0,y)

Elementwise ops only: no TF32 path exists at any dtype.
"""

from __future__ import annotations

import torch

from cdk_torch.core.registry import register
from cdk_torch.kernels.mpdata.problem import MpdataData

EPS = 1.0e-10  # limiter regularization (advect…F90:510)


def _kb(a):
    """Clamped k-1 shift along z: out[..., k] = a[..., max(0, k-1)]."""
    return torch.cat([a[..., :1], a[..., :-1]], dim=-1)


def _kc(a):
    """Clamped k+1 shift along z: out[..., k] = a[..., min(K-1, k+1)]."""
    return torch.cat([a[..., 1:], a[..., -1:]], dim=-1)


def _pp(y):
    return torch.clamp_min(y, 0.0)


def _pn(y):
    return -torch.clamp_max(y, 0.0)


def _andiff(x1, x2, a, b):
    return (torch.abs(a) - a * a * b) * 0.5 * (x2 - x1)


def _across(x1, a1, a2):
    return 0.03125 * a1 * a2 * x1


def _min3(a, b, c):
    return torch.minimum(torch.minimum(a, b), c)


def kspan(nzm: int, like: torch.Tensor) -> torch.Tensor:
    """kc - kb per level, with kc = min(nzm, k+1), kb = max(1, k-1) (:568)."""
    k1 = torch.arange(nzm, device=like.device)
    return (torch.clamp_max(k1 + 1, nzm - 1)
            - torch.clamp_min(k1 - 1, 0)).to(like.dtype)


def advect_scalar2d(f, u, w, rho, rhow, adz, flux_in):
    """One MPDATA advection step. Shapes per MpdataData; returns (f, flux).

    x-index conventions (python ix vs Fortran i): f ix=i+2, u/uuu ix=i+1,
    w/www ix=i+1, mx/mn ix=i."""
    s, fx, nzm = f.shape
    nx = fx - 6
    one = torch.ones((), dtype=f.dtype, device=f.device)

    irho = (1.0 / rho)[:, None, :]
    iadz = (1.0 / adz)[:, None, :]
    dd = 2.0 / kspan(nzm, f).reshape(1, 1, nzm) / adz[:, None, :]
    irhow = (1.0 / (rhow[..., :nzm] * adz))[:, None, :]

    w_s = w[..., :nzm]

    # -- stage 1: FCT extrema over i=0..nx+1 (:513-526)
    f_c = f[:, 2:nx + 4]
    f_ib = f[:, 1:nx + 3]
    f_ic = f[:, 3:nx + 5]
    mx = torch.maximum(
        torch.maximum(torch.maximum(f_ib, f_ic),
                      torch.maximum(_kb(f_c), _kc(f_c))),
        f_c,
    )
    mn = torch.minimum(
        torch.minimum(torch.minimum(f_ib, f_ic),
                      torch.minimum(_kb(f_c), _kc(f_c))),
        f_c,
    )

    # -- stage 2: first-order upwind fluxes + domain flux sum (:528-548)
    uuu = _pp(u) * f[:, 0:nx + 5] - _pn(u) * f[:, 1:nx + 6]
    f_w = f[:, 1:nx + 5]
    www_body = _pp(w_s) * _kb(f_w) - _pn(w_s) * f_w
    # stage 0: top boundary www(:,:,nz) = 0 (:511)
    www = torch.cat([www_body, torch.zeros_like(www_body[..., :1])], dim=-1)
    flux = torch.sum(www_body[:, 2:nx + 2], dim=1)

    # -- stage 3: upwind update of f over i=-1..nx+2 (:550-560)
    upd = (
        uuu[:, 1:nx + 5] - uuu[:, 0:nx + 4]
        + (www[..., 1:] - www[..., :nzm]) * iadz
    ) * irho
    f1 = torch.cat([f[:, :1], f[:, 1:nx + 5] - upd, f[:, nx + 5:]], dim=1)

    # -- stage 4: antidiffusive pseudo-velocities (:561-585)
    # uuu over i=0..nx+2
    a_fib = f1[:, 1:nx + 4]
    a_fi = f1[:, 2:nx + 5]
    a_u = u[:, 1:nx + 4]
    a_wib = w_s[:, 0:nx + 3]
    a_wi = w_s[:, 1:nx + 4]
    uuu2_body = _andiff(a_fib, a_fi, a_u, irho) - _across(
        dd * (_kc(a_fib) + _kc(a_fi) - _kb(a_fib) - _kb(a_fi)),
        a_u,
        a_wib + _kc(a_wib) + a_wi + _kc(a_wi),
    ) * irho
    uuu2 = torch.cat([uuu[:, :1], uuu2_body, uuu[:, nx + 4:]], dim=1)
    # www over i=0..nx+1
    b_fi = f1[:, 2:nx + 4]
    b_fib = f1[:, 1:nx + 3]
    b_fic = f1[:, 3:nx + 5]
    b_w = w_s[:, 1:nx + 3]
    b_u = u[:, 1:nx + 3]
    b_uic = u[:, 2:nx + 4]
    www2_body = _andiff(_kb(b_fi), b_fi, b_w, irhow) - _across(
        _kb(b_fic) + b_fic - _kb(b_fib) - b_fib,
        b_w,
        _kb(b_u) + b_u + b_uic + _kb(b_uic),
    ) * irho
    www2_z = torch.cat(
        [www[:, :1, :nzm], www2_body, www[:, nx + 3:, :nzm]], dim=1)
    # bottom boundary www(:,:,1) = 0 (:586) + reattach the zero top level
    www2 = torch.cat(
        [torch.zeros_like(www2_z[..., :1]), www2_z[..., 1:], www[..., nzm:]],
        dim=-1,
    )

    # -- stage 5a: second extrema update with the upwind-updated f (:588-600)
    f1_c = f1[:, 2:nx + 4]
    f1_ib = f1[:, 1:nx + 3]
    f1_ic = f1[:, 3:nx + 5]
    mx = torch.maximum(
        torch.maximum(torch.maximum(f1_ib, f1_ic),
                      torch.maximum(_kb(f1_c), _kc(f1_c))),
        torch.maximum(f1_c, mx),
    )
    mn = torch.minimum(
        torch.minimum(torch.minimum(f1_ib, f1_ic),
                      torch.minimum(_kb(f1_c), _kc(f1_c))),
        torch.minimum(f1_c, mn),
    )

    # -- stage 5b: in/out flux ratios (:601-612)
    r_ui = uuu2[:, 1:nx + 3]
    r_uic = uuu2[:, 2:nx + 4]
    r_wi = www2[:, 1:nx + 3, :nzm]
    r_wkc = _kc(r_wi)
    rho_b = rho[:, None, :]
    mxr = rho_b * (mx - f1_c) / (
        _pn(r_uic) + _pp(r_ui) + iadz * (_pn(r_wkc) + _pp(r_wi)) + EPS
    )
    mnr = rho_b * (f1_c - mn) / (
        _pp(r_uic) + _pn(r_ui) + iadz * (_pp(r_wkc) + _pn(r_wi)) + EPS
    )

    # -- stage 5c: limit fluxes + accumulate flux (:613-628)
    # uuu over i=1..nx+1
    l_u = uuu2[:, 2:nx + 3]
    uuu3_body = (
        _pp(l_u) * _min3(one, mxr[:, 1:nx + 2], mnr[:, 0:nx + 1])
        - _pn(l_u) * _min3(one, mxr[:, 0:nx + 1], mnr[:, 1:nx + 2])
    )
    uuu3 = torch.cat([uuu2[:, :2], uuu3_body, uuu2[:, nx + 3:]], dim=1)
    # www over i=1..nx (kb = max(1,k-1) on the mx/mn ratios)
    l_w = www2[:, 2:nx + 2, :nzm]
    mx_i = mxr[:, 1:nx + 1]
    mn_i = mnr[:, 1:nx + 1]
    www3_body = _pp(l_w) * _min3(one, mx_i, _kb(mn_i)) - _pn(l_w) * _min3(
        one, _kb(mx_i), mn_i
    )
    www3 = torch.cat(
        [
            torch.cat(
                [www2[:, :2, :nzm], www3_body, www2[:, nx + 2:, :nzm]], dim=1
            ),
            www2[..., nzm:],
        ],
        dim=-1,
    )
    flux = flux + torch.sum(www3_body, dim=1)

    # -- stage 6: final update with positive clip over i=1..nx (:630-637)
    f6 = f1[:, 3:nx + 3]
    upd6 = (
        uuu3[:, 3:nx + 3] - uuu3[:, 2:nx + 2]
        + (www3[:, 2:nx + 2, 1:] - www3[:, 2:nx + 2, :nzm]) * iadz
    ) * irho
    f_out = torch.cat(
        [f1[:, :3], torch.clamp_min(f6 - upd6, 0.0), f1[:, nx + 3:]], dim=1)

    # flux(:,nz) is never written by the reference (:540-547) — pass through
    flux_out = torch.cat([flux, flux_in[:, nzm:]], dim=-1)
    return f_out, flux_out


@register(
    "mpdata",
    "reference_jnp",
    "trusted PyTorch staged reference (the JAX package's jnp reference: "
    "CPU/openacc_1 semantics, advect_scalar2D…F90:477-642)",
)
def make_reference(cfg):
    def step(data: MpdataData):
        return advect_scalar2d(
            data.f, data.u, data.w, data.rho, data.rhow, data.adz, data.flux
        )

    return step
