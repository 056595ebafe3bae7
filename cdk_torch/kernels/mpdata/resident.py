"""K2: the resident MPDATA step loop — n advect_scalar2D steps in one
kernel launch, with the step-invariant factors computed once.

Replaces cdk_tpu/kernels/mpdata/pallas_xmajor.py::_kernel (stage math:
pallas_resident.py::make_invariants and advect_packed_hoisted), registered
under the same name, `pallas_xmajor`.  The TPU kernel's packing (16 slices
per vreg tile, 64-lane z segments) is not ported: the kernel takes the
canonical (S, X, Z) layout.

The CUDA kernel is csrc/mpdata_resident.cu.  Beside it here:
`advect_resident_plain`, the same hoisted-invariant step loop in plain
PyTorch (the CPU path, and what the card's kernel is compared with), and
the wrapper `advect_resident`, which launches the kernel for CUDA tensors
and runs the plain version for CPU tensors.  The plain version is
elementwise, and still runs with TF32 off (`exact_fp32`) like every plain
version and reference on the card.

Hoisting folds the stage-4 coefficients out of the loop and combines two
z-shifted terms by shift-linearity (kc(x)+kc(y) == kc(x+y)), which
reassociates a couple of additions: ~1 ulp per step against the staged
reference, as in the JAX kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from cdk_torch.core import build
from cdk_torch.core.platform import exact_fp32
from cdk_torch.core.registry import UnsupportedConfigError, register
from cdk_torch.kernels.mpdata.problem import MpdataData
from cdk_torch.kernels.mpdata.reference import (
    EPS,
    _kb,
    _kc,
    _min3,
    _pn,
    _pp,
    kspan,
)


def _shl0(a):
    """out[..., k] = a[..., k+1], and 0 above the top level (www(nz)=0)."""
    return torch.cat([a[..., 1:], torch.zeros_like(a[..., :1])], dim=-1)


def make_invariants(u, w, rho, rhow, adz):
    """Everything in a step that depends only on the velocity, density and
    grid fields, which stay fixed across the time loop."""
    nzm = rho.shape[-1]
    nx = u.shape[1] - 5
    w = w[..., :nzm]
    irho = (1.0 / rho)[:, None, :]
    dd = (2.0 / kspan(nzm, u) / adz)[:, None, :]
    irhow = (1.0 / (rhow[..., :nzm] * adz))[:, None, :]

    # stage 4a (x-direction): coefA*(f_i - f_ib) - acrossA*(kc - kb)(f_ib+f_i)
    a_u = u[:, 1:nx + 4]
    a_wib = w[:, 0:nx + 3]
    a_wi = w[:, 1:nx + 4]
    wsum_a = a_wib + _kc(a_wib) + a_wi + _kc(a_wi)
    # stage 4b (z-direction): coefB*(f_i - kb(f_i)) - acrossB*(kb(dfc) + dfc)
    b_w = w[:, 1:nx + 3]
    b_u = u[:, 1:nx + 3]
    b_uic = u[:, 2:nx + 4]
    usum_b = _kb(b_u) + b_u + b_uic + _kb(b_uic)
    return dict(
        irho=irho,
        iadz=(1.0 / adz)[:, None, :],
        rho=rho[:, None, :],
        up=_pp(u), un=_pn(u), wp=_pp(w), wn=_pn(w),
        coefA=(torch.abs(a_u) - a_u * a_u * irho) * 0.5,
        acrossA=((0.03125 * a_u) * wsum_a) * dd * irho,
        coefB=(torch.abs(b_w) - b_w * b_w * irhow) * 0.5,
        acrossB=((0.03125 * b_w) * usum_b) * irho,
    )


def advect_hoisted(f, flux_in, inv):
    """One step with the invariants of make_invariants; returns (f, flux)."""
    nx = f.shape[1] - 6
    nzm = f.shape[-1]
    one = torch.ones((), dtype=f.dtype, device=f.device)
    irho, iadz = inv["irho"], inv["iadz"]

    # -- stage 1: FCT extrema
    f_c = f[:, 2:nx + 4]
    f_ib = f[:, 1:nx + 3]
    f_ic = f[:, 3:nx + 5]
    mx = torch.maximum(
        torch.maximum(torch.maximum(f_ib, f_ic),
                      torch.maximum(_kb(f_c), _kc(f_c))), f_c)
    mn = torch.minimum(
        torch.minimum(torch.minimum(f_ib, f_ic),
                      torch.minimum(_kb(f_c), _kc(f_c))), f_c)

    # -- stage 2: first-order upwind fluxes + flux column sum
    uuu = inv["up"] * f[:, 0:nx + 5] - inv["un"] * f[:, 1:nx + 6]
    f_w = f[:, 1:nx + 5]
    www = inv["wp"] * _kb(f_w) - inv["wn"] * f_w
    flux = torch.sum(www[:, 2:nx + 2], dim=1)

    # -- stage 3: upwind update
    upd = (uuu[:, 1:nx + 5] - uuu[:, 0:nx + 4] + (_shl0(www) - www) * iadz) * irho
    f1 = torch.cat([f[:, :1], f[:, 1:nx + 5] - upd, f[:, nx + 5:]], dim=1)

    # -- stage 4: antidiffusive pseudo-velocities, in body coordinates:
    # U2[:, j] is uuu2 at u row j+1, W2[:, j] is www2 at w row j+1
    a_fib = f1[:, 1:nx + 4]
    a_fi = f1[:, 2:nx + 5]
    tmp_a = a_fib + a_fi
    U2 = inv["coefA"] * (a_fi - a_fib) - inv["acrossA"] * (_kc(tmp_a) - _kb(tmp_a))
    b_fi = f1[:, 2:nx + 4]
    dfc = f1[:, 3:nx + 5] - f1[:, 1:nx + 3]
    W2 = inv["coefB"] * (b_fi - _kb(b_fi)) - inv["acrossB"] * (_kb(dfc) + dfc)
    W2[..., 0] = 0.0  # bottom boundary www(:,:,1) = 0

    # -- stage 5a: second extrema
    f1_c = f1[:, 2:nx + 4]
    f1_ib = f1[:, 1:nx + 3]
    f1_ic = f1[:, 3:nx + 5]
    mx = torch.maximum(
        torch.maximum(torch.maximum(f1_ib, f1_ic),
                      torch.maximum(_kb(f1_c), _kc(f1_c))),
        torch.maximum(f1_c, mx))
    mn = torch.minimum(
        torch.minimum(torch.minimum(f1_ib, f1_ic),
                      torch.minimum(_kb(f1_c), _kc(f1_c))),
        torch.minimum(f1_c, mn))

    # -- stage 5b: in/out flux ratios
    r_ui = U2[:, 0:nx + 2]
    r_uic = U2[:, 1:nx + 3]
    r_wi = W2[:, 0:nx + 2]
    r_wkc = _kc(r_wi)
    mxr = inv["rho"] * (mx - f1_c) / (
        _pn(r_uic) + _pp(r_ui) + iadz * (_pn(r_wkc) + _pp(r_wi)) + EPS)
    mnr = inv["rho"] * (f1_c - mn) / (
        _pp(r_uic) + _pn(r_ui) + iadz * (_pp(r_wkc) + _pn(r_wi)) + EPS)

    # -- stage 5c: limited fluxes (U3[:, j] is uuu3 at u row j+2,
    # W3[:, j] is www3 at w row j+2) + flux accumulation
    l_u = U2[:, 1:nx + 2]
    U3 = (_pp(l_u) * _min3(one, mxr[:, 1:nx + 2], mnr[:, 0:nx + 1])
          - _pn(l_u) * _min3(one, mxr[:, 0:nx + 1], mnr[:, 1:nx + 2]))
    l_w = W2[:, 1:nx + 1]
    mx_i = mxr[:, 1:nx + 1]
    mn_i = mnr[:, 1:nx + 1]
    W3 = (_pp(l_w) * _min3(one, mx_i, _kb(mn_i))
          - _pn(l_w) * _min3(one, _kb(mx_i), mn_i))
    flux = flux + torch.sum(W3, dim=1)

    # -- stage 6: final update with positive clip on i=1..nx
    upd6 = (U3[:, 1:nx + 1] - U3[:, 0:nx] + (_shl0(W3) - W3) * iadz) * irho
    f_out = torch.cat(
        [f1[:, :3], torch.clamp_min(f1[:, 3:nx + 3] - upd6, 0.0), f1[:, nx + 3:]],
        dim=1)
    # flux(:, nz) is never written by the reference — pass it through
    flux_out = torch.cat([flux, flux_in[:, nzm:]], dim=-1)
    return f_out, flux_out


def advect_resident_plain(f, u, w, rho, rhow, adz, flux, n: int):
    """n hoisted-invariant steps; (f, flux) feed back.  n=0 returns the
    inputs unchanged."""
    exact_fp32()
    inv = make_invariants(u, w, rho, rhow, adz)
    for _ in range(n):
        f, flux = advect_hoisted(f, flux, inv)
    return f, flux


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.library()
    for name in ("cdk_mpdata_resident_f32", "cdk_mpdata_resident_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.cdk_mpdata_resident_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.cdk_mpdata_resident_smem_bytes.restype = ctypes.c_longlong
    lib.cdk_max_shared_optin.argtypes = [ctypes.c_int]
    lib.cdk_max_shared_optin.restype = ctypes.c_int
    return lib


def _validate(f, u, w, rho, rhow, adz, flux, n):
    if n < 0:
        raise ValueError(f"n must be >= 0 (got {n})")
    fields = dict(f=f, u=u, w=w, rho=rho, rhow=rhow, adz=adz, flux=flux)
    s, xf, nzm = f.shape
    nx, nz = xf - 6, nzm + 1
    want = dict(f=(s, nx + 6, nzm), u=(s, nx + 5, nzm), w=(s, nx + 4, nz),
                rho=(s, nzm), rhow=(s, nz), adz=(s, nzm), flux=(s, nz))
    for name, t in fields.items():
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, want {want[name]}")
        if t.dtype != f.dtype or t.device != f.device:
            raise TypeError(f"{name}: {t.dtype} on {t.device}; every field "
                            f"must be {f.dtype} on {f.device}")
    if f.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"advect_resident takes float32 or float64, not {f.dtype}")


def advect_resident(f, u, w, rho, rhow, adz, flux, n: int):
    """Run n steps; returns (f, flux).  CUDA tensors launch the kernel
    (never anything else); CPU tensors run advect_resident_plain."""
    _validate(f, u, w, rho, rhow, adz, flux, n)
    if f.device.type == "cpu":
        return advect_resident_plain(f, u, w, rho, rhow, adz, flux, n)
    args = (f, u, w, rho, rhow, adz, flux)
    if not all(t.is_contiguous() for t in args):
        raise ValueError("advect_resident needs contiguous fields")
    s, xf, nzm = f.shape
    nx = xf - 6
    lib = _lib()
    need = lib.cdk_mpdata_resident_smem_bytes(nx, nzm, f.element_size())
    have = lib.cdk_max_shared_optin(f.device.index)
    if need > have:
        raise UnsupportedConfigError(
            f"one slice (nx={nx}, nzm={nzm}, {f.dtype}) needs {need} B of "
            f"shared memory; the card allows {have} B per block")
    f_out = torch.empty_like(f)
    flux_out = torch.empty_like(flux)
    fn = (lib.cdk_mpdata_resident_f32 if f.dtype == torch.float32
          else lib.cdk_mpdata_resident_f64)
    stream = torch.cuda.current_stream(f.device).cuda_stream
    with torch.cuda.device(f.device):
        err = fn(*(t.data_ptr() for t in args), f_out.data_ptr(),
                 flux_out.data_ptr(), s, nx, nzm, n, stream)
    build.check(err, "advect_resident")
    advect_resident.launches += 1
    return f_out, flux_out


advect_resident.launches = 0  # kernel launches in this process


@register(
    "mpdata",
    "pallas_xmajor",
    "resident step loop: one block per CRM slice holds the slice, the "
    "hoisted invariants and the stage temporaries in shared memory and "
    "runs all n steps in one kernel launch",
)
def make_pallas_xmajor(cfg):
    def prepare(data: MpdataData):
        """The step-invariant fields, contiguous (untimed staging)."""
        return tuple(t.contiguous() for t in
                     (data.u, data.w, data.rho, data.rhow, data.adz))

    def step(aux, data: MpdataData):
        return advect_resident(data.f.contiguous(), *aux,
                               data.flux.contiguous(), 1)

    def loop(data: MpdataData, n: int):
        """n steps inside one launch (the timed path)."""
        return advect_resident(data.f.contiguous(), *prepare(data),
                               data.flux.contiguous(), n)

    return {"step": step, "prepare": prepare, "loop": loop}
