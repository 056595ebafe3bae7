"""The benchmark's own plain reference of HOMME's weak Laplacian
(`laplace_sphere_wk`, atmosphere/biharmonic_wk_kernel.F90:100-202), copied
from the port's reference so that no change to the program can move it:

  gradient_sphere:      v1(l,j) = rrearth * sum_i Dvv(i,l) s(i,j)
                        v2(j,l) = rrearth * sum_i Dvv(i,l) s(j,i)
                        ds_a = Dinv(:,:,1,a) v1 + Dinv(:,:,2,a) v2
  tensorVisc:           g_a = sum_b tensorVisc(:,:,a,b) ds_b
  divergence_sphere_wk: vt_a = sum_b Dinv(:,:,a,b) g_b
                        div(m,n) = -rrearth sum_j [spheremp(j,n) vt1(j,n) Dvv(m,j)
                                                 + spheremp(m,j) vt2(m,j) Dvv(n,j)]

`precision` is "float64" (the reference) or "tf32" (the control: float32
with both operands of every Dvv contraction rounded to TF32's 10-bit
mantissa, as float32 matrix products with TF32 allowed would run them; the
pointwise products stay float32).  Family `biharmonic`: one step is one
application, chained over the interval.  It imports nothing of the program.
"""

from __future__ import annotations

import torch

# tracers a block: the reference runs the interval a block of tracers at a
# time (each tracer and level is its own column), so that its float64
# temporaries of a whole ne30 state fit on the card beside the outputs
BLOCK = 8


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 x rounded to the nearest TF32 value (ties away from zero, as
    the card's conversion cvt.rna.tf32.f32), kept in float32."""
    b = x.contiguous().view(torch.int32)
    return ((b + 0x1000) & -0x2000).view(torch.float32)


def cast(raw: dict, precision: str) -> dict:
    """The inputs in the working dtype of `precision`."""
    dtype = torch.float64 if precision == "float64" else torch.float32
    return {k: v.to(dtype) for k, v in raw.items()}


def _op(precision: str):
    """The operand rounding of a contraction."""
    return tf32_round if precision == "tf32" else (lambda x: x)


def _contract_l(dvv, s, r):
    """out[..., l, j] = sum_i dvv[i, l] s[..., i, j]."""
    dvv, s = r(dvv), r(s)
    return sum(dvv[i, :, None] * s[..., i, None, :] for i in range(dvv.shape[0]))


def laplace_sphere_wk(s, dvv, dinv, spheremp, tensorvisc, rrearth, precision):
    """The weak Laplacian of s (..., i, j); the element fields broadcast
    over s's leading axes."""
    r = _op(precision)
    v1 = rrearth * _contract_l(dvv, s, r)
    v2 = rrearth * _contract_l(dvv, s.transpose(-1, -2), r).transpose(-1, -2)
    ds1 = dinv[..., 0, 0] * v1 + dinv[..., 1, 0] * v2
    ds2 = dinv[..., 0, 1] * v1 + dinv[..., 1, 1] * v2
    g1 = ds1 * tensorvisc[..., 0, 0] + ds2 * tensorvisc[..., 0, 1]
    g2 = ds1 * tensorvisc[..., 1, 0] + ds2 * tensorvisc[..., 1, 1]
    vt1 = dinv[..., 0, 0] * g1 + dinv[..., 0, 1] * g2
    vt2 = dinv[..., 1, 0] * g1 + dinv[..., 1, 1] * g2
    x, y = r(spheremp * vt1), r(spheremp * vt2)
    d = r(dvv)
    n = dvv.shape[0]
    t1 = sum(d[:, j, None] * x[..., j, None, :] for j in range(n))
    t2 = sum(d[None, :, j] * y[..., :, j, None] for j in range(n))
    return -rrearth * (t1 + t2)


def element_fields(f: dict):
    """dinv, spheremp, tensorvisc broadcast over qtens's (q, k) axes."""
    return (f["dinv"][:, None, None], f["spheremp"][:, None, None],
            f["tensorvisc"][:, None, None])


def by_blocks(raw: dict, precision: str, chain) -> dict:
    """chain(q block, the other fields cast) over the tracer blocks of
    qtens (nelemd, qsize, ...), in `precision` -> {"q": the whole}."""
    f = cast({k: v for k, v in raw.items() if k != "qtens"}, precision)
    q = raw["qtens"]
    return {"q": torch.cat([
        chain(cast({"q": q[:, b:b + BLOCK]}, precision)["q"], f)
        for b in range(0, q.shape[1], BLOCK)], dim=1)}


def interval(cfg: dict, raw: dict, steps: int, precision: str) -> dict:
    """`steps` chained applications from the interval's qtens."""

    def chain(q, f):
        dinv, sph, tv = element_fields(f)
        for _ in range(steps):
            q = laplace_sphere_wk(q, f["dvv"], dinv, sph, tv, cfg["rrearth"],
                                  precision)
        return q

    return by_blocks(raw, precision, chain)


# the control's precision: the step below the float32 with TF32 off that
# the family's products state
CONTROL = "tf32"
# the gate's norm (check.py), as the port's harness/specs.py gates the family
NORM = "rel_l2"
