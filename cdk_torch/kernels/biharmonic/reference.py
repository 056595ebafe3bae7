"""Trusted PyTorch reference of the biharmonic_wk weak Laplacian.

Semantics match the reference CPU kernel module `biharmonic_wk_scalar_cpu`
(atmosphere/biharmonic_wk_kernel.F90:100-202), which applies the
tensor-HV weak Laplacian once per (element, tracer, level):

  gradient_sphere (:109-134):
      v1(l,j) = rrearth * Σ_i Dvv(i,l) s(i,j)       (x-derivative)
      v2(j,l) = rrearth * Σ_i Dvv(i,l) s(j,i)       (y-derivative)
      ds_a = Dinv(:,:,1,a) v1 + Dinv(:,:,2,a) v2    (contravariant→latlon)
  tensorVisc contraction (:173-180):
      g_a = Σ_b tensorVisc(:,:,a,b) ds_b
  divergence_sphere_wk (:138-160):
      vt_a = Σ_b Dinv(:,:,a,b) g_b
      div(m,n) = -rrearth Σ_j [ spheremp(j,n) vt1(j,n) Dvv(m,j)
                              + spheremp(m,j) vt2(m,j) Dvv(n,j) ]

Every contraction is written out as broadcast multiply-adds over the np=4
GLL axis, in the JAX reference's order, so no matrix-product library call
(and no TF32 path) is involved at any dtype.
"""

from __future__ import annotations

import torch

from cdk_torch.core.registry import register
from cdk_torch.kernels.biharmonic.problem import BiharmonicData


def _bcast(elem_field: torch.Tensor) -> torch.Tensor:
    """Broadcast a per-element (e, i, j[, ...]) field over the (q, k) batch
    axes of qtens (e, q, k, i, j)."""
    return elem_field[:, None, None]


def _contract_l(dvv, s):
    """out[..., l, j] = Σ_i dvv[i, l] s[..., i, j]."""
    n = dvv.shape[0]
    return sum(dvv[i, :, None] * s[..., i, None, :] for i in range(n))


def gradient_sphere(s, dvv, dinv, rrearth):
    """s: (..., i, j) -> ds: tuple of 2 tensors (..., i, j)."""
    v1 = rrearth * _contract_l(dvv, s)
    v2 = rrearth * torch.swapaxes(
        _contract_l(dvv, torch.swapaxes(s, -1, -2)), -1, -2
    )
    ds1 = dinv[..., 0, 0] * v1 + dinv[..., 1, 0] * v2
    ds2 = dinv[..., 0, 1] * v1 + dinv[..., 1, 1] * v2
    return ds1, ds2


def divergence_sphere_wk(v1, v2, dvv, dinv, spheremp, rrearth):
    vt1 = dinv[..., 0, 0] * v1 + dinv[..., 0, 1] * v2
    vt2 = dinv[..., 1, 0] * v1 + dinv[..., 1, 1] * v2
    n = dvv.shape[0]
    x = spheremp * vt1
    y = spheremp * vt2
    # t1[m,n] = Σ_j dvv[m,j] x[j,n];  t2[m,n] = Σ_j dvv[n,j] y[m,j]
    t1 = sum(dvv[:, j, None] * x[..., j, None, :] for j in range(n))
    t2 = sum(dvv[None, :, j] * y[..., :, j, None] for j in range(n))
    return -rrearth * (t1 + t2)


def laplace_sphere_wk(s, dvv, dinv, spheremp, tensorvisc, rrearth):
    ds1, ds2 = gradient_sphere(s, dvv, dinv, rrearth)
    g1 = ds1 * tensorvisc[..., 0, 0] + ds2 * tensorvisc[..., 0, 1]
    g2 = ds1 * tensorvisc[..., 1, 0] + ds2 * tensorvisc[..., 1, 1]
    return divergence_sphere_wk(g1, g2, dvv, dinv, spheremp, rrearth)


def biharmonic_wk_reference(qtens, dvv, dinv, spheremp, tensorvisc,
                            rrearth) -> torch.Tensor:
    """Apply the weak Laplacian to every (e, q, k) slab of qtens."""
    return laplace_sphere_wk(
        qtens, dvv, _bcast(dinv), _bcast(spheremp), _bcast(tensorvisc),
        rrearth,
    )


def rrearth_as(cfg) -> float:
    """cfg.rrearth rounded to the working dtype (the JAX package's
    `np_dtype(rrearth)`), as a Python float that torch applies exactly."""
    return torch.tensor(cfg.rrearth, dtype=cfg.torch_dtype).item()


@register(
    "biharmonic",
    "reference_jnp",
    "trusted PyTorch reference (the JAX package's jnp reference, the analog "
    "of the Fortran CPU form, biharmonic_wk_kernel.F90:186-200)",
)
def make_reference(cfg):
    rr = rrearth_as(cfg)

    def step(data: BiharmonicData) -> torch.Tensor:
        return biharmonic_wk_reference(
            data.qtens, data.dvv, data.dinv, data.spheremp, data.tensorvisc, rr
        )

    return step
