"""Per-element 16x16 weak-Laplacian operator.

For fixed element matrices (Dvv, Dinv, spheremp, tensorVisc),
`laplace_sphere_wk` is a linear map on the 16 GLL points of a level, so

    qtens[e, :, col] = L[e] @ qtens[e, :, col],   L[e] ∈ R^{16×16}

and L[e] is built once by probing the trusted reference with the 16
identity basis fields (exact, since the operator is linear).

The JAX package also groups eight operators into (128, 128)
block-diagonal tiles (`blockdiag_group_operator`) only to fill the TPU's
matrix unit; the Hopper kernel takes the per-element operators as they
are, so that grouping is not ported.
"""

from __future__ import annotations

import torch

from cdk_torch.kernels.biharmonic.reference import laplace_sphere_wk


def build_element_operator(dvv, dinv, spheremp, tensorvisc,
                           rrearth) -> torch.Tensor:
    """L: (nelemd, npts, npts) with out_flat = L[e] @ s_flat (C-order
    points p = i*np + j)."""
    n = dvv.shape[0]
    npts = n * n
    basis = torch.eye(npts, dtype=dvv.dtype, device=dvv.device).reshape(
        npts, n, n)
    # out[e, b] = laplace of basis field b under element e's fields
    out = laplace_sphere_wk(basis[None], dvv, dinv[:, None],
                            spheremp[:, None], tensorvisc[:, None], rrearth)
    # L[e, p_out, p_in] = out[e, p_in] at flattened p_out
    return out.reshape(-1, npts, npts).transpose(1, 2).contiguous()
