"""Tests of the port that need the card: each hand-written kernel against
its plain PyTorch version on the card, the shared-memory refusal, and the
driver's main path through the kernels.  They skip without a CUDA card.

This file imports no jax, so it runs where the card is (no JAX there):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py -q
"""

import numpy as np
import pytest
import torch

from cdk_torch.core.config import BiharmonicConfig, MpdataConfig, with_overrides
from cdk_torch.core.norms import rel_l1, rel_l2
from cdk_torch.core.platform import resolve_device
from cdk_torch.core.registry import UnsupportedConfigError
from cdk_torch.harness.driver import run_kernel
from cdk_torch.kernels.biharmonic import resident as bres
from cdk_torch.kernels.mpdata import problem as mp
from cdk_torch.kernels.mpdata import resident as mres

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (sm_90)")
    return resolve_device("cuda")


@pytest.mark.parametrize("ncol", [8, 200])
def test_bd8_kernel_matches_plain(cuda, ncol):
    """K1 against its plain version, with a ragged column tile (ncol=8)
    and n=0."""
    rng = np.random.default_rng(3)
    L64 = torch.from_numpy(rng.standard_normal((5, 16, 16)) / 4).to(cuda)
    q64 = torch.from_numpy(rng.standard_normal((5, 16, ncol))).to(cuda)
    for dtype, prec, gate in ((torch.float32, "highest", 2e-5),
                              (torch.float32, "bf16x3", 2e-5),
                              (torch.float64, "highest", 1e-13)):
        L, q = L64.to(dtype), q64.to(dtype)
        for n in (0, 1, 3):
            before = bres.bd8_resident.launches
            out = bres.bd8_resident(L, q, n, prec)
            torch.cuda.synchronize()
            assert bres.bd8_resident.launches == before + 1
            assert rel_l2(out, bres.bd8_resident_plain(L, q, n, prec)) < gate


@pytest.mark.parametrize("geom", [(4, 8, 12), (6, 5, 9)])
def test_resident_kernel_matches_plain(cuda, geom):
    """K2 against its plain version, whole f and flux, n = 0, 1, 4."""
    s, nx, nz = geom
    cfg = with_overrides(MpdataConfig(), nslices=s, nx=nx, nz=nz)
    for dtype, gate_f, gate_flux in ((torch.float32, 1e-6, 1e-5),
                                     (torch.float64, 1e-13, 1e-13)):
        d = mp.init_data(cfg).to(cuda, dtype)
        args = (d.f, d.u, d.w, d.rho, d.rhow, d.adz, d.flux)
        for n in (0, 1, 4):
            before = mres.advect_resident.launches
            f_k, flux_k = mres.advect_resident(*args, n)
            torch.cuda.synchronize()
            assert mres.advect_resident.launches == before + 1
            f_p, flux_p = mres.advect_resident_plain(*args, n)
            assert rel_l1(f_k, f_p) < gate_f
            assert rel_l1(flux_k, flux_p) < gate_flux


def test_resident_kernel_refuses_oversized_slice(cuda):
    cfg = with_overrides(MpdataConfig(), nslices=1, nx=2048, nz=58)
    d = mp.init_data(cfg).to(cuda)
    with pytest.raises(UnsupportedConfigError, match="shared memory"):
        mres.advect_resident(d.f, d.u, d.w, d.rho, d.rhow, d.adz, d.flux, 1)


@pytest.mark.parametrize("kernel,cfg", [
    ("biharmonic", with_overrides(BiharmonicConfig(), nelemd=8, nlev=4,
                                  qsize=2, dtype="float32")),
    ("mpdata", with_overrides(MpdataConfig(), nslices=4, nx=8, nz=12)),
])
def test_driver_runs_through_the_kernels(cuda, kernel, cfg):
    wrapper = {"biharmonic": bres.bd8_resident,
               "mpdata": mres.advect_resident}[kernel]
    before = wrapper.launches
    results = run_kernel(kernel, cfg, iters=2, trials=1, quiet=True,
                         device=cuda)
    assert results and all(r.ok for r in results), results
    assert wrapper.launches > before
