"""Tests of the port that need the card: each hand-written kernel against
its plain PyTorch version on the card (K1, K2, and the CKE kernels K3, K11,
K12, K13 at ragged shapes), the shared-memory refusal, and the driver's
main path through the kernels.  They skip without a CUDA card.

This file imports no jax, so it runs where the card is (no JAX there):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py -q
"""

import numpy as np
import pytest
import torch

from cdk_torch.core.config import (
    BiharmonicConfig,
    CkeConfig,
    MpdataConfig,
    with_overrides,
)
from cdk_torch.core.norms import pointwise_check, rel_l1, rel_l2
from cdk_torch.core.platform import resolve_device
from cdk_torch.core.registry import UnsupportedConfigError, variants
from cdk_torch.harness.driver import run_kernel
from cdk_torch.kernels.biharmonic import resident as bres
from cdk_torch.kernels.cke import lanegather as klg
from cdk_torch.kernels.cke import onehot as koh
from cdk_torch.kernels.cke import problem as cp
from cdk_torch.kernels.cke import rows as krows
from cdk_torch.kernels.cke import staged as kst
from cdk_torch.kernels.cke.reference import coef3_of, fsign1
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


def _cke_cases(d, c3):
    """(name, wrapper, kernel call, plain call, bitwise) for the CKE kernels
    on one problem; K13's calls return (E, K) like the others."""
    t = d.tracer * d.cell_mask
    cells, c1, c3a, ntf, advm = (d.adv_cells, d.adv_coefs, d.adv_coefs3,
                                 d.ntf, d.adv_mask)
    e, a = cells.shape
    staged = kst.stage_slots(t, cells, torch.empty((a, e, t.shape[1]),
                                                   dtype=t.dtype,
                                                   device=t.device))
    trans = (cells.T.contiguous(), c1.T.contiguous(), c3a.T.contiguous(),
             t.T.contiguous(), (ntf * advm).T.contiguous(),
             fsign1(ntf).T.contiguous())
    cases = [
        ("K3", krows.cke_rows,
         lambda: krows.cke_rows(cells, c1, c3a, t, ntf, advm, c3),
         lambda: krows.cke_rows_plain(cells, c1, c3a, t, ntf, advm, c3), True),
        ("K11", kst.cke_staged,
         lambda: kst.cke_staged(staged, c1, c3a, ntf, advm, c3),
         lambda: kst.cke_staged_plain(staged, c1, c3a, ntf, advm, c3), True),
        ("K12", koh.cke_onehot,
         lambda: koh.cke_onehot(cells, c1, c3a, t, ntf, advm, c3),
         lambda: koh.cke_onehot_plain(cells, c1, c3a, t, ntf, advm, c3), False),
        ("K13", klg.cke_lanegather,
         lambda: klg.cke_lanegather(*trans, c3).T,
         lambda: klg.cke_lanegather_plain(*trans, c3).T, True),
    ]
    if t.dtype == torch.float32:
        cases.append((
            "K12 bf16", koh.cke_onehot,
            lambda: koh.cke_onehot(cells, c1, c3a, t, ntf, advm, c3, True),
            lambda: koh.cke_onehot_plain(cells, c1, c3a, t, ntf, advm, c3, True),
            False))
    return cases


@pytest.mark.parametrize("geom", [(130, 40, 21, 6), (300, 700, 100, 10)])
@pytest.mark.parametrize("duplicates", [False, True])
def test_cke_kernels_match_plain(cuda, geom, duplicates):
    """K3, K11, K12 (and its bf16 form) and K13 against their plain
    versions at ragged shapes (several of K12's 32-cell blocks), with and
    without duplicate cells per edge; the counter rises by one per call.
    K3, K11 and K13 are bitwise equal to plain at f64."""
    e, c, k, a = geom
    cfg = with_overrides(CkeConfig(), nedges=e, ncells=c, nvertlevels=k,
                         nadv=a)
    host = cp.init_data(cfg)
    if duplicates:
        host.adv_cells[:, 1] = host.adv_cells[:, 0]
    for dtype in (torch.float32, torch.float64):
        d = host.to(cuda, dtype)
        c3 = coef3_of(with_overrides(cfg, dtype=str(dtype)[6:]))
        for name, wrapper, kernel, plain, bitwise in _cke_cases(d, c3):
            before = wrapper.launches
            out = kernel()
            torch.cuda.synchronize()
            assert wrapper.launches == before + 1, name
            ref = plain()
            assert out.shape == (e, k) and float(ref.abs().max()) > 0
            if name == "K12 bf16":
                assert rel_l1(out, ref) < 1e-2, name
            elif dtype == torch.float64:
                assert not bitwise or torch.equal(out, ref), name
                assert pointwise_check(out, ref, cfg.errtol)[0] == 0, name
            else:
                assert rel_l1(out, ref) < 1e-6, name


def test_driver_runs_cke_through_the_kernels(cuda):
    """Every registered cke variant, the experimental ones requested
    explicitly, verifies through the driver; each kernel was launched."""
    cfg = with_overrides(CkeConfig(), nedges=300, ncells=400, nvertlevels=21,
                         nadv=6, dtype="float32")
    wrappers = (krows.cke_rows, kst.cke_staged, koh.cke_onehot,
                klg.cke_lanegather)
    before = [w.launches for w in wrappers]
    results = run_kernel("cke", cfg, variants=list(variants("cke")), iters=2,
                         trials=1, quiet=True, device=cuda)
    assert len(results) == 10 and all(r.ok for r in results), results
    assert all(w.launches > b for w, b in zip(wrappers, before))
