"""Tests of the port that need the card: each hand-written kernel against
its plain PyTorch version on the card (K1, K2, the CKE kernels K3, K11,
K12, K13 at ragged shapes, K3 off 16-byte alignment and K12 on
adversarial connectivity, K14, K19 and the rowchain kernels K15-K18 on
small and odd rings and tori (the tensor-core bf16x3 forms of K14 and the
rowchain step also at ragged m-tiles and across the step's row tiles), K4,
K5, the staged MPDATA kernel behind K6, K7 and K8, K9 and K10, the
masked-global MPDATA kernel behind K20-K25, the window-fed K14 and the
padded rowchain modes K16p-K18p of the decomposed DSS families), K1 and
K15 reading the state's own (e, q, k, i, j) layout bit for bit as they
read its lane copy, the shared-memory refusals, and the driver's and the
dist forms' paths through the kernels.  They skip without a CUDA card.

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
from cdk_torch.core import registry, trace
from cdk_torch.core.registry import UnsupportedConfigError, variants
from cdk_torch.harness.driver import run_kernel
from cdk_torch.kernels.biharmonic import dss2d_resident as dres2
from cdk_torch.kernels.biharmonic import dss2d_rowchain as rc
from cdk_torch.kernels.biharmonic import dss_resident as dres
from cdk_torch.kernels.biharmonic import fused as bfused
from cdk_torch.kernels.biharmonic import problem as bproblem
from cdk_torch.kernels.biharmonic import resident as bres
from cdk_torch.kernels.biharmonic.operator import precompose_operator
from cdk_torch.kernels.cke import lanegather as klg
from cdk_torch.kernels.cke import onehot as koh
from cdk_torch.kernels.cke import problem as cp
from cdk_torch.kernels.cke import rows as krows
from cdk_torch.kernels.cke import staged as kst
from cdk_torch.kernels.cke.reference import coef3_of, fsign1
from cdk_torch.dist import biharmonic as dbi
from cdk_torch.dist import mesh as dmesh
from cdk_torch.dist import mpdata as dmp
from cdk_torch.kernels.mpdata import lanes as mlanes
from cdk_torch.kernels.mpdata import masked as mmask
from cdk_torch.kernels.mpdata import problem as mp
from cdk_torch.kernels.mpdata import resident as mres
from cdk_torch.kernels.mpdata import staged as mstaged

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


@pytest.mark.parametrize("geom", [(4, 8, 12), (6, 5, 9), (3, 7, 100)])
def test_resident_kernel_matches_plain(cuda, geom):
    """K2 against its plain version, n = 0, 1, 4: f bit for bit (every
    operation rounds as the plain version's), the flux within the gates
    (its column sums run in x order); nzm 99 puts 4 levels on a lane."""
    s, nx, nz = geom
    cfg = with_overrides(MpdataConfig(), nslices=s, nx=nx, nz=nz)
    for dtype, gate_flux in ((torch.float32, 1e-5), (torch.float64, 1e-13)):
        d = mp.init_data(cfg).to(cuda, dtype)
        args = (d.f, d.u, d.w, d.rho, d.rhow, d.adz, d.flux)
        for n in (0, 1, 4):
            before = mres.advect_resident.launches
            f_k, flux_k = mres.advect_resident(*args, n)
            torch.cuda.synchronize()
            assert mres.advect_resident.launches == before + 1
            f_p, flux_p = mres.advect_resident_plain(*args, n)
            assert torch.equal(f_k, f_p), (dtype, n)
            assert rel_l1(flux_k, flux_p) < gate_flux, (dtype, n)


@pytest.mark.parametrize("warps", [None, 1, 2, 4, 8])
def test_resident_kernel_split_slices_match_plain(cuda, warps):
    """K2 at the shipped 48 slices, where the sweep splits a slice among
    warps (None: the kernel's own choice), one step and three: f bit for
    bit the plain version's, and f and flux bit for bit one warp a slice."""
    d = mp.init_data(with_overrides(MpdataConfig(), nslices=48, nx=32, nz=58))
    for dtype, gate_flux in ((torch.float32, 1e-5), (torch.float64, 1e-13)):
        args = tuple(t.to(cuda, dtype) for t in (d.f, d.u, d.w, d.rho, d.rhow,
                                                 d.adz, d.flux))
        for n in (1, 3):
            f_k, flux_k = mres.advect_resident(*args, n, warps=warps)
            whole = mres.advect_resident(*args, n, warps=1)
            torch.cuda.synchronize()
            f_p, flux_p = mres.advect_resident_plain(*args, n)
            assert torch.equal(f_k, f_p), (dtype, n)
            assert rel_l1(flux_k, flux_p) < gate_flux, (dtype, n)
            assert torch.equal(f_k, whole[0]) and torch.equal(flux_k, whole[1])


def test_resident_kernel_refuses_oversized_slice(cuda):
    """The hoisted sweep takes a slice of any width (nx 2048, beyond what a
    block's shared memory held) and refuses one of more levels than its
    lanes hold (nzm 300)."""
    cfg = with_overrides(MpdataConfig(), nslices=1, nx=2048, nz=58)
    d = mp.init_data(cfg).to(cuda)
    args = (d.f, d.u, d.w, d.rho, d.rhow, d.adz, d.flux)
    f_k, flux_k = mres.advect_resident(*args, 2)
    f_p, flux_p = mres.advect_resident_plain(*args, 2)
    assert torch.equal(f_k, f_p) and rel_l1(flux_k, flux_p) < 1e-13
    d = mp.init_data(with_overrides(cfg, nx=8, nz=301)).to(cuda)
    with pytest.raises(UnsupportedConfigError, match="levels"):
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


@pytest.mark.parametrize("geom", [(130, 40, 21, 6), (300, 700, 100, 10),
                                  (1000, 3000, 129, 10)])
@pytest.mark.parametrize("duplicates", [False, True])
def test_cke_kernels_match_plain(cuda, geom, duplicates):
    """K3, K11, K12 (and its bf16 form) and K13 against their plain
    versions at ragged shapes (levels past a lane's first 32; at 129 levels
    several edge tiles of K3 and K13, more than one 16-byte level group a
    row, a ragged last group and three of K13's 64-level chunks), with and
    without duplicate cells per edge; the counter rises by one per call.
    K3 and K13 are bitwise equal to plain at f32 and f64, K11 at f64."""
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
                assert name not in ("K3", "K13") or torch.equal(out, ref), name
                assert rel_l1(out, ref) < 1e-6, name


def test_cke_rows_off_alignment_matches_plain(cuda):
    """K3 on a table and edge fields that start 4 bytes past a 16-byte
    boundary (contiguous views one value into their storage) reads and
    writes its levels one by one: bitwise the plain version, f32 and f64."""
    cfg = with_overrides(CkeConfig(), nedges=300, ncells=700, nvertlevels=100,
                         nadv=10)
    host = cp.init_data(cfg)
    for dtype in (torch.float32, torch.float64):
        d = host.to(cuda, dtype)
        c3 = coef3_of(with_overrides(cfg, dtype=str(dtype)[6:]))

        def shifted(x):
            store = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
            store[1:] = x.reshape(-1)
            return store[1:].view(x.shape)

        t, ntf, advm = (shifted(x) for x in (d.tracer * d.cell_mask, d.ntf,
                                              d.adv_mask))
        assert t.data_ptr() % 16 != 0 and t.is_contiguous()
        args = (d.adv_cells, d.adv_coefs, d.adv_coefs3, t, ntf, advm, c3)
        before = krows.cke_rows.launches
        out = krows.cke_rows(*args)
        torch.cuda.synchronize()
        assert krows.cke_rows.launches == before + 1
        assert torch.equal(out, krows.cke_rows_plain(*args))


def _adversarial_cells(e, c, a, rng):
    """Connectivity that tests K12's merge of an edge's slots: edge 0 names
    one cell in every slot; edge 1 names distinct cells, 0 and c-1 among
    them, in no order; edge 2 alternates two cells; edge 3 names one cell
    twice with opposite weights (a merged weight of zero); every edge of the
    second block of eight names distinct cells where c allows it; the rest
    draw from a dozen cells, so duplicates abound."""
    cells = rng.integers(0, min(c, 12), (e, a))
    coef = rng.standard_normal((e, a))
    cells[0] = c // 2
    cells[1] = np.roll(np.concatenate([[c - 1, 0], rng.permutation(
        np.arange(1, c - 1))[:a - 2]]), 3)
    cells[2] = np.where(np.arange(a) % 2 == 0, c - 1, 0)
    cells[3, :2] = 7 % c
    coef[3, 1] = -coef[3, 0]
    block = np.arange(8, min(e, 16))
    if c >= len(block) * a:
        cells[block] = rng.permutation(c)[:len(block) * a].reshape(-1, a)
    return cells, coef


@pytest.mark.parametrize("geom", [(13, 37, 133, 10), (21, 301, 57, 10),
                                  (9, 50, 100, 40)])
def test_onehot_kernel_on_adversarial_connectivity(cuda, geom):
    """K12 (exact f32 and f64, and the bf16 form) against its plain version
    at the gates test_cke_kernels_match_plain uses, on connectivity built to
    break the merge of an edge's slots (_adversarial_cells), at ragged
    nedges, ncells and nvert (no multiple of the 8-edge block, the 32 lanes
    or a lane's 128 levels) and at nadv above the warp's 32 lanes."""
    e, c, k, a = geom
    cfg = with_overrides(CkeConfig(), nedges=e, ncells=c, nvertlevels=k, nadv=a)
    host = cp.init_data(cfg)
    cells, coef = _adversarial_cells(e, c, a, np.random.default_rng(e))
    host.adv_cells = torch.from_numpy(cells).to(torch.int32)
    host.adv_coefs = torch.from_numpy(coef).to(host.adv_coefs.dtype)
    host.adv_coefs3 = torch.from_numpy(np.flip(coef, 1).copy()).to(host.adv_coefs3.dtype)
    for dtype in (torch.float32, torch.float64):
        d = host.to(cuda, dtype)
        c3 = coef3_of(with_overrides(cfg, dtype=str(dtype)[6:]))
        t = d.tracer * d.cell_mask
        args = (d.adv_cells, d.adv_coefs, d.adv_coefs3, t, d.ntf, d.adv_mask, c3)
        for bf16 in (False, True) if dtype == torch.float32 else (False,):
            before = koh.cke_onehot.launches
            out = koh.cke_onehot(*args, bf16)
            torch.cuda.synchronize()
            assert koh.cke_onehot.launches == before + 1
            ref = koh.cke_onehot_plain(*args, bf16)
            assert out.shape == (e, k) and float(ref.abs().max()) > 0
            assert bool(torch.isfinite(out).all())
            if bf16:
                assert rel_l1(out, ref) < 1e-2
            elif dtype == torch.float64:
                assert pointwise_check(out, ref, cfg.errtol)[0] == 0
            else:
                assert rel_l1(out, ref) < 1e-6


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


def _dss_operands(e, ncol, seed):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.standard_normal((e, 16, 16)) / 4),
            torch.from_numpy(rng.uniform(0.25, 0.5, (e, 16))),
            torch.from_numpy(rng.standard_normal((e, 16, ncol))))


# (dtype, precision, gate against the plain version): the bf16x3 forms of
# K14 and the rowchain step run on the tensor cores, which sum a product's
# 16 terms in their own order, so they are held to the gate, not bit for bit
DSS_FORMS = [(torch.float64, "highest", 1e-13), (torch.float32, "highest", 1e-6),
             (torch.float32, "bf16x3", 5e-5)]


@pytest.mark.parametrize("e,ncol", [(5, 8), (16, 40), (40, 33)])
def test_dss_resident_kernel_matches_plain(cuda, e, ncol):
    """K14, all four forms, against its plain version: rings smaller than
    the window (the same element appears in it more than once), an odd
    ring, several windows, a ragged column tile, and 0 to 15 steps."""
    L64, w64, q64 = _dss_operands(e, ncol, e)
    for dtype, prec, gate in DSS_FORMS:
        L, w, q = (x.to(cuda, dtype) for x in (L64, w64, q64))
        for L2 in (None, precompose_operator(L)):
            for n in (0, 1, 2, 4, dres.MAX_STEPS):
                before = dres.dss_resident.launches
                out = dres.dss_resident(L, w, q, n, prec, L2)
                torch.cuda.synchronize()
                assert dres.dss_resident.launches == before + 1
                ref = dres.dss_resident_plain(L, w, q, n, prec, L2)
                assert rel_l2(out, ref) < gate, (dtype, prec, L2 is None, n)


def _with_lo_parts(x):
    """x (f32) with every value's bf16 lo part nonzero: a value that bf16
    holds exactly is nudged by 2^-12 of itself."""
    exact = x == x.to(torch.bfloat16).float()
    x = torch.where(exact, x * (1 + 2.0 ** -12), x)
    assert bool((x != x.to(torch.bfloat16).float()).all())
    return x


@pytest.mark.parametrize("ncol", [8, 16, 17, 33])
def test_dss_resident_tensor_core_forms_match_plain(cuda, ncol):
    """K14's bf16x3 forms (ring and precomposed) run on the tensor cores:
    against the plain version at the bf16x3 gate, not bit for bit (the
    tensor core sums a product's 16 terms in its own order), on an operator
    and a field whose bf16 lo parts are nonzero everywhere, at ragged
    16-column m-tiles (8, 17, 33) and every depth 0 to MAX_STEPS."""
    L64, w64, q64 = _dss_operands(40, ncol, ncol)
    L, q = (_with_lo_parts(x.to(cuda, torch.float32)) for x in (L64, q64))
    w = w64.to(cuda, torch.float32)
    for L2 in (None, precompose_operator(L)):
        for n in range(dres.MAX_STEPS + 1):
            out = dres.dss_resident(L, w, q, n, "bf16x3", L2)
            ref = dres.dss_resident_plain(L, w, q, n, "bf16x3", L2)
            assert float(ref.abs().max()) > 0
            assert rel_l2(out, ref) < 5e-5, (L2 is None, n)


@pytest.mark.parametrize("exy,ncol", [((4, 4), 40), ((4, 3), 8), ((16, 10), 33),
                                      ((2, 2), 8), ((5, 1), 8), ((30, 21), 33),
                                      ((3, 25), 8), ((75, 72), 8), ((6, 22), 40),
                                      ((5, 12), 33), ((5, 13), 40), ((4, 9), 33),
                                      ((75, 72), 40)])
def test_dss2d_resident_kernel_matches_plain(cuda, exy, ncol):
    """K19, both forms, against its plain version: tori smaller than the
    window (ex = 2: the up and down rows are one row; a row may appear in
    the window more than once), ey = 1 (the j neighbours are the element
    itself), rows that just fit 2k+1 of them in the 64-element whole-row
    window and rows one element longer, which take the 8 x 8 window (ey =
    21 / 22 at 1 step, 12 / 13 at 2, 9 / 10 at 3), ey = 25 and the
    production 72 at every depth, ragged 32- and 16-column tiles (ncol 8,
    33, 40), and 0 to max_steps(ey) steps."""
    ex, ey = exy
    L64, w64, q64 = _dss_operands(ex * ey, ncol, ex * 100 + ey)
    kmax = dres2.max_steps(ey)
    depths = range(kmax + 1) if kmax <= 3 else sorted({0, 1, 2, 3, kmax})
    for dtype, prec, gate in DSS_FORMS:
        L, w, q = (x.to(cuda, dtype) for x in (L64, w64, q64))
        for n in depths:
            before = dres2.dss2d_resident.launches
            out = dres2.dss2d_resident(L, w, q, ex, ey, n, prec)
            torch.cuda.synchronize()
            assert dres2.dss2d_resident.launches == before + 1
            ref = dres2.dss2d_resident_plain(L, w, q, ex, ey, n, prec)
            assert rel_l2(out, ref) < gate, (dtype, prec, n)


@pytest.mark.parametrize("exy,ncol", [((4, 4), 40), ((4, 3), 8), ((16, 10), 33),
                                      ((2, 2), 8), ((3, 9), 40), ((3, 1), 33),
                                      ((2, 72), 33)])
def test_rowchain_kernels_match_plain(cuda, exy, ncol):
    """The bridges (K15, K17) and the step at depths 1-5 (K16, K18)
    against their plain versions on small tori (ex = 2: the up and down
    rows are one row; ey = 9: a row spans two blocks; ey = 1: the j
    neighbours are the element itself), the production row of 72 (whole
    tiles of every mode), a ragged column tile (ncol 33), and each depth-k
    step bitwise against k depth-1 launches."""
    ex, ey = exy
    L64, w64, q64 = _dss_operands(ex * ey, ncol, ex * 100 + ey)
    for dtype, prec, gate in DSS_FORMS:
        L, w, q = (x.to(cuda, dtype) for x in (L64, w64, q64))
        before = (rc.rowchain_bridge_in.launches, rc.rowchain_bridge_out.launches)
        t = rc.rowchain_bridge_in(L, q, ex, ey, prec)
        assert rel_l2(t, rc.rowchain_bridge_in_plain(L, q, ex, ey, prec)) < gate
        out = rc.rowchain_bridge_out(L, w, t, ex, ey, prec)
        assert rel_l2(out, rc.rowchain_bridge_out_plain(L, w, t, ex, ey, prec)) < gate
        assert (rc.rowchain_bridge_in.launches,
                rc.rowchain_bridge_out.launches) == (before[0] + 1, before[1] + 1)
        for sq in (False, True):
            F = precompose_operator(L) if sq else L
            one = t
            for k in range(1, 6):
                before = rc.rowchain_step.launches
                deep = rc.rowchain_step(F, w, t, ex, ey, k, prec, sq)
                torch.cuda.synchronize()
                assert rc.rowchain_step.launches == before + 1
                ref = rc.rowchain_step_plain(F, w, t, ex, ey, k, prec, sq)
                assert rel_l2(deep, ref) < gate, (dtype, prec, sq, k)
                one = rc.rowchain_step(F, w, one, ex, ey, 1, prec, sq)
                assert torch.equal(deep, one), (dtype, prec, sq, k)


def test_rowchain_refuses_misaligned_operators(cuda):
    """The rowchain kernel copies each element's operator and inverse mass
    in 16-byte pieces: an operator or w that starts off 16-byte alignment
    is refused before the launch, in every mode, and no launch is
    counted."""
    ex, ey = 3, 4
    L64, w64, q64 = _dss_operands(ex * ey, 8, 1)
    L, w, q = (x.to(cuda, torch.float32) for x in (L64, w64, q64))
    Lx = torch.empty(L.numel() + 1, device=cuda)[1:].view_as(L).copy_(L)
    wx = torch.empty(w.numel() + 1, device=cuda)[1:].view_as(w).copy_(w)
    counters = (rc.rowchain_bridge_in, rc.rowchain_step, rc.rowchain_bridge_out)
    before = [f.launches for f in counters]
    with pytest.raises(ValueError, match="16-byte"):
        rc.rowchain_bridge_in(Lx, q, ex, ey)
    with pytest.raises(ValueError, match="16-byte"):
        rc.rowchain_step(L, wx, q, ex, ey)
    with pytest.raises(ValueError, match="16-byte"):
        rc.rowchain_bridge_out(Lx, w, q, ex, ey)
    assert [f.launches for f in counters] == before


@pytest.mark.parametrize("ey", [rc.STEP_ELEMS - 1, rc.STEP_ELEMS + 1,
                                2 * rc.STEP_ELEMS + 3])
def test_rowchain_step_straddles_its_tiles(cuda, ey):
    """The step's tiles hold STEP_ELEMS elements of one row and a halo
    element on each side: rows one element short of a tile, one over, and
    two tiles and three, on a 3-row torus, all four forms (bf16x3 on the
    tensor cores, held to the gate; exact) against the plain version at
    depths 1 and 3, each depth-3 step bitwise three depth-1 launches."""
    ex = 3
    L64, w64, t64 = _dss_operands(ex * ey, 40, ey)
    for dtype, prec, gate in DSS_FORMS:
        L, w, t = (x.to(cuda, dtype) for x in (L64, w64, t64))
        for sq in (False, True):
            F = precompose_operator(L) if sq else L
            one = t
            for _ in range(3):
                one = rc.rowchain_step(F, w, one, ex, ey, 1, prec, sq)
            for k, got in ((1, rc.rowchain_step(F, w, t, ex, ey, 1, prec, sq)),
                           (3, rc.rowchain_step(F, w, t, ex, ey, 3, prec, sq))):
                ref = rc.rowchain_step_plain(F, w, t, ex, ey, k, prec, sq)
                assert rel_l2(got, ref) < gate, (dtype, prec, sq, k)
            assert torch.equal(got, one), (dtype, prec, sq)


@pytest.mark.parametrize("kernel,nelemd", [("biharmonic_dss", 16),
                                           ("biharmonic_dss2d", 12)])
def test_driver_runs_dss_families_through_the_kernels(cuda, kernel, nelemd):
    """Every variant of both families verifies through the driver at f32;
    K14, or K19 and the rowchain's bridges and step, were launched."""
    cfg = with_overrides(BiharmonicConfig(), nelemd=nelemd, nlev=4, qsize=2,
                         dtype="float32")
    wrappers = ((dres.dss_resident,) if kernel == "biharmonic_dss" else
                (dres2.dss2d_resident, rc.rowchain_bridge_in, rc.rowchain_step,
                 rc.rowchain_bridge_out))
    before = [w.launches for w in wrappers]
    results = run_kernel(kernel, cfg, iters=2, trials=1, quiet=True,
                         device=cuda)
    assert len(results) == len(variants(kernel)) and all(r.ok for r in results), results
    assert all(w.launches > b for w, b in zip(wrappers, before))


@pytest.mark.parametrize("family,name,wrapper", [
    ("biharmonic_dss2d", "fused_operator_rowchain_sq_x3", rc.rowchain_bridge_in),
    ("biharmonic", "fused_operator_bd8_resident", bres.bd8_resident)])
def test_homme_loop_reuses_its_set_up_on_the_card(cuda, family, name, wrapper):
    """The benchmark's two HOMME loops on the card: two calls reuse the
    set-up built when the variant was materialised, build no operator,
    launch their kernels and give bit for bit the output of the variant
    materialised anew on the same data."""
    cfg = with_overrides(BiharmonicConfig(), nelemd=16, nlev=4, qsize=10,
                         dtype="float32", rrearth=0.1)
    data = bproblem.init_data(cfg).to(cuda)
    variant = registry.get(family, name)
    _, _, loop = registry._materialize(variant, cfg, data)
    before, launches = trace.counts(), wrapper.launches
    first = loop(data, 6)
    second = loop(data, 6)
    torch.cuda.synchronize()
    after = trace.counts()
    assert after["operator_builds"] == before["operator_builds"]
    assert after["prepare_reuses"] == before.get("prepare_reuses", 0) + 2
    assert wrapper.launches == launches + 2
    assert first.abs().min() > 0
    assert torch.equal(second, first)
    _, _, fresh = registry._materialize(variant, cfg, data)
    assert torch.equal(fresh(data, 6), first)


@pytest.mark.parametrize("ncol", [8, 200])
def test_fused_kernel_matches_plain(cuda, ncol):
    """K4, both precisions, against its plain version (ragged column tile
    at ncol=8); the elementwise stages round as the plain version's tensor
    ops, so only the 4-term sums may differ in order."""
    rng = np.random.default_rng(4)
    dvv = torch.from_numpy(rng.standard_normal((4, 4))).float().to(cuda)
    elem = torch.from_numpy(rng.uniform(0.5, 1.5, (5, 9, 16))).float().to(cuda)
    q = torch.from_numpy(rng.standard_normal((5, 16, ncol))).float().to(cuda)
    for prec in bfused.PRECISIONS:
        before = bfused.fused_laplace.launches
        out = bfused.fused_laplace(dvv, elem, q, 0.5, prec)
        torch.cuda.synchronize()
        assert bfused.fused_laplace.launches == before + 1
        ref = bfused.fused_laplace_plain(dvv, elem, q, 0.5, prec)
        assert float(ref.abs().max()) > 0
        assert rel_l2(out, ref) < 1e-6, prec


def test_operator_apply_kernel_counts_apart(cuda):
    """K5 (the operator kernel at n = 1, exact) equals the exact batched
    product and counts in its own counter, not K1's."""
    rng = np.random.default_rng(5)
    for dtype, gate in ((torch.float32, 2e-5), (torch.float64, 1e-13)):
        L = torch.from_numpy(rng.standard_normal((5, 16, 16)) / 4).to(cuda, dtype)
        q = torch.from_numpy(rng.standard_normal((5, 16, 40))).to(cuda, dtype)
        k1, k5 = bres.bd8_resident.launches, bres.apply_operator_pallas.launches
        out = bres.apply_operator_pallas(L, q)
        torch.cuda.synchronize()
        assert bres.apply_operator_pallas.launches == k5 + 1
        assert bres.bd8_resident.launches == k1
        assert rel_l2(out, torch.bmm(L, q)) < gate


STAGED = (mstaged.advect_fused, mstaged.advect_packed,
          mstaged.advect_staged_resident)


@pytest.mark.parametrize("geom", [(4, 8, 12), (5, 5, 9)])
def test_staged_kernel_matches_plain(cuda, geom):
    """The staged kernel (K6, K7, K8 wrappers) against the staged reference
    stepped n times, n = 0, 1, 4, at f32, f64 and bf16 (an odd slice count:
    the port has no even-slice guard); each wrapper counts its own launch."""
    s, nx, nz = geom
    cfg = with_overrides(MpdataConfig(), nslices=s, nx=nx, nz=nz)
    for dtype, gate_f, gate_flux in ((torch.float32, 1e-6, 1e-5),
                                     (torch.float64, 1e-13, 1e-13),
                                     (torch.bfloat16, 1e-2, 1e-1)):
        d = mp.init_data(cfg).to(cuda, dtype)
        args = (d.f, d.u, d.w, d.rho, d.rhow, d.adz, d.flux)
        for wrapper in STAGED:
            for n in (0, 1, 4):
                before = [w.launches for w in STAGED]
                f_k, flux_k = wrapper(*args, n)
                torch.cuda.synchronize()
                assert [w.launches for w in STAGED] == [
                    b + (w is wrapper) for w, b in zip(STAGED, before)]
                f_p, flux_p = mstaged.advect_staged_plain(*args, n)
                assert f_k.dtype == dtype
                assert rel_l1(f_k, f_p) < gate_f, (wrapper.__name__, dtype, n)
                assert rel_l1(flux_k, flux_p) < gate_flux, (wrapper.__name__, dtype, n)


@pytest.mark.parametrize("geom", [(4, 8, 12), (5, 5, 9), (6, 32, 58),
                                  (3, 7, 100), (2, 5, 200)])
def test_staged_kernel_steps_in_one_launch_equal_one_step_launches(cuda, geom):
    """K8 at n steps is bit for bit n one-step K6 launches, at f32, f64 and
    bf16, at the small geometries, the shipped slice (nzm 57, nx 32) and
    nzm 99 and 199 (a lane holds 4 and 8 levels); at f32 and f64 the f of
    both is bit for bit the staged reference's (every operation rounds as
    the plain version's) and the flux within the gates."""
    s, nx, nz = geom
    cfg = with_overrides(MpdataConfig(), nslices=s, nx=nx, nz=nz)
    for dtype, gate_flux in ((torch.float32, 1e-5), (torch.float64, 1e-13),
                             (torch.bfloat16, None)):
        d = mp.init_data(cfg).to(cuda, dtype)
        args = (d.f, d.u, d.w, d.rho, d.rhow, d.adz, d.flux)
        f, flux = d.f, d.flux
        for n in range(1, 4):
            f, flux = mstaged.advect_fused(f, *args[1:6], flux, 1)
            deep = mstaged.advect_staged_resident(*args, n)
            torch.cuda.synchronize()
            assert torch.equal(deep[0], f) and torch.equal(deep[1], flux), (dtype, n)
            if gate_flux is not None:
                f_p, flux_p = mstaged.advect_staged_plain(*args, n)
                assert torch.equal(f, f_p), (dtype, n)
                assert rel_l1(flux, flux_p) < gate_flux, (dtype, n)


def test_staged_kernel_split_slices_equal_whole_ones(cuda):
    """Below 1024 slices the staged kernel splits a slice's x range among
    warps (the shipped 48 slices: 8 warps a slice); the same slices in a
    launch of 1024, one warp each, come out bit for bit the same, f and
    flux, at f32, f64 and bf16, one step and three."""
    cfg = with_overrides(MpdataConfig(), nslices=1024, nx=32, nz=58)
    host = mp.init_data(cfg)
    for dtype in (torch.float32, torch.float64, torch.bfloat16):
        d = host.to(cuda, dtype)
        args = (d.f, d.u, d.w, d.rho, d.rhow, d.adz, d.flux)
        few = tuple(a[:48].contiguous() for a in args)
        for n in (1, 3):
            whole = mstaged.advect_staged_resident(*args, n)
            split = mstaged.advect_staged_resident(*few, n)
            torch.cuda.synchronize()
            assert torch.equal(split[0], whole[0][:48]), (dtype, n)
            assert torch.equal(split[1], whole[1][:48]), (dtype, n)


def test_hoisted_wrapper_counts_apart(cuda):
    """K9 runs K2's kernel and counts in its own counter."""
    d = mp.init_data(with_overrides(MpdataConfig(), nslices=4, nx=8,
                                    nz=12)).to(cuda)
    args = (d.f, d.u, d.w, d.rho, d.rhow, d.adz, d.flux)
    k2, k9 = mres.advect_resident.launches, mres.advect_hoisted_resident.launches
    got = mres.advect_hoisted_resident(*args, 3)
    torch.cuda.synchronize()
    assert (mres.advect_resident.launches,
            mres.advect_hoisted_resident.launches) == (k2, k9 + 1)
    want = mres.advect_resident(*args, 3)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_staged_kernel_refuses_oversized_slice(cuda):
    """The staged kernel sweeps a slice along x, so a slice of any width
    runs: nx 2048, which no block's shared memory held, matches its plain
    version (f bit for bit).  It refuses a slice of more levels than its
    lanes hold (nzm 300)."""
    cfg = with_overrides(MpdataConfig(), nslices=1, nx=2048, nz=58)
    d = mp.init_data(cfg).to(cuda)
    args = (d.f, d.u, d.w, d.rho, d.rhow, d.adz, d.flux)
    f_k, flux_k = mstaged.advect_staged_resident(*args, 2)
    f_p, flux_p = mstaged.advect_staged_plain(*args, 2)
    assert torch.equal(f_k, f_p) and rel_l1(flux_k, flux_p) < 1e-13
    d = mp.init_data(with_overrides(cfg, nx=8, nz=301)).to(cuda)
    with pytest.raises(UnsupportedConfigError, match="levels"):
        mstaged.advect_staged_resident(d.f, d.u, d.w, d.rho, d.rhow, d.adz,
                                       d.flux, 1)


@pytest.mark.parametrize("geom", [(1, 8, 12), (4, 8, 12), (37, 5, 9), (48, 32, 58),
                                  (64, 32, 58), (3, 7, 100), (2, 5, 200)])
def test_lanes_kernel_matches_plain(cuda, geom):
    """K10 against its plain version in the (x, z, s) layout, f32 and f64,
    one step and three chained, one launch a call: f bit for bit (every
    operation rounds as the plain version's), the flux within the gates
    (its column sums run in x order); one slice, slice counts off and on
    the block's 8, the shipped 48 (split among warps) and nzm 99 and 199
    (4 and 8 levels a lane)."""
    s, nx, nz = geom
    cfg = with_overrides(MpdataConfig(), nslices=s, nx=nx, nz=nz)
    for dtype, gate_flux in ((torch.float32, 1e-5), (torch.float64, 1e-13)):
        d = mp.init_data(cfg).to(cuda, dtype)
        xzs = [mlanes.to_xzs(getattr(d, n)) for n in mlanes.FIELDS]
        k, p = xzs[0], xzs[0]
        fk, fp = xzs[6], xzs[6]
        for n in range(3):
            before = mlanes.advect_lanes.launches
            k, fk = mlanes.advect_lanes(k, *xzs[1:6], fk)
            torch.cuda.synchronize()
            assert mlanes.advect_lanes.launches == before + 1
            p, fp = mlanes.advect_lanes_plain(p, *xzs[1:6], fp)
            assert torch.equal(k, p), (dtype, n)
            assert rel_l1(fk, fp) < gate_flux, (dtype, n)


@pytest.mark.parametrize("geom", [(5, 8, 12), (48, 32, 58), (1030, 32, 58)])
def test_lanes_kernel_equals_the_staged_kernel(cuda, geom):
    """K10 on the (x, z, s) layout and K6 on (s, x, z) run one stage chain:
    f and flux bit for bit the same through to_xzs, f32 and f64 (48
    slices split among warps in both)."""
    s, nx, nz = geom
    cfg = with_overrides(MpdataConfig(), nslices=s, nx=nx, nz=nz)
    for dtype in (torch.float32, torch.float64):
        d = mp.init_data(cfg).to(cuda, dtype)
        args = (d.f, d.u, d.w, d.rho, d.rhow, d.adz, d.flux)
        f6, flux6 = mstaged.advect_fused(*args, 1)
        f10, flux10 = mlanes.advect_lanes(*(mlanes.to_xzs(t) for t in args))
        torch.cuda.synchronize()
        assert torch.equal(f10, mlanes.to_xzs(f6)), dtype
        assert torch.equal(flux10, mlanes.to_xzs(flux6)), dtype


@pytest.mark.parametrize("warps", [None, 1, 2, 4, 8])
def test_lanes_kernel_split_slices_match_plain(cuda, warps):
    """K10 at the shipped 48 slices, a slice split among warps (None: the
    kernel's own choice; 8 warps a slice leave one slice a block): f bit
    for bit the plain version's, and f and flux bit for bit one warp a
    slice."""
    d = mp.init_data(with_overrides(MpdataConfig(), nslices=48, nx=32, nz=58))
    for dtype, gate_flux in ((torch.float32, 1e-5), (torch.float64, 1e-13)):
        xzs = [mlanes.to_xzs(getattr(d, n)).to(cuda, dtype) for n in mlanes.FIELDS]
        f_k, flux_k = mlanes.advect_lanes(*xzs, warps=warps)
        whole = mlanes.advect_lanes(*xzs, warps=1)
        torch.cuda.synchronize()
        f_p, flux_p = mlanes.advect_lanes_plain(*xzs)
        assert torch.equal(f_k, f_p), dtype
        assert rel_l1(flux_k, flux_p) < gate_flux, dtype
        assert torch.equal(f_k, whole[0]) and torch.equal(flux_k, whole[1])


def test_lanes_kernel_refuses_oversized_slice(cuda):
    """K10 refuses a slice of more levels than the sweep's lanes hold (nzm
    300), as the other MPDATA step kernels do."""
    d = mp.init_data(with_overrides(MpdataConfig(), nslices=2, nx=8, nz=301)).to(cuda)
    xzs = [mlanes.to_xzs(getattr(d, n)) for n in mlanes.FIELDS]
    with pytest.raises(UnsupportedConfigError, match="levels"):
        mlanes.advect_lanes(*xzs)


@pytest.mark.parametrize("kernel,cfg,names,wrappers", [
    ("biharmonic", with_overrides(BiharmonicConfig(), nelemd=8, nlev=4,
                                  qsize=2, dtype="float32"),
     None, (bfused.fused_laplace, bres.apply_operator_pallas)),
    ("mpdata", with_overrides(MpdataConfig(), nslices=4, nx=8, nz=12,
                              dtype="float32"),
     ["reference_jnp", "pallas_fused", "pallas_packed", "pallas_packed_bf16",
      "pallas_resident", "pallas_lanes", "pallas_hoisted"],
     STAGED + (mlanes.advect_lanes, mres.advect_hoisted_resident)),
])
def test_driver_runs_the_new_variants_through_their_kernels(cuda, kernel, cfg,
                                                            names, wrappers):
    """The variants ported with K4-K10 verify through the driver on the
    card (the experimental ones requested), and each kernel was launched."""
    before = [w.launches for w in wrappers]
    results = run_kernel(kernel, cfg, variants=names, iters=2, trials=1,
                         quiet=True, device=cuda)
    assert results and all(r.ok for r in results), results
    assert all(w.launches > b for w, b in zip(wrappers, before))


MASKED = (mmask.masked_step_pallas, mmask.masked_step_pallas_packed,
          mmask.masked_step_xmajor, mmask.masked_step_xmajor_split,
          mmask.masked_kloop_xmajor, mmask.masked_kloop_xmajor_split)


def _masked_window(d, lo, X):
    """Columns [lo, lo + X) of the collocated fields, zero-extended past
    the global grid, and gi0 = lo - 2."""
    f, u, w = dmp.to_collocated(d)
    pad = max(0, -lo), max(0, lo + X - f.shape[1])
    cut = [torch.nn.functional.pad(a, (0, 0) + pad)[:, lo + pad[0]:lo + pad[0] + X]
           .contiguous() for a in (f, u, w)]
    return (*cut, (d.rho, d.rhow, d.adz), lo - 2)


@pytest.mark.parametrize("geom", [(4, 8, 12), (5, 9, 9), (3, 40, 58)])
def test_masked_kernels_match_plain(cuda, geom):
    """K20-K25 against their plain versions on windows at the global edges
    and inside the domain, f32 and f64: f bitwise (every operation rounds
    as the plain version's), the flux partial within the gates (its column
    sums run in another order); K23 = K22 and K25 = K24 bitwise on the
    concatenated window; each wrapper counts its own launch."""
    s, nx, nz = geom
    cfg = with_overrides(MpdataConfig(), nslices=s, nx=nx, nz=nz)
    for dtype, gate in ((torch.float32, 1e-5), (torch.float64, 1e-13)):
        d = mp.init_data(cfg).to(cuda, dtype)
        for kstep in (1, 2):
            h = 3 * kstep
            for lo in (-h, 4 - h):          # the left edge; inside
                f, u, w, aux, gi0 = _masked_window(d, lo, nx + 6 + 2 * h - 4)
                X = f.shape[1]
                kw = dict(nx=nx, owned_lo=h, owned_hi=X - h)
                strips = (f[:, :h].contiguous(), f[:, X - h:].contiguous())
                own = f[:, h:X - h].contiguous()
                calls = [
                    (mmask.masked_step_pallas, lambda: mmask.masked_step_pallas(
                        f, u, w, *aux, gi0, **kw), 1),
                    (mmask.masked_step_pallas_packed,
                     lambda: mmask.masked_step_pallas_packed(
                         f, u, w, *aux, gi0, nzm=nz - 1, **kw), 1),
                    (mmask.masked_step_xmajor, lambda: mmask.masked_step_xmajor(
                        f, u, w, *aux, gi0, nzm=nz - 1, **kw), 1),
                    (mmask.masked_kloop_xmajor, lambda: mmask.masked_kloop_xmajor(
                        f, u, w, *aux, gi0, nzm=nz - 1, nsteps=kstep, **kw), kstep)]
                for wrapper, call, n in calls:
                    before = [x.launches for x in MASKED]
                    f_k, flux_k = call()
                    torch.cuda.synchronize()
                    assert [x.launches for x in MASKED] == [
                        b + (x is wrapper) for x, b in zip(MASKED, before)]
                    f_p, flux_p = (mmask.masked_step_plain(f, u, w, *aux, gi0, nx, h, X - h)
                                   if n == 1 and wrapper is not mmask.masked_kloop_xmajor
                                   else mmask.masked_kloop_plain(f, u, w, *aux, gi0, nx,
                                                                 h, X - h, n))
                    assert torch.equal(f_k, f_p), (wrapper.__name__, dtype, lo)
                    assert rel_l1(flux_k, flux_p) < gate, (wrapper.__name__, dtype)
                    if wrapper is mmask.masked_step_xmajor:
                        sp = mmask.masked_step_xmajor_split(
                            own, *strips, u, w, *aux, gi0, nx=nx, nzm=nz - 1, halo=h)
                    elif wrapper is mmask.masked_kloop_xmajor:
                        sp = mmask.masked_kloop_xmajor_split(
                            own, *strips, u, w, *aux, gi0, nx=nx, nzm=nz - 1,
                            halo=h, nsteps=kstep)
                    else:
                        continue
                    torch.cuda.synchronize()
                    assert torch.equal(sp[0], f_k[:, h:X - h]) and torch.equal(sp[1], flux_k)


def test_masked_kernel_refuses_oversized_window(cuda):
    """The masked sweep takes a window of any width: 200 columns x 57 levels
    at f64, which no block's shared memory held (the old kernel refused
    past 62), matches its plain version, f bit for bit, one step and two
    hoisted ones; it refuses a window of more levels than its lanes hold
    (nzm 300)."""
    d = mp.init_data(with_overrides(MpdataConfig(), nslices=2, nx=194,
                                    nz=58)).to(cuda, torch.float64)
    f, u, w, aux, gi0 = _masked_window(d, -3, 200)
    kw = dict(owned_lo=6, owned_hi=194)
    f_k, flux_k = mmask.masked_step_pallas(f, u, w, *aux, gi0, nx=194, **kw)
    f_p, flux_p = mmask.masked_step_plain(f, u, w, *aux, gi0, 194, 6, 194)
    assert torch.equal(f_k, f_p) and rel_l1(flux_k, flux_p) < 1e-13
    f_k, flux_k = mmask.masked_kloop_xmajor(f, u, w, *aux, gi0, nx=194, nzm=57,
                                            nsteps=2, **kw)
    f_p, flux_p = mmask.masked_kloop_plain(f, u, w, *aux, gi0, 194, 6, 194, 2)
    assert torch.equal(f_k, f_p) and rel_l1(flux_k, flux_p) < 1e-13
    d = mp.init_data(with_overrides(MpdataConfig(), nslices=1, nx=8,
                                    nz=301)).to(cuda, torch.float32)
    f, u, w, aux, gi0 = _masked_window(d, -3, 20)
    with pytest.raises(UnsupportedConfigError, match="levels"):
        mmask.masked_step_pallas(f, u, w, *aux, gi0, nx=8, owned_lo=3,
                                 owned_hi=17)


@pytest.mark.parametrize("warps", [None, 1, 2, 4, 8])
def test_masked_kernel_split_slices_match_plain(cuda, warps):
    """The masked sweep at the shipped 48 slices on the one-shard window,
    a slice split among warps (None: the kernel's own choice): K22 and K23
    one step, K24 and K25 three, f bit for bit the plain version's and f and
    flux bit for bit one warp a slice."""
    cfg = with_overrides(MpdataConfig(), nslices=48, nx=32, nz=58)
    host = mp.init_data(cfg)
    for dtype, gate in ((torch.float32, 1e-5), (torch.float64, 1e-13)):
        d = host.to(cuda, dtype)
        for n in (1, 3):
            h = 3 * n
            f, u, w, aux, gi0 = _masked_window(d, -h, 38 + 2 * h)
            X = f.shape[1]
            strips = (f[:, :h].contiguous(), f[:, X - h:].contiguous())
            own = f[:, h:X - h].contiguous()
            kw = dict(nx=32, nzm=57)
            if n == 1:
                whole = lambda k: mmask.masked_step_xmajor(
                    f, u, w, *aux, gi0, **kw, owned_lo=h, owned_hi=X - h, warps=k)
                split = lambda k: mmask.masked_step_xmajor_split(
                    own, *strips, u, w, *aux, gi0, **kw, halo=h, warps=k)
                plain = mmask.masked_step_plain(f, u, w, *aux, gi0, 32, h, X - h)
            else:
                whole = lambda k: mmask.masked_kloop_xmajor(
                    f, u, w, *aux, gi0, **kw, owned_lo=h, owned_hi=X - h,
                    nsteps=n, warps=k)
                split = lambda k: mmask.masked_kloop_xmajor_split(
                    own, *strips, u, w, *aux, gi0, **kw, halo=h, nsteps=n,
                    warps=k)
                plain = mmask.masked_kloop_plain(f, u, w, *aux, gi0, 32, h,
                                                 X - h, n)
            for run, cut in ((whole, slice(None)), (split, slice(h, X - h))):
                got, one = run(warps), run(1)
                torch.cuda.synchronize()
                assert torch.equal(got[0], plain[0][:, cut]), (dtype, n)
                assert rel_l1(got[1], plain[1]) < gate, (dtype, n)
                assert torch.equal(got[0], one[0]) and torch.equal(got[1], one[1])


def test_dist_forms_run_through_the_masked_kernels(cuda):
    """Every decomposed form on 3 shards on the card equals the same form
    on the CPU (the plain versions) within the f64 gate, and launched its
    kernel: K20, K21, K22 (step), K23 (loop), K24 and K25 (kloop), and K2
    (slice-batch loop)."""
    cfg = with_overrides(MpdataConfig(), nslices=4, nx=40, nz=12)
    host = mp.init_data(cfg)
    wrappers = MASKED + (mres.advect_resident,)
    before = [w.launches for w in wrappers]
    runs = {}
    for dev in (torch.device("cpu"), cuda):
        m = dmesh.make_mesh(3, dev)
        out = {}
        for kernel in ("pallas", "packed", "xmajor"):
            si, step, gather = dmp.make_dist_step(cfg, m, kernel=kernel)
            f, flux = step(*si(host))
            out[kernel] = (gather(f), flux)
        si, _, gather = dmp.make_dist_step(cfg, m)
        args = si(host)
        for name, loop in (("loop", dmp.make_dist_loop(cfg, m)),
                           ("k25", dmp.make_dist_loop(cfg, m, kstep=2)),
                           ("k24", dmp.make_dist_loop(cfg, m, kstep=2, split=False))):
            f, flux = loop(*args, 4)
            out[name] = (gather(f), flux)
        si, loop = dmp.make_dist_loop_slices(cfg, m)
        out["slices"] = loop(*si(host), 3)
        runs[dev.type] = out
    assert all(w.launches > b for w, b in zip(wrappers, before))
    for name, (f, flux) in runs["cuda"].items():
        f_c, flux_c = runs["cpu"][name]
        assert rel_l1(f, f_c) < 1e-13 and rel_l1(flux, flux_c) < 1e-13, name


def _ring_ext(x, h):
    """A one-shard ring's extended block: its own ends as strips."""
    return torch.cat([x[-h:], x, x[:h]])


@pytest.mark.parametrize("e,h,ncol", [(5, 2, 8), (16, 4, 40), (40, 8, 33),
                                      (20, 15, 8)])
def test_dss_resident_window_kernel_matches_plain(cuda, e, h, ncol):
    """K14w, all four forms, against its plain version on a shard of e
    elements between random strips of h (a window past the strips, several
    windows, a ragged column tile), 1 to h steps; the split and the padded
    operands (three arrays, three views of one) bitwise equal."""
    L64, w64, q64 = _dss_operands(e + 2 * h, ncol, e * 10 + h)
    for dtype, prec, gate in DSS_FORMS:
        L, w, qx = (x.to(cuda, dtype) for x in (L64, w64, q64))
        hl, q, hr = qx[:h].clone(), qx[h:h + e].clone(), qx[h + e:].clone()
        for L2 in (None, precompose_operator(L)):
            for n in sorted({1, 2, h}):
                before = dres.dss_resident_window.launches
                out = dres.dss_resident_window(L, w, hl, q, hr, n, prec, L2)
                padded = dres.dss_resident_window(L, w, qx[:h], qx[h:h + e],
                                                  qx[h + e:], n, prec, L2)
                torch.cuda.synchronize()
                assert dres.dss_resident_window.launches == before + 2
                assert torch.equal(out, padded), (dtype, prec, n)
                ref = dres.dss_resident_window_plain(L, w, hl, q, hr, n, prec, L2)
                assert rel_l2(out, ref) < gate, (dtype, prec, L2 is None, n)


@pytest.mark.parametrize("e", [16, 41])
def test_dss_resident_window_at_one_shard_equals_the_ring(cuda, e):
    """With its own ends as strips a one-shard K14w is bit for bit K14 on
    the ring, every form and depth."""
    L64, w64, q64 = _dss_operands(e, 24, e)
    for dtype, prec, _ in DSS_FORMS:
        L, w, q = (x.to(cuda, dtype) for x in (L64, w64, q64))
        for L2 in (None, precompose_operator(L)):
            for n in (1, 4, 8):
                ring = dres.dss_resident(L, w, q, n, prec, L2)
                fed = dres.dss_resident_window(
                    _ring_ext(L, n), _ring_ext(w, n), q[-n:], q, q[:n], n, prec,
                    None if L2 is None else _ring_ext(L2, n))
                torch.cuda.synchronize()
                assert torch.equal(ring, fed), (dtype, prec, L2 is None, n)


def _pad_rows(x, ex, ey, p):
    """A one-shard torus's rows padded by p wrapped rows per side."""
    x5 = x.reshape(ex, ey, *x.shape[1:])
    return torch.cat([x5[ex - p:], x5, x5[:p]]).reshape(-1, *x.shape[1:])


@pytest.mark.parametrize("exy,ncol", [((4, 4), 40), ((6, 3), 8), ((8, 10), 33),
                                      ((5, 9), 40)])
def test_rowchain_padded_kernels_match_plain(cuda, exy, ncol):
    """K16p, K17p and K18p (depths 2-4) against their plain versions on a
    shard of ex rows padded by random rows, and each K18p bitwise equal to
    that many K16p launches on shrinking windows."""
    ex, ey = exy
    kmax = 4
    L64, w64, t64 = _dss_operands((ex + 2 * kmax) * ey, ncol, ex * 100 + ey)
    for dtype, prec, gate in DSS_FORMS:
        L, w, tx = (x.to(cuda, dtype) for x in (L64, w64, t64))
        for sq in (False, True):
            F = precompose_operator(L) if sq else L
            for k in range(1, kmax + 1):
                r = (kmax - k) * ey  # the k-padded block inside the kmax one
                tp = tx[r:len(tx) - r]
                Fp, wp = F[r + ey:len(F) - r - ey], w[r + ey:len(w) - r - ey]
                before = rc.rowchain_step_padded.launches
                out = rc.rowchain_step_padded(Fp, wp, tp, ex, ey, k, prec, sq,
                                              padded_out=k > 1)
                torch.cuda.synchronize()
                assert rc.rowchain_step_padded.launches == before + 1
                own = out[k * ey:(k + ex) * ey] if k > 1 else out
                ref = rc.rowchain_step_padded_plain(Fp, wp, tp, ex, ey, k, prec, sq)
                assert rel_l2(own, ref) < gate, (dtype, prec, sq, k)
                one = tp
                for j in range(k):  # k K16p launches, one row fewer per side
                    rows = ex + 2 * (k - 1 - j)
                    one = rc.rowchain_step_padded(Fp[j * ey:(j + rows) * ey],
                                                  wp[j * ey:(j + rows) * ey],
                                                  one, rows, ey, 1, prec, sq)
                assert torch.equal(own, one), (dtype, prec, sq, k)
        Lc = L[kmax * ey:(kmax + ex) * ey]
        wc = w[kmax * ey:(kmax + ex) * ey]
        tp = tx[(kmax - 1) * ey:len(tx) - (kmax - 1) * ey]
        before = rc.rowchain_bridge_out_padded.launches
        q = rc.rowchain_bridge_out_padded(Lc, wc, tp, ex, ey, prec)
        torch.cuda.synchronize()
        assert rc.rowchain_bridge_out_padded.launches == before + 1
        ref = rc.rowchain_bridge_out_padded_plain(Lc, wc, tp, ex, ey, prec)
        assert rel_l2(q, ref) < gate, (dtype, prec)


@pytest.mark.parametrize("exy", [(4, 4), (9, 5)])
def test_rowchain_padded_at_one_shard_equals_the_torus(cuda, exy):
    """With the torus's own wrapped rows as the pad, K16p/K18p and K17p are
    bit for bit K16/K18 and K17."""
    ex, ey = exy
    L64, w64, t64 = _dss_operands(ex * ey, 24, ex + ey)
    for dtype, prec, _ in DSS_FORMS:
        L, w, t = (x.to(cuda, dtype) for x in (L64, w64, t64))
        F = precompose_operator(L)
        for k in (1, 2, 4):
            mod = rc.rowchain_step(F, w, t, ex, ey, k, prec, True)
            pad = rc.rowchain_step_padded(_pad_rows(F, ex, ey, k - 1),
                                          _pad_rows(w, ex, ey, k - 1),
                                          _pad_rows(t, ex, ey, k), ex, ey, k,
                                          prec, True, padded_out=True)
            torch.cuda.synchronize()
            assert torch.equal(mod, pad[k * ey:(k + ex) * ey]), (dtype, prec, k)
        assert torch.equal(rc.rowchain_bridge_out(L, w, t, ex, ey, prec),
                           rc.rowchain_bridge_out_padded(
                               L, w, _pad_rows(t, ex, ey, 1), ex, ey, prec))


def test_rowchain_padded_carry_reads_no_unwritten_row(cuda):
    """The padded carry: a K18p launch whose output and scratch buffers
    start as NaN (the rows a padded carry has not refreshed) reads none of
    them before writing it, so the owned rows come out finite and bit for
    bit those of fresh buffers."""
    ex, ey, k = 5, 4, 4
    L64, w64, t64 = _dss_operands((ex + 2 * k) * ey, 40, 7)
    for dtype, prec, _ in DSS_FORMS:
        L, w, tp = (x.to(cuda, dtype) for x in (L64, w64, t64))
        F, wp = L[ey:len(L) - ey], w[ey:len(w) - ey]
        want = rc.rowchain_step_padded(F, wp, tp, ex, ey, k, prec, False,
                                       padded_out=True)
        out, tmp = torch.full_like(tp, float("nan")), torch.full_like(tp, float("nan"))
        got = rc.rowchain_step_padded(F, wp, tp, ex, ey, k, prec, False,
                                      padded_out=True, out=out, tmp=tmp)
        torch.cuda.synchronize()
        own = slice(k * ey, (k + ex) * ey)
        assert got is out and torch.isfinite(got[own]).all()
        assert torch.equal(got[own], want[own])


def test_dist_biharmonic_runs_through_the_kernels(cuda):
    """The kstep ring (split and padded), the serial rowchain (k-step blocks
    and one-row steps), its overlap form and the kstep rowchain on 2 shards
    on the card equal the same loops on the CPU (the plain versions) at
    f64, and launched K14w, K15, K16p, K17p and K18p."""
    cfg = with_overrides(BiharmonicConfig(), nelemd=40, nlev=4, qsize=2)
    host = bproblem.init_data(cfg)
    wrappers = (dres.dss_resident_window, rc.rowchain_bridge_in,
                rc.rowchain_bridge_out_padded)
    before = [w.launches for w in wrappers]
    depths = dict(rc.rowchain_step_padded.depth_launches)
    runs = {}
    for dev in (torch.device("cpu"), cuda):
        m = dmesh.make_mesh(2, dev)
        out = {}
        for split in (True, False):
            si, loop, gather = dbi.make_dist_loop_dss_kstep(cfg, m, kstep=4,
                                                            split=split)
            out[f"kstep split={split}"] = gather(loop(*si(host), 8))
        for name, (si, loop, gather) in (
                ("rowchain", dbi.make_dist_loop_dss2d_rowchain(cfg, m)),
                ("overlap", dbi.make_dist_loop_dss2d_rowchain(cfg, m, overlap=True)),
                ("rowchain kstep", dbi.make_dist_loop_dss2d_rowchain_kstep(cfg, m, 2))):
            out[name] = gather(loop(*si(host), 6))
        runs[dev.type] = out
    assert all(w.launches > b for w, b in zip(wrappers, before))
    now = rc.rowchain_step_padded.depth_launches
    assert all(now.get(k, 0) > depths.get(k, 0) for k in (1, 3)), now
    for name, got in runs["cuda"].items():
        assert rel_l2(got, runs["cpu"][name]) < 1e-13, name
    assert torch.equal(runs["cuda"]["rowchain"], runs["cuda"]["overlap"])


# ---- K1 and K15 reading the state's own (e, q, k, i, j) layout

# ncol -> (qsize, nlev) of a state with that many columns
NATURAL_COLS = {1: (1, 1), 8: (2, 4), 31: (1, 31), 33: (3, 11), 40: (5, 8),
                129: (3, 43), 2880: (40, 72)}
NATURAL_FORMS = [(torch.float32, "highest"), (torch.float32, "bf16x3"),
                 (torch.float64, "highest")]


def _natural_loads():
    return trace.counts().get("natural_loads", 0)


def _state(e, ncol, seed):
    """A float64 state (e, qsize, nlev, 4, 4) with qsize * nlev = ncol."""
    nq, nlev = NATURAL_COLS[ncol]
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal((e, nq, nlev, 4, 4)))


@pytest.mark.parametrize("ncol", [1, 31, 33, 129, 2880])
def test_bd8_natural_load_equals_the_lane_load(cuda, ncol):
    """K1 reading the state where it lies gives bit for bit what it gives
    from the lane copy, every form, n of 1 and 6, ragged column tiles
    (ncol 1, 31, 33, 129) and the cells' 2880; one natural load counted a
    natural call."""
    L64, _, _ = _dss_operands(7, 1, ncol)
    q64 = _state(7, ncol, ncol)
    for dtype, prec in NATURAL_FORMS:
        L, q = L64.to(cuda, dtype), q64.to(cuda, dtype)
        for n in (1, 6):
            before, launches = _natural_loads(), bres.bd8_resident.launches
            got = bres.bd8_resident(L, q, n, prec)
            want = bres.bd8_resident(L, bproblem.to_lane_layout(q), n, prec)
            torch.cuda.synchronize()
            assert (_natural_loads(), bres.bd8_resident.launches) == (
                before + 1, launches + 2)
            assert torch.equal(got, want), (dtype, prec, n)


@pytest.mark.parametrize("exy,ncol", [((4, 4), 40), ((4, 3), 8), ((16, 10), 33),
                                      ((2, 2), 8), ((3, 9), 40), ((3, 1), 33),
                                      ((2, 72), 33)])
def test_rowchain_bridge_in_natural_load_equals_the_lane_load(cuda, exy, ncol):
    """K15 reading the state where it lies (its tile's span staged as it
    lies, turned in shared memory) gives bit for bit what it gives from the
    lane copy, every form, on the tori of test_rowchain_kernels_match_plain;
    one natural load counted a natural call."""
    ex, ey = exy
    L64, _, _ = _dss_operands(ex * ey, 1, ex * 100 + ey)
    q64 = _state(ex * ey, ncol, ex + ey)
    for dtype, prec in NATURAL_FORMS:
        L, q = L64.to(cuda, dtype), q64.to(cuda, dtype)
        before, launches = _natural_loads(), rc.rowchain_bridge_in.launches
        got = rc.rowchain_bridge_in(L, q, ex, ey, prec)
        want = rc.rowchain_bridge_in(L, bproblem.to_lane_layout(q), ex, ey, prec)
        torch.cuda.synchronize()
        assert (_natural_loads(), rc.rowchain_bridge_in.launches) == (
            before + 1, launches + 2)
        assert torch.equal(got, want), (dtype, prec)


def test_natural_load_refuses_a_misaligned_state(cuda):
    """K1 and K15 copy the state in 16-byte pieces: a state that starts off
    16-byte alignment is refused before the launch."""
    ex, ey = 3, 2
    L64, _, _ = _dss_operands(ex * ey, 1, 4)
    L = L64.to(cuda, torch.float32)
    q = _state(ex * ey, 8, 4).to(cuda, torch.float32)
    qx = torch.empty(q.numel() + 1, device=cuda)[1:].view_as(q).copy_(q)
    launches = (bres.bd8_resident.launches, rc.rowchain_bridge_in.launches)
    with pytest.raises(ValueError, match="16-byte"):
        bres.bd8_resident(L, qx, 1)
    with pytest.raises(ValueError, match="16-byte"):
        rc.rowchain_bridge_in(L, qx, ex, ey)
    assert (bres.bd8_resident.launches, rc.rowchain_bridge_in.launches) == launches


def _lane_loop(name, cfg, aux, qtens, n):
    """The loop of a natural-load variant as it ran before its kernels read
    the state where it lies: to_lane_layout, the lane-layout launches,
    from_lane_layout."""
    prec = "bf16x3" if name.endswith("x3") else "highest"
    q = bproblem.to_lane_layout(qtens)
    if "rowchain" not in name:
        return bproblem.from_lane_layout(bres.bd8_resident(aux[0], q, n, prec), cfg)
    L, w, F = aux
    ex, ey = rc.torus_shape(cfg.nelemd)
    t = rc.rowchain_bridge_in(L, q, ex, ey, prec)
    nt = n - 1
    while nt > 0:
        k = min(rc.loop_depth(prec, "_sq" in name), nt)
        t = rc.rowchain_step(F, w, t, ex, ey, k, prec, "_sq" in name)
        nt -= k
    return bproblem.from_lane_layout(rc.rowchain_bridge_out(L, w, t, ex, ey, prec),
                                     cfg)


@pytest.mark.parametrize("family,name,wrapper", [
    ("biharmonic", "fused_operator_bd8_resident", bres.bd8_resident),
    ("biharmonic", "fused_operator_bd8_resident_x3", bres.bd8_resident),
    ("biharmonic_dss2d", "fused_operator_rowchain", rc.rowchain_bridge_in),
    ("biharmonic_dss2d", "fused_operator_rowchain_sq_x3", rc.rowchain_bridge_in)])
def test_homme_loop_reads_the_state_where_it_lies_on_the_card(cuda, family, name,
                                                               wrapper):
    """A HOMME loop on the card equals from_lane_layout(its kernels on
    to_lane_layout(qtens)) bit for bit, leaves qtens unchanged, counts one
    natural load and launches its first kernel once."""
    cfg = with_overrides(BiharmonicConfig(), nelemd=16, nlev=4, qsize=10,
                         dtype="float32", rrearth=0.1)
    data = bproblem.init_data(cfg).to(cuda)
    _, aux, loop = registry._materialize(registry.get(family, name), cfg, data)
    kept = data.qtens.clone()
    want = _lane_loop(name, cfg, aux, data.qtens, 6)
    before, launches = _natural_loads(), wrapper.launches
    got = loop(data, 6)
    torch.cuda.synchronize()
    assert (_natural_loads(), wrapper.launches) == (before + 1, launches + 1)
    assert torch.equal(data.qtens, kept)
    assert got.abs().min() > 0
    assert torch.equal(got, want)


def test_k5_and_the_dist_torus_keep_the_lane_load(cuda):
    """fused_operator_pallas chains K5 on a lane copy, and the dist torus
    hands K15 lane shards: both launch, and natural_loads does not move."""
    cfg = with_overrides(BiharmonicConfig(), nelemd=16, nlev=4, qsize=2,
                         dtype="float32", rrearth=0.1)
    data = bproblem.init_data(cfg).to(cuda)
    _, _, loop = registry._materialize(
        registry.get("biharmonic", "fused_operator_pallas"), cfg, data)
    before = _natural_loads()
    launches = (bres.apply_operator_pallas.launches, rc.rowchain_bridge_in.launches)
    loop(data, 2)
    si, dloop, gather = dbi.make_dist_loop_dss2d_rowchain(cfg, dmesh.make_mesh(2, cuda))
    gather(dloop(*si(bproblem.init_data(cfg)), 3))
    torch.cuda.synchronize()
    assert _natural_loads() == before
    assert bres.apply_operator_pallas.launches == launches[0] + 2
    assert rc.rowchain_bridge_in.launches > launches[1]
