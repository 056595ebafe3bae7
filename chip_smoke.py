#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (cdk_torch) on one Hopper card.

    python3 chip_smoke.py        # from the repository root; needs one sm_90 card
    python3 chip_smoke.py --times OUT [--against REF]

Phases, each printing its result; the first failure exits non-zero:

  1. device   require CUDA and compute capability 9.0; print the card's
              name and power limit (nvidia-smi)
  2. build    compile cdk_torch/csrc/*.cu with nvcc (sm_90a); print ptxas's
              registers and spills of the kernels redesigned for Hopper:
              K14's bf16x3 ring kernel, the rowchain bridges (K15, K17)
              and step sweep (K16, K18), K19's two kernels, the MPDATA sweep (every
              instantiation: staged K6-K8, hoisted K2/K9, masked K20-K25),
              K12, and K3 and K13 (with K13's transpose)
  3. kernels  each hand-written kernel against its plain PyTorch version on
              the card, at the main path's shapes (shipped and production),
              f32 and f64, with the family's gate; both timed with CUDA
              events, beside the kernel's bound (bytes over 3.35 TB/s or
              operations over 67 TFLOP/s f32, with the bf16 products of a
              bf16x3 form over 989 TFLOP/s, whichever is larger) and,
              where one PyTorch call computes the same function, that
              call's time.  K1/K2 at n = 1 and 4 steps (K2's f bitwise its
              plain version's, K9 bitwise K2); K4 (both
              precisions), K5, the staged MPDATA kernel (K6 and K7 at one
              step, K8 at 4 in one launch, and the bf16 form; K8 bitwise
              equal to four K6 launches), K9 and K10 at shipped f32/f64 and
              production f32 (K10's f bit for bit its plain version's, and
              at production f32 K10 bitwise equal to K6 on the same data);
              the MPDATA sweep at the shipped 48 slices with 1, 2, 4 and 8
              warps a slice (K2, K6, K8, K10, K22-K25), outputs bitwise
              equal across the counts; the card's L2 read
              rate (a probe reading an L2-resident 11.2 MB buffer); the
              CKE kernels K3, K11 (beside it torch.einsum of the stacked
              coefficients by the staged rows), K12 (and its bf16
              form; beside it torch.matmul of the prebuilt [A1; A3], f32
              and f64) and K13 at the shipped 25600 x 2800 x 100, and K3
              and K13 also at the production 256000 x 28000 x 100 (beside
              them torch.sparse.mm of the prebuilt CSR [A1; A3], and the
              floor their E*A*K gathered values set at the L2 rate), and
              K3 on the cell mpaso.tracers' 486 x 488 periodic hexagonal
              mesh (711504 x 237168 x 60, f32) through out= into one
              tracer's slice of a group, bitwise its plain version, and
              K3g there over the cell's 32 tracers in one launch, bitwise
              its plain version and the per-tracer K3 path, beside its
              bound and the per-tracer path's time; K26 over the cell
              homme.hv_cube's ne30np4 cube (5400 x 2880, f32, A² and A)
              within 5e-5 of its plain version, beside its bound; K14
              (four forms), K19 (two forms) and the rowchain's
              K15, K17 and step (K16 at depth 1, K18 deeper) at the
              shipped 16 x 72 x 40 (f32 and f64) and the production
              5400 x 72 x 10 (f32): one launch of each at the real radius,
              then at rrearth 0.1 the launch depth each loop uses, each
              depth-k step also bitwise against k depth-1 launches, and
              every resident and rowchain loop(n) against n chained plain
              steps for n in {1, 2, k, k+1, 2k+1} (the bf16x3 forms of K14
              and the rowchain step run on the tensor cores, which sum a
              product's terms in their own order: held to the 5e-5 gate,
              not bit for bit); a depth sweep at production f32, us per
              step: K14 at 2-8 steps per launch (sq_x3, sq), the
              rowchain step's four forms at depths 1, 2, 3, 4, 8, and
              K19's bf16x3 form at 1-3 steps a launch (production, the 8 x 8
              window; 1-4 at the shipped 4 x 4, whole rows, with its exact
              forms' depths); the
              masked-global MPDATA kernel K20-K25 on shard windows of the
              shipped config (f32 and f64, 1 and 4 shards) and the
              production 8192 x 32 x 58 (f32, 1 shard; K24/K25 at kstep 2
              and 4), f bitwise the plain versions', K23 bitwise equal to
              K22 and K25 to K24
  4. main     cdk_torch.harness.driver.run_kernel for biharmonic,
              biharmonic_dss, biharmonic_dss2d, mpdata and cke (and the
              cube's biharmonic_dss_cube at production only, its
              reference and champion): shipped size
              with host init at f64 (every variant against the in-process
              reference at the f64 gate; for cke every registered variant,
              the experimental ones included; mpdata's experimental
              pallas_lanes in a leg of its own), and the production preset
              with device init at f32 (reference and champion; every
              non-experimental biharmonic and mpdata variant; for the DSS
              families also the exact _sq form; for cke also pallas_rows
              and pallas_lanegather)
              The dist modes of the DSS kernels on the shard windows the
              decomposed loops hand them: the window-fed K14 (K14w, kstep
              8) on 1 and 2 (shipped) or 4 (production) ring shards, split
              and padded operands bitwise equal and on 1 shard bitwise
              equal to K14; the padded rowchain K16p, K17p and K18p (at the
              loop's depth, bitwise equal to that many K16p launches; K17p
              on 1 shard bitwise equal to K17) on 1 and 2 (shipped) or 3
              (production 75 x 72) row shards
  5. dist     the decomposed MPDATA and DSS paths on a mesh of shards on the
              card: cdk_torch.harness.distbench.run_dist_legs (both mpdata
              legs and both DSS legs at the production preset on 1 shard,
              verified against pallas_xmajor and the DSS champions; the DSS
              legs at rrearth 0.1), `python -m cdk_torch scaling mpdata` and
              `scaling biharmonic`, each `--devices 1,2,4 --overlap-gain
              --kstep 4`, the serial and overlap rowchain loops bitwise
              equal at production f32 on 3 shards, and make_dist_step with
              the "pallas" and "packed" cores and make_dist_loop(kstep=4,
              split=False) at production f32; the MPDATA per-step and
              kstep-4 loops timed at production f32 on 1 shard
  6. counts   every kernel's launch counter rose during phase 4 (K1-K19, K26)
              or phase 5 (K2, K20-K25, K14w, K16p-K18p), each counted from
              zero, and each split by the size of the work that made it:
              shipped (the miniapps' sizes, and the `scaling` sweeps' small
              defaults) and production

Then the total wall time, the rows of PERF.md's kernel table (the
multi-step kernels with the steps their production launches ran), each
kernel's device time lost against its bound on its path (`[7 rank]`, the
redesign queue's order, each kernel marked queued, redesigned and not taken
again, or at half its bound or better and left alone), one JSON line describing the kernels, and as the
last line {"ok": true, "device": {...}}.  It imports nothing of JAX.

--times OUT runs phases 1 and 2 and then times K3 and K13 (at production
f32 and the shipped size in f64), K12 (at the shipped size,
f32, f64 and bf16), the MPDATA step kernel (at production, f32, f64 and
bf16: K6 and K7 one step, K8 four; K2 one and four steps, K9 four), K10
(production f32 and f64, shipped f64), the
masked kernel (K22/K23 one step, K24/K25 four, on the one-shard window at
the shipped 48 slices and at production) and the DSS kernels (K14-K19 and
their dist modes at production, K19 also shipped; and the production
biharmonic_dss2d legs of phases 4 and 5 that run the rowchain kernels, in
us/step; --kernels narrows to cke, mpdata or dss), and saves their outputs
(of the DSS kernels, digests) to OUT; --against REF then holds them bitwise
equal to those a run of another tree saved in REF, K10's within the
family gates (the bf16x3 forms of K15, K17, K17p and K19, redesigned on
the tensor cores, are not held), and prints REF's times beside.  Run against an older tree's
package, it measures that tree:

    PYTHONSAFEPATH=1 PYTHONPATH=OLD python3 chip_smoke.py --times OUT
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time

REPS = 20  # timed launches per phase-3 measurement, after two warm-ups
# the card's peaks for a kernel's bound (H100 SXM data sheet): device memory
# bytes/s, float32 operations/s outside the tensor cores, and dense bf16
# operations/s (bf16 operands, f32 accumulation) on the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12
# operations per element-column: one exact 16x16 operator apply (256 FMAs),
# a ring DSS (8 boundary sums, 16 weights), a torus DSS (16 sums, 16
# weights) and its i pass with the weights (8 + 16) and j pass (8)
APPLY, RING_DSS, TORUS_DSS, I_PASS, J_PASS = 512, 24, 32, 24, 8
# a cube DSS's least per element-column: over the cube's unique points, m - 1
# sums and one product for a point of m sharers, 16 an element on average
# (cdkbench/work/biharmonic_dss_cube.py)
CUBE_DSS = 16
# a bf16x3 apply: three bf16 products of APPLY operations each, and in f32
# the split of the column's 16 values into hi and lo parts (3 each) and the
# sum of the three partial results (2 per output); the operator's split,
# once per element per launch, is left out (about 1 per element-column)
X3_BF16, X3_F32 = 3 * APPLY, 16 * 3 + 16 * 2


# for PERF.md's table: the change that ported each kernel and, for those
# redesigned for Hopper since, the change that did and the ms per launch the
# table held before it
PORTED = {**dict.fromkeys(("K1", "K2"), 1), **dict.fromkeys(("K3", "K11", "K12", "K13"), 2),
          **dict.fromkeys(("K14", "K15", "K16", "K17", "K18", "K19"), 3),
          **dict.fromkeys(("K4", "K5", "K6", "K7", "K8", "K9", "K10"), 4),
          **dict.fromkeys(("K20", "K21", "K22", "K23", "K24", "K25"), 5),
          **dict.fromkeys(("K14w", "K16p", "K17p", "K18p"), 6)}
# kernels written for the card that port no TPU kernel: the change that added each
NEW = {"K3g": 23, "K26": 24}
REDESIGNED = {"K14": (7, 1.6638), "K14w": (7, 3.8402), "K16": (21, 0.2552),
              "K16p": (21, 0.2564), "K18": (21, 1.1170), "K18p": (21, 1.0512),
              "K6": (8, 0.5603), "K7": (8, 0.5615), "K8": (8, 1.8192),
              "K12": (8, 2.0123), "K2": (9, 0.7962), "K9": (9, 0.7968),
              "K20": (9, 0.7565), "K21": (9, 0.7535), "K22": (9, 0.7534),
              "K23": (9, 0.8306), "K24": (9, 3.2612), "K25": (9, 3.3596),
              "K3": (10, 0.3515), "K13": (10, 0.8552), "K15": (11, 0.4306),
              "K17": (11, 0.4311), "K17p": (11, 0.4250), "K19": (11, 1.6471),
              "K10": (12, 1.0110)}


# the kernels whose launches run several steps; their rows also count the
# steps their production launches ran
STEPPED = ("K2", "K8", "K9", "K14", "K14w", "K18", "K18p", "K24", "K25")


def table_row(k: str, row: dict) -> str:
    """The kernel's row of PERF.md's table, from its JSON description."""
    status = f"new PR {NEW[k]}" if k in NEW else f"ported PR {PORTED[k]}"
    ms = f"{row['ms']:.4f}"
    if k in REDESIGNED:
        pr, before = REDESIGNED[k]
        status = f"redesigned PR {pr} ({status})"
        ms += f" (PR {pr - 1}: {before:.4f})"
    lib = "none"
    if row["library_ms"] is not None:
        lib = f"{row['library_ms']:.4f} (`{row['library']}`)"
    if "ms_f64" in row:
        ms += f"; f64 {row['ms_f64']:.4f}"
        lib += f"; f64 {row['library_ms_f64']:.4f}"
    if "mpaso_ms" in row:  # K3 on the cell mpaso.tracers' mesh
        ms += f"; mpaso hex f32 {row['mpaso_ms']:.4f} (bound {row['mpaso_bound_ms']:.4f})"
        lib += f"; mpaso hex {row['mpaso_library_ms']:.4f}"
    if "shipped_ms" in row:  # a kernel whose path launches it at the shipped size
        ms += f"; shipped f64 {row['shipped_ms']:.4f} (bound {row['shipped_bound_ms']:.4f})"
    return (f"| {k} | `{row['replaces'].removeprefix('cdk_tpu/kernels/')}` | {status} | "
            f"CUDA → `{row['source'].removeprefix('cdk_torch/')}` ({row['name']}) | {ms} | "
            f"{row['launches_shipped']} / {row['launches_production']}"
            + (f" ({row['steps_production']} steps)" if "steps_production" in row else "")
            + " | "
            f"{row['bound_ms']:.4f} ({row['bound_by']}) | {row['plain_ms']:.4f} | {lib} |")


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def timed_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of fn() over `reps` calls, by CUDA events,
    after two warm-up calls."""
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def ops_ms(ops: float, bf16_ops: float = 0.0) -> float:
    """Milliseconds for `ops` float32 operations and `bf16_ops` bf16
    tensor-core operations, each at its peak rate."""
    return (ops / F32_OPS_PER_S + bf16_ops / BF16_OPS_PER_S) * 1e3


def bound(tensors, ops: float, bf16_ops: float = 0.0) -> dict:
    """The least time the card could take: every tensor (inputs and
    outputs) moved once at the memory rate, or the operations (ops_ms),
    whichever is longer."""
    moved = sum(t.numel() * t.element_size() for t in tensors)
    t_bytes, t_ops = moved / HBM_BYTES_PER_S * 1e3, ops_ms(ops, bf16_ops)
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def apply_ops(cols: float, prec: str, n_apply: int, other: int = 0) -> dict:
    """bound()'s operations for `cols` element-columns that each take
    `n_apply` 16x16 applies in `prec` and `other` more float32 ones."""
    if prec == "bf16x3":
        return dict(ops=cols * (n_apply * X3_F32 + other),
                    bf16_ops=cols * n_apply * X3_BF16)
    return dict(ops=cols * (n_apply * APPLY + other))


def _step_ops(nx: int, hoisted: bool) -> int:
    """Operations per level of one MPDATA step that produces nx columns,
    counted from the stage code (each add, mul, div, min, max, abs and
    negation one) over each stage's rows: upwind fluxes 6 each, the flux
    sums 1, the upwind update 6, the antidiffusive velocities 19 each (7
    hoisted), extrema and ratios 46, limited fluxes 10 each, the final
    update 7."""
    anti = 7 if hoisted else 19
    return (6 * (nx + 5) + 6 * (nx + 4) + 2 * nx + 6 * (nx + 4)
            + anti * (2 * nx + 5) + 46 * (nx + 2) + 10 * (2 * nx + 1) + 7 * nx)


def _invariant_ops(nx: int) -> int:
    """Operations per level of the hoisted invariants, 12 per point over
    the antidiffusive velocities' rows, once per launch."""
    return 12 * (2 * nx + 5)


def mpdata_ops(nslices: int, nx: int, nzm: int, n: int, hoisted: bool) -> float:
    """Operations of n MPDATA steps on nx columns (_step_ops, plus the
    invariants once where they are hoisted)."""
    once = _invariant_ops(nx) if hoisted else 0
    return float(nslices * nzm * (n * _step_ops(nx, hoisted) + once))


def masked_ops(nslices: int, X: int, nzm: int, n: int, hoisted: bool) -> float:
    """Operations of n masked-global MPDATA steps on a window of X columns
    whose owned block is X - 6n columns (halo 3n a side).  Step j = 1..n
    need only produce the X - 6j columns the owned outputs still depend on
    (the cone), each stage over its rows for that many outputs as
    mpdata_ops counts them; the hoisted invariants once over the first
    step's rows.  The masks cost no arithmetic."""
    steps = sum(_step_ops(X - 6 * j, hoisted) for j in range(1, n + 1))
    once = _invariant_ops(X - 6) if hoisted else 0
    return float(nslices * nzm * (steps + once))


def cke_ops(nedges: int, nvert: int, nadv: int) -> float:
    """Two FMAs per slot per (edge, level), then the finish (6)."""
    return float(nedges * nvert * (4 * nadv + 6))


def errors(out, ref, norm: str) -> tuple[float, float, float]:
    """(relative L2 or L1 error, max abs error, max |ref|) in float64 on
    the device; the last shows the comparison is not between zeros."""
    d = out.double() - ref.double()
    r = ref.double()
    if norm == "l2":
        den = (r * r).sum()
        rel = (d * d).sum() / den if den > 0 else (d * d).sum()
        rel = rel.sqrt()
    else:
        den = r.abs().sum()
        rel = d.abs().sum() / den if den > 0 else d.abs().sum()
    return float(rel), float(d.abs().max()), float(r.abs().max())


def phase_device():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    from cdk_torch.core.platform import resolve_device

    dev = resolve_device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[dev.index]
    print(f"[1 device] {torch.cuda.get_device_name(dev)} "
          f"(capability {torch.cuda.get_device_capability(dev)}), "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(card)
    return dev, card


def phase_build():
    from cdk_torch.core import build

    built = build.build()
    print(f"[2 build] {built.path.name}: nvcc {built.seconds:.1f} s")
    print(built.log.strip(), file=sys.stderr)
    # ptxas's registers and spills of the kernels redesigned for Hopper:
    # K14's bf16x3 ring, the rowchain bridges (mode 0 bridge_in, 2
    # bridge_out; tensor cores for x3) and step (the sweep), K19's two
    # kernels (x3 on the tensor cores; exact), the MPDATA sweep (L
    # levels a lane; its staged, hoisted and masked modes), K12, and K3 and
    # K13 (vec: 16-byte level groups; K13's first kernel the transpose), with
    # their static shared memory (the others' is dynamic, sized by their
    # launchers)
    flag_names = {"step_kernel": ("x3",), "sweep_kernel": ("x3", "sq"),
                  "dss_ring_x3_kernel": ("sq",),
                  "cke_onehot_kernel": ("bf16",), "cke_rows_kernel": ("vec",),
                  "cke_lanegather_kernel": ("vec",),
                  "mpdata_sweep_kernel": ("split", "hoist", "masked", "lanes")}
    int_names = {"mpdata_sweep_kernel": ("L",), "step_kernel": ("elems", "mode")}
    for m in re.finditer(r"Function properties for (\S+)\n\s+(\d+) bytes stack frame, "
                         r"(\d+) bytes spill stores, (\d+) bytes spill loads\n.*?Used "
                         r"(\d+) registers(?:, used \d+ barriers)?(?:, (\d+) bytes smem)?",
                         built.log):
        k = re.search(r"(dss_ring_x3_kernel|step_kernel|sweep_kernel|mpdata_sweep_kernel|"
                      r"cke_onehot_kernel|cke_rows_kernel|cke_lanegather_kernel|"
                      r"transpose_kernel|dss2d_x3_kernel|dss2d_exact_kernel)(?:I(\w*?)EEv)?",
                      m.group(1))
        if k:
            args = k.group(2) or ""
            dtype = ("bf16 " if args.startswith("13__nv_bfloat16")
                     else {"f": "f32 ", "d": "f64 "}.get(args[:1], "f32 "))
            flags = dict(zip(flag_names.get(k.group(1), ()),
                             re.findall(r"Lb(\d)E", args + "E")))
            ints = dict(zip(int_names.get(k.group(1), ("elems",)),
                            re.findall(r"Li(\d+)E", args + "E")))
            print(f"[2 ptxas] {k.group(1)} {dtype}"
                  + " ".join(f"{f}={v}" for f, v in {**flags, **ints}.items())
                  + f": {m.group(5)} registers, spill stores {m.group(3)} B, spill "
                  f"loads {m.group(4)} B, stack {m.group(2)} B, static smem "
                  f"{m.group(6) or 0} B")
    if not built.log:
        print("[2 ptxas] library reused, not rebuilt: no ptxas report")


def phase_kernels(dev, card):
    """K1 and K2 against their plain versions; returns the JSON rows."""
    import torch

    from cdk_torch.core.config import BiharmonicConfig, MpdataConfig
    from cdk_torch.kernels.biharmonic import problem as bp
    from cdk_torch.kernels.biharmonic.operator import build_element_operator
    from cdk_torch.kernels.biharmonic.resident import (
        bd8_resident,
        bd8_resident_plain,
    )
    from cdk_torch.kernels.mpdata import problem as mp
    from cdk_torch.kernels.mpdata.resident import (
        advect_hoisted_resident,
        advect_resident,
        advect_resident_plain,
    )

    rows = {}
    gate = {torch.float32: 2e-5, torch.float64: 1e-13}
    for label, (nelemd, qsize) in (("shipped", (16, 40)),
                                   ("production", (5400, 10))):
        cfg = BiharmonicConfig(nelemd=nelemd, qsize=qsize, dtype="float64",
                               device_init=True)
        data = bp.init_data(cfg, dev)
        # rrearth = 1: with the real radius every application scales q by
        # ~rrearth^2, and a 4-step f32 chain would sink below f32's range
        L64 = build_element_operator(data.dvv, data.dinv, data.spheremp,
                                     data.tensorvisc, 1.0)
        q64 = bp.to_lane_layout(data.qtens)
        for dtype, prec in ((torch.float32, "highest"),
                            (torch.float32, "bf16x3"),
                            (torch.float64, "highest")):
            L, q = L64.to(dtype), q64.to(dtype)
            for n in (1, 4):
                out = bd8_resident(L, q, n, prec)
                ref = bd8_resident_plain(L, q, n, prec)
                torch.cuda.synchronize()
                rel, mae, big = errors(out, ref, "l2")
                ms = timed_ms(lambda: bd8_resident(L, q, n, prec), REPS)
                plain_ms = timed_ms(lambda: bd8_resident_plain(L, q, n, prec), REPS)
                ok = (rel < gate[dtype] and big > 0
                      and bool(torch.isfinite(out).all()))
                print(f"[3 K1] {label:10s} e={nelemd} ncol={cfg.ncol} "
                      f"{str(dtype)[6:]:7s} {prec:7s} n={n}: rel_l2 {rel:.3e} "
                      f"(gate {gate[dtype]:g}) max_abs {mae:.3e} of {big:.3e}; kernel "
                      f"{ms:.4f} ms, plain {plain_ms:.4f} ms [{card}]")
                if not ok:
                    fail(f"K1 {label} {dtype} {prec} n={n}: rel_l2 {rel:.3e}")
                if (label, dtype, prec, n) == ("production", torch.float32,
                                               "bf16x3", 1):
                    # the library call: one exact batched product
                    lib_ms = timed_ms(lambda: torch.bmm(L, q), REPS)
                    cols = q.numel() / 16  # element-columns
                    rows["K1"] = dict(
                        max_abs_err=mae, ms=ms, plain_ms=plain_ms,
                        library_ms=lib_ms, library="torch.bmm",
                        **bound((L, q, out), **apply_ops(cols, prec, 1)))
                    # a long chain reads and writes q once, so its steps
                    # are bound by their operations alone
                    per_step = {p: ops_ms(**apply_ops(cols, p, 1))
                                for p in ("highest", "bf16x3")}
                    print(f"[3 K1] {label} bf16x3 n=1: torch.bmm {lib_ms:.4f} ms, "
                          f"bound {rows['K1']['bound_ms']:.4f} ms "
                          f"({rows['K1']['bound_by']}); per step of a long "
                          f"chain, operations: highest {per_step['highest']:.4f}"
                          f" ms, bf16x3 {per_step['bf16x3']:.4f} ms [{card}]")
        del data, L64, q64, L, q

    gate_flux = {torch.float32: 1e-5, torch.float64: 1e-13}
    for label, nslices in (("shipped", 48), ("production", 8192)):
        for dtype in (torch.float32, torch.float64):
            cfg = MpdataConfig(nslices=nslices, dtype=str(dtype)[6:],
                               device_init=True)
            d = mp.init_data(cfg, dev)
            args = (d.f, d.u, d.w, d.rho, d.rhow, d.adz, d.flux)
            for n in (1, 4):
                f_k, flux_k = advect_resident(*args, n)
                f_9, flux_9 = advect_hoisted_resident(*args, n)
                f_p, flux_p = advect_resident_plain(*args, n)
                torch.cuda.synchronize()
                ef, mae_f, big_f = errors(f_k, f_p, "l1")
                efl, mae_fl, big_fl = errors(flux_k, flux_p, "l1")
                # f rounds as the plain version's in every operation; the
                # flux column sums run in x order, within the gates
                same = torch.equal(f_k, f_p)
                k9 = torch.equal(f_9, f_k) and torch.equal(flux_9, flux_k)
                ms = timed_ms(lambda: advect_resident(*args, n), REPS)
                plain_ms = timed_ms(lambda: advect_resident_plain(*args, n), REPS)
                ok = (same and k9 and efl < gate_flux[dtype]
                      and big_f > 0 and big_fl > 0
                      and bool(torch.isfinite(f_k).all())
                      and bool(torch.isfinite(flux_k).all()))
                print(f"[3 K2] {label:10s} S={nslices} nx=32 nz=58 "
                      f"{str(dtype)[6:]:7s} n={n}: f bitwise={same} (rel_l1 {ef:.3e}), "
                      f"flux rel_l1 {efl:.3e} (gate {gate_flux[dtype]:g}) max_abs "
                      f"{max(mae_f, mae_fl):.3e} of {max(big_f, big_fl):.3e}; K9 = K2 "
                      f"bitwise={k9}; kernel {ms:.4f} ms, "
                      f"plain {plain_ms:.4f} ms [{card}]")
                if not ok:
                    fail(f"K2 {label} {dtype} n={n}: f bitwise {same}, K9 = K2 "
                         f"{k9}, rel_l1 f {ef:.3e} flux {efl:.3e}")
                if (label, dtype, n) == ("production", torch.float32, 1):
                    rows["K2"] = dict(
                        max_abs_err=max(mae_f, mae_fl), ms=ms,
                        plain_ms=plain_ms, steps_timed=1,
                        **bound(args + (f_k, flux_k),
                                mpdata_ops(cfg.nslices, cfg.nx, cfg.nzm, 1, True)))
            del d, args
    return rows


def phase_fused_and_staged_kernels(dev, card):
    """K4, K5, the staged MPDATA kernel (through the K6, K7 and K8
    wrappers, and its bf16 form), K9 and K10 against their plain versions,
    one launch each at the real radius and shipped f32/f64 and production
    f32; returns the JSON rows."""
    import torch

    from cdk_torch.core.config import BiharmonicConfig, MpdataConfig
    from cdk_torch.kernels.biharmonic import problem as bp
    from cdk_torch.kernels.biharmonic.fused import (
        fused_laplace,
        fused_laplace_plain,
        pack_element_fields,
    )
    from cdk_torch.kernels.biharmonic.operator import element_operator
    from cdk_torch.kernels.biharmonic.reference import rrearth_as
    from cdk_torch.kernels.biharmonic.resident import (
        apply_operator_pallas,
        bd8_resident_plain,
    )
    from cdk_torch.kernels.mpdata import lanes, staged
    from cdk_torch.kernels.mpdata import problem as mp
    from cdk_torch.kernels.mpdata.resident import (
        advect_hoisted_resident,
        advect_resident_plain,
    )

    rows = {}

    def check(tag, what, gates, kernel, plain, exact_f=False):
        """kernel() and plain() return a tensor (rel L2 against `gates[0]`)
        or MPDATA's (f, flux) (rel L1 against the f and flux gates; with
        exact_f f bit for bit)."""
        out, ref = kernel(), plain()
        torch.cuda.synchronize()
        outs = out if isinstance(out, tuple) else (out,)
        refs = ref if isinstance(ref, tuple) else (ref,)
        norm = "l1" if isinstance(out, tuple) else "l2"
        errs = [errors(o, r, norm) for o, r in zip(outs, refs)]
        same = "/".join(str(torch.equal(o, r)) for o, r in zip(outs, refs))
        ms = timed_ms(kernel, REPS)
        plain_ms = timed_ms(plain, REPS)
        mae = max(e[1] for e in errs)
        print(f"[3 {tag}] {what}: rel_{norm} "
              f"{' / '.join(f'{e[0]:.3e}' for e in errs)} (gate "
              f"{' / '.join(f'{g:g}' for g in gates)}) max_abs {mae:.3e} of "
              f"{max(e[2] for e in errs):.3e} bitwise={same}; kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms [{card}]")
        if not all(e[0] < g and e[2] > 0 and bool(torch.isfinite(o).all())
                   for e, g, o in zip(errs, gates, outs)):
            fail(f"{tag} {what}: {[e[0] for e in errs]}")
        if exact_f and not torch.equal(outs[0], refs[0]):
            fail(f"{tag} {what}: f is not bit for bit its plain version's")
        return outs, dict(max_abs_err=mae, ms=ms, plain_ms=plain_ms)

    gate = {"float32": 2e-5, "float64": 1e-13}
    for label, (nelemd, qsize), dtypes in (
            ("shipped", (16, 40), ("float32", "float64")),
            ("production", (5400, 10), ("float32",))):
        for dtype in dtypes:
            cfg = BiharmonicConfig(nelemd=nelemd, qsize=qsize, dtype=dtype,
                                   device_init=True)
            data = bp.init_data(cfg, dev)
            rr = rrearth_as(cfg)
            q = bp.to_lane_layout(data.qtens)
            cols = q.numel() / 16  # element-columns
            L = element_operator(data, rr)
            shape = f"{label:10s} e={nelemd} ncol={cfg.ncol} {dtype}"
            (out,), row = check("K5", f"{shape} one step", (gate[dtype],),
                                lambda: apply_operator_pallas(L, q),
                                lambda: bd8_resident_plain(L, q, 1))
            if dtype != "float32":
                continue
            # the library call of K5 (and of K4: the same linear map with
            # the prebuilt operator): one exact batched product
            lib_ms = timed_ms(lambda: torch.bmm(L, q), REPS)
            if label == "production":
                rows["K5"] = dict(row, library_ms=lib_ms, library="torch.bmm",
                                  **bound((L, q, out), cols * APPLY))
            elem = pack_element_fields(data.dinv, data.spheremp, data.tensorvisc)
            dvv = data.dvv.contiguous()
            # the plain version rounds as the kernel does and sums in its
            # order, so both precisions are held tighter than their gates
            # (2e-5; 1e-2 for the one-pass bf16 "default"), so that a kernel
            # that skipped the bf16 rounding fails
            for prec in ("highest", "default"):
                (out,), row = check(
                    "K4", f"{shape} {prec}", (1e-6,),
                    lambda: fused_laplace(dvv, elem, q, rr, prec),
                    lambda: fused_laplace_plain(dvv, elem, q, rr, prec))
                if (label, prec) == ("production", "highest"):
                    rows["K4"] = dict(row, library_ms=lib_ms,
                                      library="torch.bmm, prebuilt L", **bound(
                        (dvv, elem, q, out), cols * 896))
            print(f"[3 K4/K5] {shape}: torch.bmm with the prebuilt operator "
                  f"{lib_ms:.4f} ms [{card}]")
        del data, q, L

    # the bf16 form against its plain version in bf16: 1e-2 on both (the
    # registered flux gate against the reference is 1e-1), so a wrong
    # rounding scheme fails
    mgates = {"float32": (1e-6, 1e-5), "float64": (1e-13, 1e-13),
              "bfloat16": (1e-2, 1e-2)}
    for label, nslices, dtypes in (("shipped", 48, ("float32", "float64")),
                                   ("production", 8192, ("float32",))):
        for dtype in dtypes:
            cfg = MpdataConfig(nslices=nslices, dtype=dtype, device_init=True)
            d = mp.init_data(cfg, dev)
            args = (d.f, d.u, d.w, d.rho, d.rhow, d.adz, d.flux)
            shape = f"{label:10s} S={nslices} nx=32 nz=58"
            cases = [("K6", staged.advect_fused, 1, args, dtype),
                     ("K7", staged.advect_packed, 1, args, dtype),
                     ("K8", staged.advect_staged_resident, 4, args, dtype)]
            if dtype == "float32":
                cases.append(("K7", staged.advect_packed, 1,
                              tuple(a.to(torch.bfloat16) for a in args),
                              "bfloat16"))
            for tag, wrapper, n, a, kind in cases:
                outs, row = check(
                    tag, f"{shape} {kind:8s} {wrapper.__name__} n={n}",
                    mgates[kind], lambda: wrapper(*a, n),
                    lambda: staged.advect_staged_plain(*a, n))
                if label == "production" and kind == "float32":
                    rows[tag] = dict(row, steps_timed=n, **bound(
                        a + outs, mpdata_ops(cfg.nslices, cfg.nx, cfg.nzm, n, False)))
                if tag == "K8":  # n steps in one launch = n one-step launches
                    f, flux = a[0], a[6]
                    for _ in range(n):
                        f, flux = staged.advect_fused(f, *a[1:6], flux, 1)
                    torch.cuda.synchronize()
                    if not (torch.equal(outs[0], f) and torch.equal(outs[1], flux)):
                        fail(f"K8 {shape} {kind}: {n} steps in one launch differ "
                             f"from {n} one-step launches")
                    print(f"[3 K8=K6] {shape} {kind}: {n} steps in one launch "
                          f"bitwise equal to {n} one-step launches")
            outs, row = check(
                "K9", f"{shape} {dtype:8s} advect_hoisted_resident n=1",
                mgates[dtype], lambda: advect_hoisted_resident(*args, 1),
                lambda: advect_resident_plain(*args, 1))
            if label == "production":
                rows["K9"] = dict(row, steps_timed=1, **bound(
                    args + outs, mpdata_ops(cfg.nslices, cfg.nx, cfg.nzm, 1, True)))
            # K10: f bit for bit its plain version's (the sweep rounds every
            # operation as the plain version does); its path launches it at
            # the shipped size in f64, whose time and bound its row carries
            xzs = tuple(lanes.to_xzs(t) for t in args)
            outs, row = check(
                "K10", f"{shape} {dtype:8s} advect_lanes (x, z, s)",
                mgates[dtype], lambda: lanes.advect_lanes(*xzs),
                lambda: lanes.advect_lanes_plain(*xzs), exact_f=True)
            here = bound(xzs + outs, mpdata_ops(cfg.nslices, cfg.nx, cfg.nzm, 1, False))
            if label == "production":
                rows["K10"] = dict(rows.get("K10", {}), **row, **here)
                f6, flux6 = staged.advect_fused(*args, 1)
                torch.cuda.synchronize()
                if not (torch.equal(outs[0], lanes.to_xzs(f6))
                        and torch.equal(outs[1], lanes.to_xzs(flux6))):
                    fail(f"K10 {shape} {dtype}: differs from K6 on the same data")
                print(f"[3 K10=K6] {shape} {dtype}: K10 on (x, z, s) bitwise equal to K6 "
                      f"on (s, x, z), f and flux")
            elif dtype == "float64":
                rows["K10"] = dict(rows.get("K10", {}), shipped_ms=row["ms"],
                                   shipped_bound_ms=here["bound_ms"])
            del d, args, xzs
    return rows


def phase_few_slices(dev, card):
    """The warps a slice of the MPDATA sweep at the shipped 48 slices (nx 32,
    nzm 57), f32 and f64: the hoisted form (K2, 1 and 4 steps), the staged
    form (K6 one step, K8 four; K10 one step on the (x, z, s) layout) and the
    masked form on the one-shard window (K22 and K23 one step, K24 and K25
    four), each at 1, 2, 4 and 8 warps a slice and at the kernel's own
    choice, each timed in turn; f and flux bitwise equal whatever the
    count."""
    import torch

    from cdk_torch.core.config import MpdataConfig
    from cdk_torch.dist import mesh as dmesh
    from cdk_torch.dist import mpdata as dmp
    from cdk_torch.kernels.mpdata import lanes
    from cdk_torch.kernels.mpdata import masked as mk
    from cdk_torch.kernels.mpdata import problem as mp
    from cdk_torch.kernels.mpdata import staged
    from cdk_torch.kernels.mpdata.resident import advect_resident

    for dtype in ("float32", "float64"):
        cfg = MpdataConfig(dtype=dtype, device_init=True)
        d = mp.init_data(cfg, dev)
        args = (d.f, d.u, d.w, d.rho, d.rhow, d.adz, d.flux)
        xzs = tuple(lanes.to_xzs(t) for t in args)
        f_s, u_s, w_s, (rho, rhow, adz, _) = dmp.make_dist_step(
            cfg, dmesh.make_mesh(1, dev))[0](d)
        kw = dict(nx=cfg.nx, nzm=cfg.nzm)
        cases = [("K2 n=1", lambda w: advect_resident(*args, 1, warps=w)),
                 ("K2 n=4", lambda w: advect_resident(*args, 4, warps=w)),
                 ("K6 n=1", lambda w: staged.advect_fused(*args, 1, warps=w)),
                 ("K8 n=4", lambda w: staged.advect_staged_resident(*args, 4, warps=w)),
                 ("K10", lambda w: lanes.advect_lanes(*xzs, warps=w))]
        for n in (1, 4):
            h = 3 * n
            lh, rh = (x[0] for x in dmesh.exchange_strips(f_s, h))
            f_e, u_e, w_e = (dmesh.exchange(a, h)[0] for a in (f_s, u_s, w_s))
            win = (f_e, u_e, w_e, rho, rhow, adz, -2 - h)
            split = (f_s[0], lh, rh, u_e, w_e, rho, rhow, adz, -2 - h)
            own = dict(owned_lo=h, owned_hi=h + f_s.shape[2])
            if n == 1:
                cases += [("K22", lambda w, a=win, o=own: mk.masked_step_xmajor(
                               *a, **kw, **o, warps=w)),
                          ("K23", lambda w, a=split, h=h: mk.masked_step_xmajor_split(
                               *a, **kw, halo=h, warps=w))]
            else:
                cases += [("K24 n=4", lambda w, a=win, o=own: mk.masked_kloop_xmajor(
                               *a, **kw, **o, nsteps=4, warps=w)),
                          ("K25 n=4", lambda w, a=split, h=h: mk.masked_kloop_xmajor_split(
                               *a, **kw, halo=h, nsteps=4, warps=w))]
        for tag, run in cases:
            counts = (1, 2, 4, 8, None)
            outs = [run(w) for w in counts]
            torch.cuda.synchronize()
            same = all(torch.equal(o[0], outs[0][0]) and torch.equal(o[1], outs[0][1])
                       for o in outs[1:])
            ms = {w: timed_ms(lambda w=w: run(w), REPS) for w in counts}
            print(f"[3 few] {tag:7s} S=48 nx=32 nz=58 {dtype}: "
                  + ", ".join(f"{w} warps {ms[w]:.4f}" for w in counts[:-1])
                  + f" ms a launch; own choice {ms[None]:.4f} ms; bitwise equal "
                  f"across the counts={same} [{card}]")
            if not same:
                fail(f"{tag} {dtype} at 48 slices: the warps a slice change the output")
        del d, args, xzs, f_s, u_s, w_s


def l2_read_rate(dev) -> float:
    """Bytes/s at which the card reads an L2-resident buffer of the size of
    the production CKE table (28000 x 100 f32, 11.2 MB): the probe in
    csrc/cke_rows.cu reads it 200 times over through L2 only, on eight
    blocks an SM."""
    import torch

    from cdk_torch.core import build
    from cdk_torch.core.trace import counted

    buf = torch.ones(28000 * 100, dtype=torch.float32, device=dev)
    blocks = 8 * torch.cuda.get_device_properties(dev).multi_processor_count
    sink = torch.empty(blocks * 256, dtype=torch.float32, device=dev)
    reps = 200

    @counted
    def l2_read_probe():
        build.launch(l2_read_probe, 1, "l2_read_probe", "cdk_l2_read_probe", dev,
                     buf, buf.numel() // 4, reps, blocks, sink)

    ms = timed_ms(l2_read_probe, REPS)
    if float(sink.double().sum()) != buf.numel() * reps:
        fail("the L2 read probe summed the wrong total")
    return buf.numel() * 4 * reps / (ms * 1e-3)


def cke_csr(cells, c1, c3, ncells: int):
    """The stacked connectivity [A1; A3] (2E, C) in CSR, duplicate cells of
    an edge summed: the sparse form of K12's torch.matmul yardstick."""
    import warnings

    import torch

    e, a = cells.shape
    rows = torch.arange(2 * e, device=cells.device).repeat_interleave(a)
    cols = cells.long().repeat(2, 1).reshape(-1)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # CSR is "beta"; invariants unchecked
        return torch.sparse_coo_tensor(torch.stack([rows, cols]),
                                       torch.cat([c1, c3]).reshape(-1),
                                       (2 * e, ncells)).coalesce().to_sparse_csr()


def phase_cke_kernels(dev, card):
    """K3, K11, K12 and K13 against their plain versions, with the library
    calls that compute their sums and, for K3 and K13, the floor the card's
    L2 read rate sets, and K3g (phase_cke_group); returns the JSON rows."""
    import torch

    from cdk_torch.core.config import CkeConfig
    from cdk_torch.core.norms import pointwise_check
    from cdk_torch.core.platform import exact_fp32
    from cdk_torch.kernels.cke import problem as cp
    from cdk_torch.kernels.cke.lanegather import (
        cke_lanegather,
        cke_lanegather_plain,
    )
    from cdk_torch.kernels.cke.onehot import cke_onehot, cke_onehot_plain
    from cdk_torch.kernels.cke.onehot_mxu import build_connectivity_matrices
    from cdk_torch.kernels.cke.reference import coef3_of, fsign1
    from cdk_torch.kernels.cke.rows import cke_rows, cke_rows_plain
    from cdk_torch.kernels.cke.staged import (
        cke_staged,
        cke_staged_plain,
        stage_slots,
    )

    rows = {}
    l2_rate = l2_read_rate(dev)
    print(f"[3 L2] read rate over an L2-resident 11.2 MB buffer: {l2_rate / 1e12:.3f} TB/s "
          f"[{card}]")
    shapes = (("shipped", (25600, 2800), ("float32", "float64")),
              ("production", (256000, 28000), ("float32",)))
    for label, (nedges, ncells), dtypes in shapes:
        for dtype in dtypes:
            cfg = CkeConfig(nedges=nedges, ncells=ncells, dtype=dtype,
                            device_init=True)
            d = cp.init_data(cfg, dev)
            c3 = coef3_of(cfg)
            t = d.tracer * d.cell_mask
            edge = (d.adv_coefs, d.adv_coefs3)
            ef = (d.ntf, d.adv_mask)
            cases = {"K3": (lambda: cke_rows(d.adv_cells, *edge, t, *ef, c3),
                            lambda: cke_rows_plain(d.adv_cells, *edge, t, *ef, c3))}
            trans = (d.adv_cells.T.contiguous(), d.adv_coefs.T.contiguous(),
                     d.adv_coefs3.T.contiguous(), t.T.contiguous(),
                     (d.ntf * d.adv_mask).T.contiguous(),
                     fsign1(d.ntf).T.contiguous())
            cases["K13"] = (lambda: cke_lanegather(*trans, c3),
                            lambda: cke_lanegather_plain(*trans, c3))
            if label == "shipped":
                staged = stage_slots(t, d.adv_cells, torch.empty(
                    (cfg.nadv, cfg.nedges, cfg.nvertlevels), dtype=t.dtype,
                    device=dev))
                cases["K11"] = (lambda: cke_staged(staged, *edge, *ef, c3),
                                lambda: cke_staged_plain(staged, *edge, *ef, c3))
                cases["K12"] = (
                    lambda: cke_onehot(d.adv_cells, *edge, t, *ef, c3),
                    lambda: cke_onehot_plain(d.adv_cells, *edge, t, *ef, c3))
                if dtype == "float32":
                    cases["K12 bf16"] = (
                        lambda: cke_onehot(d.adv_cells, *edge, t, *ef, c3, True),
                        lambda: cke_onehot_plain(d.adv_cells, *edge, t, *ef, c3,
                                                 True))
            for name, (kernel, plain) in cases.items():
                out = kernel()
                ref = plain()
                torch.cuda.synchronize()
                if name == "K13":  # (K, E) -> (E, K)
                    out, ref = out.T, ref.T
                rel, mae, big = errors(out, ref, "l1")
                bitwise = torch.equal(out, ref)
                if name == "K12 bf16":
                    gate, measure, err = 1e-2, "rel_l1", rel
                elif dtype == "float64":
                    # the reference's per-point check; a violation or NaN
                    # fails it whatever the maximum reads
                    gate, measure = cfg.errtol, "max_rel"
                    n_bad, err, _ = pointwise_check(out, ref, gate)
                    err = err if n_bad == 0 else float("inf")
                else:
                    gate, measure, err = 1e-6, "rel_l1", rel
                ms = timed_ms(kernel, REPS)
                plain_ms = timed_ms(plain, REPS)
                ok = (err < gate and big > 0
                      and bool(torch.isfinite(out).all()))
                print(f"[3 {name}] {label:10s} {nedges}x{ncells}x"
                      f"{cfg.nvertlevels} A={cfg.nadv} {dtype:7s}: {measure} "
                      f"{err:.3e} (gate {gate:g}) max_abs {mae:.3e} of "
                      f"{big:.3e} bitwise={bitwise}; kernel {ms:.4f} ms, "
                      f"plain {plain_ms:.4f} ms [{card}]")
                if not ok:
                    fail(f"{name} {label} {dtype}: {measure} {err:.3e}")
                key = name.split()[0]
                if name == "K12":
                    # the library call: one exact product of the stacked
                    # prebuilt connectivity matrices [A1; A3] by the table
                    exact_fp32()
                    a13 = torch.cat(build_connectivity_matrices(
                        d.adv_cells, *edge, cfg.ncells))
                    lib_ms = timed_ms(lambda: torch.matmul(a13, t), REPS)
                    del a13
                    print(f"[3 K12] {label:10s} {dtype:7s}: torch.matmul of the "
                          f"prebuilt [A1; A3] {lib_ms:.4f} ms, kernel {ms:.4f} ms "
                          f"({ms / lib_ms:.4f} of it) [{card}]")
                    if dtype == "float64":
                        rows["K12"].update(ms_f64=ms, plain_ms_f64=plain_ms,
                                           library_ms_f64=lib_ms)
                    else:
                        lib = dict(library_ms=lib_ms, library="torch.matmul, "
                                   "prebuilt [A1; A3]")
                elif name == "K11" and dtype == "float32":
                    # the library call of its sums: one einsum of the
                    # stacked coefficients by the staged rows
                    c13 = torch.stack(edge)
                    lib_ms = timed_ms(lambda: torch.einsum("sea,aek->sek", c13, staged),
                                      REPS)
                    del c13
                    print(f"[3 K11] {label:10s} {dtype:7s}: torch.einsum of the stacked "
                          f"coefficients by the staged rows {lib_ms:.4f} ms, kernel "
                          f"{ms:.4f} ms [{card}]")
                    lib = dict(library_ms=lib_ms, library="torch.einsum, stacked "
                               "[c1; c3] by the staged rows")
                elif key in ("K3", "K13") and label == "production":
                    # the library call of their sums: the sparse product of
                    # the prebuilt CSR [A1; A3] by the table (first checked
                    # against the sums on a slice of edges); and the floor the
                    # gathered rows set, E * A rows of K values read from L2
                    if name == "K3":
                        a13 = cke_csr(d.adv_cells, *edge, cfg.ncells)
                        got = torch.sparse.mm(a13, t)
                        part = t[d.adv_cells[:1000].long()]
                        want = torch.cat([(c[:1000, :, None] * part).sum(1) for c in edge])
                        gap = float((torch.cat([got[:1000], got[cfg.nedges:cfg.nedges + 1000]])
                                     - want).abs().max() / want.abs().max())
                        if gap > 1e-5:
                            fail(f"torch.sparse.mm of [A1; A3] is off the sums by {gap:.3e}")
                        del got, part, want
                        sparse_ms = timed_ms(lambda: torch.sparse.mm(a13, t), REPS)
                        del a13
                        floor_ms = (cfg.nedges * cfg.nadv * cfg.nvertlevels
                                    * t.element_size() / l2_rate * 1e3)
                    lib = dict(library_ms=sparse_ms, library="torch.sparse.mm, "
                               "prebuilt CSR [A1; A3]", l2_floor_ms=floor_ms)
                if ((key in ("K3", "K13") and label == "production")
                        or (key in ("K11", "K12") and name == key
                            and dtype == "float32")):
                    if key == "K11":
                        inputs = (staged, *edge, *ef)
                    elif key == "K13":
                        inputs = trans
                    else:
                        inputs = (d.adv_cells, *edge, t, *ef)
                    rows[key] = dict(
                        max_abs_err=mae, ms=ms, plain_ms=plain_ms, **lib,
                        **bound(inputs + (out,),
                                cke_ops(cfg.nedges, cfg.nvertlevels, cfg.nadv)))
                    if key in ("K3", "K13"):
                        print(f"[3 {name}] {label:10s} {dtype:7s}: kernel {ms:.4f} ms; bound "
                              f"{rows[key]['bound_ms']:.4f} ms (bytes once); gathered-row "
                              f"floor {floor_ms:.4f} ms (E*A*K values at the L2 read rate); "
                              f"torch.sparse.mm of the prebuilt CSR [A1; A3] "
                              f"{sparse_ms:.4f} ms [{card}]")
                del out, ref
            del d, t, edge, ef, trans, cases
            if label == "shipped":
                del staged
    rows["K3"].update(phase_cke_mesh(dev, card, l2_rate))
    rows.update(phase_cke_group(dev, card))
    return rows


def phase_cke_mesh(dev, card, l2_rate: float) -> dict:
    """K3 as the benchmark cell mpaso.tracers runs it: on MPAS-Tools'
    periodic hexagonal mesh of EC30to60E2r2's size (486 x 488 cells,
    711,504 edges, nAdv 10) at 60 levels, f32, one tracer of a group of
    two written through out= into its slice of the (T, E, K) flux.  Held
    bitwise to its plain version, the other slice left untouched; timed
    beside its bound, the gathered-row floor and torch.sparse.mm of the
    prebuilt CSR [A1; A3].  Returns the K3 row's mpaso_* entries."""
    import torch

    from cdk_torch.core.config import CkeConfig
    from cdk_torch.kernels.cke import problem as cp
    from cdk_torch.kernels.cke.reference import coef3_of
    from cdk_torch.kernels.cke.rows import cke_rows, cke_rows_plain

    cfg = CkeConfig(mesh="planar_hex", nx=486, ny=488, nvertlevels=60,
                    ntracers=2, dtype="float32", device_init=True)
    d = cp.init_data(cfg, dev)
    c3 = coef3_of(cfg)
    t = d.tracer[1] * d.cell_mask
    args = (d.adv_cells, d.adv_coefs, d.adv_coefs3, t, d.ntf, d.adv_mask, c3)
    group = torch.full((2, cfg.nedges, cfg.nvertlevels), float("nan"),
                       dtype=t.dtype, device=dev)

    def kernel():
        return cke_rows(*args, out=group[1])

    out = kernel()
    ref = cke_rows_plain(*args)
    torch.cuda.synchronize()
    rel, mae, big = errors(group[1], ref, "l1")
    bitwise = torch.equal(group[1], ref)
    into = out.data_ptr() == group[1].data_ptr()
    untouched = bool(group[0].isnan().all())
    ms = timed_ms(kernel, REPS)
    a13 = cke_csr(d.adv_cells, d.adv_coefs, d.adv_coefs3, cfg.ncells)
    sparse_ms = timed_ms(lambda: torch.sparse.mm(a13, t), REPS)
    del a13
    floor_ms = cfg.nedges * cfg.nadv * cfg.nvertlevels * t.element_size() / l2_rate * 1e3
    here = bound((*args[:-1], group[1]),
                 cke_ops(cfg.nedges, cfg.nvertlevels, cfg.nadv))
    print(f"[3 K3] mpaso_ec30to60 486x488 hex {cfg.nedges}x{cfg.ncells}x"
          f"{cfg.nvertlevels} A={cfg.nadv} float32, out= a group slice: rel_l1 "
          f"{rel:.3e} max_abs {mae:.3e} of {big:.3e} bitwise={bitwise} "
          f"into_slice={into} other_slice_untouched={untouched}; kernel {ms:.4f} ms; "
          f"bound {here['bound_ms']:.4f} ms (bytes once); gathered-row floor "
          f"{floor_ms:.4f} ms; torch.sparse.mm of the prebuilt CSR [A1; A3] "
          f"{sparse_ms:.4f} ms [{card}]")
    if not (bitwise and into and untouched and big > 0):
        fail(f"K3 on the mpaso_ec30to60 mesh through out=: bitwise={bitwise} "
             f"into_slice={into} other_slice_untouched={untouched}")
    return dict(mpaso_ms=ms, mpaso_bound_ms=here["bound_ms"],
                mpaso_library_ms=sparse_ms, mpaso_l2_floor_ms=floor_ms)


def phase_cke_group(dev, card) -> dict:
    """K3g as the benchmark cell mpaso.tracers runs it: the flux of all 32
    tracers of the group on the 486 x 488 periodic hexagonal mesh at 60
    levels, f32, in one launch through the family's loop.  Held bit for
    bit, tracer by tracer, to its plain version through the same tile map,
    and to the per-tracer K3 path (K3 once a tracer on its masked table,
    through out= into its slice); timed beside the cell's bound (every
    table, the mask and the edge fields read once, the (T, E, K) flux
    written once), the per-tracer K3 path and the plain version on the
    whole group.  Returns K3g's row of PERF.md's kernel table."""
    import torch

    import cdk_torch.kernels  # noqa: F401  (registers the variants)
    from cdk_torch.core import registry, trace
    from cdk_torch.core.config import CkeConfig
    from cdk_torch.harness.specs import get_spec
    from cdk_torch.kernels.cke import group
    from cdk_torch.kernels.cke import problem as cp
    from cdk_torch.kernels.cke.reference import coef3_of
    from cdk_torch.kernels.cke.rows import cke_rows

    cfg = CkeConfig(mesh="planar_hex", nx=486, ny=488, nvertlevels=60,
                    ntracers=32, dtype="float32", device_init=True)
    d = cp.init_data(cfg, dev)
    c3 = coef3_of(cfg)
    step2, aux, _ = registry._materialize(registry.get("cke", "pallas_rows"), cfg, d)
    before, launches = trace.counts(), group.cke_group.launches
    got = get_spec("cke").loop_runner(step2, aux, 1)(d)
    torch.cuda.synchronize()
    after = trace.counts()
    one = (group.cke_group.launches - launches == 1
           and all(after.get(k, 0) - before.get(k, 0) == 1
                   for k in ("cke_group_launches", "cke_mesh_passes")))
    tm = aux(d.adv_cells, d.tracer)
    edge = (d.adv_coefs, d.adv_coefs3)
    ef = (d.cell_mask, d.ntf, d.adv_mask)
    plain_bitwise = all(
        torch.equal(got[i], group.cke_group_plain(tm, *edge, d.tracer[i:i + 1], *ef, c3)[0])
        for i in range(cfg.ntracers))

    def per_tracer(out):
        for dst, tracer in zip(out, d.tracer):
            cke_rows(d.adv_cells, *edge, tracer * d.cell_mask, *ef[1:], c3, out=dst)
        return out

    ref = per_tracer(torch.empty_like(got))
    torch.cuda.synchronize()
    k3_bitwise = torch.equal(got, ref)
    _, mae, big = errors(got, ref, "l1")
    ms = timed_ms(lambda: group.cke_group(tm, *edge, d.tracer, *ef, c3), 5)
    k3_ms = timed_ms(lambda: per_tracer(ref), 3)
    here = bound((d.adv_cells, *edge, d.tracer, *ef, got),
                 cfg.ntracers * cke_ops(cfg.nedges, cfg.nvertlevels, cfg.nadv))
    del got, ref
    plain_ms = timed_ms(lambda: group.cke_group_plain(tm, *edge, d.tracer, *ef, c3), 1)
    print(f"[3 K3g] mpaso_ec30to60 486x488 hex {cfg.nedges}x{cfg.ncells}x"
          f"{cfg.nvertlevels} A={cfg.nadv} float32, {cfg.ntracers} tracers through the "
          f"family's loop: bitwise its plain version={plain_bitwise}, bitwise the "
          f"per-tracer K3 path={k3_bitwise}, one launch and one pass={one}, tile "
          f"{tm.tile} edges, widest stage {tm.width} cells; kernel {ms:.4f} ms; bound "
          f"{here['bound_ms']:.4f} ms ({here['bound_by']}, "
          f"{100 * here['bound_ms'] / ms:.1f} %); the per-tracer K3 path ({cfg.ntracers} "
          f"masked tables and K3 launches) {k3_ms:.4f} ms; plain version on the whole "
          f"group {plain_ms:.4f} ms [{card}]")
    if not (plain_bitwise and k3_bitwise and one and big > 0):
        fail(f"K3g on the mpaso_ec30to60 mesh: bitwise plain={plain_bitwise} "
             f"K3={k3_bitwise} one_launch={one}")
    return {"K3g": dict(max_abs_err=mae, ms=ms, plain_ms=plain_ms, per_tracer_k3_ms=k3_ms,
                        **here)}


def phase_cube(dev, card) -> dict:
    """K26 as the benchmark cell homme.hv_cube runs it: one step over the
    ne30np4 cube (5,400 elements, 40 tracers x 72 levels, f32, rrearth
    0.1) with A² and with A, against its plain version within the
    registered 5e-5; timed beside its bound (the state in and out once, the
    operator, W and the map; the bf16x3 apply and the cube DSS's least) and
    the plain version.  Returns K26's row of PERF.md's kernel table."""
    import torch

    from cdk_torch.core.config import BiharmonicConfig
    from cdk_torch.kernels.biharmonic import cube
    from cdk_torch.kernels.biharmonic import dss_cube as dc
    from cdk_torch.kernels.biharmonic import problem as bp
    from cdk_torch.kernels.biharmonic.operator import precompose_operator

    cfg = BiharmonicConfig(nelemd=5400, qsize=40, nlev=72, rrearth=0.1,
                           dtype="float32", device_init=True)
    d = bp.init_data(cfg, dev)
    L = dc.build_element_operator(d.dvv, d.dinv, d.spheremp, d.tensorvisc, 0.1)
    A2 = precompose_operator(L)
    amap = cube.build_map(cfg.nelemd, dev)
    w = dc.dss_cube_weights(d.spheremp, amap).contiguous()
    t = bp.lane_of(d.qtens)
    errs = []
    for name, op in (("A2", A2), ("A", L)):
        out, ref = dc.dss_cube_step(op, amap, w, t), dc.dss_cube_step_plain(op, amap, w, t)
        torch.cuda.synchronize()
        errs.append((name, *errors(out, ref, "l2")))
        del out, ref
    ms = timed_ms(lambda: dc.dss_cube_step(A2, amap, w, t), REPS)
    plain_ms = timed_ms(lambda: dc.dss_cube_step_plain(A2, amap, w, t), 3)
    cols = cfg.nelemd * cfg.ncol
    here = bound((t, t, A2, w, amap), **apply_ops(cols, "bf16x3", 1, CUBE_DSS))
    print(f"[3 K26] homme_ne30np4_cube {cfg.nelemd}x{cfg.ncol} float32, one step: "
          + ", ".join(f"{n} rel_l2 {r:.3e} max_abs {m:.3e} of {b:.3e}" for n, r, m, b in errs)
          + f" (gate 5e-05); kernel {ms:.4f} ms; bound {here['bound_ms']:.4f} ms "
          f"({here['bound_by']}, {100 * here['bound_ms'] / ms:.1f} %); plain {plain_ms:.4f} ms "
          f"[{card}]")
    if not all(r < 5e-5 and b > 0 for _, r, _, b in errs):
        fail(f"K26 on the ne30np4 cube: {errs}")
    return {"K26": dict(max_abs_err=max(m for _, _, m, _ in errs), ms=ms,
                        plain_ms=plain_ms, **here)}


def phase_dss_kernels(dev, card):
    """K14, K19 and the rowchain kernels K15-K18 against their plain
    versions: each kernel's single launch at the real radius, the launch
    depth each loop uses (and the rowchain step against that many depth-1
    launches), and every resident and rowchain loop(n) against n chained
    plain steps; returns the JSON rows."""
    import torch

    import cdk_torch.kernels  # noqa: F401  (registers the variants)
    from cdk_torch.core import registry
    from cdk_torch.core.config import BiharmonicConfig, with_overrides
    from cdk_torch.kernels.biharmonic import dss2d_resident as dr2
    from cdk_torch.kernels.biharmonic import dss2d_rowchain as rc
    from cdk_torch.kernels.biharmonic import dss_resident as dr
    from cdk_torch.kernels.biharmonic import problem as bp
    from cdk_torch.kernels.biharmonic.dss2d import torus_shape

    rows = {}
    gates = {("float64", "highest"): 1e-13, ("float32", "highest"): 1e-6,
             ("float32", "bf16x3"): 5e-5}
    forms = {"": ("highest", False), "_x3": ("bf16x3", False),
             "_sq": ("highest", True), "_sq_x3": ("bf16x3", True)}

    def check(tag, what, gate, kernel, plain, time_it=True):
        out, ref = kernel(), plain()
        torch.cuda.synchronize()
        rel, mae, big = errors(out, ref, "l2")
        ms = timed_ms(kernel, REPS) if time_it else float("nan")
        plain_ms = timed_ms(plain, REPS) if time_it else float("nan")
        times = (f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms" if time_it
                 else "not timed")
        print(f"[3 {tag}] {what}: rel_l2 {rel:.3e} (gate {gate:g}) max_abs "
              f"{mae:.3e} of {big:.3e}; {times} [{card}]")
        if not (rel < gate and big > 0 and bool(torch.isfinite(out).all())):
            fail(f"{tag} {what}: rel_l2 {rel:.3e}")
        return out, dict(max_abs_err=mae, ms=ms, plain_ms=plain_ms)

    def check_loops(tag, what, gate, loop, chained, n_list):
        errs = []
        for n in n_list:
            got = bp.to_lane_layout(loop(n))
            want = chained(n)
            torch.cuda.synchronize()
            rel, _, big = errors(got, want, "l2")
            errs.append(f"n={n} {rel:.3e}")
            if not (rel < gate and big > 0 and bool(torch.isfinite(got).all())):
                fail(f"{tag} {what} loop n={n}: rel_l2 {rel:.3e}")
        print(f"[3 {tag} loop] {what} vs chained plain steps: "
              f"{', '.join(errs)} (gate {gate:g})")

    def loop_ns(k):
        return sorted({1, 2, k, k + 1, 2 * k + 1})

    def variant(family, name, cfg):
        return registry.get(family, name).fn(cfg)

    for label, nelemd, qsize, dtypes in (("shipped", 16, 40, ("float32", "float64")),
                                         ("production", 5400, 10, ("float32",))):
        for dtype in dtypes:
            # single launches at the real radius; chains at rrearth = 0.1:
            # with the real radius every application scales q by
            # ~rrearth^2 and an f32 chain of more than three applications
            # sinks below f32's range; at 1 a 9-step production chain grows
            # past it (~3e4 per step)
            real = BiharmonicConfig(nelemd=nelemd, qsize=qsize, dtype=dtype,
                                    device_init=True)
            chain = with_overrides(real, rrearth=0.1)
            data = bp.init_data(real, dev)
            q = bp.to_lane_layout(data.qtens)
            cols = q.numel() / 16  # element-columns
            ex, ey = torus_shape(real.nelemd)
            shape = f"{label:10s} e={nelemd} ncol={real.ncol} {dtype}"
            for suffix, (prec, sq) in forms.items():
                if (dtype, prec) not in gates:
                    continue
                gate = gates[dtype, prec]
                L, w, L2 = variant("biharmonic_dss", "fused_operator_bd8_resident"
                                   + suffix, real)["prepare"](data)
                check("K14", f"{shape} {prec} sq={sq} n=1 real radius", gate,
                      lambda: dr.dss_resident(L, w, q, 1, prec, L2),
                      lambda: dr.dss_resident_plain(L, w, q, 1, prec, L2),
                      time_it=False)
                m = variant("biharmonic_dss", "fused_operator_bd8_resident" + suffix,
                            chain)
                L, w, L2 = m["prepare"](data)
                k = dr.DEPTH
                _, row = check("K14", f"{shape} {prec} sq={sq} n={k}", gate,
                               lambda: dr.dss_resident(L, w, q, k, prec, L2),
                               lambda: dr.dss_resident_plain(L, w, q, k, prec, L2))
                if (label, suffix) == ("production", "_sq_x3"):
                    # A·D·(A²·D)^(k-1)·A: k+1 applications, k ring DSS
                    rows["K14"] = dict(row, steps_timed=k, **bound(
                        (L, w, L2, q, q),
                        **apply_ops(cols, prec, k + 1, k * RING_DSS)))
                check_loops("K14", f"{shape} resident{suffix}", gate,
                            lambda n: m["loop"](data, n),
                            lambda n: dr.dss_resident_plain(L, w, q, n, prec, L2),
                            loop_ns(k))

                if not sq:
                    name = "fused_operator_bd8_resident" + suffix
                    L, w = variant("biharmonic_dss2d", name, real)["prepare"](data)
                    check("K19", f"{shape} {prec} n=1 real radius", gate,
                          lambda: dr2.dss2d_resident(L, w, q, ex, ey, 1, prec),
                          lambda: dr2.dss2d_resident_plain(L, w, q, ex, ey, 1, prec),
                          time_it=False)
                    m = variant("biharmonic_dss2d", name, chain)
                    L, w = m["prepare"](data)
                    k = dr2.loop_depth(ey)
                    _, row = check(
                        "K19", f"{shape} {prec} n={k}", gate,
                        lambda: dr2.dss2d_resident(L, w, q, ex, ey, k, prec),
                        lambda: dr2.dss2d_resident_plain(L, w, q, ex, ey, k, prec))
                    if (label, suffix) == ("production", "_x3"):
                        rows["K19"] = dict(row, **bound(
                            (L, w, q, q),
                            **apply_ops(cols, prec, 2 * k, k * TORUS_DSS)))
                    check_loops(
                        "K19", f"{shape} resident{suffix}", gate,
                        lambda n: m["loop"](data, n),
                        lambda n: dr2.dss2d_resident_plain(L, w, q, ex, ey, n, prec),
                        loop_ns(k))

                name = "fused_operator_rowchain" + suffix
                L, w, F = variant("biharmonic_dss2d", name, real)["prepare"](data)
                if not sq:  # the bridges apply A in both the plain and A^2 forms
                    t, row = check("K15", f"{shape} {prec} bridge_in real radius", gate,
                                   lambda: rc.rowchain_bridge_in(L, q, ex, ey, prec),
                                   lambda: rc.rowchain_bridge_in_plain(L, q, ex, ey, prec))
                    if (label, prec) == ("production", "bf16x3"):
                        rows["K15"] = dict(row, **bound(
                            (L, q, t), **apply_ops(cols, prec, 1, J_PASS)))
                    _, row = check("K17", f"{shape} {prec} bridge_out real radius", gate,
                                   lambda: rc.rowchain_bridge_out(L, w, t, ex, ey, prec),
                                   lambda: rc.rowchain_bridge_out_plain(L, w, t, ex, ey, prec))
                    if (label, prec) == ("production", "bf16x3"):
                        rows["K17"] = dict(row, **bound(
                            (L, w, t, q), **apply_ops(cols, prec, 1, I_PASS)))
                # one step of q itself: from bridge-in's output the step's
                # third application would reach f32's subnormals
                check("K16", f"{shape} {prec} sq={sq} step depth 1 real radius", gate,
                      lambda: rc.rowchain_step(F, w, q, ex, ey, 1, prec, sq),
                      lambda: rc.rowchain_step_plain(F, w, q, ex, ey, 1, prec, sq),
                      time_it=False)
                m = variant("biharmonic_dss2d", name, chain)
                L, w, F = m["prepare"](data)
                t0 = rc.rowchain_bridge_in(L, q, ex, ey, prec)
                depth = rc.loop_depth(prec, sq)
                one = t0
                for k in range(1, depth + 1):
                    tag = "K16" if k == 1 else "K18"
                    out, row = check(
                        tag, f"{shape} {prec} sq={sq} step depth {k}", gate,
                        lambda: rc.rowchain_step(F, w, t0, ex, ey, k, prec, sq),
                        lambda: rc.rowchain_step_plain(F, w, t0, ex, ey, k, prec, sq))
                    one = rc.rowchain_step(F, w, one, ex, ey, 1, prec, sq)
                    if not torch.equal(out, one):
                        fail(f"{tag} {shape} depth {k} differs from {k} depth-1 launches")
                    if label == "production" and (
                            (k == 1 and suffix == "_sq_x3")
                            or (k == depth > 1 and suffix == "_sq")):
                        rows[tag] = dict(row, steps_timed=k, **bound(
                            (F, w, t0, out),
                            **apply_ops(cols, prec, k, k * (I_PASS + J_PASS))))
                print(f"[3 K16/K18] {shape} {prec} sq={sq}: depth 1..{depth} "
                      f"each bitwise equal to that many depth-1 launches")

                def chained(n, L=L, w=w, F=F, prec=prec, sq=sq):
                    t = rc.rowchain_bridge_in_plain(L, q, ex, ey, prec)
                    t = rc.rowchain_step_plain(F, w, t, ex, ey, n - 1, prec, sq)
                    return rc.rowchain_bridge_out_plain(L, w, t, ex, ey, prec)

                check_loops("K15-K18", f"{shape} rowchain{suffix}", gate,
                            lambda n: m["loop"](data, n), chained,
                            loop_ns(depth))
            del data, q
    return rows


def phase_depth_sweep(dev, card):
    """The launch depths of the redesigned DSS kernels at production f32
    (5400 x 72 x 10, rrearth 0.1 as the loops run), in us per step: K14 at 2
    to 8 steps per launch in its precomposed forms (sq_x3 on the tensor
    cores, sq exact), and the rowchain step (K16 at depth 1, K18 deeper) in
    its four forms at depths 1, 2, 3, 4 and 8.  `dss_resident.DEPTH` and
    `dss2d_rowchain.loop_depth` are set from these."""
    import torch

    import cdk_torch.kernels  # noqa: F401  (registers the variants)
    from cdk_torch.core import registry
    from cdk_torch.core.config import BiharmonicConfig, with_overrides
    from cdk_torch.kernels.biharmonic import dss2d_rowchain as rc
    from cdk_torch.kernels.biharmonic import dss_resident as dr
    from cdk_torch.kernels.biharmonic import problem as bp
    from cdk_torch.kernels.biharmonic.dss2d import torus_shape

    t0 = time.perf_counter()
    cfg = with_overrides(BiharmonicConfig(nelemd=5400, qsize=10, dtype="float32",
                                          device_init=True), rrearth=0.1)
    data = bp.init_data(cfg, dev)
    q = bp.to_lane_layout(data.qtens)
    ex, ey = torus_shape(cfg.nelemd)

    def per_step(fn, depths):
        return " / ".join(f"{timed_ms(lambda: fn(k), REPS) / k * 1e3:.1f}" for k in depths)

    L, w, L2 = registry.get("biharmonic_dss", "fused_operator_bd8_resident_sq").fn(
        cfg)["prepare"](data)
    for prec, form in (("bf16x3", "sq_x3"), ("highest", "sq")):
        us = per_step(lambda k: dr.dss_resident(L, w, q, k, prec, L2), range(2, 9))
        print(f"[3 sweep] K14 {form} production f32, us per step at 2 / 3 / ... / 8 "
              f"steps per launch: {us} [{card}]")
    L, w, F = registry.get("biharmonic_dss2d", "fused_operator_rowchain_sq").fn(
        cfg)["prepare"](data)
    t = rc.rowchain_bridge_in(L, q, ex, ey)
    for prec, sq, form in (("highest", False, "A.A"), ("bf16x3", False, "x3"),
                           ("highest", True, "sq"), ("bf16x3", True, "sq_x3")):
        op = F if sq else L
        us = per_step(lambda k: rc.rowchain_step(op, w, t, ex, ey, k, prec, sq),
                      (1, 2, 3, 4, 8))
        print(f"[3 sweep] rowchain step {form} production f32, us per step at depth "
              f"1 / 2 / 3 / 4 / 8: {us} [{card}]")
    torch.cuda.synchronize()
    del data, q, L, w, L2, F, t
    k19_window_sweep(dev, card)
    print(f"[3 sweep] {time.perf_counter() - t0:.1f} s")


def k19_window_sweep(dev, card):
    """K19's bf16x3 form, us per step at 1, 2 and 3 steps a launch in the
    window its launcher picks, each output held to the plain version at the
    bf16x3 gate: at production (75 x 72, no whole row fits: the 8 x 8) and
    at the shipped 4 x 4 torus (whole rows, also 4 steps), rrearth 0.1 as
    the loops run.  dss2d_resident.RECT_DEPTH / DEPTH are set from these;
    the window shapes that were not kept are measured by
    scripts/torch_dss2d_window_variants.py."""
    import torch

    import cdk_torch.kernels  # noqa: F401  (registers the variants)
    from cdk_torch.core import registry
    from cdk_torch.core.config import BiharmonicConfig, with_overrides
    from cdk_torch.kernels.biharmonic import dss2d_resident as dr2
    from cdk_torch.kernels.biharmonic import problem as bp
    from cdk_torch.kernels.biharmonic.dss2d import torus_shape

    for label, nelemd, qsize in (("production", 5400, 10), ("shipped", 16, 40)):
        cfg = with_overrides(BiharmonicConfig(nelemd=nelemd, qsize=qsize, dtype="float32",
                                              device_init=True), rrearth=0.1)
        data = bp.init_data(cfg, dev)
        q = bp.to_lane_layout(data.qtens)
        ex, ey = torus_shape(nelemd)
        L, w = registry.get("biharmonic_dss2d", "fused_operator_bd8_resident_x3").fn(
            cfg)["prepare"](data)
        cells = []
        for k in (1, 2, 3, 4) if label == "shipped" else (1, 2, 3):
            ref = dr2.dss2d_resident_plain(L, w, q, ex, ey, k, "bf16x3")
            out = dr2.launch(L, w, q, ex, ey, k, "bf16x3")
            torch.cuda.synchronize()
            rel, _, big = errors(out, ref, "l2")
            if not (rel < 5e-5 and big > 0):
                fail(f"K19 {label} k={k}: rel_l2 {rel:.3e}")
            us = timed_ms(lambda: dr2.launch(L, w, q, ex, ey, k, "bf16x3"), REPS) / k * 1e3
            cells.append(f"k={k} {us:.1f} (rel_l2 {rel:.1e})")
            del ref, out
        print(f"[3 sweep] K19 x3 {label} {ex}x{ey} ncol={cfg.ncol} "
              f"({'whole rows' if dr2.row_steps(ey) else '8 x 8'} window), us per "
              f"step: {'; '.join(cells)} [{card}]")
        del data, q, L, w
    # the exact forms' launch depth at the shipped torus (their windows are
    # fixed: whole rows of 4)
    for dtype in ("float32", "float64"):
        cfg = with_overrides(BiharmonicConfig(nelemd=16, qsize=40, dtype=dtype,
                                              device_init=True), rrearth=0.1)
        data = bp.init_data(cfg, dev)
        q = bp.to_lane_layout(data.qtens)
        L, w = registry.get("biharmonic_dss2d", "fused_operator_bd8_resident").fn(
            cfg)["prepare"](data)
        us = " / ".join(
            f"{timed_ms(lambda: dr2.dss2d_resident(L, w, q, 4, 4, k), REPS) / k * 1e3:.1f}"
            for k in (1, 2, 3, 4))
        print(f"[3 sweep] K19 exact shipped 4x4 {dtype}, us per step at 1 / 2 / 3 / 4 "
              f"steps a launch: {us} [{card}]")


def ring_cone_ops(e: int, ncol: int, k: int, prec: str) -> dict:
    """bound()'s operations for k steps of the d-carry ring chain
    A·D·(A²·D)^(k-1)·A whose e owned elements come out exact: each step
    reaches one element further on each side, so application i of the k+1
    covers e + 2(k-i) elements (the last e) and assembly j e + 2(k-j)."""
    applies = (k + 1) * e + k * (k + 1)
    dss = k * e + k * (k - 1)
    return apply_ops(applies * ncol, prec, 1, dss * RING_DSS / applies)


def rowchain_cone_ops(ex: int, ey: int, ncol: int, k: int, prec: str) -> dict:
    """bound()'s operations for k t-steps (A² once each) of a shard's ex
    owned rows: step j computes ex + 2(k-1-j) rows."""
    rows = sum(ex + 2 * (k - 1 - j) for j in range(k))
    return apply_ops(rows * ey * ncol, prec, 1, I_PASS + J_PASS)


def phase_dist_dss_kernels(dev, card):
    """The window-fed K14 (K14w) and the padded rowchain K16p, K17p, K18p
    against their plain versions on the shard windows the decomposed DSS
    loops hand them (the shipped 16 x 72 x 40 at f32 and f64 on 1 and 2
    shards, the production 5400 x 72 x 10 at f32 on 1 and 4 ring shards, 1
    and 3 torus row shards), in the forms the loops run (the precomposed A²,
    exact and bf16x3, at rrearth 0.1): K14w at kstep 8 on an inner shard,
    split and padded operands bitwise equal, and on 1 shard bitwise equal to
    K14 on the ring; K18p at the loop's depth, bitwise equal to that many
    K16p launches on shrinking windows.  Returns the JSON rows (production
    f32 bf16x3 on 1 shard)."""
    import torch

    from cdk_torch.core.config import BiharmonicConfig
    from cdk_torch.dist import biharmonic as dbi
    from cdk_torch.dist import mesh as dmesh
    from cdk_torch.kernels.biharmonic import dss2d_rowchain as rc
    from cdk_torch.kernels.biharmonic import dss_resident as dr
    from cdk_torch.kernels.biharmonic import problem as bp
    from cdk_torch.kernels.biharmonic.dss2d import torus_shape
    from cdk_torch.kernels.biharmonic.operator import precompose_operator

    rows = {}
    gates = {("float64", "highest"): 1e-13, ("float32", "highest"): 1e-6,
             ("float32", "bf16x3"): 5e-5}
    t0 = time.perf_counter()

    def check(tag, what, gate, kernel, plain, own=None):
        out, ref = kernel(), plain()
        torch.cuda.synchronize()
        got = out if own is None else out[own]
        rel, mae, big = errors(got, ref, "l2")
        ms, plain_ms = timed_ms(kernel, REPS), timed_ms(plain, REPS)
        print(f"[3 {tag}] {what}: rel_l2 {rel:.3e} (gate {gate:g}) max_abs "
              f"{mae:.3e} of {big:.3e} bitwise={torch.equal(got, ref)}; kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms [{card}]")
        if not (rel < gate and big > 0 and bool(torch.isfinite(got).all())):
            fail(f"{tag} {what}: rel_l2 {rel:.3e}")
        return out, dict(max_abs_err=mae, ms=ms, plain_ms=plain_ms)

    k = 8  # the dss leg's kstep
    for label, nelemd, qsize, dtypes, ring_P, torus_P in (
            ("shipped", 16, 40, ("float32", "float64"), (1, 2), (1, 2)),
            ("production", 5400, 10, ("float32",), (1, 4), (1, 3))):
        for dtype in dtypes:
            cfg = BiharmonicConfig(nelemd=nelemd, qsize=qsize, dtype=dtype,
                                   device_init=True, rrearth=0.1)
            data = bp.init_data(cfg, dev)
            ex, ey = torus_shape(nelemd)
            for prec in ("highest", "bf16x3"):
                if (dtype, prec) not in gates:
                    continue
                gate = gates[dtype, prec]
                for P in ring_P:
                    m = dmesh.make_mesh(P, dev)
                    q_s, (L_s, w_s) = dbi.make_dist_step_dss(cfg, m)[0](data)
                    p = min(1, P - 1)  # an inner shard where there is one
                    L2_s = precompose_operator(L_s.reshape(-1, 16, 16)).reshape(L_s.shape)
                    Le, L2e, we = (dmesh.ring_exchange(x, k)[p] for x in (L_s, L2_s, w_s))
                    hl, hr = (s[p] for s in dmesh.ring_strips(q_s, k))
                    q, e = q_s[p], q_s.shape[1]
                    qx = dmesh.ring_exchange(q_s, k)[p]
                    shape = (f"{label:10s} e={nelemd} ncol={cfg.ncol} {dtype} {prec} "
                             f"P={P} shard {p} kstep {k}")
                    out, row = check(
                        "K14w", shape, gate,
                        lambda: dr.dss_resident_window(Le, we, hl, q, hr, k, prec, L2e),
                        lambda: dr.dss_resident_window_plain(Le, we, hl, q, hr, k, prec, L2e))
                    padded = dr.dss_resident_window(Le, we, qx[:k], qx[k:k + e],
                                                    qx[k + e:], k, prec, L2e)
                    same = [torch.equal(out, padded)]
                    if P == 1:
                        same.append(torch.equal(out, dr.dss_resident(
                            L_s[0], w_s[0], q, k, prec, L2_s[0])))
                    torch.cuda.synchronize()
                    if not all(same):
                        fail(f"K14w {shape}: split/padded/ring bitwise {same}")
                    print(f"[3 K14w] {shape}: split bitwise equal to padded"
                          + (", and to K14 on the ring" if P == 1 else ""))
                    if (label, prec, P) == ("production", "bf16x3", 1):
                        rows["K14w"] = dict(row, steps_timed=k, **bound(
                            (Le, L2e, we, hl, q, hr, out),
                            **ring_cone_ops(e, cfg.ncol, k, prec)))
                    del q_s, L_s, w_s, L2_s, Le, L2e, we, hl, hr, qx, out, padded

                for P in torus_P:
                    m = dmesh.make_mesh(P, dev)
                    q_s, (L_s, w_s) = dbi.make_dist_loop_dss2d_rowchain(cfg, m)[0](data)
                    exl = ex // P
                    p = min(1, P - 1)
                    F_s = precompose_operator(L_s.reshape(-1, 16, 16)).reshape(L_s.shape)
                    t_s = torch.stack([rc.rowchain_bridge_in(L_s[i], q_s[i], exl, ey, prec)
                                       for i in range(P)])
                    kk = min(4 if prec == "bf16x3" else 3, exl)  # the loop's depth
                    shape = (f"{label:10s} {ex}x{ey} ncol={cfg.ncol} {dtype} {prec} "
                             f"P={P} shard {p}")
                    tp1 = dbi.ring_rows(t_s, ey, 1)[p]
                    out, row16 = check(
                        "K16p", f"{shape} depth 1", gate,
                        lambda: rc.rowchain_step_padded(F_s[p], w_s[p], tp1, exl, ey, 1,
                                                        prec, True),
                        lambda: rc.rowchain_step_padded_plain(F_s[p], w_s[p], tp1, exl,
                                                              ey, 1, prec, True))
                    q_out, row17 = check(
                        "K17p", f"{shape} bridge_out", gate,
                        lambda: rc.rowchain_bridge_out_padded(L_s[p], w_s[p], tp1, exl,
                                                              ey, prec),
                        lambda: rc.rowchain_bridge_out_padded_plain(L_s[p], w_s[p], tp1,
                                                                    exl, ey, prec))
                    if P == 1:  # the torus's own wrapped rows as the pad
                        same = torch.equal(q_out, rc.rowchain_bridge_out(
                            L_s[0], w_s[0], t_s[0], exl, ey, prec))
                        torch.cuda.synchronize()
                        if not same:
                            fail(f"K17p {shape}: differs from K17 on its own rows")
                        print(f"[3 K17p] {shape}: bitwise equal to K17")
                    tpk = dbi.ring_rows(t_s, ey, kk)[p]
                    Fk = dbi.ring_rows(F_s, ey, kk - 1)[p]
                    wk = dbi.ring_rows(w_s, ey, kk - 1)[p]
                    own = slice(kk * ey, (kk + exl) * ey)
                    deep, row18 = check(
                        "K18p", f"{shape} depth {kk}", gate,
                        lambda: rc.rowchain_step_padded(Fk, wk, tpk, exl, ey, kk, prec,
                                                        True, padded_out=True),
                        lambda: rc.rowchain_step_padded_plain(Fk, wk, tpk, exl, ey, kk,
                                                              prec, True), own=own)
                    one = tpk
                    for j in range(kk):  # kk K16p launches, one row fewer per side
                        r = exl + 2 * (kk - 1 - j)
                        one = rc.rowchain_step_padded(Fk[j * ey:(j + r) * ey],
                                                      wk[j * ey:(j + r) * ey], one,
                                                      r, ey, 1, prec, True)
                    torch.cuda.synchronize()
                    if not torch.equal(deep[own], one):
                        fail(f"K18p {shape}: depth {kk} differs from {kk} K16p launches")
                    print(f"[3 K18p] {shape}: depth {kk} bitwise equal to {kk} K16p "
                          f"launches on shrinking windows")
                    if (label, prec, P) == ("production", "bf16x3", 1):
                        cols = exl * ey * cfg.ncol
                        rows["K16p"] = dict(row16, **bound(
                            (F_s[p], w_s[p], tp1, out),
                            **rowchain_cone_ops(exl, ey, cfg.ncol, 1, prec)))
                        rows["K17p"] = dict(row17, **bound(
                            (L_s[p], w_s[p], tp1, q_out), **apply_ops(cols, prec, 1, I_PASS)))
                        rows["K18p"] = dict(row18, steps_timed=kk, **bound(
                            (Fk, wk, tpk, deep[own]),
                            **rowchain_cone_ops(exl, ey, cfg.ncol, kk, prec)))
                    del q_s, L_s, w_s, F_s, t_s, tp1, tpk, Fk, wk, out, q_out, deep, one
            del data
    print(f"[3 K14w/K16p-K18p] {time.perf_counter() - t0:.1f} s")
    return rows


def phase_masked_kernels(dev, card):
    """K20-K25 against their plain versions on shard windows (the windows
    the dist steps hand them): shipped f32 and f64 on 1 and 4 shards, and
    production f32 on 1 shard, K24/K25 at kstep 2 and 4; K23 and K25
    bitwise against K22 and K24 on the concatenated window; returns the
    JSON rows (production f32, one step, kstep 4 for K24/K25)."""
    import torch

    from cdk_torch.core.config import MpdataConfig, production_config
    from cdk_torch.dist import mesh as dmesh
    from cdk_torch.dist import mpdata as dmp
    from cdk_torch.kernels.mpdata import masked as mk
    from cdk_torch.kernels.mpdata import problem as mp

    rows = {}
    gates = {torch.float32: (1e-6, 1e-5), torch.float64: (1e-13, 1e-13)}
    shipped = MpdataConfig()
    cases = [("shipped", shipped, "float32", 1, (1, 2)),
             ("shipped", shipped, "float64", 1, (1, 2)),
             ("shipped", shipped, "float32", 4, (1,)),
             ("shipped", shipped, "float64", 4, (1,)),
             ("production", production_config("mpdata"), "float32", 1, (1, 2, 4))]
    for label, base, dtype, P, ksteps in cases:
        cfg = MpdataConfig(nslices=base.nslices, dtype=dtype, device_init=True)
        d = mp.init_data(cfg, dev)
        m = dmesh.make_mesh(P, dev)
        si, _, _ = dmp.make_dist_step(cfg, m)
        f_s, u_s, w_s, (rho, rhow, adz, _) = si(d)
        aux = (rho, rhow, adz)
        p = min(1, P - 1)  # an inner shard where there is one
        chunk = f_s.shape[2]
        gf, gflux = gates[d.f.dtype]
        for kstep in ksteps:
            h = 3 * kstep
            strips = dmesh.exchange_strips(f_s, h)
            lh, rh, own = strips[0][p], strips[1][p], f_s[p]
            f_e, u_e, w_e = (dmesh.exchange(a, h)[p] for a in (f_s, u_s, w_s))
            gi0 = p * chunk - 2 - h
            X = f_e.shape[1]
            kw = dict(nx=cfg.nx, nzm=cfg.nzm)
            win = dict(owned_lo=h, owned_hi=h + chunk)
            if kstep == 1:
                tests = [
                    ("K20", lambda: mk.masked_step_pallas(
                        f_e, u_e, w_e, *aux, gi0, nx=cfg.nx, **win), False, 1),
                    ("K21", lambda: mk.masked_step_pallas_packed(
                        f_e, u_e, w_e, *aux, gi0, **kw, **win), False, 1),
                    ("K22", lambda: mk.masked_step_xmajor(
                        f_e, u_e, w_e, *aux, gi0, **kw, **win), False, 1),
                    ("K23", lambda: mk.masked_step_xmajor_split(
                        own, lh, rh, u_e, w_e, *aux, gi0, **kw, halo=h), True, 1)]
            else:
                tests = []
            if kstep > 1:
                tests += [
                    ("K24", lambda: mk.masked_kloop_xmajor(
                        f_e, u_e, w_e, *aux, gi0, **kw, **win, nsteps=kstep),
                     False, kstep),
                    ("K25", lambda: mk.masked_kloop_xmajor_split(
                        own, lh, rh, u_e, w_e, *aux, gi0, **kw, halo=h,
                        nsteps=kstep), True, kstep)]
            outs = {}
            for tag, kernel, split, n in tests:
                hoisted = tag in ("K24", "K25")

                def plain():
                    args = (f_e, u_e, w_e, *aux, gi0, cfg.nx, h, h + chunk)
                    o = (mk.masked_kloop_plain(*args, n) if hoisted
                         else mk.masked_step_plain(*args))
                    return (o[0][:, h:h + chunk], o[1]) if split else o

                out, ref = kernel(), plain()
                torch.cuda.synchronize()
                outs[tag] = out
                ef, mae_f, big_f = errors(out[0], ref[0], "l1")
                efl, mae_fl, big_fl = errors(out[1], ref[1], "l1")
                ms = timed_ms(kernel, REPS)
                plain_ms = timed_ms(plain, REPS)
                print(f"[3 {tag}] {label:10s} S={cfg.nslices} nx=32 nz=58 {dtype:7s} "
                      f"P={P} shard {p} X={X} n={n}: rel_l1 f {ef:.3e} flux "
                      f"{efl:.3e} (gates {gf:g}/{gflux:g}) max_abs "
                      f"{max(mae_f, mae_fl):.3e} of {max(big_f, big_fl):.3e} "
                      f"f bitwise={torch.equal(out[0], ref[0])}; kernel {ms:.4f} ms, "
                      f"plain {plain_ms:.4f} ms [{card}]")
                if not (torch.equal(out[0], ref[0]) and efl < gflux and big_f > 0
                        and big_fl > 0 and bool(torch.isfinite(out[0]).all())
                        and bool(torch.isfinite(out[1]).all())):
                    fail(f"{tag} {label} {dtype} P={P} kstep={kstep}: f bitwise "
                         f"{torch.equal(out[0], ref[0])}, rel_l1 f {ef:.3e} flux "
                         f"{efl:.3e}")
                if label == "production" and (n == 1 or (hoisted and n == 4)):
                    ins = ((own, lh, rh) if split else (f_e,)) + (u_e, w_e, *aux)
                    rows[tag] = dict(
                        max_abs_err=max(mae_f, mae_fl), ms=ms, plain_ms=plain_ms,
                        steps_timed=n,
                        **bound(ins + out, masked_ops(cfg.nslices, X, cfg.nzm, n,
                                                      hoisted)))
            for split_tag, whole_tag in (("K23", "K22"), ("K25", "K24")):
                if split_tag in outs:
                    a, b = outs[split_tag], outs[whole_tag]
                    if not (torch.equal(a[0], b[0][:, h:h + chunk])
                            and torch.equal(a[1], b[1])):
                        fail(f"{split_tag} differs from {whole_tag} on the "
                             f"concatenated window ({label} {dtype} P={P})")
                    print(f"[3 {split_tag}={whole_tag}] {label} {dtype} P={P} "
                          f"kstep={kstep}: bitwise equal on the owned columns")
        del d, f_s, u_s, w_s
    return rows


class SizeLedger:
    """Kernel launches charged to the size of the work that made them:
    `read()` gives every kernel's count so far, and `charge(size)` books
    what it rose by since the last charge under "shipped" or
    "production"."""

    def __init__(self, read):
        self.read = read
        self.last = read()
        self.by = {"shipped": dict.fromkeys(self.last, 0),
                   "production": dict.fromkeys(self.last, 0)}

    def charge(self, size: str) -> None:
        now = self.read()
        for k, n in now.items():
            self.by[size][k] += n - self.last[k]
        self.last = now


def phase_main(dev, card, ledger: SizeLedger):
    import cdk_torch.kernels  # noqa: F401  (registers the variants)
    from cdk_torch.core import registry
    from cdk_torch.core.config import (
        BiharmonicConfig,
        CkeConfig,
        MpdataConfig,
        production_config,
    )
    from cdk_torch.harness.driver import run_kernel

    def stable(kernel):  # every registered variant but the experimental ones
        return [n for n, v in registry.variants(kernel).items()
                if not v.experimental]

    legs = (
        ("biharmonic", "shipped f64", BiharmonicConfig(dtype="float64"), None),
        ("mpdata", "shipped f64", MpdataConfig(dtype="float64"), None),
        ("biharmonic_dss", "shipped f64", BiharmonicConfig(dtype="float64"),
         None),
        ("biharmonic_dss2d", "shipped f64", BiharmonicConfig(dtype="float64"),
         None),
        ("mpdata", "shipped f64 lanes", MpdataConfig(dtype="float64"),
         ["reference_jnp", "pallas_lanes"]),
        ("biharmonic", "production f32", production_config("biharmonic"),
         stable("biharmonic")),
        ("mpdata", "production f32", production_config("mpdata"),
         stable("mpdata")),
        ("biharmonic_dss", "production f32", production_config("biharmonic_dss"),
         ["reference_jnp", "fused_operator_bd8_resident_sq_x3",
          "fused_operator_bd8_resident_sq"]),
        ("biharmonic_dss2d", "production f32",
         production_config("biharmonic_dss2d"),
         ["reference_jnp", "fused_operator_rowchain_sq_x3",
          "fused_operator_rowchain_sq"]),
        ("biharmonic_dss_cube", "production f32",
         production_config("biharmonic_dss_cube"),
         ["reference_jnp", "fused_operator_cube_sq_x3"]),
        ("cke", "shipped f64", CkeConfig(dtype="float64"),
         list(registry.variants("cke"))),
        ("cke", "production f32", production_config("cke"),
         ["reference_jnp", "gather_peradv", "pallas_rows",
          "pallas_lanegather"]),
    )
    for kernel, label, cfg, variants in legs:
        t0 = time.perf_counter()
        results = run_kernel(kernel, cfg, variants=variants, device=dev)
        wall = time.perf_counter() - t0
        if not results:
            fail(f"{kernel} {label}: no variant ran")
        for r in results:
            print(f"[4 main] {kernel} {label}: {r.variant} "
                  f"{'ok' if r.ok else 'FAILED'} {r.seconds_per_call * 1e6:.3f} "
                  f"us/step, {r.grid_points_per_s / 1e9:.4f} G pts/s "
                  f"[{card}] ({wall:.1f} s leg)")
            if not r.ok:
                fail(f"{kernel} {label} {r.variant}: {r.metrics} {r.note}")
        ledger.charge(label.split()[0])
    phase_main_group(dev, card)
    ledger.charge("production")


def phase_main_group(dev, card) -> None:
    """The cell mpaso.tracers' 32-tracer group through the family's loop,
    as the benchmark runs it (run_kernel takes one table): `pallas_rows`,
    one K3g launch a step, against `reference_jnp` tracer by tracer over
    two steps, then timed a step."""
    import cdk_torch.kernels  # noqa: F401  (registers the variants)
    from cdk_torch.core import registry
    from cdk_torch.core.config import CkeConfig
    from cdk_torch.harness.specs import get_spec
    from cdk_torch.kernels.cke import problem as cp

    t0 = time.perf_counter()
    cfg = CkeConfig(mesh="planar_hex", nx=486, ny=488, nvertlevels=60,
                    ntracers=32, dtype="float32", device_init=True)
    d = cp.init_data(cfg, dev)
    spec = get_spec("cke")
    flux = {}
    for name in ("reference_jnp", "pallas_rows"):
        step2, aux, _ = registry._materialize(registry.get("cke", name), cfg, d)
        flux[name] = spec.loop_runner(step2, aux, 2)(d)
    check = spec.verify(cfg, flux["pallas_rows"], flux["reference_jnp"])
    del flux
    # step2 and aux are pallas_rows', the last made
    us = timed_ms(lambda: spec.loop_runner(step2, aux, 1)(d), 5) * 1e3
    print(f"[4 main] cke production f32 hex, {cfg.ntracers} tracers through the "
          f"family's loop: pallas_rows {'ok' if check.ok else 'FAILED'} {us:.3f} us/step "
          f"{check.metrics} [{card}] ({time.perf_counter() - t0:.1f} s leg)")
    if not check.ok:
        fail(f"cke production f32 hex pallas_rows: {check.metrics}")


def phase_dist(dev, card, ledger: SizeLedger):
    """The decomposed MPDATA and DSS paths on a mesh of shards on the card."""
    import torch

    from cdk_torch import cli
    from cdk_torch.core.config import production_config
    from cdk_torch.core.norms import rel_l1, rel_l2
    from cdk_torch.dist import mesh as dmesh
    from cdk_torch.dist import mpdata as dmp
    from cdk_torch.harness.distbench import run_dist_legs
    from cdk_torch.kernels.mpdata import problem as mp

    t0 = time.perf_counter()
    champions = {"mpdata": "pallas_xmajor",
                 "biharmonic_dss": "fused_operator_bd8_resident_sq_x3",
                 "biharmonic_dss2d": "fused_operator_rowchain_sq_x3"}
    for r in run_dist_legs(champions, device=dev):
        print(f"[5 dist] leg {r.family}: {r.path} "
              f"{'ok' if r.ok else 'FAILED'} {r.seconds_per_call * 1e6:.3f} us/step "
              f"(band {r.slope_min * 1e6:.3f}-{r.slope_max * 1e6:.3f}), "
              f"{r.grid_points_per_s / 1e9:.4f} G pts/s, err {r.err:.3e} "
              f"(tol {r.tol:g}) [{card}]")
        if not r.ok:
            fail(f"dist leg {r.family}: err {r.err} {r.note}")
    ledger.charge("production")
    print(f"[5 dist] legs {time.perf_counter() - t0:.1f} s")
    for family in ("mpdata", "biharmonic"):
        t1 = time.perf_counter()
        rc = cli.main(["scaling", family, "--devices", "1,2,4", "--overlap-gain",
                       "--kstep", "4"])
        if rc != 0:
            fail(f"scaling {family} exited {rc}")
        ledger.charge("shipped")  # the sweeps' small defaults
        print(f"[5 dist] scaling {family} {time.perf_counter() - t1:.1f} s")

    # the row-sharded rowchain at production f32 on 3 shards: the serial
    # loop (a depth-4 K18p block, a K16p step) bitwise equal to the overlap
    # form (five patched K16p steps), both against the champion
    import cdk_torch.kernels  # noqa: F401  (registers the variants)
    from cdk_torch.core import registry
    from cdk_torch.core.config import with_overrides
    from cdk_torch.dist import biharmonic as dbi
    from cdk_torch.harness.distbench import CHAIN_RREARTH
    from cdk_torch.kernels.biharmonic import problem as bp

    bcfg = with_overrides(production_config("biharmonic_dss2d"),
                          rrearth=CHAIN_RREARTH["biharmonic_dss2d"])
    bdata = bp.init_data(bcfg, dev)
    m3 = dmesh.make_mesh(3, dev)
    si, serial, bgather = dbi.make_dist_loop_dss2d_rowchain(bcfg, m3)
    overlap = dbi.make_dist_loop_dss2d_rowchain(bcfg, m3, overlap=True)[1]
    bq, baux = si(bdata)
    a, b = serial(bq, baux, 6), overlap(bq, baux, 6)
    champ = registry.get("biharmonic_dss2d", champions["biharmonic_dss2d"]).fn(
        bcfg)["loop"](bdata, 6)
    torch.cuda.synchronize()
    err = rel_l2(bgather(a), champ)
    if not (torch.equal(a, b) and err < 5e-4 and bool(torch.isfinite(a).all())):
        fail(f"rowchain on 3 shards: serial vs overlap {torch.equal(a, b)}, "
             f"rel_l2 {err:.3e} against the champion")
    print(f"[5 dist] production f32 rowchain on 3 shards, 6 steps: serial bitwise "
          f"equal to overlap; rel_l2 {err:.3e} against {champions['biharmonic_dss2d']} "
          f"(gate 5e-4)")
    del bdata, bq, baux, a, b, champ

    cfg = production_config("mpdata")
    m = dmesh.make_mesh(1, dev)
    d = mp.init_data(cfg, dev)
    si, step, gather = dmp.make_dist_step(cfg, m)
    args = si(d)
    want = step(*args)
    for kernel in ("pallas", "packed"):
        got = dmp.make_dist_step(cfg, m, kernel=kernel)[1](*args)
        torch.cuda.synchronize()
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            fail(f"dist step kernel={kernel} differs from the x-major core")
    k24 = dmp.make_dist_loop(cfg, m, kstep=4, split=False)(*args, 8)
    k25 = dmp.make_dist_loop(cfg, m, kstep=4)(*args, 8)
    chained = args[0], args[3][3]
    for _ in range(8):
        chained = step(chained[0], args[1], args[2], (*args[3][:3], chained[1]))
    torch.cuda.synchronize()
    err = max(rel_l1(gather(k24[0]), gather(chained[0])),
              rel_l1(k24[1], chained[1]))
    if not (torch.equal(k24[0], k25[0]) and torch.equal(k24[1], k25[1])
            and err < 1e-5 and bool(torch.isfinite(k24[0]).all())):
        fail(f"kstep-4 loop: split vs whole window or chained steps ({err:.3e})")
    print(f"[5 dist] production f32 1 shard: step with the pallas and packed "
          f"cores bitwise equal to x-major; kstep-4 loop split=False bitwise equal "
          f"to split, rel_l1 {err:.3e} against 8 chained steps (gate 1e-5)")
    # the per-step loop against the kstep-4 loop at production (scaling
    # mpdata compares them at the small, launch-bound JAX defaults)
    per_step = {k: timed_ms(lambda: dmp.make_dist_loop(cfg, m, kstep=k)(*args, 16),
                            3) / 16 * 1e3 for k in (1, 4)}
    print(f"[5 dist] production f32 1 shard, 16 steps: per-step loop (K23) "
          f"{per_step[1]:.3f} us/step, kstep-4 loop (K25) {per_step[4]:.3f} "
          f"us/step, ratio {per_step[4] / per_step[1]:.4f} [{card}]")
    ledger.charge("production")


# the DSS kernels --times runs; the bf16x3 forms of those this change
# redesigned are not held bitwise to an older tree's
DSS_TIMED = ("K14", "K14w", "K15", "K16", "K16p", "K17", "K17p", "K18", "K18p", "K19")
DSS_REDESIGNED = ("K15", "K17", "K17p", "K19")


def digest(x):
    """The sha256 of a tensor's bytes, as a uint8 tensor: what --times saves
    of a DSS kernel's output (249 MB each at production)."""
    import hashlib

    import torch

    return torch.tensor(list(hashlib.sha256(x.contiguous().cpu().numpy().tobytes())
                             .digest()), dtype=torch.uint8)


def dss_times(dev, times, outs):
    """--times for the DSS kernels at production (5400 x 72 x 10, the torus
    75 x 72, rrearth 0.1 as the loops run), each wrapper timed and its
    output's digest saved: K14 in its four forms at dss_resident.DEPTH
    steps, K14w at kstep 8 on one ring shard (sq and sq_x3), the rowchain's
    K15, K16 (depth 1), K18 (depth 4) and K17 and the padded K16p, K18p
    (depth 4) and K17p on one row shard, in both precisions (the step and
    its padded modes with the precomposed A^2; their input t from the plain
    bridge-in), and K19 in f32 bf16x3, f32 exact and f64 at one step a
    launch, and at the shipped 4 x 4 torus (16 x 72 x 40) at two; then the
    legs that run the rowchain kernels (dss2d_leg_times).  Only wrappers an
    older tree has too are called, so the same script times either tree."""
    import torch

    import cdk_torch.kernels  # noqa: F401  (registers the variants)
    from cdk_torch.core import registry
    from cdk_torch.core.config import BiharmonicConfig
    from cdk_torch.dist import biharmonic as dbi
    from cdk_torch.dist import mesh as dmesh
    from cdk_torch.kernels.biharmonic import dss2d_resident as dr2
    from cdk_torch.kernels.biharmonic import dss2d_rowchain as rc
    from cdk_torch.kernels.biharmonic import dss_resident as dr
    from cdk_torch.kernels.biharmonic import problem as bp
    from cdk_torch.kernels.biharmonic.dss2d import torus_shape
    from cdk_torch.kernels.biharmonic.operator import precompose_operator

    def run(key, fn):
        outs[key] = digest(fn())
        times[key] = timed_ms(fn, REPS)

    for dtype in ("float32", "float64"):
        cfg = BiharmonicConfig(nelemd=5400, qsize=10, dtype=dtype, device_init=True,
                               rrearth=0.1)
        data = bp.init_data(cfg, dev)
        q = bp.to_lane_layout(data.qtens)
        ex, ey = torus_shape(cfg.nelemd)
        L, w = registry.get("biharmonic_dss2d", "fused_operator_bd8_resident").fn(
            cfg)["prepare"](data)
        for prec in ("bf16x3", "highest") if dtype == "float32" else ("highest",):
            run(f"K19 production {dtype} {prec} n=1",
                lambda: dr2.dss2d_resident(L, w, q, ex, ey, 1, prec))
            # the shipped 4 x 4 torus at the depth its loop runs (DEPTH 2)
            s_cfg = BiharmonicConfig(nelemd=16, qsize=40, dtype=dtype, device_init=True,
                                     rrearth=0.1)
            s_data = bp.init_data(s_cfg, dev)
            s_q = bp.to_lane_layout(s_data.qtens)
            s_L, s_w = registry.get("biharmonic_dss2d", "fused_operator_bd8_resident").fn(
                s_cfg)["prepare"](s_data)
            run(f"K19 shipped {dtype} {prec} n=2",
                lambda: dr2.dss2d_resident(s_L, s_w, s_q, 4, 4, 2, prec))
        if dtype == "float64":
            break
        Lr, wr, L2 = registry.get("biharmonic_dss", "fused_operator_bd8_resident_sq").fn(
            cfg)["prepare"](data)
        for prec in ("bf16x3", "highest"):
            for sq in (False, True):
                run(f"K14 production {dtype} {prec} sq={sq} n={dr.DEPTH}",
                    lambda: dr.dss_resident(Lr, wr, q, dr.DEPTH, prec, L2 if sq else None))
        m = dmesh.make_mesh(1, dev)
        q_s, (L_s, w_s) = dbi.make_dist_step_dss(cfg, m)[0](data)
        L2_s = precompose_operator(L_s.reshape(-1, 16, 16)).reshape(L_s.shape)
        Le, L2e, we = (dmesh.ring_exchange(x, 8)[0] for x in (L_s, L2_s, w_s))
        hl, hr = (x[0] for x in dmesh.ring_strips(q_s, 8))
        for prec in ("bf16x3", "highest"):
            run(f"K14w production {dtype} {prec} kstep=8",
                lambda: dr.dss_resident_window(Le, we, hl, q_s[0], hr, 8, prec, L2e))
        del q_s, L_s, w_s, L2_s, Le, L2e, we, hl, hr
        F = precompose_operator(L)
        q_t, (Lt, wt) = dbi.make_dist_loop_dss2d_rowchain(cfg, m)[0](data)
        Ft = precompose_operator(Lt.reshape(-1, 16, 16)).reshape(Lt.shape)
        for prec in ("bf16x3", "highest"):
            # the steps' and bridge-out's input from the plain bridge-in, the
            # same in either tree
            t = rc.rowchain_bridge_in_plain(L, q, ex, ey, prec)
            run(f"K15 production {dtype} {prec}",
                lambda: rc.rowchain_bridge_in(L, q, ex, ey, prec))
            run(f"K16 production {dtype} {prec} sq depth 1",
                lambda: rc.rowchain_step(F, w, t, ex, ey, 1, prec, True))
            run(f"K18 production {dtype} {prec} sq depth 4",
                lambda: rc.rowchain_step(F, w, t, ex, ey, 4, prec, True))
            run(f"K17 production {dtype} {prec}",
                lambda: rc.rowchain_bridge_out(L, w, t, ex, ey, prec))
            t_s = rc.rowchain_bridge_in_plain(Lt[0], q_t[0], ex, ey, prec)[None]
            tp1 = dbi.ring_rows(t_s, ey, 1)[0]
            tp4 = dbi.ring_rows(t_s, ey, 4)[0]
            F4, w4 = (dbi.ring_rows(x, ey, 3)[0] for x in (Ft, wt))
            run(f"K16p production {dtype} {prec} sq depth 1",
                lambda: rc.rowchain_step_padded(Ft[0], wt[0], tp1, ex, ey, 1, prec, True))
            run(f"K18p production {dtype} {prec} sq depth 4",  # the owned rows
                lambda: rc.rowchain_step_padded(F4, w4, tp4, ex, ey, 4, prec, True,
                                                padded_out=True)[4 * ey:(4 + ex) * ey])
            run(f"K17p production {dtype} {prec}",
                lambda: rc.rowchain_bridge_out_padded(Lt[0], wt[0], tp1, ex, ey, prec))
            del t, t_s, tp1, tp4, F4, w4
        del data, q, L, w, Lr, wr, L2, F, q_t, Lt, wt, Ft
    dss2d_leg_times(dev, times)


def dss2d_leg_times(dev, times):
    """--times for the legs that run the rowchain kernels: phase 4's
    biharmonic_dss2d production legs (rowchain_sq_x3 and rowchain_sq, by
    run_kernel's slope timing) and phase 5's dist biharmonic_dss2d leg, each
    verified as in those phases; us/step saved under "leg ..." keys (as ms,
    like every --times entry)."""
    from cdk_torch.core.config import production_config
    from cdk_torch.harness.distbench import run_dist_legs
    from cdk_torch.harness.driver import run_kernel

    legs = ["fused_operator_rowchain_sq_x3", "fused_operator_rowchain_sq"]
    for r in run_kernel("biharmonic_dss2d", production_config("biharmonic_dss2d"),
                        variants=legs, device=dev, quiet=True):
        if not r.ok:
            fail(f"leg biharmonic_dss2d production {r.variant}: {r.metrics} {r.note}")
        times[f"leg biharmonic_dss2d production f32 {r.variant} per step"] = (
            r.seconds_per_call * 1e3)
    for r in run_dist_legs({"biharmonic_dss2d": legs[0]}, device=dev, quiet=True):
        if not r.ok:
            fail(f"dist leg {r.family}: err {r.err} {r.note}")
        times[f"leg dist {r.family} production f32 {r.path} per step"] = (
            r.seconds_per_call * 1e3)


def phase_times(dev, card, out: str, against: str | None, kernels: str) -> None:
    """--times: K3, K13, K12, the MPDATA step kernel, K10 and the masked
    kernel (`kernels` "cke", "mpdata" or "all"), and the DSS kernels ("dss"
    or "all": dss_times), timed in the tree whose cdk_torch this imports (K3
    and K13 at production f32 and the shipped size in f64; K12 at the
    shipped size in f32, f64 and bf16; the staged form at production in
    f32, f64 and bf16, K6 and K7 one step and K8 four; the hoisted K2 one
    step, K2 and K9 four; K10 at production in f32 and f64 and at the
    shipped size in f64; K22 and K23 one step, K24 and K25 four, on the
    one-shard window at the shipped 48 slices, f32 and f64, and at
    production f32); their outputs saved to `out`, and with `against` K3's,
    K13's, K12's (also with duplicate slots), K2's and K6-K9's and
    K20-K25's held bitwise equal to those saved there, and K10's within the
    family gates (rel L1 on f 1e-6 / 1e-13, on flux 1e-5 / 1e-13 at f32 /
    f64: the sweep rounds every operation as the plain version, where the
    earlier four-launch K10 contracted into FMAs).  With `against`
    each time is printed beside the one saved there."""
    import torch

    from cdk_torch.core.config import CkeConfig, MpdataConfig
    from cdk_torch.dist import mesh as dmesh
    from cdk_torch.dist import mpdata as dmp
    from cdk_torch.kernels.cke import problem as cp
    from cdk_torch.kernels.cke.lanegather import cke_lanegather
    from cdk_torch.kernels.cke.onehot import cke_onehot
    from cdk_torch.kernels.cke.reference import coef3_of, fsign1
    from cdk_torch.kernels.cke.rows import cke_rows
    from cdk_torch.kernels.mpdata import lanes
    from cdk_torch.kernels.mpdata import masked as mk
    from cdk_torch.kernels.mpdata import problem as mp
    from cdk_torch.kernels.mpdata import staged
    from cdk_torch.kernels.mpdata.resident import (
        advect_hoisted_resident,
        advect_resident,
    )

    times, outs = {}, {}
    for label, nedges, ncells, dtype in (("production", 256000, 28000, "float32"),
                                         ("shipped", 25600, 2800, "float64"))[
                                             :2 if kernels in ("all", "cke") else 0]:
        cfg = CkeConfig(nedges=nedges, ncells=ncells, dtype=dtype, device_init=True)
        d = cp.init_data(cfg, dev)
        c3 = coef3_of(cfg)
        args = (d.adv_cells, d.adv_coefs, d.adv_coefs3, d.tracer * d.cell_mask,
                d.ntf, d.adv_mask)
        trans = (*(x.T.contiguous() for x in args[:4]),
                 (d.ntf * d.adv_mask).T.contiguous(), fsign1(d.ntf).T.contiguous())
        for tag, run in (("K3", lambda: cke_rows(*args, c3)),
                         ("K13", lambda: cke_lanegather(*trans, c3))):
            key = f"{tag} {label} {dtype}"
            outs[key] = run()
            times[key] = timed_ms(run, REPS)
        del d, args, trans
    for dtype in ("float32", "float64") if kernels in ("all", "cke") else ():
        cfg = CkeConfig(dtype=dtype, device_init=True)
        d = cp.init_data(cfg, dev)
        args = (d.adv_cells, d.adv_coefs, d.adv_coefs3, d.tracer * d.cell_mask,
                d.ntf, d.adv_mask, coef3_of(cfg))
        dup = d.adv_cells.clone()  # slots 0-1 and 2-4 name one cell each
        dup[:, 1], dup[:, 3], dup[:, 4] = dup[:, 0], dup[:, 2], dup[:, 2]
        for bf16 in (False, True) if dtype == "float32" else (False,):
            key = f"K12 shipped {dtype}{' bf16' if bf16 else ''}"
            outs[key] = cke_onehot(*args, bf16)
            outs[key + " duplicates"] = cke_onehot(dup, *args[1:], bf16)
            times[key] = timed_ms(lambda: cke_onehot(*args, bf16), REPS)
        del d, args, dup
    mp_sizes = kernels in ("all", "mpdata")
    for kind in ("float32", "float64", "bfloat16") if mp_sizes else ():
        cfg = MpdataConfig(nslices=8192, device_init=True,
                           dtype="float64" if kind == "float64" else "float32")
        d = mp.init_data(cfg, dev)
        a = tuple(x.to(torch.bfloat16) if kind == "bfloat16" else x
                  for x in (d.f, d.u, d.w, d.rho, d.rhow, d.adz, d.flux))
        cases = [("K6", staged.advect_fused, 1), ("K7", staged.advect_packed, 1),
                 ("K8", staged.advect_staged_resident, 4)]
        if kind != "bfloat16":
            cases += [("K2", advect_resident, 1), ("K2", advect_resident, 4),
                      ("K9", advect_hoisted_resident, 4)]
        for tag, wrapper, n in cases:
            key = f"{tag} production {kind} n={n}"
            outs[key] = wrapper(*a, n)
            times[key] = timed_ms(lambda: wrapper(*a, n), REPS)
        del d, a
    for label, nslices, dtype in (("production", 8192, "float32"),
                                  ("production", 8192, "float64"),
                                  ("shipped", 48, "float64")) if mp_sizes else ():
        cfg = MpdataConfig(nslices=nslices, dtype=dtype, device_init=True)
        d = mp.init_data(cfg, dev)
        xzs = tuple(lanes.to_xzs(getattr(d, n)) for n in lanes.FIELDS)
        key = f"K10 {label} {dtype} n=1"
        outs[key] = lanes.advect_lanes(*xzs)
        times[key] = timed_ms(lambda: lanes.advect_lanes(*xzs), REPS)
        del d, xzs
    for label, nslices, dtype in (("shipped", 48, "float32"), ("shipped", 48, "float64"),
                                  ("production", 8192, "float32")) if mp_sizes else ():
        cfg = MpdataConfig(nslices=nslices, dtype=dtype, device_init=True)
        d = mp.init_data(cfg, dev)
        f_s, u_s, w_s, (rho, rhow, adz, _) = dmp.make_dist_step(
            cfg, dmesh.make_mesh(1, dev))[0](d)
        kw = dict(nx=cfg.nx, nzm=cfg.nzm)
        for n in (1, 4):
            h = 3 * n
            lh, rh = (x[0] for x in dmesh.exchange_strips(f_s, h))
            f_e, u_e, w_e = (dmesh.exchange(x, h)[0] for x in (f_s, u_s, w_s))
            win = (f_e, u_e, w_e, rho, rhow, adz, -2 - h)
            split = (f_s[0], lh, rh, u_e, w_e, rho, rhow, adz, -2 - h)
            own = dict(owned_lo=h, owned_hi=h + f_s.shape[2])
            if n == 1:
                cases = [("K22", lambda: mk.masked_step_xmajor(*win, **kw, **own)),
                         ("K23", lambda: mk.masked_step_xmajor_split(*split, **kw, halo=h))]
            else:
                cases = [("K24", lambda: mk.masked_kloop_xmajor(*win, **kw, **own, nsteps=n)),
                         ("K25", lambda: mk.masked_kloop_xmajor_split(
                             *split, **kw, halo=h, nsteps=n))]
            for tag, run in cases:
                key = f"{tag} {label} {dtype} n={n}"
                outs[key] = run()
                times[key] = timed_ms(run, REPS)
        del d, f_s, u_s, w_s
    if kernels in ("all", "dss"):
        dss_times(dev, times, outs)
    torch.cuda.synchronize()
    saved = {k: tuple(x.cpu() for x in v) if isinstance(v, tuple) else (v.cpu(),)
             for k, v in outs.items()}
    torch.save({"outputs": saved, "times": times}, out)
    ref = ref_times = None
    if against is not None:
        ref = torch.load(against)
        ref, ref_times = ref["outputs"], ref["times"]
    for k, ms in times.items():
        was = (f"; {against} {ref_times[k]:.4f} ms" if ref_times and k in ref_times
               else "")
        print(f"[times] {k}: {ms:.4f} ms{was} [{card}]")
    if against is None:
        return
    differ = []
    for k, got in saved.items():
        if k not in ref:
            print(f"[times] {k}: not in {against}")
            continue
        if k.split()[0] in DSS_REDESIGNED and "bf16x3" in k:
            print(f"[times] {k} against {against}: not held (redesigned on the tensor "
                  f"cores; phase 3 holds it to its plain version)")
            continue
        same = all(torch.equal(x, y) for x, y in zip(got, ref[k]))
        if k.split()[0] in DSS_TIMED:  # sha256 digests of the outputs
            print(f"[times] {k} against {against}: bitwise={same}")
            if not same:
                differ.append(k)
            continue
        diff = max(float((x.double() - y.double()).abs().max())
                   for x, y in zip(got, ref[k]))
        gated = k.split()[0] == "K10"
        ok = same
        if gated:  # f then flux, within the family gates
            gates = (1e-13, 1e-13) if "float64" in k else (1e-6, 1e-5)
            rel = [errors(x, y, "l1")[0] for x, y in zip(got, ref[k])]
            ok = all(r < g for r, g in zip(rel, gates))
            print(f"[times] {k} against {against}: bitwise={same}, rel_l1 f "
                  f"{rel[0]:.3e} flux {rel[1]:.3e} (gates {gates[0]:g}/{gates[1]:g}), "
                  f"max_abs_diff {diff:.3e}")
        else:
            print(f"[times] {k} against {against}: bitwise={same}, max_abs_diff {diff:.3e}")
        if not ok:
            differ.append(k)
    if differ:
        fail(f"outputs that must match {against} differ: {differ}")


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--times", metavar="OUT", help="phases 1-2, then time K3, K13, "
                    "K12, the MPDATA step kernel, K10, the masked kernel and the DSS "
                    "kernels and save their outputs to OUT")
    ap.add_argument("--against", metavar="REF", help="with --times: hold those "
                    "outputs to the ones saved in REF (bitwise; K10 within the "
                    "family gates) and print REF's times beside")
    ap.add_argument("--kernels", choices=("all", "cke", "mpdata", "dss"), default="all",
                    help="with --times: the kernels to time")
    opts = ap.parse_args()
    t0 = time.perf_counter()
    dev, card = phase_device()
    phase_build()
    if opts.times:
        phase_times(dev, card, opts.times, opts.against, opts.kernels)
        return 0
    rows = phase_kernels(dev, card)
    rows.update(phase_fused_and_staged_kernels(dev, card))
    phase_few_slices(dev, card)
    rows.update(phase_cke_kernels(dev, card))
    rows.update(phase_dss_kernels(dev, card))
    rows.update(phase_cube(dev, card))
    phase_depth_sweep(dev, card)
    rows.update(phase_masked_kernels(dev, card))
    rows.update(phase_dist_dss_kernels(dev, card))

    from cdk_torch.kernels.biharmonic import dss2d_rowchain as rc
    from cdk_torch.kernels.biharmonic.dss2d_resident import dss2d_resident
    from cdk_torch.kernels.biharmonic.dss_cube import dss_cube_step
    from cdk_torch.kernels.biharmonic.dss_resident import (
        dss_resident,
        dss_resident_window,
    )
    from cdk_torch.kernels.biharmonic.fused import fused_laplace
    from cdk_torch.kernels.biharmonic.resident import (
        apply_operator_pallas,
        bd8_resident,
    )
    from cdk_torch.kernels.cke.group import cke_group
    from cdk_torch.kernels.cke.lanegather import cke_lanegather
    from cdk_torch.kernels.cke.onehot import cke_onehot
    from cdk_torch.kernels.cke.rows import cke_rows
    from cdk_torch.kernels.cke.staged import cke_staged
    from cdk_torch.kernels.mpdata import masked, staged
    from cdk_torch.kernels.mpdata.lanes import advect_lanes
    from cdk_torch.kernels.mpdata.resident import (
        advect_hoisted_resident,
        advect_resident,
    )

    wrappers = {"K1": bd8_resident, "K2": advect_resident, "K3": cke_rows,
                "K3g": cke_group, "K4": fused_laplace, "K5": apply_operator_pallas,
                "K6": staged.advect_fused, "K7": staged.advect_packed,
                "K8": staged.advect_staged_resident,
                "K9": advect_hoisted_resident, "K10": advect_lanes,
                "K11": cke_staged, "K12": cke_onehot, "K13": cke_lanegather,
                "K14": dss_resident, "K15": rc.rowchain_bridge_in,
                "K17": rc.rowchain_bridge_out, "K19": dss2d_resident,
                "K26": dss_cube_step}
    def counts(wrappers, step, one, deep):
        """Each wrapper's launches, and the rowchain step's (`step`) split
        by depth: `one` at depth 1, `deep` the same kernel deeper; and as
        "K steps" the steps the launches of each multi-step kernel ran."""
        depths = step.depth_launches
        if sum(depths.values()) != step.launches:
            fail(f"step launches {step.launches} != by depth {depths}")
        return {**{k: w.launches for k, w in wrappers.items()},
                one: depths.get(1, 0),
                deep: sum(n for k, n in depths.items() if k > 1),
                **{f"{k} steps": w.steps for k, w in wrappers.items() if k in STEPPED},
                f"{deep} steps": sum(k * n for k, n in depths.items() if k > 1)}

    for w in wrappers.values():
        w.launches = 0
    rc.rowchain_step.launches = 0
    rc.rowchain_step.depth_launches = {}
    main_ledger = SizeLedger(lambda: counts(wrappers, rc.rowchain_step, "K16", "K18"))
    phase_main(dev, card, main_ledger)
    launches = main_ledger.read()

    dist_wrappers = {"K2": advect_resident,
                     "K20": masked.masked_step_pallas,
                     "K21": masked.masked_step_pallas_packed,
                     "K22": masked.masked_step_xmajor,
                     "K23": masked.masked_step_xmajor_split,
                     "K24": masked.masked_kloop_xmajor,
                     "K25": masked.masked_kloop_xmajor_split,
                     "K14w": dss_resident_window,
                     "K17p": rc.rowchain_bridge_out_padded}
    for w in dist_wrappers.values():
        w.launches = 0
    rc.rowchain_step_padded.launches = 0
    rc.rowchain_step_padded.depth_launches = {}
    dist_ledger = SizeLedger(
        lambda: counts(dist_wrappers, rc.rowchain_step_padded, "K16p", "K18p"))
    phase_dist(dev, card, dist_ledger)
    dist_launches = dist_ledger.read()
    print(f"[6 counts] kernel launches during the main path: {launches}; "
          f"during the dist path: {dist_launches}")
    for k, n in list(launches.items()) + list(dist_launches.items()):
        if n <= 0:
            fail(f"{k} was never launched by its path")
    # the main path's K2, and each dist kernel's own path
    by_size = {size: {**{k: n for k, n in dist_ledger.by[size].items()
                         if k not in ("K2", "K2 steps")},
                      **main_ledger.by[size]} for size in ("shipped", "production")}
    launches.update({k: n for k, n in dist_launches.items() if k not in ("K2", "K2 steps")})
    print(f"[6 counts] at shipped sizes: {by_size['shipped']}; at production: "
          f"{by_size['production']}")

    import torch

    meta = {
        "K1": dict(name="biharmonic_resident", source="cdk_torch/csrc/biharmonic_resident.cu",
                   replaces="cdk_tpu/kernels/biharmonic/pallas_bd8.py:56"),
        "K2": dict(name="mpdata_resident", source="cdk_torch/csrc/mpdata_resident.cu",
                   replaces="cdk_tpu/kernels/mpdata/pallas_xmajor.py:122"),
        "K3": dict(name="cke_rows", source="cdk_torch/csrc/cke_rows.cu",
                   replaces="cdk_tpu/kernels/cke/pallas_rows.py:46"),
        # K3's group form, which replaces no TPU kernel
        "K3g": dict(name="cke_group", source="cdk_torch/csrc/cke_group.cu",
                    replaces="none (the group form of K3, cdk_tpu/kernels/cke/"
                             "pallas_rows.py:46)"),
        "K4": dict(name="biharmonic_fused", source="cdk_torch/csrc/biharmonic_fused.cu",
                   replaces="cdk_tpu/kernels/biharmonic/pallas_fused.py:41"),
        # K5 launches K1's kernel at one step
        "K5": dict(name="biharmonic_operator_apply",
                   source="cdk_torch/csrc/biharmonic_resident.cu",
                   replaces="cdk_tpu/kernels/biharmonic/operator.py:346"),
        # K6-K8 are the staged form of K2's source, K9 its hoisted form
        "K6": dict(name="mpdata_staged_fused", source="cdk_torch/csrc/mpdata_resident.cu",
                   replaces="cdk_tpu/kernels/mpdata/pallas_fused.py:41"),
        "K7": dict(name="mpdata_staged_packed", source="cdk_torch/csrc/mpdata_resident.cu",
                   replaces="cdk_tpu/kernels/mpdata/pallas_packed.py:255"),
        "K8": dict(name="mpdata_staged_resident", source="cdk_torch/csrc/mpdata_resident.cu",
                   replaces="cdk_tpu/kernels/mpdata/pallas_resident.py:49"),
        "K9": dict(name="mpdata_hoisted_resident", source="cdk_torch/csrc/mpdata_resident.cu",
                   replaces="cdk_tpu/kernels/mpdata/pallas_resident.py:260"),
        "K10": dict(name="mpdata_lanes", source="cdk_torch/csrc/mpdata_lanes.cu",
                    replaces="cdk_tpu/kernels/mpdata/pallas_lanes.py:60"),
        "K11": dict(name="cke_staged", source="cdk_torch/csrc/cke_staged.cu",
                    replaces="cdk_tpu/kernels/cke/staged.py:38"),
        "K12": dict(name="cke_onehot", source="cdk_torch/csrc/cke_onehot.cu",
                    replaces="cdk_tpu/kernels/cke/pallas_onehot.py:51"),
        "K13": dict(name="cke_lanegather", source="cdk_torch/csrc/cke_lanegather.cu",
                    replaces="cdk_tpu/kernels/cke/pallas_lanegather.py:68"),
        "K14": dict(name="biharmonic_dss_resident",
                    source="cdk_torch/csrc/biharmonic_dss_resident.cu",
                    replaces="cdk_tpu/kernels/biharmonic/pallas_dss_resident.py:100"),
    }
    rowchain = "cdk_torch/csrc/biharmonic_dss2d_rowchain.cu"
    tpu_rowchain = "cdk_tpu/kernels/biharmonic/pallas_dss2d_resident.py"
    for k, name, line in (("K15", "rowchain_bridge_in", 415),
                          ("K16", "rowchain_step", 424),
                          ("K17", "rowchain_bridge_out", 434),
                          ("K18", "rowchain_step_depth_k", 443)):
        meta[k] = dict(name=name, source=rowchain, replaces=f"{tpu_rowchain}:{line}")
    meta["K19"] = dict(name="biharmonic_dss2d_resident",
                       source="cdk_torch/csrc/biharmonic_dss2d_resident.cu",
                       replaces=f"{tpu_rowchain}:66")
    # the dist modes: K14 fed a window by the ring exchange (both the padded
    # and the split JAX call), and the rowchain on exchanged-row padding
    meta["K14w"] = dict(name="biharmonic_dss_resident_window",
                        source="cdk_torch/csrc/biharmonic_dss_resident.cu",
                        replaces="cdk_tpu/kernels/biharmonic/pallas_dss_resident.py:505"
                                 " and :570")
    for k, name, line in (("K16p", "rowchain_step_padded", "635 (step_t_padded :644)"),
                          ("K17p", "rowchain_bridge_out_padded",
                           "635 (bridge_out_padded :648)"),
                          ("K18p", "rowchain_step_padded_depth_k",
                           "802 (stepk_padded_factory)")):
        meta[k] = dict(name=name, source=rowchain, replaces=f"{tpu_rowchain}:{line}")
    for k, name, line in (("K20", "mpdata_masked_step", 44),
                          ("K21", "mpdata_masked_step_packed", 181),
                          ("K22", "mpdata_masked_step_xmajor", 292),
                          ("K23", "mpdata_masked_step_split", 355),
                          ("K24", "mpdata_masked_kloop", 580),
                          ("K25", "mpdata_masked_kloop_split", 605)):
        meta[k] = dict(name=name, source="cdk_torch/csrc/mpdata_masked.cu",
                       replaces=f"cdk_tpu/kernels/mpdata/pallas_masked.py:{line}")
    # K26, the cube's DSS step, which replaces no TPU kernel
    meta["K26"] = dict(name="biharmonic_dss_cube", source="cdk_torch/csrc/biharmonic_dss_cube.cu",
                       replaces="none (the DSS over HOMME's cubed sphere; the JAX package "
                                "assembles over a ring or a torus only)")
    order = sorted(meta, key=lambda k: (int(k[1:].rstrip("pwg")), k))
    kernels = [dict(name=meta[k]["name"], route="cuda", source=meta[k]["source"],
                    replaces=meta[k]["replaces"], launches=launches[k],
                    launches_shipped=by_size["shipped"][k],
                    launches_production=by_size["production"][k],
                    **({"steps_production": by_size["production"][f"{k} steps"]}
                       if k in STEPPED else {}),
                    **{"library_ms": None, **rows[k]},
                    **({"redesigned": REDESIGNED[k][0]} if k in REDESIGNED else {}))
               for k in order]
    if len(kernels) != 31:
        fail(f"{len(kernels)} kernels described, want all 31")
    print(f"[7 wall] {time.perf_counter() - t0:.1f} s, build included")
    for k, row in zip(order, kernels):
        print(f"[7 table] {table_row(k, row)}")
    # the redesign queue's order: device time lost against the bound by the
    # launches made at the size each kernel's ms was taken at (the shipped
    # size for K11 and K12; K10's launches are all shipped f64 ones, charged
    # at its shipped f64 ms and bound), a multi-step kernel's by the steps
    # they ran
    lost = {}
    for k, row in zip(order, kernels):
        size = "shipped" if k in ("K10", "K11", "K12") else "production"
        units = row.get("steps_production") if size == "production" else None
        per = row.get("steps_timed", 1) if units is not None else 1
        units = row[f"launches_{size}"] if units is None else units
        ms, bound_ms = ((row["shipped_ms"], row["shipped_bound_ms"]) if k == "K10"
                        else (row["ms"], row["bound_ms"]))
        lost[k] = (units, units * (ms - bound_ms) / per)
    # the queue's rule: a kernel redesigned once is not taken again, and one
    # at half its bound or better is left alone
    for k, (units, ms) in sorted(lost.items(), key=lambda kv: -kv[1][1]):
        row = kernels[order.index(k)]
        rule = (f"redesigned PR {REDESIGNED[k][0]}, not taken again" if k in REDESIGNED
                else "at half its bound or better, left alone"
                if row["bound_ms"] >= row["ms"] / 2 else "queued")
        print(f"[7 rank] {k}: {units} {'steps' if k in STEPPED else 'launches'} x "
              f"(ms - bound ms) per {'step' if k in STEPPED else 'launch'} = {ms:.1f} ms"
              f" ({rule})")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
