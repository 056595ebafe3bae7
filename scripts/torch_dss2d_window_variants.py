#!/usr/bin/env python3
"""Window shapes of K19's bf16x3 kernel, timed on one card.

    python3 scripts/torch_dss2d_window_variants.py [--only A,B] [--rounds N]

Run from the repository root on a machine with an sm_90 card and nvcc.
Each variant is a text edit of cdk_torch/csrc/biharmonic_dss2d_resident.cu,
built side by side with one nvcc each into build/dss2d_variants/<name>/ and
loaded with ctypes:

  tree     the committed kernel: two elements a warp (16-column tiles),
           whole rows where 2k+1 fit in 64 elements, else an 8 x 8 window
  rect8x8  the same kernel always in the 8 x 8 window
  rows1    one element a warp (32-column tiles), whole rows in 32 elements
  rect4x8  one element a warp, a 4 x 8 window (k <= 1)

Every variant runs the bf16x3 form at the production torus (75 x 72, ncol
720) at 1-3 steps a launch and at the shipped 4 x 4 (ncol 2880) at 1-4,
where its window takes the depth (the geometry rule below; any other
failure fails the run), is held to dss2d_resident_plain at the 5e-5 gate
and is then timed with CUDA events (chip_smoke.timed_ms) in turns, the
variants in order and then in reverse: us per step, the mean of the rounds,
printed with the card's name and power limit, and each kernel's ptxas
registers and spills.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from cdk_torch.core.build import nvcc_path  # noqa: E402

CSRC = ROOT / "cdk_torch" / "csrc"
OUT = ROOT / "build" / "dss2d_variants"
SOURCE = "biharmonic_dss2d_resident.cu"
HEADER = "biharmonic_common.cuh"
CHOICE = "  if (!whole_rows(g, 2 * X3_WARPS) && !rectangle(g, 8, 8))\n"


def sub(text: str, old: str, new: str, count: int = 1) -> str:
    if text.count(old) != count:
        raise SystemExit(f"{SOURCE}: {old!r} found {text.count(old)} times, want "
                         f"{count}: the variant table is stale")
    return text.replace(old, new)


def one_a_warp(src: str) -> str:
    """The kernel at one window element a warp: both m-tiles are halves of
    a 32-column tile of element y (columns 16m + ...), windows of up to 32
    elements."""
    s = sub(src, "constexpr int TC = 16;", "constexpr int TC = 32;")
    s = sub(s, "constexpr int WARP_STAGE = 2 * NPTS * (STAGE_STRIDE + 1);",
            "constexpr int WARP_STAGE = NPTS * (STAGE_STRIDE + 1);")
    s = sub(s, "4 * side_len(2 * warps)", "4 * side_len(warps)")
    s = sub(s, "side_len(2 * blockDim.y)", "side_len(blockDim.y)")
    # the prefetch: lane c of each of the element's 16 rows
    s = sub(s, """    const int c = lane & 15;
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int el = 2 * y + m;
      const bool present = el < W;
      const size_t e = present ? static_cast<size_t>(elem(win, el)) : 0;
#pragma unroll
      for (int i = 0; i < NPTS / 2; ++i) {
        const int p = 2 * i + (lane >> 4);
        const bool ok = present && c0 + c < g.ncol;
        bih::cp_async<4>(stage + (m * NPTS + p) * STAGE_STRIDE + c,
                         ok ? q + (e * NPTS + p) * g.ncol + c0 + c : q, ok);
      }
    }""", """    const int c = lane;
    {
      const int el = y;
      const bool present = el < W;
      const size_t e = present ? static_cast<size_t>(elem(win, el)) : 0;
#pragma unroll
      for (int p = 0; p < NPTS; ++p) {
        const bool ok = present && c0 + c < g.ncol;
        bih::cp_async<4>(stage + p * STAGE_STRIDE + c,
                         ok ? q + (e * NPTS + p) * g.ncol + c0 + c : q, ok);
      }
    }""")
    # one element's neighbours, operator and masses; the m-tiles' columns
    s = sub(s, """  int nbs[2];
#pragma unroll
  for (int m = 0; m < 2; ++m) {""", """  int nbs[1];
#pragma unroll
  for (int m = 0; m < 1; ++m) {""")
    s = sub(s, "bih::tc::Op op[2];", "bih::tc::Op op[1];")
    s = sub(s, "float* wbuf = stage + 2 * NPTS * STAGE_STRIDE;",
            "float* wbuf = stage + NPTS * STAGE_STRIDE;")
    s = sub(s, """#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const int el = 2 * y + m;""", """#pragma unroll
      for (int m = 0; m < 1; ++m) {
        const int el = y;""")
    s = sub(s, "const int el = 2 * y + m, r = el / g.cols", "const int el = y, r = el / g.cols",
            count=2)
    s = sub(s, "(2 * y + m) * NP * SIDE_STRIDE", "y * NP * SIDE_STRIDE", count=2)
    s = sub(s, "SIDE_STRIDE, gq);", "SIDE_STRIDE, 16 * m + gq);", count=4)
    s = sub(s, "nbs[m]", "nbs[0]", count=3)
    s = sub(s, "op[m], x[m]", "op[0], x[m]")
    s = sub(s, "wbuf[m * NPTS + pt(t, k & 3)]", "wbuf[pt(t, k & 3)]")
    s = sub(s, "stage[(m * NPTS + pt(t, k & 3)) * STAGE_STRIDE + 8 * (k >> 2) + gq]",
            "stage[pt(t, k & 3) * STAGE_STRIDE + 16 * m + 8 * (k >> 2) + gq]")
    s = sub(s, "const int col = c0 + 8 * (k >> 2) + gq;",
            "const int col = c0 + 16 * m + 8 * (k >> 2) + gq;")
    return sub(s, "const int warps = (g.rows * g.cols + 1) / 2;",
               "const int warps = g.rows * g.cols;")


def variants(src: str) -> dict:
    return {"tree": src,
            "rect8x8": sub(src, CHOICE, "  if (!rectangle(g, 8, 8))\n"),
            "rows1": sub(one_a_warp(src), CHOICE, "  if (!whole_rows(g, X3_WARPS))\n"),
            "rect4x8": sub(one_a_warp(src), CHOICE, "  if (!rectangle(g, 4, 8))\n")}


def takes(name: str, ey: int, k: int) -> bool:
    """Whether the variant's window takes k steps on rows of ey elements
    (whole_rows / rectangle in the source)."""
    rows = {"tree": 64, "rows1": 32}.get(name)
    whole = rows is not None and rows // ey >= 2 * k + 1
    side = {"tree": 8, "rect8x8": 8, "rect4x8": 4}.get(name)
    return whole or (side is not None and 2 * k + 1 <= side)


def build(name: str, text: str) -> tuple[str, int, str]:
    d = OUT / name
    d.mkdir(parents=True, exist_ok=True)
    (d / SOURCE).write_text(text)
    (d / HEADER).write_text((CSRC / HEADER).read_text())
    cmd = [nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
           "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-shared", "-o", str(d / "lib.so"),
           str(d / SOURCE)]
    p = subprocess.run(cmd, capture_output=True, text=True)
    return name, p.returncode, p.stderr + p.stdout


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", help="comma-separated variant names")
    ap.add_argument("--rounds", type=int, default=2, help="timing rounds (default 2)")
    opts = ap.parse_args()
    dev, card = cs.phase_device()

    import torch

    import cdk_torch.kernels  # noqa: F401  (registers the variants)
    from cdk_torch.core import registry
    from cdk_torch.core.config import BiharmonicConfig, with_overrides
    from cdk_torch.kernels.biharmonic import dss2d_resident as dr2
    from cdk_torch.kernels.biharmonic import problem as bp
    from cdk_torch.kernels.biharmonic.dss2d import torus_shape

    table = variants((CSRC / SOURCE).read_text())
    if opts.only:
        table = {k: v for k, v in table.items() if k in opts.only.split(",")}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(table)) as pool:
        built = list(pool.map(lambda kv: build(*kv), table.items()))
    print(f"[variants] built {len(built)} in {time.perf_counter() - t0:.1f} s")
    libs = {}
    for name, rc, log in built:
        if rc:
            print(f"[variants] {name}: nvcc failed\n{log[-3000:]}")
            return 1
        for m in re.finditer(r"Function properties for (\S+)\n\s+\d+ bytes stack frame, (\d+) "
                             r"bytes spill stores, (\d+) bytes spill loads\n.*?Used (\d+) "
                             r"registers", log):
            if "dss2d_x3_kernel" in m.group(1):
                print(f"[ptxas] {name} dss2d_x3_kernel: {m.group(4)} registers, spill "
                      f"{m.group(2)}/{m.group(3)} B")
        lib = ctypes.CDLL(str(OUT / name / "lib.so"))
        fn = lib.cdk_dss2d_resident_f32
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        libs[name] = fn

    failed = []
    for label, nelemd, qsize, depths in (("production", 5400, 10, (1, 2, 3)),
                                         ("shipped", 16, 40, (1, 2, 3, 4))):
        cfg = with_overrides(BiharmonicConfig(nelemd=nelemd, qsize=qsize, dtype="float32",
                                              device_init=True), rrearth=0.1)
        data = bp.init_data(cfg, dev)
        q = bp.to_lane_layout(data.qtens)
        ex, ey = torus_shape(nelemd)
        L, w = registry.get("biharmonic_dss2d", "fused_operator_bd8_resident_x3").fn(
            cfg)["prepare"](data)
        out = torch.empty_like(q)
        stream = torch.cuda.current_stream(dev).cuda_stream
        for k in depths:
            ref = dr2.dss2d_resident_plain(L, w, q, ex, ey, k, "bf16x3")
            runs = {}
            for name, fn in libs.items():
                if not takes(name, ey, k):
                    continue

                def run(fn=fn, k=k):
                    err = fn(L.data_ptr(), w.data_ptr(), q.data_ptr(), out.data_ptr(), ex, ey,
                             cfg.ncol, k, 1, stream)
                    if err:
                        raise RuntimeError(f"CUDA error {err}")

                try:
                    run()
                    torch.cuda.synchronize()
                except RuntimeError as e:
                    print(f"[variants] {name} {label} k={k}: {e}")
                    failed.append(f"{name} {label} k={k}")
                    continue
                rel, _, big = cs.errors(out, ref, "l2")
                if not (rel < 5e-5 and big > 0):
                    failed.append(f"{name} {label} k={k} rel_l2 {rel:.3e}")
                runs[name] = (run, rel)
            times = {name: [] for name in runs}
            order = list(runs)
            for r in range(opts.rounds):
                for name in order if r % 2 == 0 else order[::-1]:
                    times[name].append(cs.timed_ms(runs[name][0], cs.REPS) / k * 1e3)
            for name, us in times.items():
                print(f"[variants] {label} {ex}x{ey} ncol={cfg.ncol} k={k} {name}: "
                      f"{sum(us) / len(us):.1f} us/step (rounds "
                      f"{' '.join(f'{x:.1f}' for x in us)}), rel_l2 {runs[name][1]:.1e} "
                      f"[{card}]")
            del ref
        del data, q, L, w, out
        torch.cuda.empty_cache()
    if failed:
        print(f"[variants] failed: {failed}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
