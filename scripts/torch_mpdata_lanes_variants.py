#!/usr/bin/env python3
"""Design variants of K10, the MPDATA step on the (x, z, s) layout, timed on one card.

    python3 scripts/torch_mpdata_lanes_variants.py [--only A,B] [--rounds N] [--diagnose]

Run from the repository root on a machine with an sm_90 card and nvcc.
Each variant is a text edit of cdk_torch/csrc/mpdata_sweep.cuh (K10 is its
LANES mode, launched by csrc/mpdata_lanes.cu), built side by side with one
nvcc each into build/lanes_variants/<name>/ and loaded with ctypes:

  tree      the committed sources (LANES_WARPS 8: 8 slices a block; 2 tile rows)
  warps16   16 warps a block (16 slices; 2, 4 and 8 warps a slice split 8, 4, 2)
  warps32   32 warps a block (1024 threads, so at most 64 registers a thread)
  tiles3    three tile rows in flight (row p + 3 issued at iteration p)
  naive     no tiles: each warp reads its rows straight from device memory at
            the level stride nslices (plain loads, so L1 serves the block's
            other warps) and stores them so; the split's flux rows still meet
            in shared memory
  naive32   the naive form with 32 warps a block

With --diagnose, four more take one piece out of the tree's kernel and are
timed only (their outputs are wrong by design): nobar (no barrier), nowait
(no wait for the copies), nocopy (no copies issued) and nostore (the ring's
rows never leave for device memory).

Every variant runs at the production 8192 x 32 x 58 (f32 and f64) and the
shipped 48 slices (f64 and f32), f held bitwise and the flux within the
family gate against advect_lanes_plain; then each is timed with CUDA events
(chip_smoke.timed_ms) in turns, the variants in order and then in reverse,
and the mean ms per launch printed with the card's name and power limit.
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
OUT = ROOT / "build" / "lanes_variants"
FILES = ("mpdata_sweep.cuh", "mpdata_lanes.cu")
TREE = dict(warps=8, tiles=2)

# the naive form's rows: straight from and to device memory, no barrier
NAIVE = """template <typename S, typename C, int L>
struct Lanes {
  using Row = Lv<L, C>;
  S* buf;
  S* ring;
  long long s0;
  int W, P, j, k0, live, cj, ck, bar, threads;

  __device__ void sync() const {}
  __device__ void fetch(const Sweep<S>&, int, int, int, int) const {}
  template <int PENDING>
  __device__ void ready() const {}
  __device__ Row load(const S* base, long long ns, int x, int levels, int nzm) const {
    Row r;
    EACH(i) {
      const int k = k0 + i;
      r.v[i] = j < live && k < nzm
                   ? Cvt<S, C>::ld(base[(static_cast<long long>(x) * levels + k) * ns + s0 + j])
                   : C(0);
    }
    return r;
  }
  __device__ Row row(const Sweep<S>& a, int r, int field) const {
    if (field == 0) return load(a.f, a.nslices, r, a.nzm, a.nzm);
    if (field == 1) return load(a.u, a.nslices, r - 1, a.nzm, a.nzm);
    return load(a.w, a.nslices, r - 1, a.nzm + 1, a.nzm);
  }
  __device__ void levels(const Sweep<S>& a, Row (&lv)[3]) const {
    lv[0] = load(a.rho, a.nslices, 0, a.nzm, a.nzm);
    lv[1] = load(a.adz, a.nslices, 0, a.nzm, a.nzm);
    lv[2] = load(a.rhow, a.nslices, 0, a.nzm + 1, a.nzm);
  }
  __device__ void store(S* base, long long ns, int x, int nzm, const Row& v) const {
    if (j >= live) return;
    EACH(i) {
      const int k = k0 + i;
      if (k < nzm) base[(static_cast<long long>(x) * nzm + k) * ns + s0 + j] = Cvt<S, C>::st(v.v[i]);
    }
  }
  __device__ void put(const Sweep<S>& a, int r, const Row& x) const {
    store(a.f_out, a.nslices, r, a.nzm, x);
  }
  __device__ void flush(const Sweep<S>&, int) const {}
  __device__ void store_flux(const Sweep<S>& a, const Row& x) const {
    store(a.flux_out, a.nslices, 0, a.nzm, x);
  }
};
"""


def sub(files: dict, name: str, old: str, new: str) -> dict:
    if old not in files[name]:
        raise SystemExit(f"{name} has no {old!r}: the variant table is stale")
    return {**files, name: files[name].replace(old, new)}


def variant(src: dict, warps=8, tiles=2, naive=False) -> dict:
    """The sources with LANES_WARPS, LANES_TILES and the naive rows."""
    h = "mpdata_sweep.cuh"
    f = sub(src, h, f"constexpr int LANES_WARPS = {TREE['warps']};",
            f"constexpr int LANES_WARPS = {warps};")
    f = sub(f, h, f"constexpr int LANES_TILES = {TREE['tiles']};",
            f"constexpr int LANES_TILES = {tiles};")
    if naive:
        text = f[h]
        start = text.index("template <typename S, typename C, int L>\nstruct Lanes {")
        end = text.index("\n};\n", start) + 4
        f = {**f, h: text[:start] + NAIVE + text[end:]}
        # no tiles or ring in shared memory: only the split's flux rows
        f = sub(f, h, "constexpr int LANES_ROWS = 3 * LANES_TILES + LANES_RING;",
                "constexpr int LANES_ROWS = 0;")
    return f


def variants(src: dict) -> dict:
    return {"tree": src, "warps16": variant(src, warps=16),
            "warps32": variant(src, warps=32), "tiles3": variant(src, tiles=3),
            "naive": variant(src, naive=True), "naive32": variant(src, warps=32, naive=True)}


def diagnostics(src: dict) -> dict:
    """The tree's kernel with one piece taken out (wrong outputs, timed only)."""
    h = "mpdata_sweep.cuh"
    return {
        "nobar": sub(src, h, "__device__ void sync() const { bar_sync(bar, threads); }",
                     "__device__ void sync() const {}"),
        "nowait": sub(src, h, "    cp_async_wait_group<PENDING>();\n    sync();",
                      "    sync();"),
        "nocopy": sub(src, h, "      cp_async_elem<sizeof(S)>(dst + cj * P + k, from);",
                      "      (void)from;"),
        "nostore": sub(src, h, "for (int k = ck; k < nzm; k += 32, to += 32 * ns) *to = from[k];",
                       "(void)to;"),
    }


def build(name: str, files: dict) -> tuple[str, int, str]:
    d = OUT / name
    d.mkdir(parents=True, exist_ok=True)
    for n, text in files.items():
        (d / n).write_text(text)
    cmd = [nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
           "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-shared", "-o", str(d / "lib.so"),
           str(d / "mpdata_lanes.cu")]
    p = subprocess.run(cmd, capture_output=True, text=True)
    return name, p.returncode, p.stderr + p.stdout


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", help="comma-separated variant names")
    ap.add_argument("--rounds", type=int, default=2, help="timing rounds (default 2)")
    ap.add_argument("--diagnose", action="store_true",
                    help="also time the tree's kernel with one piece taken out")
    opts = ap.parse_args()
    dev, card = cs.phase_device()

    import torch

    from cdk_torch.core.config import MpdataConfig
    from cdk_torch.kernels.mpdata import lanes
    from cdk_torch.kernels.mpdata import problem as mp

    src = {n: (CSRC / n).read_text() for n in FILES}
    table = variants(src)
    diagnosed = diagnostics(src) if opts.diagnose else {}
    table.update(diagnosed)
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
            k = re.search(r"mpdata_sweep_kernelI(\w*?Lb1E)EEv", m.group(1))
            if k:
                print(f"[ptxas] {name} mpdata_sweep_kernel<{k.group(1)}>: {m.group(4)} "
                      f"registers, spill {m.group(2)}/{m.group(3)} B")
        lib = ctypes.CDLL(str(OUT / name / "lib.so"))
        for fn in (lib.cdk_mpdata_lanes_f32, lib.cdk_mpdata_lanes_f64):
            fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        libs[name] = lib

    failed = []
    gates = {"float32": 1e-5, "float64": 1e-13}
    for label, nslices, dtype in (("production", 8192, "float32"),
                                  ("production", 8192, "float64"),
                                  ("shipped", 48, "float64"), ("shipped", 48, "float32")):
        cfg = MpdataConfig(nslices=nslices, dtype=dtype, device_init=True)
        d = mp.init_data(cfg, dev)
        xzs = [lanes.to_xzs(getattr(d, n)) for n in lanes.FIELDS]
        f_p, flux_p = lanes.advect_lanes_plain(*xzs)
        stream = torch.cuda.current_stream(dev).cuda_stream
        runs = {}
        for name, lib in libs.items():
            f_o, flux_o = torch.empty_like(xzs[0]), torch.empty_like(xzs[6])
            fn = lib.cdk_mpdata_lanes_f32 if dtype == "float32" else lib.cdk_mpdata_lanes_f64
            ptrs = [t.data_ptr() for t in xzs] + [f_o.data_ptr(), flux_o.data_ptr()]

            def run(fn=fn, ptrs=ptrs, name=name):
                if fn(*ptrs, nslices, cfg.nx, cfg.nzm, 0, stream):
                    raise RuntimeError(f"{name}: launch failed")

            run()
            torch.cuda.synchronize()
            same = torch.equal(f_o, f_p)
            rel = cs.errors(flux_o, flux_p, "l1")[0]
            print(f"[check] {name} {label} {dtype}: f bitwise={same}, flux rel_l1 {rel:.3e} "
                  f"(gate {gates[dtype]:g})" + (", not held (diagnostic)" if name in diagnosed
                                                else ""))
            if not (same and rel < gates[dtype]) and name not in diagnosed:
                failed.append(f"{name} {label} {dtype}")
            runs[name] = run
        ms = {name: [] for name in runs}
        for r in range(opts.rounds):
            order = list(runs) if r % 2 == 0 else list(runs)[::-1]
            for name in order:
                ms[name].append(cs.timed_ms(runs[name], cs.REPS))
        for name, t in ms.items():
            print(f"[time] {name} {label} S={nslices} {dtype}: {sum(t) / len(t):.4f} ms a "
                  f"launch (rounds {', '.join(f'{x:.4f}' for x in t)}) [{card}]")
        del d, xzs, f_p, flux_p
    if failed:
        print(f"[variants] FAILED: {failed}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
