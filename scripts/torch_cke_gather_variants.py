#!/usr/bin/env python3
"""Design variants of the CKE gather kernels K3 and K13, timed on one card.

    python3 scripts/torch_cke_gather_variants.py [--parent DIR] [--only A,B] [--rounds N]

Run from the repository root on a machine with an sm_90 card and nvcc.
Each variant is a text edit of cdk_torch/csrc/cke_common.cuh, cke_rows.cu
and cke_lanegather.cu (the constants SLOTS, THREADS and CHUNK, the vector
path, the cache hints, launch bounds), built side by side with one nvcc
each into build/cke_variants/<name>/ and loaded with ctypes.  `--parent
DIR` adds the sources of an older tree's cdk_torch/csrc as the variant
"parent" (its K13 takes no scratch table).  Every variant's K3 and K13 run
at the production 256000 x 28000 x 100 (f32) and the shipped 25600 x 2800
x 100 (f64 and f32) and are held bitwise to the plain versions; then each
is timed with CUDA events (chip_smoke.timed_ms) in turns, the variants in
order and then in reverse, and the mean ms per launch printed with the
card's name and power limit.
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
OUT = ROOT / "build" / "cke_variants"
FILES = ("cke_common.cuh", "cke_rows.cu", "cke_lanegather.cu")
# the constants of the committed sources, as the edits find them
TREE = dict(slots=5, t3=128, t13=160, chunk=64)


def sub(files: dict, name: str, old: str, new: str) -> dict:
    if old not in files[name]:
        raise SystemExit(f"{name} has no {old!r}: the variant table is stale")
    return {**files, name: files[name].replace(old, new)}


def variant(src: dict, slots=5, t3=128, t13=160, chunk=64, scalar=False, policy=True,
            stream=True, l1na=False, bounds3=None, bounds13=None) -> dict:
    """The sources with the given constants and switches (the committed
    tree's by default): `scalar` never takes the 16-byte path; `policy`
    False reads the table evict_normal; `stream` False reads and writes the
    streams without the evict-first hint; `l1na` adds L1::no_allocate to the
    table reads; bounds3/bounds13 give the kernels' min blocks an SM."""
    f = sub(src, "cke_common.cuh", f"constexpr int SLOTS = {TREE['slots']};",
            f"constexpr int SLOTS = {slots};")
    f = sub(f, "cke_rows.cu", f"constexpr int THREADS = {TREE['t3']};",
            f"constexpr int THREADS = {t3};")
    f = sub(f, "cke_lanegather.cu", f"constexpr int THREADS = {TREE['t13']};",
            f"constexpr int THREADS = {t13};")
    f = sub(f, "cke_lanegather.cu", f"constexpr int CHUNK = {TREE['chunk']};",
            f"constexpr int CHUNK = {chunk};")
    if scalar:
        for name in ("cke_rows.cu", "cke_lanegather.cu"):
            f = sub(f, name, "const bool vec = nvert", "const bool vec = false && nvert")
    if not policy:
        f = sub(f, "cke_common.cuh", "L2::evict_last.b64", "L2::evict_normal.b64")
    if not stream:
        f = {n: t.replace("__ldcs(", "__ldg(").replace("__stcs(", "STORE_PLAIN(")
             for n, t in f.items()}
        f = sub(f, "cke_common.cuh", "#include <cuda_runtime.h>\n",
                "#include <cuda_runtime.h>\n#define STORE_PLAIN(p, v) (*(p) = (v))\n")
    if l1na:
        f = sub(f, "cke_common.cuh", "ld.global.nc.L2::cache_hint",
                "ld.global.nc.L1::no_allocate.L2::cache_hint")
    for name, kern, nb in (("cke_rows.cu", "cke_rows_kernel", bounds3),
                           ("cke_lanegather.cu", "cke_lanegather_kernel", bounds13)):
        if nb:
            f = sub(f, name, f"__launch_bounds__(THREADS)\n{kern}",
                    f"__launch_bounds__(THREADS, {nb})\n{kern}")
    return f


def variants(src: dict) -> dict:
    first = dict(slots=10, t3=256, t13=256, chunk=128)  # the first design
    v = {"tree": src, "first": variant(src, **first),
         "first_scalar": variant(src, **first, scalar=True)}
    for n in (1, 2, 3, 4, 5, 6, 8):
        v[f"slots{n}"] = variant(src, **{**first, "slots": n})
    five = {**first, "slots": 5}
    v["slots5_no_policy"] = variant(src, **five, policy=False)
    v["slots5_no_stream"] = variant(src, **five, stream=False)
    v["slots5_no_hints"] = variant(src, **five, policy=False, stream=False)
    v["slots5_l1na"] = variant(src, **five, l1na=True)
    for t3 in (64, 96, 192, 256):
        v[f"k3_threads{t3}"] = variant(src, t3=t3)
    for t13 in (128, 160, 192, 224, 256, 320):
        v[f"k13_threads{t13}_chunk128"] = variant(src, t13=t13, chunk=128)
    v["k3_bounds12"] = variant(src, bounds3=12)
    v["k3_bounds16"] = variant(src, bounds3=16)
    v["k13_bounds8"] = variant(src, bounds13=8)
    v["k13_bounds10"] = variant(src, bounds13=10)
    return v


def build(name: str, files: dict) -> tuple[str, int, str]:
    d = OUT / name
    d.mkdir(parents=True, exist_ok=True)
    for n, text in files.items():
        (d / n).write_text(text)
    cmd = [nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
           "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-shared", "-o", str(d / "lib.so"),
           str(d / "cke_rows.cu"), str(d / "cke_lanegather.cu")]
    p = subprocess.run(cmd, capture_output=True, text=True)
    return name, p.returncode, p.stderr + p.stdout


def entry(lib, fname: str, npointers: int):
    fn = getattr(lib, fname)
    fn.argtypes = ([ctypes.c_void_p] * npointers + [ctypes.c_int] * 4
                   + [ctypes.c_double, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", help="an older tree's root: its csrc is the variant 'parent'")
    ap.add_argument("--only", help="comma-separated variant names")
    ap.add_argument("--rounds", type=int, default=2, help="timing rounds (default 2)")
    opts = ap.parse_args()
    dev, card = cs.phase_device()

    import torch

    from cdk_torch.core.config import CkeConfig
    from cdk_torch.kernels.cke import problem as cp
    from cdk_torch.kernels.cke.lanegather import cke_lanegather_plain
    from cdk_torch.kernels.cke.reference import coef3_of, fsign1
    from cdk_torch.kernels.cke.rows import cke_rows_plain

    src = {n: (CSRC / n).read_text() for n in FILES}
    table = variants(src)
    if opts.parent:
        table = {"parent": {n: (Path(opts.parent) / "cdk_torch" / "csrc" / n).read_text()
                            for n in FILES}, **table}
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
            k = re.search(r"(cke_rows_kernel|cke_lanegather_kernel)I(\w*?)EEv", m.group(1))
            if k:
                print(f"[ptxas] {name} {k.group(1)}<{k.group(2)}>: {m.group(4)} registers, "
                      f"spill {m.group(2)}/{m.group(3)} B")
        libs[name] = ctypes.CDLL(str(OUT / name / "lib.so"))

    failed = []
    for label, nedges, ncells, dtype in (("production", 256000, 28000, "float32"),
                                         ("shipped", 25600, 2800, "float64"),
                                         ("shipped", 25600, 2800, "float32")):
        cfg = CkeConfig(nedges=nedges, ncells=ncells, dtype=dtype, device_init=True)
        d = cp.init_data(cfg, dev)
        c3 = coef3_of(cfg)
        args = [d.adv_cells, d.adv_coefs, d.adv_coefs3, d.tracer * d.cell_mask, d.ntf,
                d.adv_mask]
        trans = [x.T.contiguous() for x in args[:4]] + [
            (d.ntf * d.adv_mask).T.contiguous(), fsign1(d.ntf).T.contiguous()]
        ref3, ref13 = cke_rows_plain(*args, c3), cke_lanegather_plain(*trans, c3)
        sfx = "f32" if dtype == "float32" else "f64"
        sizes = (nedges, ncells, cfg.nadv, cfg.nvertlevels)
        stream = torch.cuda.current_stream(dev).cuda_stream
        runs = {}
        for name, lib in libs.items():
            out3, out13 = torch.empty_like(d.ntf), torch.empty_like(trans[4])
            tab = torch.empty((ncells, cfg.nvertlevels), dtype=args[3].dtype, device=dev)
            p13 = [x.data_ptr() for x in trans] + ([] if name == "parent" else [tab.data_ptr()])
            f3 = entry(lib, f"cdk_cke_rows_{sfx}", 7)
            f13 = entry(lib, f"cdk_cke_lanegather_{sfx}", len(p13) + 1)
            p3 = [x.data_ptr() for x in args] + [out3.data_ptr()]
            p13 = p13 + [out13.data_ptr()]

            def k3(f3=f3, p3=p3):
                if f3(*p3, *sizes, c3, stream):
                    raise RuntimeError("K3 launch failed")

            def k13(f13=f13, p13=p13):
                if f13(*p13, *sizes, c3, stream):
                    raise RuntimeError("K13 launch failed")

            k3()
            k13()
            torch.cuda.synchronize()
            same = (torch.equal(out3, ref3), torch.equal(out13, ref13))
            if not all(same):
                failed.append(f"{name} {label} {dtype}")
            runs[name] = (k3, k13, same, (out3, out13, tab))
        times = {name: ([], []) for name in runs}
        order = list(runs)
        for r in range(opts.rounds):
            for name in order if r % 2 == 0 else order[::-1]:
                times[name][0].append(cs.timed_ms(runs[name][0], cs.REPS))
                times[name][1].append(cs.timed_ms(runs[name][1], cs.REPS))
        for name, (t3, t13) in times.items():
            print(f"[variants] {label} {dtype} {name}: K3 {sum(t3) / len(t3):.4f} ms "
                  f"K13 {sum(t13) / len(t13):.4f} ms (rounds {' '.join(f'{x:.4f}' for x in t3)}"
                  f" / {' '.join(f'{x:.4f}' for x in t13)}); bitwise K3={runs[name][2][0]} "
                  f"K13={runs[name][2][1]} [{card}]")
        del runs, d, args, trans, ref3, ref13
        torch.cuda.empty_cache()
    if failed:
        print(f"[variants] not bitwise the plain versions: {failed}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
