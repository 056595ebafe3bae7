"""Build the hand-written CUDA kernels and load them with ctypes.

Every ``csrc/*.cu`` is compiled by its own nvcc, all started together,
and the objects are linked into one shared library with a plain C
interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
         -Xcompiler -fPIC -Xptxas -v -c -o <name>.o csrc/<name>.cu   # each
    nvcc -gencode arch=compute_90a,code=sm_90a -shared \
         -o build/cdk_torch/libcdk_torch_<hash>.so *.o

The library goes to ``build/cdk_torch/`` beside the package, at first use,
named by a hash of the sources and flags, so an edited source is rebuilt
and an unchanged one is loaded as it is.  A failed build raises with
nvcc's stderr.  Kernels take device pointers and PyTorch's current stream
as ``c_void_p`` and return ``cudaGetLastError()`` as an int.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "cdk_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")


@dataclass(frozen=True)
class Built:
    path: Path
    seconds: float  # nvcc wall time; 0.0 when an existing build was reused
    log: str        # nvcc's output (ptxas registers / shared memory / spills)


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME); the CUDA kernels "
                       "are built on the machine with the card")


def _digest(sources: list[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _run(cmd: list[str]) -> subprocess.CompletedProcess:
    return subprocess.run(cmd, capture_output=True, text=True)


def build(build_dir: Path = BUILD_DIR) -> Built:
    """Compile csrc/*.cu into build_dir unless this exact build exists."""
    cu = sorted(CSRC.glob("*.cu"))
    out = build_dir / f"libcdk_torch_{_digest(cu + sorted(CSRC.glob('*.cuh')))}.so"
    if out.exists():
        return Built(out, 0.0, "")
    nvcc = nvcc_path()
    build_dir.mkdir(parents=True, exist_ok=True)
    # private names, then an atomic rename: concurrent processes never load
    # a half-written library
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    objs = [out.with_name(f"{out.stem}.{src.stem}.{os.getpid()}.o")
            for src in cu]
    t0 = time.perf_counter()
    try:
        with ThreadPoolExecutor(max_workers=len(cu)) as pool:
            procs = list(pool.map(_run, (
                [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                for src, obj in zip(cu, objs))))
        log = "".join(p.stderr + p.stdout for p in procs)
        for src, proc in zip(cu, procs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name} (exit "
                                   f"{proc.returncode}):\n{proc.stderr}{proc.stdout}")
        proc = _run([nvcc, *LINK_FLAGS, "-o", str(tmp), *map(str, objs)])
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed (exit {proc.returncode}):"
                               f"\n{proc.stderr}{proc.stdout}")
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
        for obj in objs:
            obj.unlink(missing_ok=True)
    return Built(out, time.perf_counter() - t0, log + proc.stderr + proc.stdout)


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use in this process)."""
    return ctypes.CDLL(str(build().path))


def check(err: int, what: str) -> None:
    """Raise if a kernel's C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
