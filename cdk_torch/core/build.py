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
nvcc's stderr.

The C interface is read from the sources: every ``int cdk_*(...)``
definition in ``csrc/*.cu`` (written out, or made by a ``#define`` whose
body defines ``int name(...)``) is an entry point, typed from its
parameters when the library is loaded (`declarations`).  Every kernel is
launched through `launch`, which passes tensors as device pointers, adds
PyTorch's current stream as the last argument, raises on the
``cudaGetLastError()`` the entry returns, and counts the launch on its
`trace.counted` wrapper.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from pathlib import Path

import torch

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


# C parameter types -> ctypes; any other type is refused at load
C_TYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
           "int": ctypes.c_int, "float": ctypes.c_float,
           "double": ctypes.c_double, "long long": ctypes.c_longlong}
_COMMENT = re.compile(r"//[^\n]*|/\*.*?\*/", re.S)
_DEFINITION = re.compile(r"\bint\s+(cdk_\w+)\s*\(([^)]*)\)\s*\{")
_MACRO = re.compile(r"#define\s+(\w+)\(\s*(\w+)\s*,[^)]*\)\s*"
                    r"int\s+\2\s*\(([^)]*)\)")


def _param_types(params: str, name: str) -> tuple:
    """The ctypes of a C parameter list `T1 name1, T2 name2, ...`."""
    out = []
    for p in params.split(","):
        if p.strip() in ("", "void"):
            continue
        ctype = " ".join(p.replace("*", " * ").split()[:-1]).replace(" *", "*")
        if ctype not in C_TYPES:
            raise TypeError(f"{name}: parameter {p.strip()!r} has a type the "
                            f"launch path does not map ({', '.join(C_TYPES)})")
        out.append(C_TYPES[ctype])
    return tuple(out)


def parse_declarations(text: str) -> dict[str, tuple]:
    """Each `int cdk_*(...)` entry defined in the CUDA source `text` -> its
    parameters' ctypes, in order; entries a macro defines are read from
    the macro's parameter list at each `MACRO(cdk_name, ...)` use."""
    text = _COMMENT.sub("", text.replace("\\\n", " "))
    out = {name: _param_types(params, name)
           for name, params in _DEFINITION.findall(text)}
    for macro, _, params in _MACRO.findall(text):
        for name in re.findall(rf"^\s*{macro}\(\s*(cdk_\w+)\s*,", text, re.M):
            out[name] = _param_types(params, name)
    return out


@functools.cache
def declarations() -> dict[str, tuple]:
    """Every entry point of csrc/*.cu -> its parameters' ctypes."""
    out: dict[str, tuple] = {}
    for src in sorted(CSRC.glob("*.cu")):
        for name, types in parse_declarations(src.read_text()).items():
            if name in out:
                raise ValueError(f"{name} is defined twice in csrc/")
            out[name] = types
    return out


@functools.cache
def library() -> dict:
    """The loaded kernel library (built on first use in this process): each
    entry point by name -> (its ctypes function, argtypes and restype set
    from its declaration; the positions of its pointer parameters before
    the last, the stream)."""
    lib = ctypes.CDLL(str(build().path))
    entries = {}
    for name, types in declarations().items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = types, ctypes.c_int
        entries[name] = fn, tuple(i for i, t in enumerate(types[:-1])
                                  if t is ctypes.c_void_p)
    return entries


def c_args(pointers: tuple, args) -> list:
    """A launch's arguments as ctypes takes them: at each position in
    `pointers` a tensor as its data pointer and None as NULL; a number
    elsewhere as it is."""
    out = list(args)
    for i in pointers:
        a = out[i]
        if a is not None:
            out[i] = a.data_ptr()
    return out


def launch(wrapper, steps: int, what: str, entry: str, device, *args) -> None:
    """Call the entry point `entry` with `args` in C order (`c_args`) and
    PyTorch's current stream on `device` (a CUDA tensor's device, so
    indexed), under that device; raise as `what` if it reports an error,
    else add one launch and `steps` steps to `wrapper`, the
    `trace.counted` wrapper it launches for."""
    fn, pointers = library()[entry]
    # the raw stream handle: `current_stream(device).cuda_stream` builds a
    # Stream object first, ~5 us a launch on the H100 machine's host
    stream = torch._C._cuda_getCurrentRawStream(device.index)
    with torch.cuda.device(device):
        err = fn(*c_args(pointers, args), stream)
    if err:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
    wrapper.launches += 1
    wrapper.steps += steps
