#!/usr/bin/env python3
"""ptxas's registers and spills of every kernel, this tree against an older one.

    python3 scripts/torch_ptxas_compare.py --parent DIR

Run from the repository root on a machine with nvcc.  Builds this tree's
cdk_torch/csrc (cdk_torch.core.build) and DIR's (an older tree unpacked
with `git archive`, built by its own build module in a child process), reads
each nvcc log's "Function properties ... Used N registers" entries and
prints, per mangled kernel name (the hashes nvcc puts in the names of
anonymous namespaces dropped): the kernels of DIR whose registers, spill
stores or spill loads changed, those this tree no longer has, those only
this tree has, and a count of those unchanged.  A template parameter this
tree appended to a kernel of DIR (the MPDATA sweep's LANES flag, `Lb0E`
last) is matched to DIR's name without it.  Exits 1 if a kernel of DIR
that this tree still has changed.
"""

from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from cdk_torch.core import build  # noqa: E402

ENTRY = re.compile(r"Function properties for (\S+)\n\s+\d+ bytes stack frame, (\d+) bytes "
                   r"spill stores, (\d+) bytes spill loads\n.*?Used (\d+) registers")
# nvcc's name for a source's anonymous namespace carries hashes of its path
HASHED = re.compile(r"_GLOBAL__N__[0-9a-f]{8}_(\d+_\w+?)_[0-9a-f]{8}")


def report(log: str) -> dict:
    """{mangled name, path hashes dropped: (registers, spill stores, spill loads)}"""
    return {HASHED.sub(r"_GLOBAL__N__\1_", m.group(1)):
            (int(m.group(4)), int(m.group(2)), int(m.group(3)))
            for m in ENTRY.finditer(log)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", required=True, help="an older tree's root")
    opts = ap.parse_args()
    mine = report(build.build().log)
    old = Path(opts.parent).resolve()
    p = subprocess.run([sys.executable, "-c",
                        "from cdk_torch.core import build; print(build.build().log)"],
                       cwd=old, capture_output=True, text=True,
                       env={**os.environ, "PYTHONSAFEPATH": "1", "PYTHONPATH": str(old)})
    if p.returncode:
        print(f"[ptxas] the older tree's build failed:\n{p.stderr[-3000:]}")
        return 1
    theirs = report(p.stdout + p.stderr)
    if not mine or not theirs:
        print("[ptxas] no report: a library was reused, not rebuilt (delete its build/)")
        return 1
    # this tree's name for each of the older tree's kernels
    alias = {re.sub(r"Lb0EEEv", "EEv", k, count=1): k for k in mine
             if "mpdata_sweep_kernel" in k}
    bad, same, gone = [], 0, 0
    for k, v in theirs.items():
        now = mine.get(k, mine.get(alias.get(k, ""), None))
        if now == v:
            same += 1
        elif now is None:
            gone += 1
            print(f"[ptxas] gone {k} (parent {v[0]} registers, spill {v[1]}/{v[2]} B)")
        else:
            bad.append(k)
            print(f"[ptxas] changed {k}: {now} (parent {v}; registers, spill stores, loads)")
    matched = set(theirs) | {alias[k] for k in theirs if k in alias}
    for k, v in sorted(mine.items()):
        if k not in matched:
            print(f"[ptxas] new {k}: {v[0]} registers, spill stores {v[1]} B, loads {v[2]} B")
    print(f"[ptxas] {same} of the older tree's {len(theirs)} kernels unchanged, "
          f"{len(bad)} changed, {gone} gone; {len(mine) - len(matched & set(mine))} new")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
