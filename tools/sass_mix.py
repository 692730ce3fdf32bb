#!/usr/bin/env python3
"""Instruction mix of the CUDA kernels as compiled for sm_90a: builds the
port's libraries (kernels/_build.py), disassembles each with cuobjdump
and prints, per kernel whose name matches the arguments, the count of
every opcode in its SASS. Needs the CUDA toolkit (cuobjdump), so it runs
on the machine with the card:

    python3 tools/sass_mix.py ssm_scan_kernel flash_tf32_kernel

An opcode's count is per compiled instruction, not per execution: a
loop's body counts once (the scan's and flash's inner loops are
unrolled, so their steps count in full)."""
from __future__ import annotations

import collections
import re
import shutil
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.kernels import _build  # noqa: E402

SOURCES = ("flash_attention", "ssm_scan")


def cuobjdump() -> str:
    found = shutil.which("cuobjdump")
    return found or "/usr/local/cuda/bin/cuobjdump"


def kernels_sass(lib: Path) -> dict:
    """{mangled kernel name: [opcodes]} of one library."""
    out = subprocess.run([cuobjdump(), "-sass", str(lib)], check=True,
                         capture_output=True, text=True).stdout
    found, name = {}, None
    for line in out.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            found[name] = []
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?"
                     r"([A-Z][A-Z0-9_.]*)", line)
        if m and name is not None:
            found[name].append(m.group(2))
    return found


def main(patterns) -> int:
    built = _build.build_many(SOURCES)
    for src, b in built.items():
        for name, ops in sorted(kernels_sass(b.path).items()):
            if patterns and not any(p in name for p in patterns):
                continue
            mix = collections.Counter(op.split(".")[0] for op in ops)
            print(f"{src} {name}: {len(ops)} instructions")
            print("  " + ", ".join(f"{op} {n}" for op, n in mix.most_common()))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
