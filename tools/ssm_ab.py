#!/usr/bin/env python3
"""Time per launch of the selective-scan kernel of several checkouts, on
one card in one call.

    python3 tools/ssm_ab.py SRC [SRC ...]

Each SRC is the ``src`` directory of a checkout (this one's, or a parent's
unpacked with ``git archive`` into a directory that .gitignore lists).
Each runs in a process of its own, in the order given (parent, change,
change, parent compares two versions fairly): it imports ``repro_torch``
from SRC, builds that checkout's ``csrc/ssm_scan.cu`` into its own
``build/``, and times ``ssm_scan_cuda`` at the Jamba mixer's [2, 2048,
16384, 16] in float32 and bfloat16 on the mixer's inputs (chip_smoke.py
phase 11's: CUDA events, inputs cycled past the L2), and its copies alone
(``ssm_scan_loads_cuda``) where the checkout has them. Prints one JSON
line per run and the card's name and power limit. Needs a card.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def one(src: str) -> dict:
    sys.path.insert(0, src)
    import torch

    import repro_torch
    from repro_torch.kernels.ssm_scan import kernel
    sys.path.insert(1, str(ROOT))
    import chip_smoke           # after repro_torch: it puts its own src first
    torch.backends.cuda.matmul.allow_tf32 = False
    row = {"src": src, "package": str(Path(repro_torch.__file__).parent)}
    for dtype in ("float32", "bfloat16"):
        inputs = chip_smoke.ssm_inputs(2, 2048, 16384, 16, dtype)
        nbytes = chip_smoke.ssm_bound(2, 2048, 16384, 16, dtype)[3]
        row[f"ms_{dtype}"] = chip_smoke.device_ms(chip_smoke.cycling(
            kernel.ssm_scan_cuda, inputs, nbytes), reps=10, rounds=5)
        loads = getattr(kernel, "ssm_scan_loads_cuda", None)
        row[f"loads_only_ms_{dtype}"] = None if loads is None else (
            chip_smoke.device_ms(chip_smoke.cycling(loads, inputs, nbytes),
                                 reps=10, rounds=5))
        del inputs
        torch.cuda.empty_cache()
    return row


def main() -> int:
    if len(sys.argv) > 2 and sys.argv[1] == "--one":
        print(json.dumps(one(sys.argv[2])), flush=True)
        return 0
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    for src in sys.argv[1:]:
        run = subprocess.run([sys.executable, __file__, "--one", src],
                             capture_output=True, text=True)
        sys.stderr.write(run.stderr[-2000:])
        if run.returncode != 0:
            return run.returncode
        print(run.stdout.strip().splitlines()[-1], flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
