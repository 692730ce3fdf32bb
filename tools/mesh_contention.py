#!/usr/bin/env python3
"""Whether chip_smoke.py's phase-20 dry-run process slows the phases it
runs beside: phase 6c ("graph", host-heavy) alone, then beside the process
``chip_smoke.start_dryrun_cells`` starts, then alone again, each wall
printed. Card only; run from the repo root:

    python3 tools/mesh_contention.py
"""
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def main() -> int:
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import _build
    if not torch.cuda.is_available():
        print("mesh_contention: torch sees no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.card_line(), flush=True)
    mods = cs._kernel_modules()
    _build.build_many(k.NAME for k in mods.values())
    for k in mods.values():
        k.build()

    def graph(tag):
        t = time.perf_counter()
        cs.phase_graph({})
        print(f"phase 6c {tag}: {time.perf_counter() - t!r} s", flush=True)

    graph("alone")
    proc, _ = cs.start_dryrun_cells()
    try:
        t = time.perf_counter()
        graph("beside the dry-run process")
        rc = proc.wait()
        print(f"the dry-run process: {time.perf_counter() - t!r} s, exit "
              f"{rc}", flush=True)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    graph("alone again")
    return 0


if __name__ == "__main__":
    sys.exit(main())
