#!/usr/bin/env python3
"""Wall per tick of a protocol's Fig-6 grid through the port's unreduced
``run_sweep`` and its reduced path (``run_sweep(..., mesh=1)``), in turns
in one process on one card, so that the host's drift over a call does not
pass for a difference between the two paths.

    python3 tools/reduced_ab.py [--protocol P] [--seconds S] [--pairs N]

Runs unreduced, reduced, reduced, unreduced, ... (N pairs, each pair in
the other order than the last), each the 16-lane Fig-6 grid of the
protocol (benchmarks/figures.py's rates x seeds 0-3) for S simulated
seconds, and checks every run's scalars against the first unreduced
run's, bit for bit. Both paths run once first, untimed: the kernels'
build and each path's tick capture (core/compile_cache.py) fall there, so
every timed run replays a stored program (each run's line says how many
it captured). Prints one JSON line per run, the medians, and the card's
name and power limit. Needs a card.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

RATES = {"mandator-sporades": (50_000, 150_000, 300_000, 450_000),
         "multipaxos": (10_000, 30_000, 50_000, 100_000)}
SCALARS = ("throughput", "median_ms", "p99_ms", "committed")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--protocol", default="mandator-sporades",
                    choices=sorted(RATES))
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--pairs", type=int, default=3)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        raise SystemExit("reduced_ab: torch sees no CUDA device")
    from repro_torch.configs.smr import SMRConfig
    from repro_torch.core import compile_cache
    from repro_torch.core.experiment import SweepSpec, run_sweep

    cfg = SMRConfig(sim_seconds=args.seconds)
    spec = SweepSpec(rates=RATES[args.protocol], seeds=(0, 1, 2, 3))
    ticks = int(args.seconds * 1000 / cfg.tick_ms)
    run_sweep(args.protocol, cfg, spec, mesh=1)      # first calls: the
    run_sweep(args.protocol, cfg, spec)              # build, the captures
    order = []
    for i in range(args.pairs):
        order += ["unreduced", "reduced"][::1 if i % 2 == 0 else -1]
    walls = {"unreduced": [], "reduced": []}
    first = None
    for path in order:
        before = compile_cache.stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rows = run_sweep(args.protocol, cfg, spec,
                         mesh=1 if path == "reduced" else None)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        captures = compile_cache.delta(before)["captures"]
        first = first or rows
        for a, b in zip(first, rows):
            for k in SCALARS:
                if repr(a[k]) != repr(b[k]):
                    raise AssertionError(f"{path} {k}: {a[k]} != {b[k]}")
        walls[path].append(wall)
        print(json.dumps({"path": path, "wall_s": wall,
                          "ms_per_tick": wall / ticks * 1e3,
                          "captures": captures}), flush=True)
    print(json.dumps({f"median_ms_per_tick_{p}":
                      statistics.median(w) / ticks * 1e3
                      for p, w in walls.items()}))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True)
    print(card.stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
