#!/usr/bin/env python3
"""Time per simulator tick of the port at the Fig-6 shape, for comparing
checkouts on one card in one call.

    python3 tools/tick_ab.py SRC [SRC ...]

Each SRC is the ``src`` directory of a checkout (this one's, or a parent's
unpacked with ``git archive`` into a directory that .gitignore lists).
Each runs in a process of its own, in the order given (parent, change,
change, parent compares two versions fairly), which imports
``repro_torch`` from SRC and runs a window of chip_smoke phase 5's
grid: the 16-lane Fig-6 grid stepped to tick 500, then ticks 500-700
three times untraced (wall per tick, the device drained at both ends)
and once under torch.profiler (kernel launches and device busy time per
tick). Prints one JSON line per run and the card's name and power limit.
Needs a card.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

FIG6_RATES = (50_000, 150_000, 300_000, 450_000)
FIG6_SEEDS = (0, 1, 2, 3)


def one(src: str) -> dict:
    sys.path.insert(0, src)
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import repro_torch
    from repro_torch.configs.smr import SMRConfig
    from repro_torch.core import experiment, harness, workload
    from repro_torch.core.experiment import SweepSpec

    if not torch.cuda.is_available():
        raise SystemExit("tick_ab: torch sees no CUDA device")
    dev = torch.device("cuda")
    spec = SweepSpec(rates=FIG6_RATES, seeds=FIG6_SEEDS)
    _, cfg, _, env, rate_b, seeds = experiment._lower(SMRConfig(), spec, dev)
    ticks = int(cfg.sim_seconds * 1000 / cfg.tick_ms)
    draws = workload.draw_table(rate_b.tolist(), seeds, ticks,
                                cfg.n_replicas, dev)
    carry = harness.init_carry(cfg, ticks, len(seeds), dev)
    for t in range(500):
        carry = harness.step(carry, t, draws, env, cfg)
    window = range(500, 700)
    walls = []
    for _ in range(3):
        state = _clone(carry)           # a tick updates the rings in place
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in window:
            state = harness.step(state, t, draws, env, cfg)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3 / len(window))
        carry_after = state
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        state = _clone(carry)
        for t in window:
            state = harness.step(state, t, draws, env, cfg)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    same = all(torch.equal(a, b) for a, b in zip(
        _leaves(state), _leaves(carry_after)))
    return {"src": str(Path(repro_torch.__file__).parents[1]),
            "walls_ms_per_tick": walls,
            "median_ms_per_tick": statistics.median(walls),
            "launches_per_tick": sum(e.count for e in kernels) / len(window),
            "device_ms_per_tick": sum(e.self_device_time_total
                                      for e in kernels) / 1e3 / len(window),
            "traced_equals_untraced": same}


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    else:
        yield tree


def main() -> int:
    if len(sys.argv) >= 3 and sys.argv[1] == "--one":
        print(json.dumps(one(sys.argv[2])), flush=True)
        return 0
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    rc = 0
    for src in sys.argv[1:]:
        src = str(Path(src).resolve())
        env = dict(os.environ, PYTHONPATH=src)
        r = subprocess.run([sys.executable, __file__, "--one", src], env=env,
                           timeout=900)
        rc = rc or r.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
