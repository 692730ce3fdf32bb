#!/usr/bin/env python3
"""Time per simulator tick of the port at the Fig-6 shape, for comparing
checkouts, and the captured tick graph against the eager loop, on one
card in one call.

    python3 tools/tick_ab.py [--protocols P,P] [--turns N] SRC [SRC ...]

Each SRC is the ``src`` directory of a checkout (this one's, or a parent's
unpacked with ``git archive`` into a directory that .gitignore lists).
Each runs in a process of its own, in the order given (parent, change,
change, parent compares two versions fairly), which imports
``repro_torch`` from SRC and, for each protocol (default: the four scan
protocols), builds its 16-lane Fig-6 grid (its own rates x seeds 0-3,
D = 256), steps it eagerly to tick 500 and then, in ``--turns`` turns
(default 3):

  eager — ticks 500-700 stepped one Python iteration a tick
          (``harness.step``; wall per tick, the device drained at both
          ends);
  graph — where SRC has the captured tick (``core/compile_cache.py``):
          ticks 500-1500 as 1000 replays of one captured tick from the
          same state (``compile_cache.run``: the copies of the carry in
          and out are inside the time); captured once before the turns.

Then once each under torch.profiler: kernel launches and device busy time
per tick (eager: 50 ticks; graph: 50 replays, whose kernels the profiler
sees one by one), the captured graph's kernel nodes (its DOT dump) and
the capture's seconds. Prints the card's name and power limit, then one
JSON line per SRC and protocol. Needs a card.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

FIG6_SEEDS = (0, 1, 2, 3)
FIG6_RATES = {"mandator-sporades": (50_000, 150_000, 300_000, 450_000),
              "mandator-paxos": (50_000, 150_000, 300_000, 450_000),
              "multipaxos": (10_000, 30_000, 50_000, 100_000),
              "mandator": (50_000, 150_000, 300_000, 450_000)}
START, EAGER_WINDOW, GRAPH_WINDOW, PROFILED = 500, 200, 1000, 50


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


def _device_profile(fn, ticks: int):
    """(kernel launches per tick, device ms per tick) of ``fn()``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    return (sum(e.count for e in kernels) / ticks,
            sum(e.self_device_time_total for e in kernels) / 1e3 / ticks)


def one(src: str, protocol: str, turns: int) -> dict:
    sys.path.insert(0, src)
    import torch

    import repro_torch
    from repro_torch.configs.smr import SMRConfig
    from repro_torch.core import experiment, harness, netsim, workload
    from repro_torch.core.experiment import SweepSpec

    if not torch.cuda.is_available():
        raise SystemExit("tick_ab: torch sees no CUDA device")
    dev = torch.device("cuda")
    spec = SweepSpec(rates=FIG6_RATES[protocol], seeds=FIG6_SEEDS)
    _, cfg, _, env, rate_b, seeds = experiment._lower(SMRConfig(), spec, dev)
    ticks = netsim.sim_ticks(cfg)
    draws = workload.draw_table(rate_b.tolist(), seeds, ticks,
                                cfg.n_replicas, dev)
    carry = harness.init_carry(cfg, ticks, len(seeds), dev, protocol)
    for t in range(START):
        carry = harness.step(carry, t, draws, env, cfg, protocol)
    graph = hasattr(harness, "_graph_tick")
    out = {"src": str(Path(repro_torch.__file__).parents[1]),
           "protocol": protocol, "D": int(cfg.delay_horizon_ticks),
           "lanes": len(seeds)}

    def eager(state, n=EAGER_WINDOW):
        # a checkout with the device tick index advances one in place, as
        # its own loop does; an older one passes Python ints
        tt = torch.full((), START, dtype=torch.int32, device=dev)
        for t in range(START, START + n):
            state = harness.step(state, tt if graph else t, draws, env, cfg,
                                 protocol)
            if graph:
                tt.add_(1)
        return state

    if graph:
        from repro_torch.core import compile_cache
        run = harness._setup(protocol, cfg, ticks, env, draws, len(seeds),
                             dev)
        run["carry"] = carry
        run["t"].fill_(START)
        key = harness._program_key(protocol, cfg, run["arr"], False,
                                   carry, run["inputs"])
        tick = harness._graph_tick(run, protocol, cfg)

        def replay(n):
            t = torch.full((), START, dtype=torch.int32, device=dev)
            return compile_cache.run(key, protocol, tick, _clone(carry),
                                     run["inputs"], t, n)
        before = compile_cache.stats()
        _, prog = replay(1)                          # the capture
        out["capture_s"] = compile_cache.delta(before)["capture_s"]
        nodes = prog.kernel_nodes()
        out["graph_nodes"] = nodes["nodes"]
        out["graph_kernel_nodes"] = sum(nodes["kernels"].values())
        out["graph_node_types"] = nodes["types"]
    walls = {"eager": [], "graph": []}
    for _ in range(turns):
        state = _clone(carry)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eager(state)
        torch.cuda.synchronize()
        walls["eager"].append((time.perf_counter() - t0) * 1e3
                              / EAGER_WINDOW)
        if graph:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            replay(GRAPH_WINDOW)
            torch.cuda.synchronize()
            walls["graph"].append((time.perf_counter() - t0) * 1e3
                                  / GRAPH_WINDOW)
    out["eager_ms_per_tick"] = walls["eager"]
    out["eager_median_ms_per_tick"] = statistics.median(walls["eager"])
    st = _clone(carry)
    out["eager_launches_per_tick"], out["eager_device_ms_per_tick"] = \
        _device_profile(lambda: eager(st, PROFILED), PROFILED)
    out["eager_busy_share"] = (out["eager_device_ms_per_tick"]
                               / out["eager_median_ms_per_tick"])
    if graph:
        out["graph_ms_per_tick"] = walls["graph"]
        out["graph_median_ms_per_tick"] = statistics.median(walls["graph"])
        out["graph_launches_per_tick"], out["graph_device_ms_per_tick"] = \
            _device_profile(lambda: prog.replay(PROFILED), PROFILED)
        out["graph_busy_share"] = (out["graph_device_ms_per_tick"]
                                   / out["graph_median_ms_per_tick"])
        out["speedup"] = (out["eager_median_ms_per_tick"]
                          / out["graph_median_ms_per_tick"])
        # the graph's window from the eager loop's state equals the eager
        # loop's, bit for bit, on every carried leaf
        st = eager(_clone(carry))
        t = torch.full((), START, dtype=torch.int32, device=dev)
        g, _ = compile_cache.run(key, protocol, tick, _clone(carry),
                                 run["inputs"], t, EAGER_WINDOW)
        out["graph_equals_eager"] = all(
            torch.equal(a.view(torch.int32) if a.is_floating_point()
                        else a, b.view(torch.int32) if b.is_floating_point()
                        else b)
            for a, b in zip(_leaves(g), _leaves(st)))
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    else:
        yield tree


def main() -> int:
    if len(sys.argv) >= 5 and sys.argv[1] == "--one":
        print(json.dumps(one(sys.argv[2], sys.argv[3], int(sys.argv[4]))),
              flush=True)
        return 0
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--protocols", default=",".join(FIG6_RATES))
    ap.add_argument("--turns", type=int, default=3)
    ap.add_argument("srcs", nargs="+")
    args = ap.parse_args()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    rc = 0
    for protocol in args.protocols.split(","):
        for src in args.srcs:
            src = str(Path(src).resolve())
            env = dict(os.environ, PYTHONPATH=src)
            r = subprocess.run([sys.executable, __file__, "--one", src,
                                protocol, str(args.turns)], env=env,
                               timeout=900)
            rc = rc or r.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
