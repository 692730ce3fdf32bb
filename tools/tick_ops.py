#!/usr/bin/env python3
"""PyTorch operators dispatched per simulator tick, by protocol, on the CPU.

    PYTHONPATH=src python3 tools/tick_ops.py [--workloads]

Steps each scan protocol's 16-lane Fig-6 grid (rates of
benchmarks/figures.py, seeds 0-3, 1 s) to tick 500 on the CPU, then counts
the aten operators that ticks 500-600 dispatch (a TorchDispatchMode
counter) and prints one JSON line per protocol. ``--workloads`` counts
chip_smoke.py phase 15's grids instead: the workload matrix's 14 lanes
(seven library workloads x baseline, paper-ddos; closed mode) and the
robustness matrix's 20 lanes with trace_level and monitor_level at
"full" and at "off". On the CPU the ring commit
is the plain path, so the count is an upper estimate of the kernels a tick
launches on a card, where the fused commit replaces the plain path's
preparation; it is a count, not a time. Needs no card.
"""
from __future__ import annotations

import json

import torch
from torch.utils._python_dispatch import TorchDispatchMode

import dataclasses
import sys

from repro_torch.configs.smr import SMRConfig
from repro_torch.core import experiment, harness, netsim
from repro_torch.core.experiment import SweepSpec
from repro_torch.scenarios import library as scenario_library
from repro_torch.workloads import library as workload_library

GRIDS = {"mandator-sporades": (50_000, 150_000, 300_000, 450_000),
         "mandator-paxos": (50_000, 150_000, 300_000, 450_000),
         "multipaxos": (10_000, 30_000, 50_000, 100_000),
         "mandator": (50_000, 150_000, 300_000, 450_000)}
START, WINDOW = 500, 100


class _Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def ops_per_tick(protocol: str, rates, cfg=None, spec=None) -> float:
    """Operators a tick of ``protocol`` dispatches: the Fig-6 grid at
    ``rates``, or ``spec`` under ``cfg``."""
    dev = torch.device("cpu")
    spec = spec or SweepSpec(rates=rates, seeds=(0, 1, 2, 3))
    _, cfg, mode, env, rate_b, seeds = experiment._lower(
        cfg or SMRConfig(sim_seconds=1.0), spec, dev)
    arr = harness.make_arrivals(cfg, mode, rate_b.tolist(), seeds, dev,
                                experiment._lower_workloads(cfg, spec))
    carry, grace = harness.init_run(protocol, cfg, netsim.sim_ticks(cfg),
                                    env, arr, len(seeds), dev)
    for t in range(START):
        carry = harness.step(carry, t, arr, env, cfg, protocol, grace)
    count = _Count()
    with count:
        for t in range(START, START + WINDOW):
            carry = harness.step(carry, t, arr, env, cfg, protocol, grace)
    return count.n / WINDOW


# chip_smoke.py phase 15's rates (benchmarks/figures.py's)
MATRIX = {"mandator-sporades": 200_000, "mandator-paxos": 200_000,
          "mandator": 200_000, "multipaxos": 30_000}
ROBUST = {"mandator-sporades": (50_000, 200_000),
          "mandator-paxos": (50_000, 200_000),
          "multipaxos": (10_000, 30_000)}


def phase15() -> None:
    cfg = SMRConfig(sim_seconds=1.0)
    wl = workload_library.workloads(4.0, cfg.n_replicas)
    sc = scenario_library.scenarios(4.0, cfg.n_replicas)
    for protocol, rate in MATRIX.items():
        spec = SweepSpec(rates=(rate,), scenarios=(sc["baseline"],
                                                   sc["paper-ddos"]),
                         workloads=tuple(wl.values()))
        print(json.dumps({"protocol": protocol, "grid": "workload matrix",
                          "device": "cpu", "aten_ops_per_tick":
                              ops_per_tick(protocol, None, cfg, spec)}),
              flush=True)
    sc = scenario_library.scenarios(2.0, cfg.n_replicas)
    for protocol, rates in ROBUST.items():
        spec = SweepSpec(rates=rates, scenarios=tuple(sc.values()))
        for level in ("off", "full"):
            c = dataclasses.replace(cfg, trace_level=level,
                                    monitor_level=level)
            print(json.dumps({"protocol": protocol, "grid": "robustness",
                              "telemetry": level, "device": "cpu",
                              "aten_ops_per_tick":
                                  ops_per_tick(protocol, None, c, spec)}),
                  flush=True)


def main() -> None:
    if "--workloads" in sys.argv[1:]:
        phase15()
        return
    for protocol, rates in GRIDS.items():
        print(json.dumps({"protocol": protocol, "device": "cpu",
                          "aten_ops_per_tick":
                              ops_per_tick(protocol, rates)}), flush=True)


if __name__ == "__main__":
    main()
