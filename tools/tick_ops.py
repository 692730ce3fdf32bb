#!/usr/bin/env python3
"""PyTorch operators dispatched per simulator tick, by protocol, on the CPU.

    PYTHONPATH=src python3 tools/tick_ops.py

Steps each scan protocol's 16-lane Fig-6 grid (rates of
benchmarks/figures.py, seeds 0-3, 1 s) to tick 500 on the CPU, then counts
the aten operators that ticks 500-600 dispatch (a TorchDispatchMode
counter) and prints one JSON line per protocol. On the CPU the ring commit
is the plain path, so the count is an upper estimate of the kernels a tick
launches on a card, where the fused commit replaces the plain path's
preparation; it is a count, not a time. Needs no card.
"""
from __future__ import annotations

import json

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs.smr import SMRConfig
from repro_torch.core import experiment, harness, workload
from repro_torch.core.experiment import SweepSpec

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


def ops_per_tick(protocol: str, rates) -> float:
    dev = torch.device("cpu")
    spec = SweepSpec(rates=rates, seeds=(0, 1, 2, 3))
    _, cfg, _, env, rate_b, seeds = experiment._lower(
        SMRConfig(sim_seconds=1.0), spec, dev)
    ticks = int(cfg.sim_seconds * 1000 / cfg.tick_ms)
    draws = workload.draw_table(rate_b.tolist(), seeds, ticks,
                                cfg.n_replicas, dev)
    carry = harness.init_carry(cfg, ticks, len(seeds), dev, protocol)
    for t in range(START):
        carry = harness.step(carry, t, draws, env, cfg, protocol)
    count = _Count()
    with count:
        for t in range(START, START + WINDOW):
            carry = harness.step(carry, t, draws, env, cfg, protocol)
    return count.n / WINDOW


def main() -> None:
    for protocol, rates in GRIDS.items():
        print(json.dumps({"protocol": protocol, "device": "cpu",
                          "aten_ops_per_tick":
                              ops_per_tick(protocol, rates)}), flush=True)


if __name__ == "__main__":
    main()
