"""Curated workload library — the traffic shapes the workload matrix runs
(a copy of ``repro.workloads.library``).

Windows are placed at fractions of ``sim_s`` so the same shapes stress a
2-second smoke run and a 10-second sweep alike. ``workloads(sim_s)``
returns an ordered name -> Workload dict; ``get(name, sim_s)`` fetches one.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from repro_torch.workloads.primitives import (
    ClosedLoop,
    DiurnalRamp,
    FlashCrowd,
    OnOffBurst,
    PoissonOpen,
    RegionSkew,
    Workload,
)


def _geo_weights(n: int) -> tuple:
    """A plausibly-skewed planet: population decays by region index."""
    w = 0.5 ** np.arange(n)
    return tuple(float(x) for x in w / w.sum())


def workloads(sim_s: float, n: int = 5) -> Dict[str, Workload]:
    return {
        # the paper's §5.2 baseline — compiles to the all-ones fast path
        "poisson-open": Workload("poisson-open", (PoissonOpen(),)),
        # everyone bursts together: 40% duty at 2.5x, silent otherwise
        "onoff-burst": Workload("onoff-burst", (
            OnOffBurst(period_s=0.25 * sim_s, duty=0.4, on_scale=2.5,
                       off_scale=0.0),)),
        # one day/night cycle across the run, staircased at 16 steps
        "diurnal": Workload("diurnal", (
            DiurnalRamp(period_s=sim_s, low=0.25, high=1.75,
                        step_s=sim_s / 16),)),
        # Mumbai goes viral mid-run: 6x spike, exponential cool-down
        "flash-crowd": Workload("flash-crowd", (
            FlashCrowd(at_s=0.4 * sim_s, duration_s=0.15 * sim_s,
                       magnitude=6.0, targets=(2 % n,),
                       decay_s=0.2 * sim_s),)),
        # WPaxos-style locality: 80% of load on one region, hotspot
        # migrating to the next region four times over the run
        "region-skew": Workload("region-skew", (
            RegionSkew(hot_frac=0.8, hot=(0,), migrate_s=0.25 * sim_s),)),
        # Atlas-style closed loop: uniform client pools, 50ms think time
        "closed-loop": Workload("closed-loop", (
            ClosedLoop(think_ms=50.0, cap=4000.0),)),
        # geo-placed closed loop: population-skewed pools + bursty rhythm
        "skewed-closed": Workload("skewed-closed", (
            OnOffBurst(period_s=0.5 * sim_s, duty=0.6, on_scale=1.5,
                       off_scale=0.5),
            ClosedLoop(think_ms=50.0, cap=4000.0,
                       placement=_geo_weights(n)),)),
    }


NAMES = tuple(workloads(1.0))


def get(name: str, sim_s: float, n: int = 5) -> Workload:
    lib = workloads(sim_s, n)
    if name not in lib:
        raise KeyError(
            f"unknown workload {name!r}; known: {', '.join(lib)}")
    return lib[name]
