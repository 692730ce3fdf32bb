"""Declarative WAN adversary scenarios (a copy of ``repro.scenarios``).

A ``Scenario`` is a named list of composable event primitives (crash
intervals, partitions, regional outages, gray failures, targeted delay
attacks, bandwidth throttles). ``compile.lower`` turns one into fixed-shape
windowed numpy tables that ``netsim.build_env`` moves to the device; the
sweep engine stacks them along the grid's batch axis.
"""
from repro_torch.scenarios.primitives import (
    BandwidthThrottle,
    Crash,
    GrayFailure,
    Partition,
    Recover,
    RegionOutage,
    Scenario,
    TargetedDelay,
)
from repro_torch.scenarios.compile import as_scenario, lower

__all__ = [
    "BandwidthThrottle", "Crash", "GrayFailure", "Partition", "Recover",
    "RegionOutage", "Scenario", "TargetedDelay",
    "as_scenario", "lower",
]
