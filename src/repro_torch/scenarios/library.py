"""Curated scenario library — the adversaries the robustness matrix runs.

Windows are placed at fractions of ``sim_s`` so the same shapes stress a
2-second smoke run and a 10-second sweep alike. ``scenarios(sim_s)``
returns an ordered name -> Scenario dict; ``get(name, sim_s)`` fetches one.
"""
from __future__ import annotations

import math
from typing import Dict

from repro_torch.scenarios.primitives import (
    BandwidthThrottle,
    Crash,
    GrayFailure,
    Partition,
    RegionOutage,
    Scenario,
    TargetedDelay,
)


def _minority_split(n: int):
    f = (n - 1) // 2
    return tuple(range(f)), tuple(range(f, n))


def scenarios(sim_s: float, n: int = 5) -> Dict[str, Scenario]:
    minority, majority = _minority_split(n)
    flap_on = 0.12 * sim_s
    return {
        "baseline": Scenario("baseline"),
        # the paper's §5.5 attack: random minority re-picked every second
        "paper-ddos": Scenario("paper-ddos", (
            TargetedDelay(delay_ms=800.0, targets="random-minority",
                          repick_s=1.0, seed=7),)),
        # pin the attack on the initial leader instead of a rotating minority
        "leader-ddos": Scenario("leader-ddos", (
            TargetedDelay(delay_ms=800.0, targets="leader"),)),
        # clean two-sided cut mid-run, heals: minority side must stall,
        # then catch up
        "symmetric-partition": Scenario("symmetric-partition", (
            Partition(0.4 * sim_s, 0.7 * sim_s, (minority, majority)),)),
        # the minority is cut off for good — the majority side must keep
        # committing without it
        "minority-partition": Scenario("minority-partition", (
            Partition(0.4 * sim_s, math.inf, (minority, majority)),)),
        # a whole region goes dark and the surviving WAN reroutes
        "region-outage": Scenario("region-outage", (
            RegionOutage(0.4 * sim_s, 0.7 * sim_s, regions=(2,),
                         delay_ms=50.0),)),
        # sustained gray failure: per-link jitter + loss, re-drawn at 10 Hz
        "gray-wan": Scenario("gray-wan", (
            GrayFailure(0.2 * sim_s, 0.9 * sim_s, loss=0.05, jitter_ms=25.0,
                        redraw_s=0.1, seed=11),)),
        # one link flaps on/off four times
        "flapping-link": Scenario("flapping-link", tuple(
            Partition((0.2 + 0.2 * k) * sim_s,
                      (0.2 + 0.2 * k + flap_on) * sim_s, ((0,), (1,)))
            for k in range(4))),
        # the leader's NIC degrades to 10% mid-run
        "throttled-nic": Scenario("throttled-nic", (
            BandwidthThrottle(0.3 * sim_s, math.inf, scale=0.1,
                              targets="leader"),)),
        # crash as an *interval*: the leader is down for a third of the run
        # and comes back
        "leader-crash-recover": Scenario("leader-crash-recover", (
            Crash(0.3 * sim_s, targets="leader", end_s=0.6 * sim_s),)),
    }


NAMES = tuple(scenarios(1.0))


def get(name: str, sim_s: float, n: int = 5) -> Scenario:
    lib = scenarios(sim_s, n)
    if name not in lib:
        raise KeyError(
            f"unknown scenario {name!r}; known: {', '.join(lib)}")
    return lib[name]
