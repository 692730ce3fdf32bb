"""The benchmark's inputs, made with NumPy from the run's seed.

A cell's traffic file (``traffic/<name>.json``) gives the grid's axes; this
module turns them into ``SweepSpec`` arguments and, for grid ``k`` of a run
seeded ``seed``, the arrivals both sides read: the open-loop Poisson draw
table ``[B, T, n]`` float32, lane ``b`` drawing from its own
``numpy.random.Generator`` (``SeedSequence([seed, k, b])``) at its rate per
origin per tick (the rate over the replicas, in float64, cast to float32,
as the sweep engine lowers it).

A mix may name fault scenarios (``null``, the fault-free network, or a
name of the simulator's scenario library, ``plainscen.NAMES``); a lane
draws the same way whatever its scenario. The port's own arrival sampling
(``draw_table``, ``epoch_stream``) is never called: a grid's draws are
made here, once, before the window, and handed to the port and to the
reference alike. What the reference does not simulate is refused: a
workload other than open-loop Poisson, and the flight recorder or the
health monitor switched on.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

import plainscen

# the workloads this module makes arrivals for: open-loop Poisson at the
# sweep rate, the same mean at every origin and tick
OPEN_WORKLOADS = ("poisson-open",)

SEED_MOD = 2 ** 64


@dataclass(frozen=True)
class Grid:
    """One grid's axes (the ``SweepSpec`` fields, by name) and its arrivals.
    ``points`` lists (rate, seed, scenario index, workload index) in
    ``SweepSpec.points()`` order."""
    rates: Tuple[float, ...]
    seeds: Tuple[int, ...]
    scenarios: Tuple[Optional[str], ...]
    workloads: Tuple[str, ...]
    draws: np.ndarray

    @property
    def points(self) -> List[Tuple[float, int, int, int]]:
        return [(float(r), int(s), fi, wi) for r in self.rates
                for s in self.seeds for fi in range(len(self.scenarios))
                for wi in range(len(self.workloads))]

    @property
    def lanes(self) -> int:
        return self.draws.shape[0]


def smr_settings(config: Dict, traffic: Dict) -> Dict:
    """The ``SMRConfig`` settings of a cell: the configuration's deployment
    (``config["smr"]``) with the traffic's run length and telemetry
    (``traffic["smr"]``) over it."""
    return {**config["smr"], **traffic.get("smr", {})}


def sim_ticks(settings: Dict) -> int:
    return int(float(settings["sim_seconds"]) * 1000
               / float(settings["tick_ms"]))


def rate_per_tick(settings: Dict, rate: float) -> np.float32:
    """Per-replica Poisson mean per tick: float64 on the host, cast to
    float32."""
    return np.float32(np.float64(rate) * float(settings["tick_ms"]) / 1000.0
                      / int(settings["n_replicas"]))


def _rng(seed: int, *keys: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([int(seed) % SEED_MOD, *keys]))


def grid_seeds(seed: int, grid: int, count: int) -> Tuple[int, ...]:
    """The seed axis of grid ``grid`` of a run seeded ``seed``: ``count``
    labels, fresh for every grid."""
    words = np.random.SeedSequence(
        [int(seed) % SEED_MOD, grid, 0xA11CE]).generate_state(count,
                                                             np.uint32)
    return tuple(int(w) for w in words)


# telemetry settings the reference simulates only when off: the flight
# recorder adds its phase arrays to every row, the monitor its gauges
TELEMETRY = ("trace_level", "monitor_level")


def _refusal(settings: Dict, traffic: Dict) -> Optional[str]:
    """Why the reference cannot check a mix, or None."""
    scen = list(traffic.get("scenarios", [None]))
    unknown = [s for s in scen if s is not None and s not in plainscen.NAMES]
    if unknown:
        return (f"scenarios {unknown} are not in the scenario library "
                f"({', '.join(plainscen.NAMES)})")
    wls = [w for w in traffic.get("workloads", ["poisson-open"])
           if w not in OPEN_WORKLOADS]
    if wls:
        return (f"workloads {wls}: the reference simulates open-loop "
                f"arrivals alone ({', '.join(OPEN_WORKLOADS)}), no closed "
                f"loop and no rate table")
    on = {k: settings[k] for k in TELEMETRY if settings.get(k, "off") != "off"}
    if on:
        return (f"{on}: the reference simulates no flight recorder and no "
                f"health monitor, so telemetry must be off")
    return None


def make_grid(settings: Dict, traffic: Dict, seed: int, grid: int
              ) -> Grid:
    """Grid ``grid`` of a run seeded ``seed``: the traffic's axes with a
    fresh seed axis, and every lane's arrivals. Raises ValueError for a
    mix the reference cannot check (``_refusal``)."""
    why = _refusal(settings, traffic)
    if why is not None:
        raise ValueError(f"the benchmark cannot check this mix: {why}")
    rates = tuple(float(r) for r in traffic["rates"])
    scen = tuple(traffic.get("scenarios", [None]))
    wls = tuple(traffic.get("workloads", ["poisson-open"]))
    seeds = grid_seeds(seed, grid, int(traffic["seeds_per_grid"]))
    pts = Grid(rates, seeds, scen, wls, np.empty((0,))).points
    T, n = sim_ticks(settings), int(settings["n_replicas"])
    draws = np.zeros((len(pts), T, n), np.float32)
    for b, (rate, _, _, _) in enumerate(pts):
        lam = np.full((T, n), rate_per_tick(settings, rate), np.float32)
        draws[b] = _rng(seed, grid, b).poisson(lam).astype(np.float32)
    return Grid(rates, seeds, scen, wls, draws)


def spec_kwargs(settings: Dict, g: Grid, scenario_lib, workload_lib
                ) -> Dict:
    """The port's ``SweepSpec`` keyword arguments for ``g``, scenarios and
    workloads taken by name from its libraries."""
    s, n = float(settings["sim_seconds"]), int(settings["n_replicas"])
    return {"rates": g.rates, "seeds": g.seeds,
            "scenarios": tuple(None if x is None else
                               scenario_lib.get(x, s, n)
                               for x in g.scenarios),
            "workloads": tuple(workload_lib.get(x, s, n)
                               for x in g.workloads)}


def take_lanes(g: Grid, lanes: Sequence[int]) -> np.ndarray:
    """The draws of ``lanes`` alone, [len(lanes), T, n]."""
    return np.ascontiguousarray(g.draws[np.asarray(list(lanes), np.int64)])
