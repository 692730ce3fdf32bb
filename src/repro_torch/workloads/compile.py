"""Lower a declarative Workload to fixed-shape windowed rate tables.

A copy of ``repro.workloads.compile``: the union of every primitive's tick
edges cuts the run into W maximal windows over which the rate table is
constant; ``lower`` paints each primitive onto the rows it covers and emits,
as plain numpy:

  win_start[W]           first tick of each window (win_start[0] == 0)
  win_of_tick[n_ticks]   tick -> window row
  rate_of[W, n]          per-origin rate multiplier (1.0 = uniform share)
  closed[()]             1.0 if the workload is closed-loop, else 0.0
  think_ticks[()]        closed-loop think time (1.0 when open)
  cap[()]                closed-loop per-origin outstanding cap

The port runs unpadded tables: it stacks no workload axis yet.
``is_trivial`` detects the all-ones open-loop table (a bare
``PoissonOpen()``), the §5.2 baseline. The port runs only that trivial mode
so far; ``experiment.run_sweep`` refuses any other.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np

from repro_torch.configs.smr import SMRConfig
from repro_torch.workloads.primitives import PoissonOpen, Workload

# float32 "unbounded" outstanding cap for open-loop lanes
OPEN_CAP = 1e18

Tables = Dict[str, np.ndarray]


@dataclass(frozen=True)
class WorkloadMode:
    """Static shape of a sweep's workload axis: ``trivial`` is the §5.2
    scalar-broadcast path, ``closed`` the closed-loop machinery."""
    trivial: bool = True
    closed: bool = False


TRIVIAL_MODE = WorkloadMode()


def _sim_ticks(cfg: SMRConfig) -> int:
    # keep in sync with netsim.sim_ticks
    return int(cfg.sim_seconds * 1000 / cfg.tick_ms)


def _win_starts(cfg: SMRConfig, wl: Workload) -> np.ndarray:
    n_ticks = _sim_ticks(cfg)
    edges = {0}
    for shape in wl.shapes:
        edges.update(int(e) for e in shape.edges(cfg, n_ticks))
    return np.array(sorted(e for e in edges if 0 <= e < n_ticks), np.int64)


def lower(cfg: SMRConfig, wl) -> Tables:
    wl = as_workload(wl)
    n = cfg.n_replicas
    n_ticks = _sim_ticks(cfg)
    win_start = _win_starts(cfg, wl)
    tab: dict = {
        # float64 paint buffer so primitive stacking is bit-stable; one
        # float32 cast below
        "rate_of": np.ones((len(win_start), n), np.float64),
        "closed": False,
        "think_ticks": 1.0,
        "cap": OPEN_CAP,
    }
    for shape in wl.shapes:
        shape.paint(cfg, n_ticks, win_start, tab)
    rate_of = tab["rate_of"].astype(np.float32)
    return {
        "win_start": win_start,
        "win_of_tick": (np.searchsorted(win_start, np.arange(n_ticks),
                                        side="right") - 1).astype(np.int32),
        "rate_of": rate_of,
        "closed": np.float32(1.0 if tab["closed"] else 0.0),
        "think_ticks": np.float32(tab["think_ticks"]),
        "cap": np.float32(tab["cap"]),
    }


def is_trivial(tab: Tables) -> bool:
    """True iff the lowered table is the §5.2 baseline: open-loop, single
    window, every origin at exactly its uniform share."""
    return (float(tab["closed"]) == 0.0
            and tab["rate_of"].shape[0] == 1
            and bool(np.all(tab["rate_of"] == 1.0)))


def mode_of(tabs) -> WorkloadMode:
    """The static mode a grid of lowered workloads runs under."""
    return WorkloadMode(
        trivial=all(is_trivial(t) for t in tabs),
        closed=any(float(t["closed"]) > 0 for t in tabs),
    )


def as_workload(obj) -> Workload:
    """Normalize None / Workload to a Workload."""
    if obj is None:
        return Workload("poisson-open", (PoissonOpen(),))
    if isinstance(obj, Workload):
        return obj
    raise TypeError(f"expected Workload or None, got {type(obj)}")
