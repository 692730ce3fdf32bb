"""Lower a declarative Workload to fixed-shape windowed rate tables.

A copy of ``repro.workloads.compile``: the union of every primitive's tick
edges cuts the run into W maximal windows over which the rate table is
constant; ``lower`` paints each primitive onto the rows it covers (in
Workload order) and emits, as plain numpy:

  win_start[W]           first tick of each window (win_start[0] == 0)
  win_of_tick[n_ticks]   tick -> window row
  rate_of[W, n]          per-origin rate multiplier (1.0 = uniform share)
  closed[()]             1.0 if the workload is closed-loop, else 0.0
  think_ticks[()]        closed-loop think time (1.0 when open)
  cap[()]                closed-loop per-origin outstanding cap
                         (``OPEN_CAP`` when open)

Padding to a common ``pad_windows`` (repeat-last-row; padded rows are
never read because ``win_of_tick`` only indexes real windows) is what lets
the workloads of a grid stack along its lane axis
(``experiment._lower_workloads``), as the scenarios' env tables do.

``is_trivial`` detects the all-ones open-loop table (a bare
``PoissonOpen()``), the §5.2 baseline, whose lanes read their arrivals
straight from the draw table. ``mode_of`` gives the mode a grid runs
under: a grid that mixes open and closed lanes runs in closed mode and
picks each lane's behaviour from its ``closed`` leaf.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

from repro_torch.configs.smr import SMRConfig
from repro_torch.workloads.primitives import PoissonOpen, Workload

# float32 "unbounded" outstanding cap for open-loop lanes stacked into a
# closed-mode grid (finite so cap arithmetic can never produce inf-inf)
OPEN_CAP = 1e18

Tables = Dict[str, np.ndarray]


@dataclass(frozen=True)
class WorkloadMode:
    """Static shape of a sweep's workload axis: ``trivial`` is the §5.2
    path, ``closed`` the closed-loop machinery (population arrivals and
    in-flight feedback). A grid mixing open and closed workloads runs in
    closed mode and selects per-lane behaviour on the ``closed`` leaf."""
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


def n_windows(cfg: SMRConfig, wl) -> int:
    """Window count of the lowered workload (for cross-workload padding)."""
    return len(_win_starts(cfg, as_workload(wl)))


def lower(cfg: SMRConfig, wl, pad_windows: Optional[int] = None) -> Tables:
    wl = as_workload(wl)
    n = cfg.n_replicas
    n_ticks = _sim_ticks(cfg)
    win_start = _win_starts(cfg, wl)
    w = len(win_start)
    tab: dict = {
        # float64 paint buffer so primitive stacking is bit-stable; one
        # float32 cast below
        "rate_of": np.ones((w, n), np.float64),
        "closed": False,
        "think_ticks": 1.0,
        "cap": OPEN_CAP,
    }
    for shape in wl.shapes:
        shape.paint(cfg, n_ticks, win_start, tab)
    rate_of = tab["rate_of"].astype(np.float32)
    if pad_windows is not None:
        if pad_windows < w:
            raise ValueError(f"pad_windows={pad_windows} < {w} real windows")
        rate_of = np.pad(rate_of, ((0, pad_windows - w), (0, 0)),
                         mode="edge")
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
    window, every origin at exactly its uniform share. Judge the UNPADDED
    lowering: padding widens the window axis without changing
    semantics."""
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
