"""Traffic-shape primitives: the two the trivial §5.2 workload needs, copied
from ``repro.workloads.primitives``. The windowed and closed-loop shapes
come with ROADMAP Queue A item 11.

Each primitive knows how to *paint* itself onto the windowed rate table
``rate_of[w, n]`` (per-origin multiplier, 1.0 = the origin's uniform share
of the sweep's offered rate) that compile.py builds.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np

from repro_torch.configs.smr import SMRConfig

Tables = dict


@dataclass(frozen=True)
class Workload:
    """A named, ordered composition of traffic-shape primitives."""
    name: str = "poisson-open"
    shapes: Tuple = ()


@dataclass(frozen=True)
class PoissonOpen:
    """Open-loop Poisson arrivals, colocated with every replica, at
    ``scale`` x the uniform share. scale=1.0 lowers to the all-ones table."""
    scale: float = 1.0

    def edges(self, cfg: SMRConfig, n_ticks: int):
        return ()

    def paint(self, cfg: SMRConfig, n_ticks: int, win_start: np.ndarray,
              tab: Tables) -> None:
        tab["rate_of"] *= np.float64(self.scale)
