"""Host-side view of a compiled workload for the analytic baselines (a copy
of ``repro.workloads.analytic``).

The EPaxos/Rabia models (core/epaxos.py, core/rabia.py) have no tick loop;
they integrate batch streams on the host. ``host_rate`` gives them the
compiled rate table the simulator reads, as a ``TableRate`` lookup, or
None for the trivial §5.2 baseline, where callers keep their exact
constant-rate code path.


Closed-loop workloads have no open offered rate; ``closed_equilibrium_rate``
maps the sweep rate (= client population via Little's law) to the
equilibrium arrival rate clients sustain once the model's own latency is
fed back: rate_eff = rate x think / (think + median latency), additionally
bounded by the per-origin outstanding cap (throughput <= n x cap / latency).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from repro_torch.configs.smr import SMRConfig
from repro_torch.workloads.compile import as_workload, is_trivial, lower


class TableRate:
    """Host-side lookup over a compiled rate table: ``at(t_ms)`` is the
    per-origin multiplier row, ``next_change_ms(t_ms)`` the time the row
    next changes (sim end if never) — so stream generators can skip a
    zero-rate window instead of dividing by ~0 and jumping past the run."""

    def __init__(self, cfg: SMRConfig, tab):
        self._cfg = cfg
        self._win_start = tab["win_start"]
        self._win_of_tick = tab["win_of_tick"]
        self._rate_of = tab["rate_of"]

    def at(self, t_ms: float) -> np.ndarray:
        tick = min(max(int(t_ms / self._cfg.tick_ms), 0),
                   len(self._win_of_tick) - 1)
        return self._rate_of[self._win_of_tick[tick]]

    def next_change_ms(self, t_ms: float) -> float:
        sim_ms = len(self._win_of_tick) * self._cfg.tick_ms
        tick = int(t_ms / self._cfg.tick_ms)
        nxt = np.searchsorted(self._win_start, tick, side="right")
        if nxt >= len(self._win_start):
            return sim_ms
        return float(self._win_start[nxt]) * self._cfg.tick_ms


def host_rate(cfg: SMRConfig, workload
              ) -> Tuple[Optional[TableRate], Optional[dict]]:
    """Returns (rate, closed): ``rate`` is a TableRate over the compiled
    table (None for the trivial baseline — callers keep their exact
    constant-rate path), ``closed`` is None or {"think_ms", "cap"}."""
    tab = lower(cfg, as_workload(workload))
    closed = None
    if float(tab["closed"]) > 0:
        closed = {"think_ms": float(tab["think_ticks"]) * cfg.tick_ms,
                  "cap": float(tab["cap"])}
    if is_trivial(tab):
        return None, None
    return TableRate(cfg, tab), closed


def closed_equilibrium_rate(rate_tx_s: float, closed: dict,
                            median_ms: float, n_origins: int) -> float:
    """Little's-law equilibrium arrival rate for a closed-loop pool whose
    open-loop latency measurement came back ``median_ms``."""
    think = closed["think_ms"]
    lat = median_ms if np.isfinite(median_ms) else think
    rate = rate_tx_s * think / (think + max(lat, 0.0))
    cap_bound = n_origins * closed["cap"] * 1000.0 / max(lat, 1e-9)
    return float(min(rate, cap_bound))
