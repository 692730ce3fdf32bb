"""Lower a declarative Scenario to the array-native windowed env tables.

The union of every primitive's tick edges cuts the run into W maximal
windows over which all tables are constant; ``lower`` paints each primitive
onto the rows it covers (in Scenario order) and emits, as plain numpy:

  win_start[W]           first tick of each window (win_start[0] == 0)
  win_of_tick[n_ticks]   tick -> window row (precomputed, exact)
  alive[W, n], drop[W, n, n], extra_delay[W, n, n], nic_scale[W, n]

``netsim.build_env`` moves these into the env dict; padding to a common
``n_windows`` (repeat-last-row, rows never read because ``win_of_tick``
only indexes real windows) is what lets heterogeneous scenarios stack along
the batch axis of ``experiment.run_sweep``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.configs.smr import SMRConfig
from repro_torch.scenarios.primitives import Scenario, Tables


def _sim_ticks(cfg: SMRConfig) -> int:
    # keep in sync with netsim.sim_ticks (not imported: scenarios sit below
    # core in the layering; netsim imports us lazily from build_env)
    return int(cfg.sim_seconds * 1000 / cfg.tick_ms)


def n_windows(cfg: SMRConfig, scenario: Scenario) -> int:
    """Window count of the lowered scenario (for cross-scenario padding)."""
    return len(_win_starts(cfg, scenario))


def _win_starts(cfg: SMRConfig, scenario: Scenario) -> np.ndarray:
    n_ticks = _sim_ticks(cfg)
    edges = {0}
    for ev in scenario.events:
        edges.update(int(e) for e in ev.edges(cfg, n_ticks))
    return np.array(sorted(e for e in edges if 0 <= e < n_ticks), np.int64)


_WINDOW_KEYS = ("alive", "drop", "extra_delay", "nic_scale")


def pad_tables(tab: Tables, pad_windows: int) -> Tables:
    """Repeat-last-row pad the [W, ...] window tables to a common width
    (padding rows are never read: ``win_of_tick`` only indexes real
    windows). ``win_start``/``win_of_tick`` pass through untouched."""
    w = tab["alive"].shape[0]
    if pad_windows < w:
        raise ValueError(f"pad_windows={pad_windows} < {w} real windows")
    pad = pad_windows - w
    return {k: (np.pad(v, ((0, pad),) + ((0, 0),) * (v.ndim - 1),
                       mode="edge") if k in _WINDOW_KEYS else v)
            for k, v in tab.items()}


def lower(cfg: SMRConfig, scenario: Scenario,
          pad_windows: Optional[int] = None) -> Tables:
    n = cfg.n_replicas
    n_ticks = _sim_ticks(cfg)
    win_start = _win_starts(cfg, scenario)
    w = len(win_start)
    tab: Tables = {
        "alive": np.ones((w, n), np.bool_),
        "drop": np.zeros((w, n, n), np.bool_),
        "extra_delay": np.zeros((w, n, n), np.float32),
        "nic_scale": np.ones((w, n), np.float32),
    }
    for ev in scenario.events:
        ev.paint(cfg, n_ticks, win_start, tab)
    tab["win_start"] = win_start
    tab["win_of_tick"] = (np.searchsorted(win_start, np.arange(n_ticks),
                                          side="right") - 1).astype(np.int32)
    if pad_windows is not None:
        tab = pad_tables(tab, pad_windows)
    return tab


def as_scenario(obj) -> Scenario:
    """Normalize None / Scenario to a Scenario."""
    if obj is None:
        return Scenario()
    if isinstance(obj, Scenario):
        return obj
    raise TypeError(f"expected Scenario or None, got {type(obj)}")
