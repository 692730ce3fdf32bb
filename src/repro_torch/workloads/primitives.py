"""Composable traffic-shape primitives (a copy of
``repro.workloads.primitives``; the lowered tables must stay bitwise equal)
— the client side of the paper's
§5.2–§5.5 experiments, made declarative the same way scenarios made the
network adversary declarative.

Each primitive is a frozen dataclass with a time window (seconds) and knows
how to *paint* itself onto the windowed rate table the compiler builds
(see compile.py):

  rate_of[w, n]   per-origin rate multiplier, 1.0 = the origin's uniform
                  share of the sweep's offered rate (so an all-ones table
                  is exactly the seed-era colocated open-loop Poisson load)

Composition rules (primitives are applied in Workload order):
  scalers        (PoissonOpen, OnOffBurst, DiurnalRamp, FlashCrowd)
                 — multiplicative on the rows/origins they cover,
  redistributors (RegionSkew, ClosedLoop placement)
                 — replace the per-origin split of a window while
                 conserving that window's total offered load.

Windows are maximal intervals between the union of all primitives' tick
edges, so every table row is constant over its window by construction;
time-varying shapes (ramps, decays) are evaluated at the window midpoint.

``ClosedLoop`` switches the workload from open-loop (rate is offered
regardless of progress) to closed-loop (Atlas-style geo-placed client
pools): the sweep rate sets the client population via Little's law
(clients = rate x think time), each pool submits at
(clients - in_flight) / think_ticks, and arrivals are additionally capped
so per-origin in-flight never exceeds ``cap``. The in-flight decrement at
commit lives inside the simulator's scan carry (core/harness.py).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from repro_torch.configs.smr import SMRConfig
from repro_torch.scenarios.primitives import (
    Targets,
    _covered,
    _tick,
    resolve_targets,
)

Tables = dict


@dataclass(frozen=True)
class Workload:
    """A named, ordered composition of traffic-shape primitives."""
    name: str = "poisson-open"
    shapes: Tuple = ()


def _redistribute(tab: Tables, rows: np.ndarray, weights: np.ndarray) -> None:
    """Replace covered rows' per-origin split with ``weights`` (sum 1),
    conserving each row's total offered load."""
    totals = tab["rate_of"][rows].sum(axis=1, keepdims=True)
    tab["rate_of"][rows] = totals * weights[None, :]


@dataclass(frozen=True)
class PoissonOpen:
    """The seed-era baseline: open-loop Poisson arrivals, colocated with
    every replica, at ``scale`` x the uniform share. scale=1.0 compiles to
    the all-ones table (the provably-identical fast path)."""
    scale: float = 1.0

    def edges(self, cfg: SMRConfig, n_ticks: int):
        return ()

    def paint(self, cfg: SMRConfig, n_ticks: int, win_start: np.ndarray,
              tab: Tables) -> None:
        tab["rate_of"] *= np.float64(self.scale)


@dataclass(frozen=True)
class OnOffBurst:
    """Square-wave traffic: each ``period_s`` the targets send at
    ``on_scale`` for ``duty`` of the period, then ``off_scale`` for the
    rest, over [start_s, end_s)."""
    period_s: float
    duty: float = 0.5
    on_scale: float = 2.0
    off_scale: float = 0.0
    targets: Targets = "all"
    start_s: float = 0.0
    end_s: float = math.inf

    def edges(self, cfg: SMRConfig, n_ticks: int):
        if self.period_s <= 0 or not 0 < self.duty <= 1:
            raise ValueError("OnOffBurst needs period_s > 0, 0 < duty <= 1")
        t0 = _tick(cfg, self.start_s, n_ticks)
        t1 = _tick(cfg, self.end_s, n_ticks)
        out = [t0, t1]
        k = 0
        while True:
            on = _tick(cfg, self.start_s + k * self.period_s, n_ticks)
            off = _tick(cfg, self.start_s + (k + self.duty) * self.period_s,
                        n_ticks)
            if on >= t1 and off >= t1:
                break
            out += [on, off]
            k += 1
        return tuple(e for e in out if t0 <= e <= t1)

    def paint(self, cfg: SMRConfig, n_ticks: int, win_start: np.ndarray,
              tab: Tables) -> None:
        t0 = _tick(cfg, self.start_s, n_ticks)
        t1 = _tick(cfg, self.end_s, n_ticks)
        mask = resolve_targets(self.targets, tab["rate_of"].shape[1])
        period = max(self.period_s * 1000.0 / cfg.tick_ms, 1.0)
        for w in np.flatnonzero(_covered(win_start, t0, t1)):
            nxt = win_start[w + 1] if w + 1 < len(win_start) else n_ticks
            mid = (win_start[w] + nxt) / 2.0
            phase = ((mid - t0) % period) / period
            s = self.on_scale if phase < self.duty else self.off_scale
            tab["rate_of"][w, mask] *= np.float64(s)


@dataclass(frozen=True)
class DiurnalRamp:
    """Smooth day/night load cycle discretized to a staircase: total load
    ramps between ``low`` and ``high`` x baseline along a cosine of period
    ``period_s``, re-evaluated every ``step_s`` (at the step midpoint, so a
    whole period averages exactly (low+high)/2)."""
    period_s: float
    low: float = 0.25
    high: float = 1.75
    step_s: float = 0.25
    targets: Targets = "all"

    def edges(self, cfg: SMRConfig, n_ticks: int):
        step = max(1, _tick(cfg, self.step_s, n_ticks))
        return tuple(range(0, n_ticks, step)) + (n_ticks,)

    def paint(self, cfg: SMRConfig, n_ticks: int, win_start: np.ndarray,
              tab: Tables) -> None:
        mask = resolve_targets(self.targets, tab["rate_of"].shape[1])
        period = self.period_s * 1000.0 / cfg.tick_ms
        for w in range(len(win_start)):
            nxt = win_start[w + 1] if w + 1 < len(win_start) else n_ticks
            mid = (win_start[w] + nxt) / 2.0
            s = self.low + (self.high - self.low) * 0.5 * (
                1.0 - math.cos(2.0 * math.pi * mid / period))
            tab["rate_of"][w, mask] *= np.float64(s)


@dataclass(frozen=True)
class FlashCrowd:
    """A sudden crowd at the target regions: load jumps to ``magnitude`` x
    over [at_s, at_s + duration_s), then decays back exponentially over
    ``decay_s`` (staircase, ``decay_steps`` windows; decay_s=0 is a clean
    rectangle — the analytically-exact form the conservation tests pin)."""
    at_s: float
    duration_s: float = 0.5
    magnitude: float = 8.0
    targets: Targets = "all"
    decay_s: float = 0.0
    decay_steps: int = 6

    def edges(self, cfg: SMRConfig, n_ticks: int):
        t0 = _tick(cfg, self.at_s, n_ticks)
        t1 = _tick(cfg, self.at_s + self.duration_s, n_ticks)
        out = [t0, t1]
        if self.decay_s > 0:
            step = self.decay_s / self.decay_steps
            out += [_tick(cfg, self.at_s + self.duration_s + k * step,
                          n_ticks) for k in range(1, self.decay_steps + 1)]
        return tuple(out)

    def paint(self, cfg: SMRConfig, n_ticks: int, win_start: np.ndarray,
              tab: Tables) -> None:
        mask = resolve_targets(self.targets, tab["rate_of"].shape[1])
        t0 = _tick(cfg, self.at_s, n_ticks)
        t1 = _tick(cfg, self.at_s + self.duration_s, n_ticks)
        w = _covered(win_start, t0, t1)
        tab["rate_of"][np.ix_(w, mask)] *= np.float64(self.magnitude)
        if self.decay_s > 0:
            t2 = _tick(cfg, self.at_s + self.duration_s + self.decay_s,
                       n_ticks)
            tau = self.decay_s * 1000.0 / cfg.tick_ms / 3.0
            for wi in np.flatnonzero(_covered(win_start, t1, t2)):
                nxt = win_start[wi + 1] if wi + 1 < len(win_start) else n_ticks
                mid = (win_start[wi] + nxt) / 2.0
                s = 1.0 + (self.magnitude - 1.0) * math.exp(-(mid - t1) / tau)
                tab["rate_of"][wi, mask] *= np.float64(s)


@dataclass(frozen=True)
class RegionSkew:
    """WPaxos-style locality: ``hot_frac`` of the total offered load comes
    from the ``hot`` regions, the rest is shared evenly by the others —
    and, with ``migrate_s``, the hotspot *moves* to the next region (mod n)
    every ``migrate_s`` seconds (the locality-shifting access pattern
    WPaxos is built around). Conserves each window's total load."""
    hot_frac: float = 0.8
    hot: Tuple[int, ...] = (0,)
    migrate_s: Optional[float] = None
    start_s: float = 0.0
    end_s: float = math.inf

    def _migrate_ticks(self, cfg: SMRConfig) -> int:
        assert self.migrate_s is not None
        return max(1, int(self.migrate_s * 1000.0 / cfg.tick_ms))

    def edges(self, cfg: SMRConfig, n_ticks: int):
        t0 = _tick(cfg, self.start_s, n_ticks)
        t1 = _tick(cfg, self.end_s, n_ticks)
        if self.migrate_s is None:
            return (t0, t1)
        return tuple(range(t0, t1 if math.isfinite(self.end_s) else n_ticks,
                           self._migrate_ticks(cfg))) + (t1,)

    def paint(self, cfg: SMRConfig, n_ticks: int, win_start: np.ndarray,
              tab: Tables) -> None:
        n = tab["rate_of"].shape[1]
        t0 = _tick(cfg, self.start_s, n_ticks)
        t1 = _tick(cfg, self.end_s, n_ticks)
        n_hot = len(self.hot)
        if not 0 < n_hot < n:
            raise ValueError("RegionSkew.hot must be a proper subset")
        for w in np.flatnonzero(_covered(win_start, t0, t1)):
            shift = 0 if self.migrate_s is None else \
                (int(win_start[w]) - t0) // self._migrate_ticks(cfg)
            weights = np.full((n,), (1.0 - self.hot_frac) / (n - n_hot))
            for h in self.hot:
                weights[(h + shift) % n] = self.hot_frac / n_hot
            _redistribute(tab, np.array([w]), weights)


@dataclass(frozen=True)
class ClosedLoop:
    """Geo-placed closed-loop client pools (Atlas-style): the sweep rate
    sets the total client population via Little's law
    (clients = rate_tx_s x think_ms), split across regions by
    ``placement`` (None = uniform; else per-region weights, normalized).
    Each pool submits at (clients - in_flight)/think ticks and never holds
    more than ``cap`` requests in flight per origin; the in-flight count is
    decremented when the batch carrying a request commits (the feedback
    lives in the scan carry, core/harness.py)."""
    think_ms: float = 50.0
    cap: float = 4000.0
    placement: Optional[Tuple[float, ...]] = None

    def edges(self, cfg: SMRConfig, n_ticks: int):
        return ()

    def paint(self, cfg: SMRConfig, n_ticks: int, win_start: np.ndarray,
              tab: Tables) -> None:
        n = tab["rate_of"].shape[1]
        if tab["closed"]:
            raise ValueError("a Workload may contain only one ClosedLoop")
        if self.placement is not None:
            w = np.asarray(self.placement, np.float64)
            if w.shape != (n,) or (w < 0).any() or w.sum() <= 0:
                raise ValueError(
                    f"placement must be {n} non-negative weights")
            _redistribute(tab, np.arange(tab["rate_of"].shape[0]),
                          w / w.sum())
        tab["closed"] = True
        tab["think_ticks"] = max(self.think_ms / cfg.tick_ms, 1.0)
        tab["cap"] = float(self.cap)
