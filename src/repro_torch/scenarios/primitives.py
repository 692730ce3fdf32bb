"""Composable WAN adversary primitives (a copy of
``repro.scenarios.primitives``; the lowered tables must stay bitwise equal).

Each primitive is a frozen dataclass with a time window (seconds) and a
target selector, and knows how to *paint* itself onto the windowed env
tables the compiler builds (see compile.py):

  alive[w, n]          replica up/down per window
  drop[w, n, n]        link drop mask (sender, receiver)
  extra_delay[w, n, n] extra one-way delay in ticks
  nic_scale[w, n]      egress bandwidth multiplier per sender

Composition rules (primitives are applied in Scenario order):
  alive       — last writer wins (so ``Recover`` can undo a ``Crash``),
  drop        — OR (cuts accumulate; healing is the window's end),
  extra_delay — additive,
  nic_scale   — multiplicative.

Windows are maximal intervals between the union of all primitives' tick
edges, so every table row is constant over its window by construction.
Diagonal (self) links are never dropped or delayed: protocols rely on
self-delivery, and a box that cannot talk to itself is a ``Crash``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.configs.smr import SMRConfig

# "leader" = replica 0 (the leader of view 0 under the rotating v % n rule);
# "minority" = the first f = (n-1)//2 replicas; "random-minority" (only for
# TargetedDelay) re-picks a seeded random minority per repick window.
Targets = Union[str, Sequence[int]]

Tables = Dict[str, np.ndarray]


def resolve_targets(targets: Targets, n: int) -> np.ndarray:
    """[n] bool mask for a static target selector."""
    mask = np.zeros((n,), np.bool_)
    if isinstance(targets, str):
        if targets == "all":
            mask[:] = True
        elif targets == "leader":
            mask[0] = True
        elif targets == "minority":
            mask[: (n - 1) // 2] = True
        else:
            raise ValueError(f"unknown target selector {targets!r}")
    else:
        mask[np.asarray(list(targets), np.int64)] = True
    return mask


def _tick(cfg: SMRConfig, seconds: float, n_ticks: int) -> int:
    """First tick at or after a point in time, clipped to the sim. The
    boundary is computed in float32 — the simulator's native time
    precision."""
    if not math.isfinite(seconds):
        return n_ticks
    ticks = np.float32(seconds * 1000.0 / cfg.tick_ms)
    return min(n_ticks, max(0, int(np.ceil(ticks))))


def _covered(win_start: np.ndarray, t0: int, t1: int) -> np.ndarray:
    """[W] bool — windows whose (constant) span lies inside [t0, t1)."""
    return (win_start >= t0) & (win_start < t1)


def _offdiag(n: int) -> np.ndarray:
    return ~np.eye(n, dtype=np.bool_)


@dataclass(frozen=True)
class Scenario:
    """A named, ordered composition of adversary primitives."""
    name: str = "baseline"
    events: Tuple = ()


@dataclass(frozen=True)
class Crash:
    """Targets are down over [start_s, end_s) — an interval, not a one-way
    trip; omit end_s for a permanent crash.

    Semantics: a down replica neither sends nor acts, but its channels keep
    absorbing delivered state (netsim gates *actions* on alive, matching
    the seed model). Recovery therefore models a paused-then-resumed
    process that kept its in-memory monotone state — not a disk-wiped
    rebuild; there is no post-recovery catch-up cost beyond re-joining the
    protocol."""
    start_s: float
    targets: Targets = "leader"
    end_s: float = math.inf

    def edges(self, cfg: SMRConfig, n_ticks: int):
        return (_tick(cfg, self.start_s, n_ticks),
                _tick(cfg, self.end_s, n_ticks))

    def paint(self, cfg: SMRConfig, n_ticks: int, win_start: np.ndarray,
              tab: Tables) -> None:
        w = _covered(win_start, _tick(cfg, self.start_s, n_ticks),
                     _tick(cfg, self.end_s, n_ticks))
        tab["alive"][np.ix_(w, resolve_targets(self.targets,
                                               tab["alive"].shape[1]))] = False


@dataclass(frozen=True)
class Recover:
    """Targets are up from at_s on (overrides any earlier Crash)."""
    at_s: float
    targets: Targets = "all"

    def edges(self, cfg: SMRConfig, n_ticks: int):
        return (_tick(cfg, self.at_s, n_ticks),)

    def paint(self, cfg: SMRConfig, n_ticks: int, win_start: np.ndarray,
              tab: Tables) -> None:
        w = win_start >= _tick(cfg, self.at_s, n_ticks)
        tab["alive"][np.ix_(w, resolve_targets(self.targets,
                                               tab["alive"].shape[1]))] = True


@dataclass(frozen=True)
class Partition:
    """Drop every link between replicas of *different* groups over
    [start_s, end_s); replicas in no group keep all their links. Heals when
    the window ends (in-flight messages are not retroactively dropped)."""
    start_s: float
    end_s: float
    groups: Tuple[Tuple[int, ...], ...]

    def edges(self, cfg: SMRConfig, n_ticks: int):
        return (_tick(cfg, self.start_s, n_ticks),
                _tick(cfg, self.end_s, n_ticks))

    def paint(self, cfg: SMRConfig, n_ticks: int, win_start: np.ndarray,
              tab: Tables) -> None:
        n = tab["alive"].shape[1]
        member = np.full((n,), -1, np.int64)
        for gi, g in enumerate(self.groups):
            member[np.asarray(list(g), np.int64)] = gi
        cut = ((member[:, None] >= 0) & (member[None, :] >= 0)
               & (member[:, None] != member[None, :]))
        w = _covered(win_start, _tick(cfg, self.start_s, n_ticks),
                     _tick(cfg, self.end_s, n_ticks))
        tab["drop"][w] |= cut[None]


@dataclass(frozen=True)
class RegionOutage:
    """Correlated regional event over [start_s, end_s): the region's
    replicas are down AND the surviving WAN picks up reroute turbulence
    (delay_ms extra one-way delay on every link)."""
    start_s: float
    end_s: float
    regions: Targets = (2,)
    delay_ms: float = 50.0

    def edges(self, cfg: SMRConfig, n_ticks: int):
        return (_tick(cfg, self.start_s, n_ticks),
                _tick(cfg, self.end_s, n_ticks))

    def paint(self, cfg: SMRConfig, n_ticks: int, win_start: np.ndarray,
              tab: Tables) -> None:
        n = tab["alive"].shape[1]
        w = _covered(win_start, _tick(cfg, self.start_s, n_ticks),
                     _tick(cfg, self.end_s, n_ticks))
        tab["alive"][np.ix_(w, resolve_targets(self.regions, n))] = False
        tab["extra_delay"][w] += (np.float32(self.delay_ms / cfg.tick_ms)
                                  * _offdiag(n)[None])


@dataclass(frozen=True)
class GrayFailure:
    """Stochastic per-link degradation over [start_s, end_s): every
    redraw_s the adversary re-draws, per directed link, a uniform extra
    delay in [0, jitter_ms] and a Bernoulli(loss) drop. Draws come from a
    seeded per-redraw-window RandomState, so the lowered tables are a pure
    function of (cfg, primitive)."""
    start_s: float
    end_s: float
    loss: float = 0.05
    jitter_ms: float = 20.0
    redraw_s: float = 0.1
    seed: int = 0

    def _redraw_ticks(self, cfg: SMRConfig) -> int:
        return max(1, int(self.redraw_s * 1000.0 / cfg.tick_ms))

    def edges(self, cfg: SMRConfig, n_ticks: int):
        t0 = _tick(cfg, self.start_s, n_ticks)
        t1 = _tick(cfg, self.end_s, n_ticks)
        return tuple(range(t0, t1, self._redraw_ticks(cfg))) + (t1,)

    def paint(self, cfg: SMRConfig, n_ticks: int, win_start: np.ndarray,
              tab: Tables) -> None:
        n = tab["alive"].shape[1]
        t0 = _tick(cfg, self.start_s, n_ticks)
        t1 = _tick(cfg, self.end_s, n_ticks)
        off = _offdiag(n)
        for w in np.flatnonzero(_covered(win_start, t0, t1)):
            k = int(win_start[w] - t0) // self._redraw_ticks(cfg)
            rng = np.random.RandomState(
                (self.seed * 1_000_003 + 7919 * k) % (2**32 - 1))
            jit = rng.uniform(0.0, self.jitter_ms, (n, n)) / cfg.tick_ms
            lost = rng.random_sample((n, n)) < self.loss
            tab["extra_delay"][w] += (jit * off).astype(np.float32)
            tab["drop"][w] |= lost & off


@dataclass(frozen=True)
class TargetedDelay:
    """Generalized §5.5 DDoS: every link touching an attacked replica gains
    delay_ms each way over [start_s, end_s). Attack a fixed set ("leader",
    "minority", explicit indices) or, with targets="random-minority" and a
    repick_s, a seeded random minority re-picked per repick window — the
    exact seed-era DDoS fault-schedule attack."""
    delay_ms: float = 800.0
    targets: Targets = "minority"
    start_s: float = 0.0
    end_s: float = math.inf
    repick_s: Optional[float] = None
    seed: int = 7

    def _repick_ticks(self, cfg: SMRConfig) -> int:
        assert self.repick_s is not None
        return max(1, int(self.repick_s * 1000.0 / cfg.tick_ms))

    def edges(self, cfg: SMRConfig, n_ticks: int):
        t0 = _tick(cfg, self.start_s, n_ticks)
        t1 = _tick(cfg, self.end_s, n_ticks)
        if self.repick_s is None:
            return (t0, t1)
        return tuple(range(t0, t1, self._repick_ticks(cfg))) + (t1,)

    def paint(self, cfg: SMRConfig, n_ticks: int, win_start: np.ndarray,
              tab: Tables) -> None:
        n = tab["alive"].shape[1]
        t0 = _tick(cfg, self.start_s, n_ticks)
        t1 = _tick(cfg, self.end_s, n_ticks)
        ws = np.flatnonzero(_covered(win_start, t0, t1))
        delay = np.float32(self.delay_ms / cfg.tick_ms)
        if self.targets == "random-minority":
            if self.repick_s is None:
                raise ValueError("random-minority requires repick_s")
            repick = self._repick_ticks(cfg)
            # one sequential RandomState stream, row k = k-th repick window
            # (matches the seed-era pre-generated attacked-minority table)
            n_draws = ((int(win_start[ws[-1]]) - t0) // repick + 1
                       if len(ws) else 0)
            rng = np.random.RandomState(self.seed)
            f = (n - 1) // 2
            att_k = [rng.choice(n, size=f, replace=False)
                     for _ in range(n_draws)]
            for w in ws:
                att = np.zeros((n,), np.bool_)
                att[att_k[(int(win_start[w]) - t0) // repick]] = True
                tab["extra_delay"][w] += (att[:, None] | att[None, :]) * delay
        else:
            att = resolve_targets(self.targets, n)
            tab["extra_delay"][ws] += ((att[:, None] | att[None, :])
                                       * delay)[None]


@dataclass(frozen=True)
class BandwidthThrottle:
    """Scale the targets' NIC egress rate (bytes_per_tick) by ``scale``
    over [start_s, end_s)."""
    start_s: float
    end_s: float
    scale: float = 0.1
    targets: Targets = "all"

    def edges(self, cfg: SMRConfig, n_ticks: int):
        return (_tick(cfg, self.start_s, n_ticks),
                _tick(cfg, self.end_s, n_ticks))

    def paint(self, cfg: SMRConfig, n_ticks: int, win_start: np.ndarray,
              tab: Tables) -> None:
        w = _covered(win_start, _tick(cfg, self.start_s, n_ticks),
                     _tick(cfg, self.end_s, n_ticks))
        mask = resolve_targets(self.targets, tab["alive"].shape[1])
        tab["nic_scale"][np.ix_(w, mask)] *= np.float32(self.scale)
