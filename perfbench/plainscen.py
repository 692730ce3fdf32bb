"""The plain reference's fault scenarios: windowed network tables, in NumPy.

A scenario is an ordered list of adversary primitives over a run of
``T = int(sim_seconds * 1000 / tick_ms)`` ticks. ``lower`` cuts the run
into windows at the union of the primitives' tick edges, paints each
primitive, in order, onto the windows its span covers, and returns:

  win_start [W]          int64, the first tick of each window (0 first)
  win_of_tick [T]        int32, each tick's window
  alive [W, n]           bool, a replica is up (last writer wins)
  drop [W, n, n]         bool, the link sender -> receiver is cut (OR)
  extra_delay [W, n, n]  float32, extra one-way delay in ticks (added)
  nic_scale [W, n]       float32, a sender's NIC rate factor (multiplied)

A self link is never cut or delayed. A time in seconds becomes the first
tick at or after it, computed in float32 and clipped to the run; an
unbounded end is the run's end.

``scenarios`` holds the simulator's named scenarios (its robustness
matrix, the paper's sec. 5.5 attack among them), placed at shares of the
run's length. This module was written from the simulator's scenario
library as it states it (the JAX package's ``scenarios/{library,
primitives,compile}.py`` were read as the specification and are not
imported); it shares no code with the port and imports nothing but NumPy.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

F32 = np.float32
KEYS = ("alive", "drop", "extra_delay", "nic_scale")


def _tick(tick_ms: float, seconds: float, ticks: int) -> int:
    if not math.isfinite(seconds):
        return ticks
    return min(ticks, max(0, int(np.ceil(F32(seconds * 1000.0 / tick_ms)))))


def _targets(sel, n: int) -> np.ndarray:
    """[n] bool: "all", "leader" (replica 0, view 0's leader), "minority"
    (the first (n - 1) // 2) or explicit indices."""
    mask = np.zeros((n,), np.bool_)
    if sel == "all":
        mask[:] = True
    elif sel == "leader":
        mask[0] = True
    elif sel == "minority":
        mask[: (n - 1) // 2] = True
    elif isinstance(sel, str):
        raise ValueError(f"unknown target selector {sel!r}")
    else:
        mask[np.asarray(list(sel), np.int64)] = True
    return mask


def _offdiag(n: int) -> np.ndarray:
    return ~np.eye(n, dtype=np.bool_)


class _Run:
    """What a primitive paints with: the run's length and tick, and the
    windows' first ticks."""

    def __init__(self, tick_ms: float, ticks: int, n: int,
                 win_start: np.ndarray = None):
        self.tick_ms, self.ticks, self.n = tick_ms, ticks, n
        self.win_start = win_start

    def at(self, seconds: float) -> int:
        return _tick(self.tick_ms, seconds, self.ticks)

    def covered(self, start_s: float, end_s: float) -> np.ndarray:
        """[W] bool: the windows whose first tick lies in [start, end)."""
        t0, t1 = self.at(start_s), self.at(end_s)
        return (self.win_start >= t0) & (self.win_start < t1)


@dataclass(frozen=True)
class Crash:
    """Targets down over [start, end): they act and send nothing, while
    what reaches them is still delivered."""

    start_s: float
    targets: object = "leader"
    end_s: float = math.inf

    def edges(self, r: _Run):
        return (r.at(self.start_s), r.at(self.end_s))

    def paint(self, r: _Run, tab) -> None:
        w = r.covered(self.start_s, self.end_s)
        tab["alive"][np.ix_(w, _targets(self.targets, r.n))] = False


@dataclass(frozen=True)
class Partition:
    """Every link between replicas of different groups cut over [start,
    end); a replica in no group keeps its links."""

    start_s: float
    end_s: float
    groups: Tuple

    def edges(self, r: _Run):
        return (r.at(self.start_s), r.at(self.end_s))

    def paint(self, r: _Run, tab) -> None:
        member = np.full((r.n,), -1, np.int64)
        for gi, g in enumerate(self.groups):
            member[np.asarray(list(g), np.int64)] = gi
        cut = ((member[:, None] >= 0) & (member[None, :] >= 0)
               & (member[:, None] != member[None, :]))
        tab["drop"][r.covered(self.start_s, self.end_s)] |= cut[None]


@dataclass(frozen=True)
class RegionOutage:
    """A region's replicas down over [start, end), and ``delay_ms`` more
    one-way delay on every other link meanwhile."""

    start_s: float
    end_s: float
    regions: object = (2,)
    delay_ms: float = 50.0

    def edges(self, r: _Run):
        return (r.at(self.start_s), r.at(self.end_s))

    def paint(self, r: _Run, tab) -> None:
        w = r.covered(self.start_s, self.end_s)
        tab["alive"][np.ix_(w, _targets(self.regions, r.n))] = False
        tab["extra_delay"][w] += (F32(self.delay_ms / r.tick_ms)
                                  * _offdiag(r.n)[None])


@dataclass(frozen=True)
class GrayFailure:
    """Over [start, end), every ``redraw_s`` a fresh draw for each directed
    link of a uniform extra delay in [0, jitter_ms] and a cut with
    probability ``loss``, from a ``RandomState`` seeded by the primitive's
    seed and the redraw window's index."""

    start_s: float
    end_s: float
    loss: float = 0.05
    jitter_ms: float = 20.0
    redraw_s: float = 0.1
    seed: int = 0

    def _every(self, r: _Run) -> int:
        return max(1, int(self.redraw_s * 1000.0 / r.tick_ms))

    def edges(self, r: _Run):
        t0, t1 = r.at(self.start_s), r.at(self.end_s)
        return tuple(range(t0, t1, self._every(r))) + (t1,)

    def paint(self, r: _Run, tab) -> None:
        t0, off = r.at(self.start_s), _offdiag(r.n)
        for w in np.flatnonzero(r.covered(self.start_s, self.end_s)):
            k = int(r.win_start[w] - t0) // self._every(r)
            rng = np.random.RandomState(
                (self.seed * 1_000_003 + 7919 * k) % (2 ** 32 - 1))
            jit = rng.uniform(0.0, self.jitter_ms, (r.n, r.n)) / r.tick_ms
            lost = rng.random_sample((r.n, r.n)) < self.loss
            tab["extra_delay"][w] += (jit * off).astype(F32)
            tab["drop"][w] |= lost & off


@dataclass(frozen=True)
class TargetedDelay:
    """Every link to or from an attacked replica gains ``delay_ms`` over
    [start, end). The attacked set is fixed, or with "random-minority" a
    minority of (n - 1) // 2 drawn afresh every ``repick_s`` from one
    ``RandomState(seed)`` stream, draw k for the k-th repick window."""

    delay_ms: float = 800.0
    targets: object = "minority"
    start_s: float = 0.0
    end_s: float = math.inf
    repick_s: Optional[float] = None
    seed: int = 7

    def _every(self, r: _Run) -> int:
        return max(1, int(self.repick_s * 1000.0 / r.tick_ms))

    def edges(self, r: _Run):
        t0, t1 = r.at(self.start_s), r.at(self.end_s)
        if self.repick_s is None:
            return (t0, t1)
        return tuple(range(t0, t1, self._every(r))) + (t1,)

    def paint(self, r: _Run, tab) -> None:
        t0, n = r.at(self.start_s), r.n
        ws = np.flatnonzero(r.covered(self.start_s, self.end_s))
        delay = F32(self.delay_ms / r.tick_ms)
        if self.targets != "random-minority":
            att = _targets(self.targets, n)
            tab["extra_delay"][ws] += ((att[:, None] | att[None, :])
                                       * delay)[None]
            return
        if self.repick_s is None:
            raise ValueError("random-minority needs repick_s")
        every = self._every(r)
        draws = (int(r.win_start[ws[-1]]) - t0) // every + 1 if len(ws) else 0
        rng = np.random.RandomState(self.seed)
        picks = [rng.choice(n, size=(n - 1) // 2, replace=False)
                 for _ in range(draws)]
        for w in ws:
            att = np.zeros((n,), np.bool_)
            att[picks[(int(r.win_start[w]) - t0) // every]] = True
            tab["extra_delay"][w] += (att[:, None] | att[None, :]) * delay


@dataclass(frozen=True)
class BandwidthThrottle:
    """The targets' NIC rate times ``scale`` over [start, end)."""

    start_s: float
    end_s: float
    scale: float = 0.1
    targets: object = "all"

    def edges(self, r: _Run):
        return (r.at(self.start_s), r.at(self.end_s))

    def paint(self, r: _Run, tab) -> None:
        w = r.covered(self.start_s, self.end_s)
        tab["nic_scale"][np.ix_(w, _targets(self.targets, r.n))] *= F32(
            self.scale)


def scenarios(sim_s: float, n: int = 5) -> Dict[str, Tuple]:
    """The named scenarios of a run of ``sim_s`` seconds at n replicas,
    each an ordered tuple of primitives."""
    f = (n - 1) // 2
    minority, majority = tuple(range(f)), tuple(range(f, n))
    flap_on = 0.12 * sim_s
    return {
        "baseline": (),
        # sec. 5.5: 800 ms on a random minority's links, re-picked each
        # second
        "paper-ddos": (TargetedDelay(800.0, "random-minority",
                                     repick_s=1.0, seed=7),),
        "leader-ddos": (TargetedDelay(800.0, "leader"),),
        "symmetric-partition": (Partition(0.4 * sim_s, 0.7 * sim_s,
                                          (minority, majority)),),
        "minority-partition": (Partition(0.4 * sim_s, math.inf,
                                         (minority, majority)),),
        "region-outage": (RegionOutage(0.4 * sim_s, 0.7 * sim_s, (2,),
                                       50.0),),
        "gray-wan": (GrayFailure(0.2 * sim_s, 0.9 * sim_s, loss=0.05,
                                 jitter_ms=25.0, redraw_s=0.1, seed=11),),
        "flapping-link": tuple(
            Partition((0.2 + 0.2 * k) * sim_s,
                      (0.2 + 0.2 * k + flap_on) * sim_s, ((0,), (1,)))
            for k in range(4)),
        "throttled-nic": (BandwidthThrottle(0.3 * sim_s, math.inf, 0.1,
                                            "leader"),),
        "leader-crash-recover": (Crash(0.3 * sim_s, "leader",
                                       end_s=0.6 * sim_s),),
    }


NAMES = tuple(scenarios(1.0))


def lower(settings: Dict, name: Optional[str]) -> Dict[str, np.ndarray]:
    """The tables of scenario ``name`` (None: the fault-free network) for
    a run of ``settings`` (``n_replicas``, ``tick_ms``, ``sim_seconds``)."""
    n, tick_ms = int(settings["n_replicas"]), float(settings["tick_ms"])
    sim_s = float(settings["sim_seconds"])
    ticks = int(sim_s * 1000 / tick_ms)
    lib = scenarios(sim_s, n)
    if name is not None and name not in lib:
        raise KeyError(f"unknown scenario {name!r}; known: {', '.join(lib)}")
    events = () if name is None else lib[name]
    r = _Run(tick_ms, ticks, n)
    edges = {0}
    for ev in events:
        edges.update(int(e) for e in ev.edges(r))
    win_start = np.array(sorted(e for e in edges if 0 <= e < ticks),
                         np.int64)
    w = len(win_start)
    r.win_start = win_start
    tab = {"alive": np.ones((w, n), np.bool_),
           "drop": np.zeros((w, n, n), np.bool_),
           "extra_delay": np.zeros((w, n, n), F32),
           "nic_scale": np.ones((w, n), F32)}
    for ev in events:
        ev.paint(r, tab)
    tab["win_start"] = win_start
    tab["win_of_tick"] = (np.searchsorted(win_start, np.arange(ticks),
                                          side="right") - 1).astype(np.int32)
    return tab


def stack(tabs: Sequence[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """Lanes' tables stacked on a leading axis: ``win_of_tick`` [B, T] and
    each window table [B, W, ...], padded to the lanes' most windows with
    its last row (a row no tick reads)."""
    most = max(t["alive"].shape[0] for t in tabs)
    out: Dict[str, List[np.ndarray]] = {k: [] for k in KEYS}
    for t in tabs:
        pad = most - t["alive"].shape[0]
        for k in KEYS:
            out[k].append(np.pad(t[k], ((0, pad),) + ((0, 0),) * (
                t[k].ndim - 1), mode="edge"))
    stacked = {k: np.stack(v) for k, v in out.items()}
    stacked["win_of_tick"] = np.stack([t["win_of_tick"] for t in tabs])
    return stacked
