"""Sporades for the training control plane: dual-mode step/cut commit
(port of ``repro.runtime.sporades_rt``, a copy: a host state machine in
numpy that touches no device).

Synchronous mode: the view's leader proposes the next cut (a Mandator
round-vector); every live controller votes; one round-trip commit — O(n)
control messages per training step.

Asynchronous mode: if the leader (or the fabric) stalls past the timeout,
controllers run the two-height fallback and the shared-seed common coin
(core/coin.py — the exact primitive from §3.2.1) elects whose cut commits;
training liveness survives any minority of stalled/dead pods, which is the
paper's DDoS/crash resilience transplanted to stragglers and pod failures.

Transport is pluggable (in-process here); the protocol state machine is the
one verified tick-level in core/sporades.py — this runtime trades the tick
simulator for a synchronous scheduler usable inside a training loop.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.coin import common_coin_flip
from repro_torch.obs.monitor import HostMonitor
from repro_torch.obs.trace import HostTrace


@dataclass
class CommitRecord:
    view: int
    round: int
    cut: np.ndarray
    mode: str                      # "sync" | "async"


@dataclass
class ControllerState:
    idx: int
    alive: bool = True
    straggling: bool = False       # responds after the deadline
    v_cur: int = 0
    r_cur: int = 0
    committed: List[CommitRecord] = field(default_factory=list)


class SporadesRuntime:
    """Step-commit driver. Each call to `commit_step(cuts)` is one consensus
    round over the controllers' proposed cuts."""

    def __init__(self, n_pods: int, seed: int = 0):
        self.n = n_pods
        self.f = (n_pods - 1) // 2
        self.seed = seed
        self.ctl = [ControllerState(i) for i in range(n_pods)]
        self.view = 0
        self.round = 0
        # flight recorder (host-side twin of repro_torch.obs, same taxonomy)
        self.trace = HostTrace()
        # health monitor: every commit any controller applies is checked
        # for monotone views, prefix order, commit-once and agreement
        self.monitor = HostMonitor(n_pods)

    # ---- liveness predicates ----------------------------------------------
    def _responsive(self) -> List[int]:
        return [c.idx for c in self.ctl if c.alive and not c.straggling]

    def _live(self) -> List[int]:
        return [c.idx for c in self.ctl if c.alive]

    def leader(self, view: int) -> int:
        return view % self.n

    # ---- one commit round ---------------------------------------------------
    def commit_step(self, cuts: Dict[int, np.ndarray]
                    ) -> Optional[CommitRecord]:
        """cuts: proposed vector-clock cut per live controller. Returns the
        committed record, or None if even the fallback lacks a quorum."""
        resp = [i for i in self._responsive() if i in cuts]
        ldr = self.leader(self.view)
        # ---- synchronous path: leader proposes, all responsive vote -------
        if ldr in resp and len(resp) >= self.n - self.f:
            cut = cuts[ldr]
            rec = CommitRecord(self.view, self.round + 1, cut.copy(), "sync")
            self._apply(rec, resp)
            self.trace.record("commit", rec.round, who=ldr,
                              key=rec.view, total=len(resp))
            return rec
        # ---- timeout -> asynchronous fallback ------------------------------
        self.trace.record("mode_switch", self.round, who=ldr,
                          is_async=1, view=self.view)
        live = [i for i in self._live() if i in cuts]
        if len(live) < self.n - self.f:
            return None                                  # no quorum at all
        # two-height exchange happens among `live`; the common coin elects
        view = self.view + 1
        elected = int(common_coin_flip(view, self.n, self.seed))
        self.trace.record("leader_change", self.round, who=elected,
                          leader=elected, view=view)
        # the elected block commits iff its controller completed height 2 —
        # i.e. it is among the live quorum ("first n-f async-complete")
        if elected in live:
            cut = cuts[elected]
            rec = CommitRecord(view, self.round + 1, cut.copy(), "async")
            self.view = view + 1
            self.trace.record("view_change", rec.round,
                              view=self.view, round=rec.round)
            self.trace.record("mode_switch", rec.round, who=elected,
                              is_async=0, view=self.view)
            self._apply(rec, live)
            self.trace.record("commit", rec.round, who=elected,
                              key=rec.view, total=len(live))
            return rec
        # coin landed on a dead/straggling pod: adopt its height-1 block if
        # seen (Bfall) — here: no commit this round, advance the view
        self.view = view + 1
        self.round += 1
        self.trace.record("view_change", self.round, view=self.view,
                          round=self.round)
        return None

    def _apply(self, rec: CommitRecord, voters: List[int]) -> None:
        self.round = rec.round
        for i in voters:
            c = self.ctl[i]
            c.v_cur = rec.view
            c.r_cur = rec.round
            c.committed.append(rec)
            self.monitor.observe_commit(i, rec.view, rec.round, rec.cut)

    # ---- failure injection ---------------------------------------------------
    def crash(self, pod: int) -> None:
        self.ctl[pod].alive = False
        self.trace.record("crash", self.round, who=pod,
                          view=self.view, round=self.round)

    def recover(self, pod: int) -> None:
        self.ctl[pod].alive = True
        self.trace.record("recover", self.round, who=pod,
                          view=self.view, round=self.round)

    def set_straggler(self, pod: int, straggling: bool = True) -> None:
        self.ctl[pod].straggling = straggling
