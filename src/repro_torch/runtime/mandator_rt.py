"""Mandator for the training control plane: vector-clock artifact rounds
(port of ``repro.runtime.mandator_rt``, a copy: a host state machine in
numpy that touches no device).

Each pod controller owns a chain of *artifact rounds* (gradient
accumulations, checkpoint shards, metric records). The dissemination layer
(payload movement: reduce-scatters, shard uploads) runs at network speed,
ahead of commit; the control plane exchanges only int round-vectors and
commits *cuts* — getClientRequests() of Algorithm 1, verbatim, with pods in
place of replicas and artifact rounds in place of request batches.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from repro_torch.obs.monitor import HostMonitor
from repro_torch.obs.trace import HostTrace


@dataclass
class PodState:
    """One pod controller's view (lastCompletedRounds + own chain)."""
    pod: int
    n_pods: int
    own_round: int = 0
    awaiting: bool = False
    lcr: np.ndarray = field(default=None)
    votes: Dict[int, set] = field(default_factory=dict)

    def __post_init__(self):
        if self.lcr is None:
            self.lcr = np.zeros(self.n_pods, np.int64)


class MandatorRuntime:
    """In-process multi-pod instance (transport = direct calls; a real
    deployment swaps `broadcast` for RPC — the state machine is identical).
    Omission faults are injected by dropping deliveries (see tests)."""

    def __init__(self, n_pods: int):
        self.n = n_pods
        self.f = (n_pods - 1) // 2
        self.pods = [PodState(i, n_pods) for i in range(n_pods)]
        self.drop = np.zeros((n_pods, n_pods), bool)   # drop[i, j]: i->j lost
        # flight recorder (host-side twin of repro_torch.obs, same taxonomy)
        self.trace = HostTrace()
        # health monitor: completions must be strictly in round order and
        # never repeat (chain order is Algorithm 1's core invariant)
        self.monitor = HostMonitor(n_pods)

    # ---- Algorithm 1 ------------------------------------------------------
    def write(self, pod: int, payload_ready: bool = True) -> Optional[int]:
        """new-Mandator-batch: announce round own_round+1 (payload assumed
        disseminated by the data plane — payload_ready is its ack)."""
        p = self.pods[pod]
        if p.awaiting or not payload_ready:
            return None
        r = p.own_round + 1
        p.awaiting = True
        p.votes[r] = set()
        self.trace.record("batch_create", r, who=pod, round=r, count=1)
        for j in range(self.n):
            if not self.drop[pod, j]:
                self._deliver_batch(pod, j, r)
        return r

    def _deliver_batch(self, owner: int, to: int, r: int) -> None:
        q = self.pods[to]
        q.lcr[owner] = max(q.lcr[owner], r - 1)
        if not self.drop[to, owner]:                   # Mandator-vote
            self.pods[owner].votes.setdefault(r, set()).add(to)
            self._check_complete(owner, r)

    def _check_complete(self, owner: int, r: int) -> None:
        p = self.pods[owner]
        if p.awaiting and r == p.own_round + 1 \
                and len(p.votes.get(r, ())) >= self.n - self.f:
            p.own_round = r
            p.awaiting = False
            p.lcr[owner] = r
            self.monitor.observe_completion(owner, r)
            self.trace.record("batch_stable", r, who=owner, round=r,
                              completed=1)

    # ---- consensus payload -------------------------------------------------
    def get_client_requests(self, pod: int) -> np.ndarray:
        """lastCompletedRounds — what the commit layer orders."""
        return self.pods[pod].lcr.copy()

    def committed_cut(self, cuts: List[np.ndarray]) -> np.ndarray:
        """Elementwise max of committed vector clocks (commit = monotone)."""
        out = np.zeros(self.n, np.int64)
        for c in cuts:
            out = np.maximum(out, c)
        return out
