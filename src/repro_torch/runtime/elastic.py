"""Elastic scaling + straggler mitigation for the pure-DP pod axis (port
of ``repro.runtime.elastic``, a copy: host numpy, no device).

Because (a) the pod axis carries no model state (DESIGN.md §4) and (b) the
data pipeline is a pure function of (seed, step, shard, n_shards), scaling
from P to P' pods is a *deterministic replan*: survivors re-derive their
batch shards and the Sporades commit quorum shrinks/grows — no resharding
of weights across the pod axis is ever needed. Straggler mitigation commits
a step with the quorum's gradients, rescaled by the participation fraction
(bounded-staleness correction).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np


@dataclass(frozen=True)
class ShardPlan:
    step: int
    n_pods: int
    pods: Tuple[int, ...]          # surviving pod ids, sorted
    shard_of: Dict[int, int]       # pod id -> data shard index

    @property
    def n_shards(self) -> int:
        return len(self.pods)


def replan(step: int, live_pods: List[int]) -> ShardPlan:
    pods = tuple(sorted(live_pods))
    return ShardPlan(step=step, n_pods=len(pods), pods=pods,
                     shard_of={p: i for i, p in enumerate(pods)})


def grad_scale(n_participating: int, n_planned: int) -> float:
    """Straggler drop: mean-of-means correction when only a quorum of pod
    gradients made the deadline (unbiased if shards are iid)."""
    assert 0 < n_participating <= n_planned
    return n_planned / n_participating


@dataclass
class StragglerPolicy:
    """Deadline policy: wait for all pods up to `deadline_ms`; after that
    commit with >= quorum gradients (Sporades async path decides whose)."""
    deadline_ms: float = 250.0
    min_quorum_frac: float = 0.5

    def decide(self, arrival_ms: Dict[int, float], n_pods: int
               ) -> Tuple[List[int], bool]:
        """Returns (participating pods, used_fallback)."""
        on_time = [p for p, t in arrival_ms.items() if t <= self.deadline_ms]
        if len(on_time) == n_pods:
            return sorted(on_time), False
        quorum = max(int(np.ceil(n_pods * self.min_quorum_frac)),
                     n_pods - (n_pods - 1) // 2)
        if len(on_time) >= quorum:
            return sorted(on_time), True
        # below quorum: wait for the stragglers (liveness over latency)
        return sorted(arrival_ms), True
