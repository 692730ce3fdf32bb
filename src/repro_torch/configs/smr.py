"""The paper's own deployment configuration (§5.1–5.2).

Regions, RTT matrix, bandwidth, batch sizes and request sizes used by the
WAN simulator (core/netsim.py) and the sweep engine. A copy of
``repro.configs.smr``: the port keeps its own, so that it imports nothing of
the JAX package.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple, Union

import numpy as np

# 9 AWS regions of §5.1 (first 5 used for figs 6-8; up to 9 for fig 9).
REGIONS: Tuple[str, ...] = (
    "virginia", "ireland", "mumbai", "saopaulo", "tokyo",
    "oregon", "ohio", "singapore", "sydney",
)

# Public inter-region RTT estimates (ms). Symmetric; diagonal ~0.5ms.
# Source: cloudping-style public measurements, rounded. Kept in float64 on
# the host for exact ms arithmetic; netsim.build_env casts to float32 at the
# device boundary.
_RTT_MS = np.array([
    #  vir   ire   mum   sao   tok   ore   ohi   sin   syd
    [   1,   75,  185,  115,  160,   60,   12,  215,  200],  # virginia
    [  75,    1,  120,  175,  210,  130,   85,  175,  260],  # ireland
    [ 185,  120,    1,  300,  125,  215,  195,   60,  220],  # mumbai
    [ 115,  175,  300,    1,  255,  175,  125,  325,  310],  # saopaulo
    [ 160,  210,  125,  255,    1,   95,  145,   70,  105],  # tokyo
    [  60,  130,  215,  175,   95,    1,   50,  165,  140],  # oregon
    [  12,   85,  195,  125,  145,   50,    1,  200,  190],  # ohio
    [ 215,  175,   60,  325,   70,  165,  200,    1,   90],  # singapore
    [ 200,  260,  220,  310,  105,  140,  190,   90,    1],  # sydney
], dtype=np.float64)


def one_way_delay_ms(n: int) -> np.ndarray:
    """One-way delay matrix for the first n regions."""
    assert 3 <= n <= 9
    return _RTT_MS[:n, :n] / 2.0


@dataclass(frozen=True)
class SMRConfig:
    """§5.2 workload + per-protocol batching constants."""
    n_replicas: int = 5
    request_bytes: int = 16            # 8B key + 8B value
    client_batch: int = 100            # client-side batch size
    max_batch_ms: float = 5.0          # replica max batch time
    nic_gbps: float = 10.0             # c4.4xlarge "up to 10 Gbps"
    # per-request replica CPU cost (µs), shared by all protocols
    cpu_us_per_request: float = 3.0
    # replica-side batch sizes (requests) per §5.2
    batch_epaxos: int = 1000
    batch_paxos: int = 5000
    batch_rabia: int = 300
    batch_sporades: int = 2000
    batch_mandator: int = 2000
    # §4 child processes: parallel stateless dissemination lanes per replica
    mandator_lanes: int = 4
    # consensus metadata message size (bytes) — vector clock for mandator-*
    meta_bytes: int = 128
    epaxos_conflict_rate: float = 0.03
    view_timeout_ms: float = 300.0     # sporades/paxos view-change timeout
    sim_seconds: float = 10.0
    tick_ms: float = 1.0
    # Delayed-delivery horizon (ring-buffer slots) of the simulated
    # channels: a message's total delay is capped at horizon-1 ticks.
    # "auto" sizes it per sweep (netsim.resolve_horizon); an int pins it.
    delay_horizon_ticks: Union[int, str] = "auto"
    # Packed-channel-ring commit backend (repro_torch.kernels.channel_ring):
    # "auto" = the CUDA kernel on CUDA tensors, the plain PyTorch version on
    # CPU tensors; "ref" = the plain version on any device; "cuda" = the
    # kernel (raises on CPU tensors).
    channel_backend: str = "auto"
    # Flight recorder (repro_torch.obs): "off" (default — the tick runs
    # exactly the untraced ops), "counters" (per-kind event counts only),
    # or "full" (event rings + per-batch phase marks).
    trace_level: str = "off"
    # Event-ring capacity per replica per layer at trace_level="full";
    # overflow keeps the newest events and counts the dropped oldest.
    trace_events: int = 512
    # Consensus health monitor (repro_torch.obs.monitor): "off" (default),
    # "gauges" (ring occupancy, dropped sends, inflight high-water,
    # starvation) or "full" (gauges + safety/liveness invariant checks).
    monitor_level: str = "off"
    # Commit-stall watchdog grace window (ms). 0 = derive it per lane from
    # the view timeout and the scenario's delay tables.
    monitor_stall_grace_ms: float = 0.0

    def delays_ms(self) -> np.ndarray:
        return one_way_delay_ms(self.n_replicas)
