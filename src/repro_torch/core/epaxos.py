"""EPaxos baseline — analytic model, a copy of ``repro.core.epaxos``
(host numpy; no device work).

Why a model: the paper itself explains EPaxos's WAN collapse via the revised
EPaxos study (NSDI'21 [45]): with batching, request batches conflict almost
surely, forcing (a) the slow path (second round) and (b) *execution* to wait
for dependency batches from other replicas' instances. We model:

- per-replica sequential instances (no pipelining, §5.2), batch 1000;
- commit latency = fast-quorum RTT + P_slow * majority RTT, with
  P_slow = 1 - (1 - p_conflict)^min(batch, 100);
- execution: global dependency order — executing instance k requires
  learning the previous conflicting instance's commit from its (remote)
  command leader, costing one average one-way delay per link in the chain:
  exec_k = max(commit_k + d_max(origin), exec_{k-1} + d_avg).

The d_avg serial term is the "infinitely growing dependency chains" effect:
when commits outpace 1/d_avg, execution latency diverges — reproducing the
~6.5k tx/s @ <=720ms saturation the paper measures.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from repro_torch.configs.smr import SMRConfig
from repro_torch.obs import monitor as hmon
from repro_torch.obs.decode import host_phases
from repro_torch.obs.trace import TraceLevel
from repro_torch.workloads.analytic import (
    TableRate,
    closed_equilibrium_rate,
    host_rate,
)


def run_epaxos_model(cfg: SMRConfig, rate_tx_s: float, scenario=None,
                     workload=None) -> Dict:
    """``workload``: a ``workloads.Workload`` (or None). Open-loop shapes
    modulate the per-origin mean rate over time through the same compiled
    table the simulator reads; a closed-loop workload is approximated at
    its Little's-law equilibrium (run once open to measure latency, then
    re-run at the rate the client pools actually sustain)."""
    wl_rate, closed = host_rate(cfg, workload)
    if closed is not None:
        first = _epaxos_once(cfg, rate_tx_s, wl_rate)
        rate_eff = closed_equilibrium_rate(rate_tx_s, closed,
                                           first["median_ms"],
                                           cfg.n_replicas)
        out = _epaxos_once(cfg, rate_eff, wl_rate)
        out["rate"] = rate_tx_s
        return out
    return _epaxos_once(cfg, rate_tx_s, wl_rate)


def _epaxos_once(cfg: SMRConfig, rate_tx_s: float,
                 wl_rate: Optional[TableRate] = None) -> Dict:
    n = cfg.n_replicas
    d = cfg.delays_ms()                      # one-way ms
    off = d + np.where(np.eye(n, dtype=bool), np.inf, 0)
    rtt = 2 * d
    fast_q = n // 2 + 1                      # thrifty fast quorum incl self
    # per-replica commit duration for one instance
    sorted_rtt = np.sort(np.where(np.eye(n, dtype=bool), np.inf, rtt), axis=1)
    fast_rtt = sorted_rtt[:, fast_q - 2]     # slowest needed remote ack
    maj_rtt = sorted_rtt[:, n // 2]
    p_slow = 1.0 - (1.0 - cfg.epaxos_conflict_rate) ** min(cfg.batch_epaxos,
                                                           100)
    slot_ms = fast_rtt + p_slow * maj_rtt
    d_avg = float(np.mean(np.where(np.isfinite(off), off, 0))
                  * n / (n - 1))             # mean off-diagonal one-way
    d_max = np.max(d, axis=1)

    sim_ms = cfg.sim_seconds * 1000.0
    lam = rate_tx_s / n / 1000.0             # req per ms per replica
    batch = cfg.batch_epaxos
    # generate instance streams; lam_i varies over time when the workload
    # table is non-trivial (the exact constant-lam path otherwise)
    events = []                    # (create_ms, commit_ms, origin, count, lam)
    for i in range(n):
        t, nxt = 0.0, 0.0
        while t < sim_ms:
            lam_t = lam if wl_rate is None else lam * float(wl_rate.at(t)[i])
            if wl_rate is not None and lam_t <= 0.0:
                # zero-rate window: no arrivals — resume the stream at the
                # window's end instead of dividing by ~0 past the sim
                t = max(wl_rate.next_change_ms(t), t + cfg.tick_ms)
                continue
            fill_ms = batch / max(lam_t, 1e-9)
            start = max(t, nxt)
            create = start + min(fill_ms, cfg.max_batch_ms / 1
                                 + batch / max(lam_t, 1e-9))
            commit = create + slot_ms[i]
            events.append((create, commit, i,
                           min(batch, lam_t * max(fill_ms, cfg.max_batch_ms)),
                           lam_t))
            nxt = commit                     # sequential instances
            t = create
    events.sort(key=lambda e: e[1])
    exec_prev = 0.0
    lat, wt = [], []
    committed = 0.0
    # phase accounting (analytic twin of harness._phase_breakdown):
    # queue = half the batch fill, consensus = the instance's commit
    # round(s), delivery = the dependency-chain execution wait; EPaxos
    # has no separate dissemination layer (batches ride inside PreAccept)
    phases = {"queue": [], "consensus": [], "delivery": []} \
        if cfg.trace_level != TraceLevel.OFF else None
    for create, commit, i, cnt, lam_t in events:
        e = max(commit + d_max[i], exec_prev + p_slow * d_avg)
        exec_prev = e
        if e < sim_ms:
            committed += cnt
            lat.append(e - create + batch / max(lam_t, 1e-9) / 2)
            wt.append(cnt)
            if phases is not None:
                phases["queue"].append(batch / max(lam_t, 1e-9) / 2)
                phases["consensus"].append(commit - create)
                phases["delivery"].append(e - commit)
    lat, wt = np.array(lat), np.array(wt)
    order = np.argsort(lat) if len(lat) else np.array([], int)
    med = p99 = float("nan")
    if len(lat):
        cum = np.cumsum(wt[order]) / wt.sum()
        med = float(lat[order][np.searchsorted(cum, 0.5)])
        p99 = float(lat[order][min(np.searchsorted(cum, 0.99), len(lat) - 1)])
    nbuck = int(np.ceil(sim_ms / 500.0))
    timeline = np.zeros(nbuck)
    for create, commit, i, cnt, _ in events:
        if commit < sim_ms:
            timeline[int(commit // 500)] += cnt
    out = {"protocol": "epaxos", "rate": rate_tx_s,
           "throughput": committed / (sim_ms / 1000.0),
           "median_ms": med, "p99_ms": p99, "committed": committed,
           "timeline": timeline / 0.5}
    if phases is not None:
        out.update(host_phases(phases, wt))
    if hmon.on(cfg.monitor_level):
        # host twin of the device monitor: the model is correct by
        # construction, so the checks are overdraw-style — more committed
        # than offered would be a phantom commit; events sort by commit
        # time, so a backwards execution order would be a prefix break
        offered = rate_tx_s * sim_ms / 1000.0
        execs = [e[1] for e in events]
        starved = sum(1 for create, commit, _, cnt, _ in events
                      if commit >= sim_ms)
        out["monitor"] = hmon.host_verdict(
            violations={
                "commit_once": int(committed > offered * 1.01 + 1.0),
                "prefix": sum(1 for a, b in zip(execs, execs[1:])
                              if b < a),
            },
            gauges={"starved_batches": int(starved),
                    "instances": len(events)},
            level=cfg.monitor_level)
    return out
