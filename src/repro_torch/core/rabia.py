"""Rabia baseline — analytic model, a copy of ``repro.core.rabia`` (host
numpy; no device work).

Rabia (SOSP'21) commits a slot only when a majority of replicas propose the
*same* head-of-queue batch; in a LAN that holds (synchronized arrival), in
the WAN it requires the oldest uncommitted batch to have propagated to a
majority before the slot starts — and each weak-MVC slot costs ~2.5 majority
RTTs. We simulate slot-by-slot over the real batch streams:

- batches form per replica at min(arrival, CPU) into batches of 300;
- slot s (duration 2.5 x median majority RTT) commits the globally oldest
  uncommitted batch iff it is known to >= majority replicas at slot start
  (creation + one-way delay), else the slot is a NULL round (Ben-Or coin
  retry) — reproducing the ~500 tx/s WAN collapse of Fig. 6.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from repro_torch.configs.smr import SMRConfig
from repro_torch.obs import monitor as hmon
from repro_torch.obs.decode import host_phases
from repro_torch.obs.trace import HostTrace, TraceLevel
from repro_torch.workloads.analytic import (
    TableRate,
    closed_equilibrium_rate,
    host_rate,
)


def run_rabia_model(cfg: SMRConfig, rate_tx_s: float, scenario=None,
                    workload=None) -> Dict:
    """``workload``: a ``workloads.Workload`` (or None). Open-loop shapes
    make the batch streams time-varying through the compiled rate table;
    closed-loop pools are approximated at their Little's-law equilibrium
    (measure latency open, re-run at the sustainable rate)."""
    wl_rate, closed = host_rate(cfg, workload)
    if closed is not None:
        first = _rabia_once(cfg, rate_tx_s, wl_rate)
        rate_eff = closed_equilibrium_rate(rate_tx_s, closed,
                                           first["median_ms"],
                                           cfg.n_replicas)
        out = _rabia_once(cfg, rate_eff, wl_rate)
        out["rate"] = rate_tx_s
        return out
    return _rabia_once(cfg, rate_tx_s, wl_rate)


def _rabia_once(cfg: SMRConfig, rate_tx_s: float,
                wl_rate: Optional[TableRate] = None) -> Dict:
    n = cfg.n_replicas
    d = cfg.delays_ms()
    maj = n // 2 + 1
    maj_rtt = np.median(np.sort(2 * d, axis=1)[:, maj - 1])
    slot_ms = 2.5 * maj_rtt
    # propagation time of a batch from origin i to a majority
    prop_ms = np.sort(d, axis=1)[:, maj - 1]

    sim_ms = cfg.sim_seconds * 1000.0
    lam = rate_tx_s / n / 1000.0
    batch = cfg.batch_rabia
    streams = []
    for i in range(n):
        t = 0.0
        while t < sim_ms:
            lam_t = lam if wl_rate is None else lam * float(wl_rate.at(t)[i])
            if wl_rate is not None and lam_t <= 0.0:
                # zero-rate window: no arrivals — resume the stream at the
                # window's end instead of dividing by ~0 past the sim
                t = max(wl_rate.next_change_ms(t), t + cfg.tick_ms)
                continue
            fill = max(batch / max(lam_t, 1e-9), cfg.max_batch_ms)
            t += fill
            streams.append((t, i, min(batch, lam_t * fill)))
    streams.sort()
    committed = 0.0
    lat, wt = [], []
    nbuck = int(np.ceil(sim_ms / 500.0))
    timeline = np.zeros(nbuck)
    # flight recorder (host-side twin of repro.obs): one commit event per
    # committed slot, one view_change per NULL (Ben-Or coin) round
    tr = None if cfg.trace_level == TraceLevel.OFF else HostTrace()
    # phase accounting (analytic twin of harness._phase_breakdown):
    # dissemination = propagation to a majority, consensus = the slot
    # wait + 2.5-RTT weak-MVC rounds (the remainder of the latency)
    phases = {"dissemination": [], "consensus": []} if tr is not None \
        else None
    ptr = 0
    slot_idx = 0
    null_slots = 0
    commit_ts = []
    t_slot = slot_ms
    while t_slot < sim_ms and ptr < len(streams):
        create, origin, cnt = streams[ptr]
        if create + prop_ms[origin] <= t_slot:   # majority knows the head
            t_end = t_slot + slot_ms
            if t_end < sim_ms:
                committed += cnt
                commit_ts.append(t_end)
                lat.append(t_end - create)
                wt.append(cnt)
                timeline[int(t_end // 500)] += cnt
                if tr is not None:
                    tr.record("commit", t_end / cfg.tick_ms, who=origin,
                              key=slot_idx, total=cnt)
                    diss = min(prop_ms[origin], t_end - create)
                    phases["dissemination"].append(diss)
                    phases["consensus"].append(t_end - create - diss)
            ptr += 1
        else:
            # NULL slot (coin round commits nothing)
            null_slots += 1
            if tr is not None:
                tr.record("view_change", t_slot / cfg.tick_ms,
                          view=slot_idx, round=0)
        t_slot += slot_ms
        slot_idx += 1
    lat, wt = np.array(lat), np.array(wt)
    med = p99 = float("nan")
    if len(lat):
        order = np.argsort(lat)
        cum = np.cumsum(wt[order]) / wt.sum()
        med = float(lat[order][np.searchsorted(cum, 0.5)])
        p99 = float(lat[order][min(np.searchsorted(cum, 0.99), len(lat) - 1)])
    out = {"protocol": "rabia", "rate": rate_tx_s,
           "throughput": committed / (sim_ms / 1000.0),
           "median_ms": med, "p99_ms": p99, "committed": committed,
           "timeline": timeline / 0.5}
    if tr is not None:
        out["host_trace"] = {
            "counts": tr.counts(),
            "events": tr.events if cfg.trace_level == TraceLevel.FULL
            else []}
        out.update(host_phases(phases, wt))
    if hmon.on(cfg.monitor_level):
        # host twin of the device monitor: slots commit one batch each in
        # strictly increasing slot time (a backwards commit would break
        # prefix order), never more than was offered; NULL-round fraction
        # is THE Rabia starvation gauge (the WAN-collapse mechanism)
        offered = rate_tx_s * sim_ms / 1000.0
        out["monitor"] = hmon.host_verdict(
            violations={
                "commit_once": int(committed > offered * 1.01 + 1.0),
                "prefix": sum(1 for a, b in zip(commit_ts, commit_ts[1:])
                              if b <= a),
            },
            gauges={"null_slots": int(null_slots),
                    "null_frac": round(null_slots / max(slot_idx, 1), 4),
                    "backlog": int(len(streams) - ptr)},
            level=cfg.monitor_level)
    return out
