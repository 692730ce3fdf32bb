"""Host-side flight-recorder decoding: device trace state -> per-replica
timelines (a copy of ``repro.obs.decode``).

The on-device ring (obs/trace.py) keeps the newest ``cap`` events with the
write pointer free-running, so decoding unwraps modulo the capacity:
with ``ptr <= cap`` the valid entries are ``buf[:ptr]`` in order; past
that the ring holds the last ``cap`` events starting at the oldest slot
``ptr % cap``. Counters and the saturating ``dropped`` count come along
verbatim.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from repro_torch.obs.trace import DEFAULT_SPEC, FIELDS, PHASES, TraceSpec


def decode_ring(ts: Dict, spec: TraceSpec = DEFAULT_SPEC) -> List[Dict]:
    """One layer's trace state of one lane (numpy-able leaves of a result
    row's ``obs``, as ``trace.public_view`` gives them) -> per-replica
    dicts:

      {"events": [{"name", "tick", "args": {a_name: a, b_name: b}}, ...],
       "counts": {event_name: int, ...},
       "dropped": int}

    ``events`` is oldest-to-newest and absent at TraceLevel.COUNTERS.
    """
    counts = np.asarray(ts["counts"])
    n = counts.shape[0]
    out: List[Dict] = []
    buf = np.asarray(ts["buf"]) if "buf" in ts else None
    ptr = np.asarray(ts["ptr"]) if buf is not None else None
    dropped = np.asarray(ts["dropped"]) if buf is not None else None
    ki, ti, ai, bi = (FIELDS.index(f) for f in ("kind", "tick", "a", "b"))
    for i in range(n):
        rep: Dict = {"counts": {name: int(counts[i, k])
                                for k, name in enumerate(spec.names)}}
        if buf is not None:
            cap = buf.shape[1]
            p = int(ptr[i])
            if p <= cap:
                order = buf[i, :p]
            else:
                s = p % cap
                order = np.concatenate([buf[i, s:], buf[i, :s]])
            events = []
            for rec in order:
                kind = int(rec[ki])
                name = spec.names[kind]
                an, bn = spec.args_of(kind)
                events.append({"name": name, "tick": int(rec[ti]),
                               "args": {an: int(rec[ai]),
                                        bn: int(rec[bi])}})
            rep["events"] = events
            rep["dropped"] = int(dropped[i])
        out.append(rep)
    return out


def decode_result(result: Dict,
                  spec: TraceSpec = DEFAULT_SPEC) -> Optional[Dict]:
    """Decode every layer ring of one sweep-point result (the ``obs`` key
    harness.sim_point emits when tracing): {layer: [per-replica dicts]}.
    None when the point was run without tracing."""
    obs = result.get("obs")
    if not obs:
        return None
    return {layer: decode_ring(ts, spec) for layer, ts in obs.items()}


def weighted_quantile(vals, weights, q: float) -> float:
    """Numpy twin of harness._weighted_quantile, for the host-side
    analytic baselines (epaxos/rabia phase accounting)."""
    vals = np.asarray(vals, float)
    weights = np.asarray(weights, float)
    if vals.size == 0 or weights.sum() <= 0:
        return float("nan")
    order = np.argsort(vals)
    v, w = vals[order], weights[order]
    cdf = np.cumsum(w) / w.sum()
    return float(v[min(np.searchsorted(cdf, q, side="left"), len(v) - 1)])


def host_phases(per_phase_ms: Dict[str, np.ndarray],
                weights) -> Dict[str, np.ndarray]:
    """Per-phase med/p99 arrays (obs.PHASES order) from host-side phase
    samples — the analytic models' counterpart of harness._phase_breakdown,
    so ``export.phases_dict`` reads every protocol uniformly."""
    med = [weighted_quantile(per_phase_ms.get(ph, ()), weights, 0.5)
           for ph in PHASES]
    p99 = [weighted_quantile(per_phase_ms.get(ph, ()), weights, 0.99)
           for ph in PHASES]
    return {"phase_med_ms": np.asarray(med),
            "phase_p99_ms": np.asarray(p99)}


def event_summary(decoded: Dict) -> Dict[str, Dict[str, int]]:
    """Cluster-wide event totals per layer: {layer: {event: count}}."""
    out: Dict[str, Dict[str, int]] = {}
    for layer, reps in decoded.items():
        tot: Dict[str, int] = {}
        for rep in reps:
            for name, c in rep["counts"].items():
                if c:
                    tot[name] = tot.get(name, 0) + c
        out[layer] = tot
    return out
