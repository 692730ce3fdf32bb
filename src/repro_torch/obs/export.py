"""Chrome/Perfetto ``trace_event`` export of one traced sweep point (a copy
of ``repro.obs.export``).

``chrome_trace`` turns a FULL-level result dict (harness.sim_point via the
experiment engine) into the JSON Object Format that ui.perfetto.dev and
chrome://tracing load directly:

  - one *process* (pid) per replica, named after its region;
  - per replica, one *thread* (tid) per view: the batch-phase track
    (``X`` duration events for dissemination / consensus / delivery of
    every committed batch), the protocol-mode track (``X`` spans covering
    async-mode intervals), and one instant-event (``i``) track per
    protocol layer straight from the decoded flight-recorder ring;
  - a cluster-level process carrying the scenario windows (``X`` spans +
    ``i`` instants) and the committed-throughput counter track (``C``).

Timestamps are microseconds (trace_event's native unit) derived from
simulator ticks via ``cfg.tick_ms``.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from repro_torch.obs import decode as _decode
from repro_torch.obs.trace import DEFAULT_SPEC, PHASES, TraceSpec

# thread ids inside each replica process
TID_PHASES = 0
TID_MODE = 1
_LAYER_TID0 = 2      # layer instant tracks start here, in sorted order

# cluster-process thread ids: 0 = scenario, 1 = committed tx/s counter,
# then the health-monitor gauge counters (repro_torch.obs.monitor)
TID_GAUGE_OCC = 2
TID_GAUGE_DROP = 3

_PH_ALLOWED = {"M", "i", "I", "X", "C"}

# batch_marks_t rows (harness.sim_point): absolute ticks of each boundary
MARKS = ("create", "stable", "commit", "deliver")


def _us(ticks, tick_ms: float) -> float:
    return float(ticks) * tick_ms * 1000.0


def _meta(pid: int, name: str, tid: Optional[int] = None,
          tname: Optional[str] = None) -> List[Dict]:
    ev = [{"ph": "M", "pid": pid, "tid": 0, "name": "process_name",
           "args": {"name": name}}]
    if tid is not None:
        ev = [{"ph": "M", "pid": pid, "tid": tid, "name": "thread_name",
               "args": {"name": tname}}]
    return ev


def chrome_trace(result: Dict, cfg, protocol: str, scenario=None,
                 regions: Optional[List[str]] = None,
                 spec: TraceSpec = DEFAULT_SPEC,
                 max_batches: int = 4096) -> Dict:
    """Build the trace_event JSON dict for one FULL-level sweep point.
    ``scenario`` (a repro_torch.scenarios.Scenario or None) contributes the
    adversity windows; ``max_batches`` bounds the per-origin batch-span
    count (newest kept) so hot sweeps stay loadable."""
    if "obs" not in result:
        raise ValueError(
            "result has no flight-recorder data; run with "
            "SMRConfig(trace_level='full')")
    if regions is None:
        from repro_torch.configs.smr import REGIONS
        regions = list(REGIONS)
    decoded = _decode.decode_result(result, spec)
    layers = sorted(decoded)
    tick_ms = cfg.tick_ms
    n = np.asarray(result["obs"][layers[0]]["counts"]).shape[0]
    ev: List[Dict] = []

    for i in range(n):
        name = regions[i] if i < len(regions) else f"replica-{i}"
        ev += _meta(i, f"replica {i} ({name})")
        ev += _meta(i, "", TID_PHASES, "batch phases")
        ev += _meta(i, "", TID_MODE, f"{protocol} mode")
        for li, layer in enumerate(layers):
            ev += _meta(i, "", _LAYER_TID0 + li, f"{layer} events")

    # ---- batch phase spans (X) from the commit-boundary marks ----------
    marks = result.get("batch_marks_t")
    if marks is not None:
        marks = np.asarray(marks)                       # [4, n, R]
        count = np.asarray(result.get("batch_n"))       # [n, R]
        spans = (("dissemination", 0, 1), ("consensus", 1, 2),
                 ("delivery", 2, 3))
        for i in range(n):
            ok = np.isfinite(marks[:, i, :]).all(axis=0) & (count[i] > 0)
            rounds = np.nonzero(ok)[0][-max_batches:]
            for r in rounds:
                for pname, j0, j1 in spans:
                    t0, t1 = marks[j0, i, r], marks[j1, i, r]
                    ev.append({
                        "ph": "X", "pid": i, "tid": TID_PHASES,
                        "name": pname, "cat": "batch",
                        "ts": _us(t0, tick_ms),
                        "dur": max(_us(t1 - t0, tick_ms), 0.0),
                        "args": {"round": int(r),
                                 "requests": int(count[i, r])}})

    # ---- per-layer instant events + async-mode spans from the rings ----
    # timeline buckets are 500ms (harness._batch_metrics) -> sim length
    sim_us = (np.asarray(result["timeline"]).shape[0] * 500e3
              if "timeline" in result else None)
    for li, layer in enumerate(layers):
        for i, rep in enumerate(decoded[layer]):
            open_async: Optional[float] = None
            for e in rep.get("events", ()):
                ts = _us(e["tick"], tick_ms)
                ev.append({"ph": "i", "pid": i, "tid": _LAYER_TID0 + li,
                           "name": e["name"], "cat": layer, "ts": ts,
                           "s": "t", "args": dict(e["args"])})
                if e["name"] == "mode_switch":
                    if e["args"].get("is_async"):
                        open_async = ts
                    elif open_async is not None:
                        ev.append({"ph": "X", "pid": i, "tid": TID_MODE,
                                   "name": "async mode", "cat": layer,
                                   "ts": open_async,
                                   "dur": max(ts - open_async, 0.0),
                                   "args": {}})
                        open_async = None
            if open_async is not None and sim_us is not None:
                ev.append({"ph": "X", "pid": i, "tid": TID_MODE,
                           "name": "async mode", "cat": layer,
                           "ts": open_async,
                           "dur": max(sim_us - open_async, 0.0),
                           "args": {}})

    # ---- cluster process: scenario windows + throughput counter --------
    pid_c = n
    ev += _meta(pid_c, "cluster")
    ev += _meta(pid_c, "", 0, "scenario")
    ev += _meta(pid_c, "", 1, "committed tx/s")
    if scenario is not None:
        for s in getattr(scenario, "events", ()):
            start = getattr(s, "start_s", getattr(s, "at_s", 0.0))
            end = getattr(s, "end_s", float("inf"))
            ts = start * 1e6
            kind = type(s).__name__
            ev.append({"ph": "i", "pid": pid_c, "tid": 0, "name": kind,
                       "cat": "scenario", "ts": ts, "s": "p",
                       "args": {"start_s": start}})
            if np.isfinite(end):
                ev.append({"ph": "X", "pid": pid_c, "tid": 0, "name": kind,
                           "cat": "scenario", "ts": ts,
                           "dur": max((end - start) * 1e6, 0.0), "args": {}})
    if "timeline" in result:
        tl = np.asarray(result["timeline"])
        for b, v in enumerate(tl):
            ev.append({"ph": "C", "pid": pid_c, "tid": 1,
                       "name": "committed tx/s", "ts": b * 500e3,
                       "args": {"tx_s": float(v)}})

    # ---- health-monitor resource gauges as counter tracks --------------
    # (repro_torch.obs.monitor; present when the point ran with monitor_level
    # != "off" — same 500ms buckets as the throughput counter)
    mon = result.get("mon")
    if mon is not None:
        ev += _meta(pid_c, "", TID_GAUGE_OCC, "ring occupancy")
        ev += _meta(pid_c, "", TID_GAUGE_DROP, "dropped sends/s")
        occ = np.asarray(mon["occ_tl"])
        drp = np.asarray(mon["drop_tl"])
        for b in range(occ.shape[0]):
            ev.append({"ph": "C", "pid": pid_c, "tid": TID_GAUGE_OCC,
                       "name": "ring occupancy", "ts": b * 500e3,
                       "args": {"occupancy": float(occ[b])}})
            ev.append({"ph": "C", "pid": pid_c, "tid": TID_GAUGE_DROP,
                       "name": "dropped sends/s", "ts": b * 500e3,
                       "args": {"sends_s": float(drp[b]) / 0.5}})

    return {"displayTimeUnit": "ms", "traceEvents": ev,
            "otherData": {"protocol": protocol,
                          "scenario": getattr(scenario, "name", "baseline"),
                          "tick_ms": tick_ms}}


def validate(trace: Dict) -> None:
    """Structural trace_event-schema check (what chrome://tracing and
    Perfetto require to load): raises ValueError on the first violation."""
    if trace.get("displayTimeUnit") not in ("ms", "ns"):
        raise ValueError("missing/invalid displayTimeUnit")
    evs = trace.get("traceEvents")
    if not isinstance(evs, list) or not evs:
        raise ValueError("traceEvents must be a non-empty list")
    for k, e in enumerate(evs):
        ph = e.get("ph")
        if ph not in _PH_ALLOWED:
            raise ValueError(f"event {k}: unsupported ph {ph!r}")
        for f in ("pid", "tid"):
            if not isinstance(e.get(f), int):
                raise ValueError(f"event {k}: {f} must be an int")
        if not isinstance(e.get("name"), str):
            raise ValueError(f"event {k}: missing name")
        if ph != "M":
            if not isinstance(e.get("ts"), (int, float)):
                raise ValueError(f"event {k}: missing ts")
            if e["ts"] < 0:
                raise ValueError(f"event {k}: negative ts")
        if ph == "X":
            if not isinstance(e.get("dur"), (int, float)) or e["dur"] < 0:
                raise ValueError(f"event {k}: X event needs dur >= 0")
        if ph == "C":
            # counter tracks must carry at least one finite numeric series
            # value (Perfetto drops NaN/non-numeric counter samples)
            a = e.get("args")
            if not isinstance(a, dict) or not a:
                raise ValueError(f"event {k}: C event needs args")
            for ak, av in a.items():
                if not isinstance(av, (int, float)) or not np.isfinite(av):
                    raise ValueError(
                        f"event {k}: C arg {ak!r} must be finite numeric")


def write(path, trace: Dict) -> Path:
    """Validate + write the trace JSON; returns the path."""
    validate(trace)
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(json.dumps(trace))
    return p


def phases_dict(result: Dict) -> Optional[Dict]:
    """The phase-breakdown quantiles of one result as a JSON-able dict:
    {phase: {"med_ms", "p99_ms"}} (None when the point was untraced)."""
    if "phase_med_ms" not in result:
        return None
    med = np.asarray(result["phase_med_ms"])
    p99 = np.asarray(result["phase_p99_ms"])
    fin = lambda x: float(x) if np.isfinite(x) else None  # noqa: E731
    return {ph: {"med_ms": fin(med[j]), "p99_ms": fin(p99[j])}
            for j, ph in enumerate(PHASES)}


def phase_table(result: Dict, regions: Optional[List[str]] = None) -> str:
    """Human-readable per-phase latency breakdown of one traced point:
    the cluster-wide quantiles plus the per-origin medians."""
    if "phase_med_ms" not in result:
        return "(no phase breakdown: run with trace_level != 'off')"
    med = np.asarray(result["phase_med_ms"])
    p99 = np.asarray(result["phase_p99_ms"])
    omed = np.asarray(result["phase_origin_med_ms"])    # [4, n]
    if regions is None:
        from repro_torch.configs.smr import REGIONS
        regions = list(REGIONS)
    fmt = lambda x: f"{x:8.1f}" if np.isfinite(x) else "       -"  # noqa
    lines = [f" {'phase':16s} {'median':>8s} {'p99':>8s}   (ms)"]
    for j, ph in enumerate(PHASES):
        lines.append(f" {ph:16s} {fmt(med[j])} {fmt(p99[j])}")
    e2e_med, e2e_p99 = result.get("median_ms"), result.get("p99_ms")
    if e2e_med is not None:
        lines.append(f" {'end-to-end':16s} {fmt(e2e_med)} {fmt(e2e_p99)}")
    n = omed.shape[1]
    hdr = " ".join(f"{ph[:7]:>8s}" for ph in PHASES)
    lines.append(f"\n per-origin medians (ms):\n {'origin':10s} {hdr}")
    for i in range(n):
        name = regions[i] if i < len(regions) else f"r{i}"
        cells = " ".join(fmt(omed[j, i]) for j in range(len(PHASES)))
        lines.append(f" {name[:10]:10s} {cells}")
    return "\n".join(lines)
