"""The port's own spans and counters, as a run of the benchmark reads them.

The port times itself in ``repro_torch/core/spans.py``: named host spans
of its sweep engine (``sweep.*``, ``collect.*``), the tick's per-module
scopes (``tick.*``), byte and lane counters, and CUDA events at each
grid's boundaries on the card (``device.*`` counters), each kept per grid
in the module's grid table (``spans.grids()``). The window's grids
(``window_grids``) are those of the table that were collected, captured
no program and ran no span under a profiler: in a run of the benchmark,
every grid but the warm one (it captures) and the traced boundary's two.
A port without spans (an older checkout) has no such module: every
reader here then reads nothing and returns None.

While a ``torch.profiler`` runs, each span also opens
``record_function(name)``: the profiler then holds the spans on the host
(CPU user annotations) beside the kernels. ``host_spans``,
``scope_kernels`` and ``named_gaps`` read a stopped profiler's events: the
device work each tick scope launched (matched through the CUDA
correlation id of its launching runtime call), and the idle gaps of a
``pb_trace.Timeline`` named by the innermost span open on the host when
each began. The profiler also gives each span a device-side range, but
that runs from the span's first kernel to its last, host launch gaps
included, so the busy time comes from the matched kernels instead.
"""
from __future__ import annotations

import statistics
from typing import Dict, List, Optional, Sequence, Tuple

import pb_trace

PREFIXES = ("sweep.", "collect.", "tick.")
TICK_SCOPES = ("tick.mandator", "tick.order", "tick.closed", "tick.monitor",
               "tick.trace")

Span = Tuple[float, float, str]         # (start_us, end_us, name)


def steady(g: Dict) -> bool:
    """A grid of the window: collected, no capture, nothing profiled."""
    return "sweep.collect" in g["ns"] and "sweep.capture" not in g["ns"] \
        and not g["tags"].get("profiled")


def window_grids(obs: Dict) -> Optional[List[Dict]]:
    """The window's grids, oldest first: ``obs["window_grids"]`` where the
    harness passes them, else the port's grid table less the grids that
    are not ``steady``; None where the port has no spans."""
    got = obs.get("window_grids")
    if got is not None:
        return got
    try:
        from repro_torch.core import spans
    except ImportError:
        return None
    return [g for g in spans.grids() if steady(g)]


def _sum(grids: List[Dict], name: str) -> float:
    return sum(g["counters"].get(name, 0) for g in grids)


def ratio(obs: Dict, total: str, count: str,
          scale: float = 1.0) -> Optional[float]:
    """The window's counter ``total`` over its counter ``count``, summed
    over its grids, times ``scale``; None where the count is 0."""
    grids = window_grids(obs)
    if not grids or not _sum(grids, count):
        return None
    return _sum(grids, total) / _sum(grids, count) * scale


def inner(grids: List[Dict]) -> List[Dict]:
    """The grids of ``grids`` whose boundary opens from one of them: the
    window's boundaries, the one from the warm grid left out."""
    ids = {g["id"] for g in grids}
    return [g for g in grids if g["prev"] in ids
            and g["counters"].get("device.boundaries")]


def boundary_ms(obs: Dict) -> Optional[float]:
    """The mean of ``device.boundary_ms`` over the window's boundaries
    whose earlier grid is the window's too."""
    inner_grids = inner(window_grids(obs) or [])
    if not inner_grids:
        return None
    return _sum(inner_grids, "device.boundary_ms") \
        / _sum(inner_grids, "device.boundaries")


def span_median_ms(obs: Dict, name: str) -> Optional[float]:
    """The lower median over the window's grids of each grid's total of
    the spans ``name``, in ms."""
    per = [g["ns"][name] for g in window_grids(obs) or () if name in g["ns"]]
    return statistics.median_low(per) / 1e6 if per else None


def summary(grids: List[Dict], parents: Dict[str, Optional[str]]
            ) -> Dict[str, Dict[str, float]]:
    """Per span name over ``grids``: the grids that ran it, and its total
    and self ms a grid (self: less its children's, ``parents`` naming
    each span's parent as ``spans.stats()`` does)."""
    g = max(len(grids), 1)
    total: Dict[str, float] = {}
    seen: Dict[str, int] = {}
    for x in grids:
        for k, ns in x["ns"].items():
            total[k] = total.get(k, 0) + ns
            seen[k] = seen.get(k, 0) + 1
    own = dict(total)
    for k, ns in total.items():
        p = parents.get(k)
        if p in own:
            own[p] -= ns
    return {k: {"grids": seen[k], "total_ms_per_grid": total[k] / 1e6 / g,
                "self_ms_per_grid": own[k] / 1e6 / g}
            for k in sorted(total)}


def _cuda(e) -> bool:
    from torch.autograd import DeviceType
    return e.device_type == DeviceType.CUDA


def host_spans(events: Sequence) -> List[Span]:
    """The port's spans as the profiler saw them on the host, in time
    order."""
    return sorted((float(e.time_range.start), float(e.time_range.end),
                   e.name) for e in events
                  if not _cuda(e) and e.name.startswith(PREFIXES))


def scope_kernels(events: Sequence, name: str
                  ) -> List[pb_trace.Interval]:
    """The device intervals launched inside the host spans ``name``: each
    device kernel or copy whose launching runtime call (a CPU event of
    the CUDA runtime or driver, sharing its correlation id) lies inside
    one, markers and user annotations left out."""
    ranges = [(s, e) for s, e, n in host_spans(events) if n == name]
    if not ranges:
        return []
    device: Dict[int, list] = {}
    for e in events:
        if _cuda(e) and not getattr(e, "is_user_annotation", False) \
                and pb_trace.MARK_KERNEL not in e.name:
            device.setdefault(e.id, []).append(e)
    out = []
    for e in events:
        if _cuda(e) or not e.name.startswith("cu") or e.id not in device:
            continue
        t = float(e.time_range.start)
        if any(s <= t <= f for s, f in ranges):
            for d in device[e.id]:
                tr = d.time_range
                out.append((float(tr.start), float(tr.end), d.name,
                            not d.name.startswith(("Memcpy", "Memset"))))
    return sorted(out)


def scope_split(events: Sequence,
                scopes: Sequence[str] = TICK_SCOPES) -> Dict[str, Dict]:
    """Per scope with device work: its busy ms (the union of its
    intervals), kernels and copies."""
    out = {}
    for name in scopes:
        ev = scope_kernels(events, name)
        if ev:
            out[name] = {
                "busy_ms": pb_trace.busy_us(ev, ev[0][0],
                                            max(e for _, e, _, _ in ev))
                / 1e3,
                "kernels": sum(1 for x in ev if x[3]),
                "copies": sum(1 for x in ev if not x[3])}
    return out


def innermost(host: Sequence[Span], t: float) -> Optional[str]:
    """The innermost span open at ``t``: the latest-starting one that
    holds it."""
    best = None
    for s, e, name in host:
        if s > t:
            break
        if e >= t and (best is None or s >= best[0]):
            best = (s, name)
    return None if best is None else best[1]


def bucket(tl: pb_trace.Timeline, t: float) -> str:
    """The marker bucket of a gap starting at ``t``, as
    ``pb_trace.top_gaps`` names it."""
    m = [a for a, _ in tl.marks]
    if len(m) > 1 and t >= m[1]:
        return "grid k+1: graph replays"
    if m and t >= m[0]:
        return "dispatch_sweep of grid k+1: lowering, tick 0, load"
    return "grid k: graph replays"


def named_gaps(tl: pb_trace.Timeline, host: Sequence[Span],
               k: int = 10) -> List[List]:
    """The longest idle gaps, [name, seconds], each named ``<marker
    bucket> / <span>`` by the innermost span open on the host when it
    began (the bucket alone where none was)."""
    out = []
    for s, e in pb_trace.gaps(tl.clipped(), tl.lo, tl.hi):
        span = innermost(host, s)
        name = bucket(tl, s) + ("" if span is None else f" / {span}")
        out.append([name, (e - s) / 1e6])
    return sorted(out, key=lambda x: -x[1])[:k]
