"""The device timeline of a traced run, and the arithmetic on it.

A traced run profiles one grid boundary with ``torch.profiler`` in the
window's own schedule (``run.traced_boundary``): grid k's last graph
replays, grid k+1 dispatched before grid k is collected (its host
lowering, its eager tick 0, the load of its captured program), and grid
k+1's first replays. Two marker kernels (``torch.cuda._sleep``, a few
hundred cycles each) go on the stream: one once grid k's dispatch has
returned (everything of grid k is enqueued before it), one just before
grid k+1's first replay. ``Timeline`` holds what the profiler saw on the
device: the kernel and copy intervals ``(start_us, end_us, name,
is_kernel)``, the markers' intervals, and the traced span ``[lo, hi]``
from the first interval's start to the last one's end, all on the
profiler's clock.

The arithmetic:

* busy time: the union of the device intervals inside a span;
* ``gap_us``: the device's idle time from the first marker to the second:
  what of grid k+1's lowering, tick 0 and program load the queue of grid
  k's work did not hide;
* ``tick_us``: the busy time of grid k+1's traced replays (after the
  second marker) over their count;
* ``ring_us``: the channel ring commit kernel's mean time in those
  replays. The profiler adds about a microsecond to each kernel it times
  inside a graph, so both read high for kernels this small;
* ``idle_share``: the share of the traced span in which no device
  interval runs.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

RING_KERNEL = "commit_kernel"       # in csrc/channel_ring.cu's kernel name
MARK_KERNEL = "spin_kernel"         # torch.cuda._sleep's kernel

Interval = Tuple[float, float, str, bool]


@dataclass
class Timeline:
    events: List[Interval]          # device intervals, markers left out
    marks: List[Tuple[float, float]]    # the markers, in time order
    lo: float                       # traced span, microseconds
    hi: float

    def clipped(self) -> List[Interval]:
        out = []
        for s, e, name, k in self.events:
            s, e = max(s, self.lo), min(e, self.hi)
            if e > s:
                out.append((s, e, name, k))
        return sorted(out)


def merged(events: Sequence[Interval]) -> List[Tuple[float, float]]:
    """The union of the intervals, as sorted disjoint (start, end)."""
    out: List[List[float]] = []
    for s, e, *_ in sorted(events):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_us(events: Sequence[Interval], lo: float, hi: float) -> float:
    return sum(min(e, hi) - max(s, lo) for s, e in merged(events)
               if min(e, hi) > max(s, lo))


def gaps(events: Sequence[Interval], lo: float, hi: float
         ) -> List[Tuple[float, float]]:
    """The idle intervals of [lo, hi]."""
    out, at = [], lo
    for s, e in merged(events):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if s > at:
            out.append((at, s))
        at = max(at, e)
    if hi > at:
        out.append((at, hi))
    return out


def gap_us(tl: Timeline) -> Optional[float]:
    """Idle device time from the first marker (grid k all enqueued) to
    the second (grid k+1's first replay next)."""
    if len(tl.marks) < 2:
        return None
    a, b = tl.marks[0][0], tl.marks[1][1]
    return (b - a) - busy_us(tl.events, a, b)


def _replays(tl: Timeline) -> List[Interval]:
    """The intervals after the second marker: grid k+1's replays."""
    if len(tl.marks) < 2:
        return []
    at = tl.marks[1][1]
    return [x for x in tl.clipped() if x[0] >= at]


def tick_us(tl: Timeline, replays: int) -> Optional[float]:
    """Busy time of grid k+1's traced replays over their count."""
    ev = _replays(tl)
    if not ev or replays <= 0:
        return None
    return busy_us(ev, ev[0][0], tl.hi) / replays


def ring_us(tl: Timeline) -> Optional[float]:
    """Mean time of the channel ring's commit kernel in grid k+1's traced
    replays; None with fewer than four launches."""
    rings = [e - s for s, e, name, k in _replays(tl)
             if k and RING_KERNEL in name]
    if len(rings) < 4:
        return None
    return sum(rings) / len(rings)


def idle_share(tl: Timeline) -> Optional[float]:
    """Share of the traced span in which no device interval runs."""
    if tl.hi <= tl.lo:
        return None
    return 1.0 - busy_us(tl.events, tl.lo, tl.hi) / (tl.hi - tl.lo)


def top_ops(tl: Timeline, k: int = 10) -> List[List]:
    """The device operations that took most time: [name, seconds]."""
    tot: Dict[str, float] = {}
    for s, e, name, _ in tl.clipped():
        tot[name] = tot.get(name, 0.0) + (e - s)
    top = sorted(tot.items(), key=lambda x: -x[1])[:k]
    return [[name, us / 1e6] for name, us in top]


def top_gaps(tl: Timeline, k: int = 10) -> List[List]:
    """The longest idle gaps, [name, seconds], each named by what the host
    was doing then: issuing grid k's last replays, dispatching grid k+1
    (lowering, tick 0, the program's load), or issuing its replays."""
    m = [a for a, _ in tl.marks]
    out = []
    for s, e in gaps(tl.clipped(), tl.lo, tl.hi):
        if len(m) > 1 and s >= m[1]:
            name = "grid k+1: graph replays"
        elif m and s >= m[0]:
            name = "dispatch_sweep of grid k+1: lowering, tick 0, load"
        else:
            name = "grid k: graph replays"
        out.append([name, (e - s) / 1e6])
    return sorted(out, key=lambda x: -x[1])[:k]


def from_profiler(prof) -> Optional[Timeline]:
    """A ``Timeline`` from a stopped ``torch.profiler.profile``: every
    device kernel and copy, the markers apart. None where the profiler saw
    no device time."""
    from torch.autograd import DeviceType
    events, marks = [], []
    for e in prof.events():
        if e.device_type != DeviceType.CUDA or getattr(
                e, "is_user_annotation", False):
            continue
        tr = e.time_range
        s, t = float(tr.start), float(tr.end)
        if MARK_KERNEL in e.name:
            marks.append((s, t))
        else:
            kernel = not e.name.startswith(("Memcpy", "Memset"))
            events.append((s, t, e.name, kernel))
    if not events:
        return None
    ends = [x for ev in events for x in ev[:2]] + [x for m in marks
                                                    for x in m]
    return Timeline(events, sorted(marks), min(ends), max(ends))
