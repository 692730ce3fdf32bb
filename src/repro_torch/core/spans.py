"""The port's own clock: named host spans, the grid each belongs to, and
the device events at a grid's boundaries. Nothing else in the port times
itself.

**Spans.** ``with span(name):`` records a host interval
(``time.perf_counter_ns``), its enclosing span (the parent) and the grid
it belongs to: ``experiment.dispatch_sweep`` opens ``sweep.dispatch``
under a new grid id (``new_grid``) and ``PendingSweep.collect`` opens
``sweep.collect`` under the same id; a span opened inside either inherits
it. Per name, the counters keep the count, the total, the self time (the
total less the children's), the longest interval and the parent's name;
per grid, the grid table keeps the total of each name, the counters added
under it and the grid's tags (``new_grid``, ``tag``; ``profiled`` once one
of its spans ran under a profiler). The counters are always on: a span
costs two clock reads and a few dictionary updates. While a
``torch.profiler`` is active the span also opens
``torch.profiler.record_function(name)``, so that it lies on the
profiler's clock beside the kernels it launched; with no profiler it
makes no call into torch.

The sweep engine's spans (``core/experiment.py``, ``core/harness.py``,
``core/compile_cache.py``)::

    sweep.dispatch      one grid's dispatch_sweep
      sweep.lower       the host's lowering: envs, tables, signature
      sweep.arrivals    the arrival tables and the env on the device
      sweep.tick0       the tick loop's set-up and its eager tick 0
      sweep.capture     a new program's capture (compile_cache.capture)
      sweep.load        the run's state into the program's buffers
      sweep.enqueue     the replays enqueued (on the CPU: ticks 1..n-1)
      sweep.finish      the results copied out and the metrics extracted
    sweep.collect       the same grid's collect()
      collect.wait      the host blocked on the grid's end and its checks
      collect.readback  the results copied to the host
      collect.rows      the rows built

and the tick's per-module scopes (``harness._tick``, ``_loop_tick``),
which run in Python only: at the eager tick 0, in the capture, and at
every tick of an eager loop, never in a replay: ``tick.mandator``,
``tick.order`` (Sporades or Paxos), ``tick.closed``, ``tick.monitor``,
``tick.trace``.

**Counters** (``count``, kept in total and per grid):
``collect.readback_bytes`` (bytes copied to the host) and
``collect.lanes`` (lanes collected), ``order.kernel_calls`` and
``order.chain_calls`` (``sporades.tick`` calls that took the CUDA kernel
or the op chain; Python calls only, as the tick scopes), and on the card
the device counters that ``GridEvents`` adds.

**Device events** (``GridEvents``; unreduced grids on a card). A grid
with replays records CUDA events with timing on its stream:
``first_replay`` after its program's load, ``last_replay`` after its last
replay is enqueued, and ``end`` after its results. The module keeps the
last grid's ``last_replay`` per device. Once ``collect.wait`` has waited
on ``end``, the elapsed times are read without another synchronization
and added to:

* ``device.replay_ms`` / ``device.replays``: ``first_replay`` to
  ``last_replay``, and the replays between;
* ``device.boundary_ms`` / ``device.boundaries``: the previous grid's
  ``last_replay`` to this grid's ``first_replay``: all the device did or
  waited for between two grids' replays, the host's work at the boundary
  included. The grid table keeps the previous grid's id (``prev``).

A boundary counts only when its earlier grid was dispatched since the
last ``reset()``. One host thread drives the engine (``experiment``), so
the module holds no locks.
"""
from __future__ import annotations

import collections
import itertools
import time
from typing import Dict, List, Optional

import torch
from torch.autograd import profiler as _profiler

# grids the grid table keeps, the latest
MAX_GRIDS = 4096

_STACK: List["span"] = []
# name -> [count, total ns, self ns, max ns, the parent's name]
_SPANS: Dict[str, list] = {}
_COUNTERS: Dict[str, float] = {}
_GRIDS: "collections.OrderedDict[int, Dict]" = collections.OrderedDict()
_IDS = itertools.count(1)
# per device index: (grid id, that grid's last_replay event)
_LAST_REPLAY: Dict[int, tuple] = {}


class span:
    """``with span(name) as s:`` records the block as one span of ``name``
    (module docstring); ``grid`` sets its grid, else it inherits its
    parent's. ``s.ns`` holds its length once the block has left."""

    __slots__ = ("name", "grid", "parent", "start_ns", "ns", "child_ns",
                 "_rf")

    def __init__(self, name: str, grid: Optional[int] = None):
        self.name, self.grid = name, grid
        self.ns = self.child_ns = 0
        self._rf = None

    def __enter__(self) -> "span":
        self.parent = _STACK[-1] if _STACK else None
        if self.grid is None and self.parent is not None:
            self.grid = self.parent.grid
        if _profiler._is_profiler_enabled:
            if self.grid is not None:
                tag(self.grid, profiled=True)
            self._rf = _profiler.record_function(self.name)
            self._rf.__enter__()
        _STACK.append(self)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        ns = time.perf_counter_ns() - self.start_ns
        _STACK.pop()
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
            self._rf = None
        self.ns = ns
        parent = self.parent
        if parent is not None:
            parent.child_ns += ns
        c = _SPANS.get(self.name)
        if c is None:
            c = _SPANS[self.name] = [0, 0, 0, 0, None]
        c[0] += 1
        c[1] += ns
        c[2] += ns - self.child_ns
        c[3] = max(c[3], ns)
        c[4] = None if parent is None else parent.name
        if self.grid is not None:
            totals = _grid(self.grid)["ns"]
            totals[self.name] = totals.get(self.name, 0) + ns


def _grid(gid: int) -> Dict:
    g = _GRIDS.get(gid)
    if g is None:
        g = _GRIDS[gid] = {"tags": {}, "ns": {}, "counters": {},
                           "prev": None}
        while len(_GRIDS) > MAX_GRIDS:
            _GRIDS.popitem(last=False)
    return g


def new_grid(**tags) -> int:
    """A new grid id, with ``tags`` (e.g. the protocol) kept beside its
    spans' totals."""
    gid = next(_IDS)
    _grid(gid)["tags"].update(tags)
    return gid


def tag(gid: int, **tags) -> None:
    """Add ``tags`` to grid ``gid``."""
    _grid(gid)["tags"].update(tags)


def grids() -> List[Dict]:
    """The latest ``MAX_GRIDS`` grids since the last reset, oldest first:
    {"id", "tags", "ns": {span name: total ns}, "counters", "prev": the
    grid whose replays precede this grid's boundary, or None}."""
    return [{"id": k, "tags": dict(g["tags"]), "ns": dict(g["ns"]),
             "counters": dict(g["counters"]), "prev": g["prev"]}
            for k, g in _GRIDS.items()]


def count(name: str, n: float, grid: Optional[int] = None) -> None:
    """Add ``n`` to the counter ``name``, in total and for ``grid`` (by
    default the innermost open span's)."""
    _COUNTERS[name] = _COUNTERS.get(name, 0) + n
    if grid is None and _STACK:
        grid = _STACK[-1].grid
    if grid is not None:
        c = _grid(grid)["counters"]
        c[name] = c.get(name, 0) + n


def stats() -> Dict:
    """Everything since the last reset: ``spans`` {name: {"count",
    "total_ns", "self_ns", "max_ns", "parent"}}, ``counters`` {name:
    value} and ``grids`` (grid ids in the table)."""
    return {"spans": {k: {"count": c[0], "total_ns": c[1], "self_ns": c[2],
                          "max_ns": c[3], "parent": c[4]}
                      for k, c in _SPANS.items()},
            "counters": dict(_COUNTERS),
            "grids": len(_GRIDS)}


def reset() -> None:
    """Zero the counters and empty the grid table; a grid dispatched
    before now opens no boundary after it."""
    _SPANS.clear()
    _COUNTERS.clear()
    _GRIDS.clear()
    _LAST_REPLAY.clear()


def _device_index(device: torch.device) -> int:
    return torch.cuda.current_device() if device.index is None \
        else device.index


class GridEvents:
    """One grid's events on its card's current stream (module docstring).
    The sweep engine records them with ``record``, waits with ``wait`` and
    adds the device counters with ``account``."""

    def __init__(self, device: torch.device, grid: int):
        self.index, self.grid = _device_index(device), grid
        self.replays = 0
        self.prev = _LAST_REPLAY.get(self.index)
        self.events: Dict[str, torch.cuda.Event] = {}

    def record(self, name: str) -> None:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(self.index))
        self.events[name] = ev
        if name == "last_replay":
            _LAST_REPLAY[self.index] = (self.grid, ev)

    def wait(self) -> None:
        """Block the host until the grid's ``end`` has run."""
        self.events["end"].synchronize()

    def account(self) -> None:
        """Add the grid's replay and boundary times (after ``wait``)."""
        ev = self.events
        if "last_replay" not in ev or self.grid not in _GRIDS:
            return
        count("device.replay_ms",
              ev["first_replay"].elapsed_time(ev["last_replay"]), self.grid)
        count("device.replays", self.replays, self.grid)
        if self.prev is not None and self.prev[0] in _GRIDS:
            _GRIDS[self.grid]["prev"] = self.prev[0]
            count("device.boundary_ms",
                  self.prev[1].elapsed_time(ev["first_replay"]), self.grid)
            count("device.boundaries", 1, self.grid)
