"""Captured tick programs and their accounting (counterpart of
``repro.core.compile_cache`` and of ``repro.core.experiment._PROGRAMS``).

The reference runs a point's whole tick loop as ONE compiled XLA program
(a ``lax.scan``); compiling it is its cost, and its compile cache makes
that cost once-ever. The port's counterpart is one simulator tick
captured as a CUDA graph: ``harness._scan_body`` runs tick 0 eagerly (the
warm-up), captures the next tick once with ``torch.cuda.graph`` and
replays it for ticks 1 .. n-1. The capture is this module's cost, and the
store below makes it once per process and program:

* ``run`` looks a program up by its key (the harness builds it from the
  protocol, the config's statics, the workload mode and every input's
  shape, dtype and device, so an equal ``experiment.ProgramSignature``
  under an equal config gives an equal key), captures it on a miss, and
  replays it. A hit captures nothing: the run's carry and inputs are
  copied into the program's static buffers, the graph replays, and the
  results are copied out, all in stream order and without a read back
  (``start`` / ``Replays`` enqueue a run a share at a time). A run's own
  tensors are never the program's buffers, so a later run of the same
  program, dispatched before this one's results are read, overwrites
  nothing a caller holds.
* ``stats()`` / ``delta()`` / ``reset_stats()`` count captures, capture
  seconds, hits, replays and eager ticks, the kernel launches the
  replays made (each program's kernel nodes, read once from its graph,
  times its replays; ``graph_kernel_launches`` by kernel), and the kernel
  libraries' build cache (``kernels/_build.py``): libraries loaded as
  built and libraries nvcc compiled. A kernel wrapper's own
  ``launch_count`` moves for the eager warm-up tick and once for the
  capture (a launch recorded into the graph), never for a replay.
  A capture's seconds are its ``sweep.capture`` span and a load is a
  ``sweep.load`` span (``core/spans.py``, the sweep engine's clock, which
  keeps and resets its own counters).

No persistent cache is ported: a CUDA graph holds device pointers of one
process and cannot be saved to disk, so every process captures its
programs anew (a capture takes a fraction of a second; the kernels'
libraries, which can be kept, are kept by ``kernels/_build.py``).

Nothing falls back: a capture that fails, or a replay that raises, raises
to the caller. The eager loop on the card is reachable only through
``harness._eager_on_card()``, for the graph's parity checks.
"""
from __future__ import annotations

import collections
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch

from repro_torch.core import spans
from repro_torch.kernels import _build

# programs kept; the oldest is dropped past this (its graph and buffers
# freed once no pending run holds it): a program holds a copy of its
# carry, rings included
MAX_PROGRAMS = 24

STAT_KEYS = ("captures", "capture_s", "hits", "replays", "graph_runs",
             "eager_runs", "eager_ticks", "graph_kernel_launches",
             "build_hits", "build_misses")


@dataclass(frozen=True, order=True)
class ProgramSignature:
    """The static shape key of one sweep's tick program (the reference's
    ``experiment.ProgramSignature``, with one field more). Two sweeps with
    equal signatures under an equal protocol, config and workload mode
    replay one captured program: zero new captures.

    ``lanes`` is the grid's width: the port runs a grid's points as the
    lanes of one program (the reference pins its program to one lane and
    dispatches the points one by one). ``epoch_slots`` is the width M of
    the closed lanes' epoch stream (0 when no lane samples one), which
    the reference, drawing inside its tick, has no counterpart of."""
    n: int             # replicas
    ticks: int         # loop length (sim_seconds / tick_ms)
    lanes: int         # grid width B
    scen_windows: int  # scenario window-table rows (padded)
    wl_windows: int    # workload window-table rows (padded)
    horizon: int       # channel-ring slots (Dmax)
    trivial: bool      # workload-mode statics
    closed: bool
    epoch_slots: int = 0


class Program:
    """One captured tick: the graph and the static buffers it reads and
    writes (``carry``, ``inputs``: {"in": read-only, "out": written}, and
    the tick counter ``t``)."""

    def __init__(self, graph, carry: Dict, inputs: Dict, t: torch.Tensor,
                 capture_s: float, protocol: str):
        self.graph = graph
        self.carry = carry
        self.inputs = inputs
        self.t = t
        self.capture_s = capture_s
        self.protocol = protocol
        self.replays = 0
        self.nodes = self.kernel_nodes()

    def load(self, carry: Dict, inputs: Dict, t: torch.Tensor) -> None:
        """Copy a run's carry, inputs and counter into the buffers."""
        _copy_tree(self.carry, carry)
        _copy_tree(self.inputs, inputs)
        self.t.copy_(t)

    def replay(self, n: int) -> None:
        """Replay the graph ``n`` times, accounting its kernel launches."""
        for _ in range(n):
            self.graph.replay()
        self.replays += n
        _STATS["replays"] += n
        for name, k in self.nodes["kernels"].items():
            _KERNELS[name] = _KERNELS.get(name, 0) + k * n
            _STATS["graph_kernel_launches"] += k * n

    def unload(self, inputs: Dict, t: torch.Tensor) -> Dict:
        """Copy the written inputs (``inputs["out"]``) and the counter back
        into the run's own tensors; return a copy of the carry."""
        _copy_tree(inputs["out"], self.inputs["out"])
        t.copy_(self.t)
        return _clone_tree(self.carry)

    def kernel_nodes(self) -> Dict[str, int]:
        """The captured graph's kernel nodes by kernel name (the graph's
        own DOT dump)."""
        from repro_torch.distributed import graph_analysis
        return graph_analysis.graph_kernel_nodes(self.graph)


_STORE: "collections.OrderedDict[tuple, Program]" = collections.OrderedDict()
_STATS: Dict[str, float] = dict.fromkeys(STAT_KEYS, 0)
_CAPTURES: Dict[str, int] = {}
_KERNELS: Dict[str, int] = {}


def graph_kernel_launches(match: str = "") -> int:
    """Kernel launches the replays made since the last reset, of the
    kernels whose (mangled) name holds ``match`` (all with "")."""
    return sum(n for name, n in _KERNELS.items() if match in name)


def stats() -> Dict[str, float]:
    """Cumulative process-wide accounting: ``captures`` (programs
    captured), ``capture_s`` (their seconds, warm-up excluded), ``hits``
    (runs that replayed a stored program), ``replays`` (graph launches),
    ``graph_runs`` / ``eager_runs`` (tick loops run as a graph / eagerly,
    the CPU's included), ``eager_ticks`` (ticks run eagerly, each graph
    run's warm-up tick included), ``graph_kernel_launches`` (kernels the
    replays launched), and the kernel libraries' build cache:
    ``build_hits`` (loaded as built) and ``build_misses`` (compiled)."""
    out = dict(_STATS)
    out["build_hits"] = _build.STATS["hits"]
    out["build_misses"] = _build.STATS["misses"]
    return out


def delta(since: Dict[str, float]) -> Dict[str, float]:
    """Stats accumulated since a previous ``stats()`` snapshot."""
    now = stats()
    return {k: type(now[k])(now[k] - since.get(k, 0)) for k in STAT_KEYS}


def reset_stats() -> None:
    """Zero the counters (the stored programs stay)."""
    for k in _STATS:
        _STATS[k] = 0
    _CAPTURES.clear()
    _KERNELS.clear()
    _build.STATS.update(hits=0, misses=0)


def capture_counts() -> Dict[str, int]:
    """Captures per protocol since the last ``reset_stats()``."""
    return dict(_CAPTURES)


def programs() -> int:
    """Programs held in the store."""
    return len(_STORE)


def clear() -> None:
    """Drop every stored program (their graphs and buffers are freed)."""
    _STORE.clear()


def count_eager(ticks: int) -> None:
    """Account one tick loop run eagerly (the CPU's, or the card's through
    ``harness._eager_on_card``)."""
    _STATS["eager_runs"] += 1
    _STATS["eager_ticks"] += ticks


class Replays:
    """One run's replays of a program, enqueued a share at a time: ``step``
    enqueues up to ``n`` more, ``finish`` copies the results out. Between
    ``start`` and ``finish`` the program's buffers hold this run, so runs
    of one program go one after another; runs of distinct programs (one
    per card on the reduced path) may interleave their steps. Everything
    is enqueued in stream order and nothing is read back, so a run's
    results are those of ``run``. Holding it keeps its program (graph and
    buffers) alive, evicted from the store or not."""

    def __init__(self, prog: Program, inputs: Dict, t: torch.Tensor,
                 left: int):
        self.program = prog
        self._inputs, self._t, self.left = inputs, t, left

    def step(self, n: Optional[int] = None) -> bool:
        """Enqueue up to ``n`` replays (all that are left with None);
        True while some are left."""
        k = self.left if n is None else min(n, self.left)
        self.program.replay(k)
        self.left -= k
        return self.left > 0

    def finish(self) -> Dict:
        """Copy the written inputs and ``t`` back into the run's own
        tensors (after the last replay, in stream order); return a copy
        of the final carry."""
        if self.left:
            raise RuntimeError(f"{self.left} replays not enqueued yet")
        return self.program.unload(self._inputs, self._t)


def start(key: tuple, protocol: str,
          tick: Callable[[Dict, Dict, torch.Tensor], Dict], carry: Dict,
          inputs: Dict, t: torch.Tensor, replays: int) -> Replays:
    """Begin a run of ``replays`` ticks of ``tick(carry, inputs, t) ->
    carry`` (which advances ``t`` itself) as replays of one captured
    graph, from this run's ``carry`` (after its eager warm-up tick) and
    ``inputs``: the program is captured on the first run of ``key`` (a
    capture synchronizes), and the run's state is loaded into its buffers
    (enqueued copies; nothing synchronizes). ``inputs``: {"in": tensors
    the tick reads, "out": tensors it writes in place}, leaves may be
    None."""
    prog = _STORE.get(key)
    if prog is None:
        prog = capture(tick, carry, inputs, t, protocol)
        _STORE[key] = prog
        while len(_STORE) > MAX_PROGRAMS:
            _STORE.popitem(last=False)
        _STATS["captures"] += 1
        _STATS["capture_s"] += prog.capture_s
        _CAPTURES[protocol] = _CAPTURES.get(protocol, 0) + 1
    else:
        _STORE.move_to_end(key)
        _STATS["hits"] += 1
    with spans.span("sweep.load"):
        prog.load(carry, inputs, t)
    _STATS["graph_runs"] += 1
    _STATS["eager_ticks"] += 1          # the run's warm-up tick
    return Replays(prog, inputs, t, replays)


def run(key: tuple, protocol: str,
        tick: Callable[[Dict, Dict, torch.Tensor], Dict], carry: Dict,
        inputs: Dict, t: torch.Tensor, replays: int) -> tuple:
    """``start`` a run and enqueue all its replays. Returns (final carry,
    the program); ``inputs["out"]`` and ``t`` hold the run's results."""
    r = start(key, protocol, tick, carry, inputs, t, replays)
    r.step()
    return r.finish(), r.program


# lint: traced-root
def capture(tick: Callable[[Dict, Dict, torch.Tensor], Dict], carry: Dict,
            inputs: Dict, t: torch.Tensor, protocol: str) -> Program:
    """Capture one ``tick`` into a CUDA graph over static copies of
    ``carry``, ``inputs`` and ``t`` (fresh, dense buffers that nothing
    else holds). Each carry leaf the tick returns as a new tensor is
    copied back into its static buffer inside the graph; a leaf updated in
    place (the rings, the batch records) is its own buffer and needs no
    copy. A leaf that is another static leaf, or a view of one, is copied
    out first, so no copy-back reads a buffer already overwritten. The
    capture executes nothing: the buffers hold the run's state until the
    first replay. Its seconds are the ``sweep.capture`` span: from the
    device drained to the graph instantiated and the device drained
    again."""
    static_carry = _clone_tree(carry)
    static_inputs = _clone_tree(inputs)
    static_t = t.clone()
    # the captured graph is kept beside its executable, and debug mode
    # lets it print itself (graph_analysis.graph_kernel_nodes)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    graph.enable_debug_mode()
    torch.cuda.synchronize()
    with spans.span("sweep.capture") as sp:
        with torch.cuda.graph(graph):
            new = tick(static_carry, static_inputs, static_t)
            _copy_back(static_carry, new)
        graph.instantiate()
        torch.cuda.synchronize()
    return Program(graph, static_carry, static_inputs, static_t,
                   sp.ns / 1e9, protocol)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in tree:
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, tree


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _clone_tree(tree):
    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    return None if tree is None else tree.clone()


def _copy_tree(dst, src) -> None:
    """dst's leaves := src's (same structure; None leaves on both)."""
    for path, d in _leaves(dst):
        s = _get(src, path)
        if (d is None) != (s is None):
            raise ValueError(f"carry leaf {'.'.join(path)}: one side is "
                             "None")
        if d is not None and d is not s:
            d.copy_(s)


def _copy_back(static: Dict, new: Dict) -> None:
    """Inside the capture: the static carry := the tick's new carry."""
    paths = dict(_leaves(static))
    if set(paths) != {p for p, _ in _leaves(new)}:
        raise ValueError("the tick changed its carry's structure")
    storages = {x.untyped_storage().data_ptr(): p for p, x in paths.items()
                if x is not None}
    srcs = {}
    for path, x in _leaves(new):
        s = paths[path]
        if (s is None) != (x is None):
            raise ValueError(f"carry leaf {'.'.join(path)}: one side is "
                             "None")
        if x is None or x is s:
            continue
        if x.shape != s.shape or x.dtype != s.dtype:
            raise ValueError(f"carry leaf {'.'.join(path)}: the tick returns "
                             f"{x.dtype} {tuple(x.shape)} for its "
                             f"{s.dtype} {tuple(s.shape)}")
        if x.untyped_storage().data_ptr() in storages:
            x = x.clone()               # another buffer, or a view of one
        srcs[path] = x
    for path, x in srcs.items():
        paths[path].copy_(x)

