"""The port's own clock (``core/spans.py``), on the CPU (and, where a
card is present, ``async_frac`` on it):

- spans nest: each records its parent and its grid (set, or inherited from
  the parent), and its self time is its length less its children's;
  ``stats`` / ``reset`` keep the per-name counters and the counters added
  with ``count``, in total and per grid; ``spans.reset``,
  ``compile_cache.reset_stats`` and ``experiment.reset_timing_stats``
  each reset their own accounting alone;
- one CPU ``dispatch_sweep`` and its ``collect()`` record the sweep
  engine's spans in order, under one grid id, with the bytes read back and
  the lanes collected, and no device counter (the CPU records no events);
- a grid under fault scenarios lowers them in one ``lower.scenarios``
  span under ``sweep.lower`` and counts its window tables' bytes and its
  lanes; a Sporades grid's rows count its replica-ticks in the
  asynchronous view, the counts behind ``async_frac``, on the plain and
  the reduced path, and ``async_frac`` is the count over the size rounded
  once, on the CPU and on the card (a test marked ``cuda``);
- the device events' replay and boundary counters, with stand-in events:
  a boundary counts only where its earlier grid is in the grid table;
- ``experiment.timing_stats()`` is summed from the spans' lengths;
- under ``torch.profiler`` the spans are the profiler's ranges too, and
  with no profiler no ``record_function`` is entered.

That the rows do not change with the spans is what every parity test of
the sweep engine holds (tests/test_torch_dispatch.py,
tests/test_torch_experiment.py, tests/torch_sim_parity.py's users): their
rows are compared bit for bit with the reference's and with each other.
"""
import time

import numpy as np
import pytest
import torch
from torch.autograd import profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs.smr import SMRConfig
from repro_torch.core import compile_cache, experiment, harness, netsim, spans
from repro_torch.core.experiment import SweepSpec, dispatch_sweep, run_sweep
from repro_torch.scenarios import library as scl

CFG = SMRConfig(sim_seconds=0.05)
SPEC = SweepSpec(rates=(40_000, 120_000), seeds=(0,))
# a view timeout under the WAN's round trips: lanes go asynchronous in a
# 200-tick run, the attacked and crashed ones at other shares
FAULTS_CFG = SMRConfig(sim_seconds=0.2, view_timeout_ms=60.0)
FAULTS_SPEC = SweepSpec(rates=(100_000,), seeds=(3,), scenarios=(
    None, scl.get("paper-ddos", 0.2), scl.get("leader-crash-recover", 0.2)))

DISPATCH = ["lower.scenarios", "sweep.lower", "sweep.arrivals",
            "sweep.tick0", "sweep.enqueue", "sweep.finish", "sweep.dispatch"]
COLLECT = ["collect.wait", "collect.readback", "collect.rows",
           "sweep.collect"]


@pytest.fixture(autouse=True)
def fresh():
    spans.reset()
    yield
    spans.reset()


def _closing_order(monkeypatch):
    """The (name, parent, grid) of every span as it closes, from now."""
    seen = []
    exit_ = spans.span.__exit__

    def record(self, *exc):
        exit_(self, *exc)
        seen.append((self.name, None if self.parent is None
                     else self.parent.name, self.grid))
    monkeypatch.setattr(spans.span, "__exit__", record)
    return seen


def test_nesting_parents_grids_and_self_time(monkeypatch):
    seen = _closing_order(monkeypatch)
    g = spans.new_grid(protocol="p")
    with spans.span("outer", grid=g) as outer:
        with spans.span("inner") as inner:
            time.sleep(0.002)
        with spans.span("inner"):
            pass
        with spans.span("other", grid=g + 1):
            pass
    with spans.span("loose"):
        pass
    assert seen == [("inner", "outer", g), ("inner", "outer", g),
                    ("other", "outer", g + 1), ("outer", None, g),
                    ("loose", None, None)]
    assert inner.ns >= 2_000_000 and outer.ns >= inner.ns
    st = spans.stats()["spans"]
    assert st["inner"]["parent"] == "outer" and st["outer"]["parent"] is None
    children = st["inner"]["total_ns"] + st["other"]["total_ns"]
    assert st["outer"]["self_ns"] == st["outer"]["total_ns"] - children
    assert st["inner"]["count"] == 2
    assert st["inner"]["max_ns"] == inner.ns
    assert st["inner"]["self_ns"] == st["inner"]["total_ns"]
    # the grid table keeps each grid's tags and totals per name
    grids = {x["id"]: x for x in spans.grids()}
    assert grids[g]["tags"] == {"protocol": "p"}
    assert grids[g]["ns"]["outer"] == outer.ns
    assert grids[g]["ns"]["inner"] == st["inner"]["total_ns"]
    assert grids[g + 1]["ns"] == {"other": st["other"]["total_ns"]}


def test_a_span_closes_when_its_block_raises():
    with pytest.raises(ValueError):
        with spans.span("outer"):
            with spans.span("inner"):
                raise ValueError("x")
    st = spans.stats()["spans"]
    assert st["outer"]["count"] == st["inner"]["count"] == 1
    with spans.span("after"):
        pass
    assert spans.stats()["spans"]["after"]["parent"] is None


def test_stats_counters_and_resets():
    g = spans.new_grid()
    with spans.span("a", grid=g):
        spans.count("bytes", 10)
    spans.count("bytes", 5)
    spans.count("lanes", 2, grid=g)
    st = spans.stats()
    assert st["counters"] == {"bytes": 15, "lanes": 2}
    assert st["spans"]["a"]["count"] == 1 and st["grids"] == 1
    assert spans.grids()[0]["counters"] == {"bytes": 10, "lanes": 2}
    # each reset has one owner: the cache's and the walls' leave the spans
    experiment.reset_timing_stats()
    compile_cache.reset_stats()
    assert spans.stats() == st
    assert "spans" not in compile_cache.stats()
    spans.reset()
    assert spans.stats() == {"spans": {}, "counters": {}, "grids": 0}
    assert spans.grids() == []


def test_one_cpu_dispatch_and_collect(monkeypatch):
    seen = _closing_order(monkeypatch)
    pending = dispatch_sweep("mandator-sporades", CFG, SPEC, device="cpu")
    mid = [x for x in seen if not x[0].startswith("tick.")]
    assert [x[0] for x in mid] == DISPATCH
    rows = pending.collect()
    recs = [x for x in seen if not x[0].startswith("tick.")]
    assert [x[0] for x in recs] == DISPATCH + COLLECT
    grid = recs[0][2]
    assert grid is not None and all(x[2] == grid for x in recs)
    parents = {x[0]: x[1] for x in recs}
    assert parents["lower.scenarios"] == "sweep.lower"
    assert all(parents[n] == "sweep.dispatch" for n in DISPATCH[1:-1])
    assert all(parents[n] == "sweep.collect" for n in COLLECT[:-1])
    assert parents["sweep.dispatch"] is None \
        and parents["sweep.collect"] is None
    st = spans.stats()
    ticks = int(CFG.sim_seconds * 1000 / CFG.tick_ms)
    # the CPU runs every tick eagerly, each module in its scope
    for name in ("tick.mandator", "tick.order", "tick.trace"):
        assert st["spans"][name]["count"] == ticks
    tick_recs = [x for x in seen if x[0].startswith("tick.")]
    assert {x[1] for x in tick_recs} == {"sweep.tick0", "sweep.enqueue"}
    assert all(x[2] == grid for x in tick_recs)
    c = st["counters"]
    assert c["collect.lanes"] == SPEC.size == len(rows) == c["lower.lanes"]
    assert c["order.replica_ticks"] == SPEC.size * ticks * CFG.n_replicas
    assert c["order.async_replica_ticks"] == 0
    # per lane: cvc_all [T, 5, 5] and commit_key [T, 5] int32 at least
    assert c["collect.readback_bytes"] >= SPEC.size * ticks * 30 * 4
    assert not any(k.startswith("device.") for k in c)
    g, = spans.grids()
    assert g["id"] == grid and g["counters"] == c and g["prev"] is None
    # a second collect() records nothing more
    pending.collect()
    assert spans.stats()["spans"]["sweep.collect"]["count"] == 1


def test_a_faults_grid_lowers_its_scenarios_in_one_span(monkeypatch):
    seen = _closing_order(monkeypatch)
    rows = dispatch_sweep("mandator-sporades", FAULTS_CFG, FAULTS_SPEC,
                          device="cpu").collect()
    grid = next(x[2] for x in seen if x[0] == "sweep.dispatch")
    assert [x[1:] for x in seen if x[0] == "lower.scenarios"] \
        == [("sweep.lower", grid)]
    env = experiment._lower(FAULTS_CFG, FAULTS_SPEC, torch.device("cpu"),
                            canonical=True)[3]
    want = sum(env[k].nbytes for k in netsim.WINDOW_TABLES)
    # a lane: win_of_tick [T] int32; per window alive [n] and drop [n, n]
    # bool, delay [n, n] and nic [n] float32
    n, windows = FAULTS_CFG.n_replicas, env["alive_tab"].shape[1]
    assert windows == experiment.CANONICAL_MIN_WINDOWS
    assert want == FAULTS_SPEC.size * (
        int(FAULTS_CFG.sim_seconds * 1000) * 4 + windows * 5 * (n + n * n))
    g, = spans.grids()
    assert g["counters"]["lower.window_bytes"] == want
    assert g["counters"]["lower.lanes"] == len(rows) == FAULTS_SPEC.size
    assert g["ns"]["lower.scenarios"] <= g["ns"]["sweep.lower"]


@pytest.mark.parametrize("mesh", (None, 2), ids=("plain", "reduced"))
def test_async_counters_are_the_rows_async_share(mesh):
    kw = ({"device": "cpu"} if mesh is None
          else {"mesh": [torch.device("cpu")] * mesh})
    rows = run_sweep("mandator-sporades", FAULTS_CFG, FAULTS_SPEC, **kw)
    c = spans.stats()["counters"]
    size = int(FAULTS_CFG.sim_seconds * 1000) * FAULTS_CFG.n_replicas
    assert c["order.replica_ticks"] == size * len(rows)
    fracs = [r["async_frac"] for r in rows]
    assert len(set(fracs)) == len(fracs) and min(fracs) > 0
    counts = [round(f * size) for f in fracs]
    assert fracs == [float(np.float32(k) / np.float32(size))
                     for k in counts]
    assert c["order.async_replica_ticks"] == sum(counts)
    assert c["order.async_replica_ticks"] / c["order.replica_ticks"] \
        == pytest.approx(np.mean(fracs), rel=1e-6)
    # no other protocol counts them
    spans.reset()
    run_sweep("mandator-paxos", FAULTS_CFG, FAULTS_SPEC, **kw)
    assert not any(k.startswith("order.") and "replica" in k
                   for k in spans.stats()["counters"])


def test_async_frac_is_the_count_over_the_size_rounded_once():
    is_async = torch.zeros(3, 2000, 5, dtype=torch.bool)
    flat = is_async.view(3, -1)
    gen = torch.Generator().manual_seed(5)
    for lane, k in enumerate((2248, 1917, 0)):
        flat[lane, torch.randperm(10_000, generator=gen)[:k]] = True
    got = harness.async_frac(is_async)
    assert got.dtype == torch.float32
    want = np.float32([2248, 1917, 0]) / np.float32(10_000)
    assert got.numpy().tolist() == want.tolist()
    # the sum times float32(1 / size), as the card's mean computes it, is
    # one place lower for 2 248
    assert np.float32(2248) * np.float32(1 / 10_000) \
        == np.nextafter(want[0], np.float32(0))


@pytest.mark.cuda
def test_async_frac_on_the_card_is_the_count_over_the_size():
    """Every count from 0 to 10 000 of a 2 000-tick, five-replica lane, on
    the card, where ``mean`` reads one place low for many of them (2 248
    among them). Skips without a CUDA device; run it on the card with
    ``python -m pytest --noconftest -k on_the_card`` (tests/conftest.py
    imports the JAX package)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the card's reduction is checked")
    size = 10_000
    counts = torch.arange(size + 1, device="cuda")
    is_async = (torch.arange(size, device="cuda") < counts[:, None]).view(
        size + 1, 2000, 5)
    got = harness.async_frac(is_async).cpu().numpy()
    want = np.arange(size + 1, dtype=np.float32) / np.float32(size)
    assert got.dtype == np.float32
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    assert got[2248] == np.float32(2248) / np.float32(size)


class _Event:
    """A stand-in CUDA event on a made-up clock (ms)."""
    clock = 0.0

    def __init__(self, enable_timing=False):
        self.at = None

    def record(self, stream=None):
        self.at = _Event.clock

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return other.at - self.at


def test_device_events_replays_and_boundaries(monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda i=None: None)
    dev = torch.device("cuda", 0)

    def grid(t0, replay_ms, replays=10):
        gid = spans.new_grid(protocol="p")
        ev = spans.GridEvents(dev, gid)
        ev.replays = replays
        _Event.clock = t0
        ev.record("first_replay")
        _Event.clock = t0 + replay_ms
        ev.record("last_replay")
        ev.record("end")
        return gid, ev

    g1, e1 = grid(0.0, 8.0)
    g2, e2 = grid(20.0, 8.0)            # boundary 8 -> 20: 12 ms
    for e in (e1, e2):
        e.wait()
        e.account()
    c = spans.stats()["counters"]
    assert c["device.replay_ms"] == pytest.approx(16.0)
    assert c["device.replays"] == 20
    assert c["device.boundary_ms"] == pytest.approx(12.0)
    assert c["device.boundaries"] == 1
    by = {g["id"]: g for g in spans.grids()}
    assert by[g1]["prev"] is None and by[g2]["prev"] == g1
    assert by[g2]["counters"]["device.boundary_ms"] == pytest.approx(12.0)
    # after a reset no boundary opens from a grid dispatched before it
    g3, e3 = grid(40.0, 8.0)
    spans.reset()
    g4, e4 = grid(60.0, 8.0)
    e3.account()                        # its grid left the table
    e4.account()
    c = spans.stats()["counters"]
    assert c == {"device.replay_ms": pytest.approx(8.0),
                 "device.replays": 10}
    assert spans.grids()[0]["prev"] is None


@pytest.mark.parametrize("protocol", ("mandator-paxos", "multipaxos",
                                      "mandator"))
def test_tick_scopes_of_each_protocol(protocol):
    run_sweep(protocol, CFG, SweepSpec(rates=(40_000,)), device="cpu")
    st = spans.stats()["spans"]
    ticks = int(CFG.sim_seconds * 1000 / CFG.tick_ms)
    if protocol == "multipaxos":
        assert "tick.mandator" not in st
    else:
        assert st["tick.mandator"]["count"] == ticks
    if protocol == "mandator":
        assert "tick.order" not in st
    else:
        assert st["tick.order"]["count"] == ticks
    assert st["tick.trace"]["count"] == ticks


def test_timing_stats_is_computed_from_the_spans():
    experiment.reset_timing_stats()
    run_sweep("mandator-paxos", CFG, SPEC, device="cpu")
    run_sweep("mandator-paxos", CFG, SPEC, device="cpu")
    run_sweep("multipaxos", CFG, SweepSpec(rates=(20_000,)), device="cpu")
    got = experiment.timing_stats()
    st = spans.stats()["spans"]
    for proto, n in (("mandator-paxos", 2), ("multipaxos", 1)):
        grids = [g for g in spans.grids() if g["tags"]["protocol"] == proto]
        assert len(grids) == n
        want = sum(g["ns"]["sweep.dispatch"] + g["ns"]["sweep.collect"]
                   for g in grids) / 1e9
        assert got[proto]["run_s"] == pytest.approx(want, rel=1e-12)
        assert got[proto]["compile_s"] == 0.0
        assert got[proto]["dispatches"] == n
        assert got[proto]["horizon"] == 256
    total = (st["sweep.dispatch"]["total_ns"]
             + st["sweep.collect"]["total_ns"]) / 1e9
    assert sum(v["run_s"] for v in got.values()) == pytest.approx(total)
    # the walls do not depend on the spans' table: its reset leaves them
    spans.reset()
    assert experiment.timing_stats() == got
    experiment.reset_timing_stats()
    assert experiment.timing_stats() == {}


def test_spans_are_profiler_ranges_only_under_a_profiler(monkeypatch):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run_sweep("mandator-sporades", CFG, SweepSpec(rates=(40_000,)),
                  device="cpu")
    names = {e.name for e in prof.events()}
    assert set(DISPATCH + COLLECT) <= names
    assert {"tick.mandator", "tick.order", "tick.trace"} <= names
    # a tick scope lies inside sweep.tick0 or sweep.enqueue on the
    # profiler's clock
    ranges = {}
    for e in prof.events():
        ranges.setdefault(e.name, []).append((e.time_range.start,
                                              e.time_range.end))
    outer = ranges["sweep.tick0"] + ranges["sweep.enqueue"]
    for s, t in ranges["tick.order"]:
        assert any(a <= s and t <= b for a, b in outer)

    def refuse(*a, **k):
        raise AssertionError("record_function entered with no profiler")
    monkeypatch.setattr(autograd_profiler, "record_function", refuse)
    assert not autograd_profiler._is_profiler_enabled
    rows = run_sweep("mandator-sporades", CFG, SweepSpec(rates=(40_000,)),
                     device="cpu")
    assert len(rows) == 1
    assert spans.stats()["spans"]["sweep.dispatch"]["count"] == 2
    # a grid is tagged as profiled once one of its spans ran under one
    assert [bool(g["tags"].get("profiled")) for g in spans.grids()] \
        == [True, False]


def test_the_capture_is_the_capture_span(monkeypatch):
    """``compile_cache.capture`` times itself with ``sweep.capture``: its
    Program's ``capture_s`` is that span's length (driven here with a
    stand-in for the CUDA graph, which the CPU has not)."""
    class Graph:
        def __init__(self, keep_graph=False):
            pass

        def enable_debug_mode(self):
            pass

        def instantiate(self):
            time.sleep(0.003)

    class Capture:
        def __init__(self, graph):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.cuda, "CUDAGraph", Graph)
    monkeypatch.setattr(torch.cuda, "graph", Capture)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(compile_cache.Program, "kernel_nodes",
                        lambda self: {"kernels": {}})
    carry = {"x": torch.zeros(3)}
    prog = compile_cache.capture(lambda c, x, t: {"x": c["x"] + 1}, carry,
                                 {"in": {}, "out": {}},
                                 torch.zeros((), dtype=torch.int32), "p")
    rec, = spans.stats()["spans"].items()
    assert rec[0] == "sweep.capture" and rec[1]["total_ns"] >= 3_000_000
    assert prog.capture_s == rec[1]["total_ns"] / 1e9
