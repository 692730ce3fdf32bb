"""The metric arithmetic on synthetic inputs: the device timeline's busy
time, gaps and grid gap, the ring kernel's time, the tick's busy time, the
idle share, the ring's bytes and roofline share, the per-layer readers and
the rate over whole grids."""
import pytest

import pb_registry
import pb_roofline
import pb_trace
import plainsim
import run

K = "channel_ring_commit_kernel<8>"


def _timeline():
    # grid k: 2 replays of 50 us busy in 60 us (0-120); marker 130-131;
    # idle to 200 (lowering), a copy 200-210, tick 0 210-260, idle to 300;
    # marker 300-301; grid k+1: 5 replays of 2 rings and one other kernel
    ev = []
    for i in range(2):
        t = 60.0 * i
        ev += [(t, t + 50.0, "other", True)]
    ev += [(200.0, 210.0, "Memcpy HtoD", False), (210.0, 260.0, "t0", True)]
    for i in range(5):
        t = 310.0 + 60.0 * i
        ev += [(t, t + 10.0, K, True), (t + 10.0, t + 40.0, "other", True),
               (t + 40.0, t + 50.0, K, True)]
    return pb_trace.Timeline(ev, [(130.0, 131.0), (300.0, 301.0)], 0.0,
                             600.0)


def test_busy_and_gaps():
    tl = _timeline()
    ev = tl.clipped()
    assert pb_trace.busy_us(ev, 0.0, 600.0) == pytest.approx(410.0)
    assert pb_trace.gaps(ev, 100.0, 310.0) == [(110.0, 200.0),
                                                (260.0, 310.0)]
    # marker to marker, 130 to 301, less the copy and tick 0
    assert pb_trace.gap_us(tl) == pytest.approx(171.0 - 60.0)
    overlapping = [(0.0, 10.0, "a", True), (5.0, 20.0, "b", True)]
    assert pb_trace.busy_us(overlapping, 0.0, 100.0) == pytest.approx(20.0)
    assert pb_trace.gap_us(pb_trace.Timeline(ev, [(1.0, 2.0)], 0.0,
                                             600.0)) is None


def test_ring_tick_and_idle():
    tl = _timeline()
    # the 10 ring launches after the second marker, 10 us each
    assert pb_trace.ring_us(tl) == pytest.approx(10.0)
    assert pb_trace.tick_us(tl, 5) == pytest.approx(50.0)
    assert pb_trace.idle_share(tl) == pytest.approx(1 - 410.0 / 600.0)
    short = pb_trace.Timeline(tl.events[:6], tl.marks, 0.0, 600.0)
    assert pb_trace.ring_us(short) is None


def test_top_ops_and_gaps_named():
    tl = _timeline()
    ops = dict(pb_trace.top_ops(tl))
    assert ops["other"] == pytest.approx(250e-6)
    gaps = dict((n, s) for n, s in reversed(pb_trace.top_gaps(tl)))
    # each gap named by where it starts: the last of grid k's replays,
    # the boundary past the first marker, grid k+1's replays
    assert gaps["grid k: graph replays"] == pytest.approx(90e-6)
    assert gaps["dispatch_sweep of grid k+1: lowering, tick 0, load"] \
        == pytest.approx(50e-6)
    assert gaps["grid k+1: graph replays"] == pytest.approx(10e-6)
    assert len(pb_trace.top_gaps(tl)) <= 10


def test_readers_on_synthetic_obs():
    tl = _timeline()
    obs = {"timeline": tl, "replays": 5,
           "setup_stats": {"captures": 1, "capture_s": 0.25},
           "window_stats": {"replays": 100, "graph_kernel_launches": 49800},
           "ring_bytes": 3.35e4}
    read = {m: pb_registry.reader(m) for m in (
        "grid_gap_ms", "kernels_per_tick", "tick_device_ms", "capture_s",
        "ring_roofline", "device_idle")}
    assert read["grid_gap_ms"](obs) == pytest.approx(0.111)
    assert read["kernels_per_tick"](obs) == pytest.approx(498.0)
    assert read["tick_device_ms"](obs) == pytest.approx(0.05)
    assert read["device_idle"](obs) == pytest.approx(100 * 190.0 / 600.0)
    assert read["capture_s"](obs) == 0.25
    # 3.35e4 bytes at 3.35e12 B/s = 10 ns against 10 us: 0.1%
    assert read["ring_roofline"](obs) == pytest.approx(0.1)
    empty = {"timeline": None, "replays": 5,
             "setup_stats": {"captures": 0, "capture_s": 0.0},
             "window_stats": {"replays": 0, "graph_kernel_launches": 0},
             "ring_bytes": None}
    assert all(r(empty) is None for r in read.values())


def test_roofline_and_ring_bytes():
    assert pb_roofline.roofline_pct(3.35e9, 1.0) == pytest.approx(0.1)
    cell = pb_registry.cell(pb_registry.load_benchmark(), "paxos.fig6")
    dep = plainsim.deployment(cell.config)
    n = 5
    # mandator: K = 3 + 2 = 5 fields; paxos: K = 9 + 2 = 11 fields
    mandator = (n * n * 5 * 4 + (n * 2 * 4 + n * n * 5)
                + (n * 1 * 4 + n * n * 5) + 5 * n * n * 8)
    paxos = (n * n * 11 * 4 + (n * 8 * 4 + n * n * 5)
             + (n * 1 * 4 + n * n * 5) + 11 * n * n * 8)
    assert plainsim.ring_bytes("mandator-paxos", dep, 64) == pytest.approx(
        64 * (mandator + paxos) / 2)


def test_rate_is_over_whole_grids():
    class G:
        def __init__(self, lanes):
            self.lanes = lanes
    # every collected grid's lanes x ticks over the window's wall time
    assert run.lane_ticks_per_s([G(64)] * 3, 10_000, 30.0) \
        == pytest.approx(64_000.0)
    assert run.lane_ticks_per_s([G(80), G(40)], 2_000, 4.0) \
        == pytest.approx(60_000.0)
