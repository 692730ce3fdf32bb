"""The readers of the port's own spans and counters (``pb_spans``,
``metrics/{replay_tick_ms,boundary_device_ms,tick0_host_ms,
readback_kib_per_lane}.py``) on synthetic grids and on a tiny run of a
cell on the CPU; the profiler-side helpers (the device work
a tick scope launched, gaps named by the span open on the host) on
synthetic profiler events."""
from types import SimpleNamespace

import sys

import pytest
import torch
from torch.autograd import DeviceType

import pb_registry
import pb_spans
import pb_trace
import run
from test_perfbench_faults import tiny_cell

NEW = ("replay_tick_ms", "boundary_device_ms", "tick0_host_ms",
       "readback_kib_per_lane")


def _grid(gid, prev, tick0_ms, boundary_ms=None, capture=False,
          profiled=False):
    c = {"device.replay_ms": 8290.0, "device.replays": 9999,
         "collect.readback_bytes": 64 * 1_228_800, "collect.lanes": 64}
    if boundary_ms is not None:
        c.update({"device.boundary_ms": boundary_ms,
                  "device.boundaries": 1})
    ns = {"sweep.dispatch": 9e9, "sweep.tick0": tick0_ms * 1e6,
          "sweep.collect": 5e8}
    if capture:
        ns["sweep.capture"] = 5e7
    return {"id": gid, "tags": {"profiled": profiled}, "ns": ns,
            "counters": c, "prev": prev}


def _grids():
    # the warm grid (captures), the window's three (the second's tick 0
    # waited on the launch queue), the traced boundary's two (profiled)
    return [_grid(1, None, 30.0, capture=True),
            _grid(2, 1, 9.6, boundary_ms=900.0),
            _grid(3, 2, 441.5, boundary_ms=4.5),
            _grid(4, 3, 16.1, boundary_ms=38.5),
            _grid(5, 4, 12.0, boundary_ms=77.0, profiled=True),
            _grid(6, 5, 12.0, boundary_ms=77.0, profiled=True)]


def test_readers_on_synthetic_grids():
    read = {m: pb_registry.reader(m) for m in NEW}
    window = [g for g in _grids() if pb_spans.steady(g)]
    assert [g["id"] for g in window] == [2, 3, 4]
    obs = {"window_grids": window}
    assert read["replay_tick_ms"](obs) == pytest.approx(8290.0 / 9999)
    # the boundary from the warm grid is not the window's
    assert read["boundary_device_ms"](obs) == pytest.approx(21.5)
    # the lower median, not the mean (155.7)
    assert read["tick0_host_ms"](obs) == pytest.approx(16.1)
    assert read["tick0_host_ms"]({"window_grids": window[:2]}) \
        == pytest.approx(9.6)
    assert read["readback_kib_per_lane"](obs) == pytest.approx(1200.0)


def test_readers_read_the_ports_grid_table(monkeypatch):
    from repro_torch.core import spans
    monkeypatch.setattr(spans, "grids", _grids)
    read = {m: pb_registry.reader(m) for m in NEW}
    assert read["boundary_device_ms"]({}) == pytest.approx(21.5)
    assert read["tick0_host_ms"]({}) == pytest.approx(16.1)


def test_readers_read_nothing_from_a_port_without_spans(monkeypatch):
    read = {m: pb_registry.reader(m) for m in NEW}
    import repro_torch.core
    monkeypatch.delattr(repro_torch.core, "spans", raising=False)
    monkeypatch.setitem(sys.modules, "repro_torch.core.spans", None)
    parent = {"window_stats": {"replays": 10, "graph_kernel_launches": 4980},
              "timeline": None}
    assert all(r(parent) is None for r in read.values())
    cpu = {"window_grids": [{"id": 1, "tags": {}, "ns": {}, "prev": None,
                             "counters": {"collect.readback_bytes": 0,
                                          "collect.lanes": 0}}]}
    assert all(r(cpu) is None for r in read.values())
    assert all(r({"window_grids": []}) is None for r in read.values())


def test_every_new_metric_is_declared():
    bench = pb_registry.load_benchmark()
    entries = {m["name"]: m for m in bench["per_layer"]}
    cells = [w["name"] for w in bench["workloads"]]
    for name in NEW:
        m = entries[name]
        assert m["source"] == "program_counter"
        assert m["moves"] == "lane_ticks_per_s"
        assert m["workloads"] == cells
        assert m["layer"] in {e["layer"] for e in bench["per_layer"]
                              if e["name"] not in NEW}


def test_a_tiny_cpu_run_reads_the_host_spans():
    """A traced run on the CPU (nothing is profiled there) reads the host
    spans and counters of its window; the device counters stay absent."""
    from repro_torch.core import spans
    torch.set_num_threads(2)
    spans.reset()
    cell = tiny_cell("sporades.fig6")
    out = run.run_cell(cell, 2 ** 31 + 7, 0.2, True, device="cpu")
    m = out["metrics"]
    assert m["tick0_host_ms"]["value"] > 0
    ticks = 400        # sim_seconds 0.4 at 1 ms a tick
    # cvc_all [T, 5, 5] and commit_key [T, 5] int32, at the least
    assert m["readback_kib_per_lane"]["value"] >= ticks * 30 * 4 / 1024
    assert not {"replay_tick_ms", "boundary_device_ms"} & set(m)


def _ev(name, s, e, cuda=False, corr=0, note=False):
    return SimpleNamespace(
        name=name, time_range=SimpleNamespace(start=s, end=e), id=corr,
        device_type=DeviceType.CUDA if cuda else DeviceType.CPU,
        is_user_annotation=note)


def _events():
    # host: sweep.tick0 [0, 100] holding tick.mandator [10, 40] and
    # tick.order [50, 90]; runtime calls inside each, their device work
    # later on the device clock; a marker and a device-side annotation
    return [
        _ev("sweep.tick0", 0, 100, note=True),
        _ev("tick.mandator", 10, 40, note=True),
        _ev("cudaLaunchKernel", 12, 13, corr=1),
        _ev("cudaLaunchKernel", 20, 21, corr=2),
        _ev("cudaMemcpyAsync", 30, 31, corr=3),
        _ev("tick.order", 50, 90, note=True),
        _ev("cudaLaunchKernel", 60, 61, corr=4),
        _ev("aten::add", 59, 62, corr=4),
        _ev("k1", 200, 210, cuda=True, corr=1),
        _ev("k2", 205, 220, cuda=True, corr=2),
        _ev("Memcpy DtoD", 230, 232, cuda=True, corr=3),
        _ev("k3", 240, 250, cuda=True, corr=4),
        _ev("spin_kernel", 260, 261, cuda=True, corr=9),
        _ev("tick.mandator", 200, 232, cuda=True, note=True),
    ]


def test_scope_kernels_follow_the_launching_calls():
    ev = _events()
    got = pb_spans.scope_kernels(ev, "tick.mandator")
    assert [x[2] for x in got] == ["k1", "k2", "Memcpy DtoD"]
    split = pb_spans.scope_split(ev)
    assert split["tick.mandator"] == {"busy_ms": pytest.approx(0.022),
                                      "kernels": 2, "copies": 1}
    assert split["tick.order"] == {"busy_ms": pytest.approx(0.010),
                                   "kernels": 1, "copies": 0}
    assert "tick.trace" not in split
    t0 = pb_spans.scope_kernels(ev, "sweep.tick0")
    assert len(t0) == 4
    assert [x[2] for x in pb_spans.host_spans(ev)] == [
        "sweep.tick0", "tick.mandator", "tick.order"]


def test_gaps_named_by_the_open_span():
    tl = pb_trace.Timeline([(0.0, 50.0, "a", True), (60.0, 140.0, "b", True),
                            (200.0, 260.0, "c", True),
                            (310.0, 400.0, "d", True)],
                           [(130.0, 131.0), (300.0, 301.0)], 0.0, 400.0)
    host = [(100.0, 290.0, "sweep.dispatch"), (150.0, 190.0, "sweep.lower"),
            (255.0, 280.0, "sweep.tick0"), (280.0, 285.0, "sweep.load")]
    named = dict(pb_spans.named_gaps(tl, host))
    assert named == {
        "grid k: graph replays": pytest.approx(10e-6),
        "dispatch_sweep of grid k+1: lowering, tick 0, load / "
        "sweep.dispatch": pytest.approx(60e-6),
        "dispatch_sweep of grid k+1: lowering, tick 0, load / "
        "sweep.tick0": pytest.approx(50e-6)}
    # without spans, the names are pb_trace.top_gaps' own
    assert sorted(pb_spans.named_gaps(tl, [])) == sorted(
        pb_trace.top_gaps(tl))
    assert pb_spans.innermost(host, 160.0) == "sweep.lower"
    assert pb_spans.innermost(host, 50.0) is None


def test_summary_per_grid():
    parents = {"sweep.tick0": "sweep.dispatch", "sweep.capture":
               "sweep.dispatch", "sweep.dispatch": None,
               "sweep.collect": None}
    s = pb_spans.summary(_grids()[1:4], parents)
    assert s["sweep.tick0"]["grids"] == 3
    assert s["sweep.tick0"]["total_ms_per_grid"] == pytest.approx(
        (9.6 + 441.5 + 16.1) / 3)
    assert s["sweep.dispatch"]["self_ms_per_grid"] == pytest.approx(
        9000.0 - (9.6 + 441.5 + 16.1) / 3)
    assert "sweep.capture" not in s
