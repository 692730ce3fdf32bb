"""The fault deployment's cell, ``sporades.faults``: its configuration is
the ``wan5`` deployment with a failure model that names the scenario
library's ten scenarios, its traffic is a mix the reference checks, it
reports every accepted per-layer metric and its own three, whose readers
read the port's ``lower.*`` span and counters and ``order.*replica_ticks``
counters (and nothing where the port has none, as before they existed),
a tiny ``paper-ddos`` grid's rows equal the reference's to the last
place, and a tiny traced run of the cell on the CPU reads the three."""
import dataclasses

import pytest
import torch

import pb_check
import pb_inputs
import pb_registry
import plainscen
import run

CELL = "sporades.faults"
READERS = ("scen_lower_ms", "window_kib_per_lane", "async_share")


def _cell():
    return pb_registry.cell(pb_registry.load_benchmark(), CELL)


def tiny(scenarios, sim_seconds=0.2, view_timeout_ms=None):
    """The cell cut to one rate, one seed and ``scenarios``."""
    cell = _cell()
    tr = dict(cell.traffic, rates=cell.traffic["rates"][-1:],
              seeds_per_grid=1, scenarios=list(scenarios),
              smr=dict(cell.traffic["smr"], sim_seconds=sim_seconds))
    cfg = cell.config
    if view_timeout_ms is not None:
        cfg = dict(cfg, smr=dict(cfg["smr"], view_timeout_ms=view_timeout_ms))
    return dataclasses.replace(cell, traffic=tr, config=cfg)


def test_the_cell_is_wan5_under_the_librarys_faults():
    bench = pb_registry.load_benchmark()
    cell = _cell()
    wan5 = pb_registry.load_json(next(
        c["file"] for c in bench["configs"]
        if c["name"] == "mandator-sporades.wan5"))
    cfg, tr = cell.config, cell.traffic
    # the two deployments differ only in the failure model they state,
    # and the source names the part of the paper that defines it
    for k in ("protocol", "regions", "rtt_ms", "smr", "reduced"):
        assert cfg[k] == wan5[k], k
    entry = next(c for c in bench["configs"] if c["name"] == cfg["name"])
    assert cfg["source"] == entry["source"] != wan5["source"]
    assert cfg["source"].startswith(wan5["source"] + " sec. 5.5")
    assert cfg["failures"]["f"] == 2
    names = tuple(s["name"] for s in cfg["failures"]["scenarios"])
    assert names == plainscen.NAMES == tuple(tr["scenarios"])
    assert not set(wan5["assumed"]) - set(cfg["assumed"])
    settings = pb_inputs.smr_settings(cfg, tr)
    assert pb_inputs._refusal(settings, tr) is None
    assert pb_inputs.sim_ticks(settings) == 2000
    assert settings["delay_horizon_ticks"] == "auto"
    assert (len(tr["rates"]) * tr["seeds_per_grid"] * len(tr["scenarios"])
            * len(tr["workloads"])) == 80
    assert cell.chips == 1
    accepted = [m["name"] for m in bench["per_layer"]
                if m["workloads"][:2] == ["sporades.fig6", "paxos.fig6"]]
    assert len(accepted) == 10
    assert [m.name for m in cell.per_layer] == accepted + list(READERS)
    assert {m.name for m in cell.end_to_end} == {
        "lane_ticks_per_s", "peak_mem_mib", "setup_s"}


def _grid(gid, counters, ns):
    return {"id": gid, "tags": {}, "prev": gid - 1, "counters": counters,
            "ns": {"sweep.dispatch": 9e6, "sweep.collect": 1e6, **ns}}


def test_readers_read_the_new_names_and_nothing_without_them():
    read = {m: pb_registry.reader(m) for m in READERS}
    window = [_grid(g, {"lower.window_bytes": 80 * 12_800,
                        "lower.lanes": 80,
                        "order.async_replica_ticks": k,
                        "order.replica_ticks": 80 * 10_000},
                    {"lower.scenarios": ms * 1e6})
              for g, k, ms in ((2, 77_568, 3.0), (3, 77_568, 5.0),
                               (4, 77_572, 4.0))]
    obs = {"window_grids": window}
    assert read["scen_lower_ms"](obs) == pytest.approx(4.0)
    assert read["window_kib_per_lane"](obs) == pytest.approx(12.5)
    assert read["async_share"](obs) == pytest.approx(
        100 * 232_708 / 2_400_000)
    # the parent's grid table: every other span and counter, none of these
    parent = {"window_grids": [_grid(2, {"collect.readback_bytes": 10,
                                         "collect.lanes": 80}, {})]}
    assert all(r(parent) is None for r in read.values())
    assert all(r({"window_grids": []}) is None for r in read.values())


def test_paper_ddos_rows_equal_the_reference_to_the_last_place():
    """Lanes in the asynchronous view (a 60 ms view timeout under the
    WAN's round trips): ``async_frac`` is the reference's count over the
    size, and every value of the rows is the reference's."""
    torch.set_num_threads(2)
    cell = tiny(["paper-ddos", "baseline"], view_timeout_ms=60.0)
    settings = pb_inputs.smr_settings(cell.config, cell.traffic)
    g = pb_inputs.make_grid(settings, cell.traffic, 2 ** 31 + 321, 1)
    rows = run.Port("cpu").dispatch(cell.config["protocol"], settings,
                                    g).collect()
    ref = pb_check.reference_rows(cell.config["protocol"], cell.config,
                                  cell.traffic, g, [0, 1])
    assert rows[0]["async_frac"] > 0
    for row, r in zip(rows, ref):
        got = pb_check.compare_rows(row, r)
        assert got["exact_mismatches"] == 0 and got["max_ulps"] == 0, got


def test_a_tiny_traced_cpu_run_reads_the_new_metrics():
    from repro_torch.core import spans
    torch.set_num_threads(2)
    spans.reset()
    cell = tiny(["paper-ddos", "leader-crash-recover"])
    out = run.run_cell(cell, 2 ** 31 + 17, 0.2, True, device="cpu")
    assert out["correct"], out["checks"]
    m = out["metrics"]
    assert set(READERS) <= set(m)
    assert m["scen_lower_ms"]["value"] > 0
    # a 300 ms view timeout: no lane of a 200-tick run goes asynchronous
    assert m["async_share"]["value"] == 0
    # a lane: win_of_tick [200] int32, 32 windows of alive [5], drop
    # [5, 5] (bool), delay [5, 5] and nic [5] (float32)
    assert m["window_kib_per_lane"]["value"] == pytest.approx(
        (200 * 4 + 32 * 5 * 30) / 1024)
