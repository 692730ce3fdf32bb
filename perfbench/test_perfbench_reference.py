"""The plain reference against the port on the CPU, on a tiny grid of
each cell's traffic; the control (the reference with its float32 state
rounded to bfloat16 every tick) fails the comparison; the common coin is
JAX's; the NumPy inputs repeat from the seed and are fresh for every grid;
the check's lanes cover every axis of a grid."""
import dataclasses

import numpy as np
import pytest
import torch

import pb_check
import pb_inputs
import pb_registry
import plainsim

from repro_torch.configs.smr import SMRConfig as PortConfig
from repro_torch.core import experiment as port_experiment
from repro_torch.scenarios import library as port_scl
from repro_torch.workloads import library as port_wll

CELLS = [w["name"] for w in pb_registry.load_benchmark()["workloads"]]
BIG_SEED = 2 ** 31 + 12345


def tiny(cell, sim_seconds=0.25, keep=2):
    """The cell's traffic cut to a test's size: a few of each axis."""
    tr = dict(cell.traffic)
    tr["smr"] = dict(tr.get("smr", {}), sim_seconds=sim_seconds)
    tr["rates"] = tr["rates"][-keep:]
    tr["seeds_per_grid"] = 1
    return dataclasses.replace(cell, traffic=tr)


def port_rows(cell, g, settings):
    spec = port_experiment.SweepSpec(
        **pb_inputs.spec_kwargs(settings, g, port_scl, port_wll))
    return port_experiment.run_sweep(
        cell.config["protocol"], PortConfig(**settings), spec, device="cpu",
        draws=g.draws)


def ref_rows(cell, g, lanes, precision="float32"):
    return pb_check.reference_rows(cell.config["protocol"], cell.config,
                                   cell.traffic, g, lanes, precision)


@pytest.mark.parametrize("name", CELLS)
def test_reference_equals_port(name):
    torch.set_num_threads(2)
    bench = pb_registry.load_benchmark()
    cell = tiny(pb_registry.cell(bench, name))
    settings = pb_inputs.smr_settings(cell.config, cell.traffic)
    g = pb_inputs.make_grid(settings, cell.traffic, BIG_SEED, 1)
    rows = port_rows(cell, g, settings)
    lanes = [g.lanes - 1, 0]
    ref = ref_rows(cell, g, lanes)
    assert len(rows) == g.lanes
    for lane, r in zip(lanes, ref):
        got = pb_check.compare_rows(rows[lane], r)
        assert got["exact_mismatches"] == 0 and got["max_ulps"] == 0, got
    # the check sees a float one place off, and an integer changed
    bad = dict(rows[0], throughput=float(np.nextafter(np.float32(
        rows[0]["throughput"]), np.float32(np.inf))))
    got = pb_check.compare_rows(bad, ref[1])
    assert got["max_ulps"] == 1 and got["paths"] == {".throughput": 1}
    bad = dict(rows[0], seed=rows[0]["seed"] + 1)
    assert pb_check.compare_rows(bad, ref[1])["exact_mismatches"] == 1


@pytest.mark.parametrize("name", CELLS)
def test_control_fails(name):
    """The reference with its float32 state rounded to bfloat16 after
    every tick differs from the float32 reference past the limit."""
    bench = pb_registry.load_benchmark()
    cell = tiny(pb_registry.cell(bench, name), sim_seconds=0.4)
    settings = pb_inputs.smr_settings(cell.config, cell.traffic)
    g = pb_inputs.make_grid(settings, cell.traffic, BIG_SEED, 2)
    exact = ref_rows(cell, g, [0, 1])
    control = ref_rows(cell, g, [0, 1], "bfloat16")
    got = [pb_check.compare_rows(c, r) for c, r in zip(control, exact)]
    assert max(x["max_ulps"] for x in got) > pb_check.MAX_ULPS or \
        sum(x["exact_mismatches"] for x in got) > 0


def test_coin_is_jax_common_coin():
    """The reference's coin table is the JAX package's, drawn by JAX."""
    coin = pytest.importorskip("repro.core.coin")
    want = np.asarray(coin.coin_table(plainsim.MAX_VIEWS, 5))
    assert np.array_equal(plainsim.coin_table(plainsim.MAX_VIEWS, 5), want)
    want7 = np.asarray(coin.coin_table(64, 7, seed=3))
    assert np.array_equal(plainsim.coin_table(64, 7, seed=3), want7)


def test_inputs_repeat_and_differ():
    bench = pb_registry.load_benchmark()
    cell = tiny(pb_registry.cell(bench, "paxos.fig6"))
    settings = pb_inputs.smr_settings(cell.config, cell.traffic)
    a = pb_inputs.make_grid(settings, cell.traffic, BIG_SEED, 1)
    b = pb_inputs.make_grid(settings, cell.traffic, BIG_SEED, 1)
    c = pb_inputs.make_grid(settings, cell.traffic, BIG_SEED, 2)
    assert a.seeds == b.seeds and np.array_equal(a.draws, b.draws)
    assert a.seeds != c.seeds and not np.array_equal(a.draws, c.draws)
    assert a.draws.dtype == np.float32
    assert a.draws.shape == (a.lanes, 250, 5)
    # each lane draws at its own rate: the means order as the rates do
    means = a.draws.mean(axis=(1, 2))
    assert means[0] < means[-1]
    with pytest.raises(ValueError):
        pb_inputs.make_grid(settings, dict(cell.traffic,
                                           workloads=["closed-loop"]),
                            BIG_SEED, 1)


def test_open_workload_is_the_ports_flat_rate():
    """The port's ``poisson-open`` rate table is flat, as the draws here
    assume."""
    from repro_torch import workloads as port_workloads
    cfg = PortConfig(sim_seconds=0.1)
    tab = port_workloads.lower(cfg, port_wll.get("poisson-open", 0.1, 5))
    assert np.all(np.asarray(tab["rate_of"]) == 1.0)


def test_ulps():
    a = np.array([0.0, -0.0, 1.0, np.nan, np.inf, -1.0], np.float32)
    b = np.array([-0.0, 1e-45, np.nextafter(np.float32(1), np.float32(2)),
                  np.nan, np.inf, -1.0], np.float32)
    assert pb_check.ulps(a, b).tolist() == [0, 1, 1, 0, 0, 0]
    assert pb_check.ulps(np.float32(np.nan), np.float32(1.0)) \
        == pb_check.UNMATCHED


def test_sample_lanes():
    bench = pb_registry.load_benchmark()
    cell = pb_registry.cell(bench, "sporades.fig6")
    settings = pb_inputs.smr_settings(cell.config, dict(
        cell.traffic, smr={"sim_seconds": 0.01}))
    grids = [pb_inputs.make_grid(settings, cell.traffic, 7, k)
             for k in range(3)]
    gi, lanes = pb_check.sample_lanes(7, grids, 8)
    assert len(set(lanes)) == 8 and 0 <= gi < 3
    pts = grids[gi].points
    rates = cell.traffic["rates"]
    assert pts[lanes[0]][0] == max(rates)
    # a lane of every rate in the first ones drawn
    assert sorted(pts[i][0] for i in lanes[:len(rates)]) == sorted(rates)
    assert (gi, lanes) == pb_check.sample_lanes(7, grids, 8)
    assert pb_check.sample_lanes(8, grids, 8) != (gi, lanes)
    # every scenario and workload of a grid at its highest rate
    g = pb_inputs.Grid((1.0, 2.0), (5, 6), ("x", "y", "z"), ("p", "q"),
                       np.zeros((24, 1, 1), np.float32))
    for seed in range(20):
        _, got = pb_check.sample_lanes(seed, [g], 2)
        top = [g.points[i] for i in got if g.points[i][0] == 2.0]
        assert {p[2] for p in top} == {0, 1, 2}
        assert {p[3] for p in top} == {0, 1}
        assert {g.points[i][0] for i in got} == {1.0, 2.0}
