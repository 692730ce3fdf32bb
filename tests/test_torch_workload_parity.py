"""Windowed and closed-loop workloads in the port's four scan protocols
against the JAX reference on the CPU (tests/torch_sim_parity.py), at n=5,
1.5 s, 100k tx/s, seed 0, on baseline and paper-ddos:

- table mode: onoff-burst, flash-crowd and region-skew, one 6-lane grid;
- closed mode: closed-loop and skewed-closed, one 4-lane grid.

The reference draws its arrivals inside the scan from its own state in
closed mode, which no torch sampler reproduces, so its per-tick counts
(after the alive mask and the cap) are logged in its scan and replayed
into the port, whose cap must then never cut one. Checked bit for bit:
every carried leaf of the final state (the closed loop's cl_submitted,
cl_done and batch_count_cum among them), the per-tick trace (with the
in-flight counts in closed mode) and each row's inflight_max; the other
metrics of the rows within tests/test_torch_slice.py's stated tolerances
(throughput and committed 1e-6 relative, median/p99 equal or one sorted
neighbour apart, timelines 1e-6 of their largest bucket, per-origin
quantiles bitwise)."""
import numpy as np
import pytest

import torch_sim_parity as P
from torch_sim_parity import single_thread  # noqa: F401

PROTOCOLS = ("mandator-sporades", "mandator-paxos", "multipaxos",
             "mandator")
SCENARIOS = ("baseline", "paper-ddos")
GRIDS = {"table": ("onoff-burst", "flash-crowd", "region-skew"),
         "closed": ("closed-loop", "skewed-closed")}
CASES = [(p, g) for p in PROTOCOLS for g in GRIDS]
IDS = [f"{p}-{g}" for p, g in CASES]
TRACE = {"multipaxos": "committed_slot", "mandator": "own_round"}


@pytest.fixture(scope="module")
def runs():
    cache = {}

    def get(protocol, grid):
        if (protocol, grid) not in cache:
            cache[protocol, grid] = P.run_both_workloads(
                protocol, SCENARIOS, GRIDS[grid])
        return cache[protocol, grid]

    return get


@pytest.mark.parametrize("protocol,grid", CASES, ids=IDS)
def test_grid_runs_its_mode(runs, protocol, grid):
    """The grid lowers to the mode it is meant to exercise, and a closed
    grid's replayed counts were never cut by the port's cap."""
    r = runs(protocol, grid)
    assert not r["mode"].trivial
    assert r["mode"].closed == (grid == "closed")
    if grid == "closed":
        assert not r["cut"].any()


@pytest.mark.parametrize("protocol,grid", CASES, ids=IDS)
def test_final_state_bitwise(runs, protocol, grid):
    r = runs(protocol, grid)
    P.assert_state_bitwise(r)
    part = "p" if protocol == "multipaxos" else "m"
    if grid == "closed":
        assert {"wl.cl_submitted", "wl.cl_done",
                "wl.batch_count_cum"} <= set(r["port_state"][part])
        assert r["port_state"][part]["wl.cl_submitted"].max() > 0


@pytest.mark.parametrize("protocol,grid", CASES, ids=IDS)
def test_trace_bitwise(runs, protocol, grid):
    r = runs(protocol, grid)
    keys = set(r["port_trace"])
    assert TRACE.get(protocol, "cvc") in keys
    assert ("inflight" in keys) == (grid == "closed")
    for k in keys:
        P.assert_trace_bitwise(r, k)
    assert r["port_trace"][TRACE.get(protocol, "cvc")][:, -1].max() > 0


@pytest.mark.parametrize("protocol,grid", CASES, ids=IDS)
def test_rows(runs, protocol, grid):
    r = runs(protocol, grid)
    P.row_keys_equal(r)
    for i, (ref, got) in enumerate(zip(r["ref_rows"], r["port_rows"])):
        assert got["workload"] == ref["workload"]
        P.assert_metrics(r, i, P.port_latencies(r, protocol, i))
        if grid == "closed":
            np.testing.assert_array_equal(np.asarray(ref["inflight_max"]),
                                          got["inflight_max"])
    assert any(x["committed"] > 0 for x in r["port_rows"])
