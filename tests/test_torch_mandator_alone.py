"""Mandator alone (the dissemination layer, completion = commit) against
the JAX reference on the CPU, with the reference's arrival draws replayed
into the port (tests/torch_sim_parity.py), at n=5, 1.5 s, 100k tx/s, on
baseline and leader-crash-recover: the per-tick own_round trace and every
carried leaf of the final state bitwise, the metrics within
tests/test_torch_slice.py's stated tolerances, and the result rows' keys
equal to the reference's."""
import numpy as np
import pytest

import torch_sim_parity as P

NAMES = ("baseline", "leader-crash-recover")


@pytest.fixture(scope="module")
def runs():
    return P.run_both("mandator", NAMES)


@pytest.mark.parametrize("i", range(len(NAMES)), ids=NAMES)
def test_trace_bitwise(runs, i):
    np.testing.assert_array_equal(runs["ref_trace"]["own_round"][i],
                                  runs["port_trace"]["own_round"][i])
    assert runs["port_trace"]["own_round"][i, -1].min() > 0


def test_final_state_bitwise(runs):
    P.assert_state_bitwise(runs)


@pytest.mark.parametrize("i", range(len(NAMES)), ids=NAMES)
def test_metrics_within_stated_tolerance(runs, i):
    assert runs["port_rows"][i]["committed"] > 0
    P.assert_metrics(runs, i, P.port_latencies(runs, "mandator", i))


def test_row_keys_equal_reference(runs):
    P.row_keys_equal(runs)
