"""Mandator-Paxos and Multi-Paxos (repro_torch.core.paxos) against the JAX
reference on the CPU, with the reference's arrival draws replayed into the
port (tests/torch_sim_parity.py), at n=5, 1.5 s, 100k tx/s, on baseline
and leader-crash-recover, and for multipaxos also paper-ddos:

- the per-tick trace (committed_slot, cvc) bitwise;
- every carried leaf of the final state bitwise: rounds, views, slots,
  acks, vector clocks, ring contents, and the float leaves (the leader's
  pooled ``buffer_tsum``, the batch records);
- the metrics within tests/test_torch_slice.py's stated tolerances;
- the result rows' keys equal to the reference's.

100k tx/s is above Multi-Paxos's saturation (the reference commits
47 059 tx/s on baseline): the leader's pending requests pile up and its
``buffer_tsum`` passes 2^24, where every float32 add rounds, so the
order of the forwarded sums and the form_batches remainder decide the
bits.
"""
import numpy as np
import pytest

import torch_sim_parity as P

SCENARIOS = {
    "multipaxos": ("baseline", "leader-crash-recover", "paper-ddos"),
    "mandator-paxos": ("baseline", "leader-crash-recover"),
}
TRACE = {"multipaxos": "committed_slot", "mandator-paxos": "cvc"}
CASES = [(p, i) for p, names in SCENARIOS.items() for i in range(len(names))]
IDS = [f"{p}-{SCENARIOS[p][i]}" for p, i in CASES]


@pytest.fixture(scope="module")
def runs():
    cache = {}

    def get(protocol):
        if protocol not in cache:
            cache[protocol] = P.run_both(protocol, SCENARIOS[protocol])
        return cache[protocol]

    return get


@pytest.mark.parametrize("protocol,i", CASES, ids=IDS)
def test_trace_bitwise(runs, protocol, i):
    r = runs(protocol)
    key = TRACE[protocol]
    np.testing.assert_array_equal(r["ref_trace"][key][i],
                                  r["port_trace"][key][i])
    assert r["port_trace"][key][i, -1].max() > 0, "nothing committed"


@pytest.mark.parametrize("protocol", SCENARIOS)
def test_final_state_bitwise(runs, protocol):
    r = runs(protocol)
    P.assert_state_bitwise(r)
    # the crash scenario moved the view on (lane 1)
    assert r["port_state"]["p"]["view"][1].max() >= 1


@pytest.mark.parametrize("protocol,i", CASES, ids=IDS)
def test_metrics_within_stated_tolerance(runs, protocol, i):
    r = runs(protocol)
    assert r["port_rows"][i]["committed"] > 0
    P.assert_metrics(r, i, P.port_latencies(r, protocol, i))


@pytest.mark.parametrize("protocol", SCENARIOS)
def test_row_keys_equal_reference(runs, protocol):
    P.row_keys_equal(runs(protocol))


def test_multipaxos_point_is_above_saturation(runs):
    """The 100k tx/s baseline point leaves the leader with a backlog whose
    arrival-tick sum is past float32's exact integers."""
    r = runs("multipaxos")
    assert r["port_rows"][0]["throughput"] < 0.6 * P.RATE
    tsum = r["port_state"]["p"]["wl.buffer_tsum"][0]
    assert tsum.max() > 2.0 ** 24
