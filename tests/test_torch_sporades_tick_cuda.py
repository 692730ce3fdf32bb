"""The Sporades tick's CUDA kernel against its op chain, bit for bit, on
the card: 16 lanes (4 rates x 4 seeds) of the paper's deployment, a real
Mandator feeding both routes its ``lcr`` each tick, 512 ticks (2 D at the
canonical D = 256; the delay attacks' horizon is 1 024). After every tick
every leaf of the Sporades state and the ring are equal (floats as their
bits). The scenarios run with a 60 ms view timeout, under the WAN's round
trips, so that 512 ticks hold view changes, the asynchronous path and
its exits; across them every transition of the tick fires, counted from
the op chain's own masks. One case more runs the benchmark's config (300
ms), one with telemetry full (flight recorder and monitor IO equal too),
and baseline and leader-crash-recover at n = 3 and n = 9 (Fig 9's sizes:
the quorum, the payload widths and shared-memory offsets, and the
shuffles over the senders all depend on n).
The pairs are chip_smoke.py's own (``sporades_tick_pair``), so the two
checks cannot drift apart. Skips without a CUDA device; run it on the
card with

    PYTHONPATH=src python -m pytest -q --noconftest <this file>

(``--noconftest``: tests/conftest.py imports the JAX package.)
"""
import importlib.util
from pathlib import Path

import pytest
import torch

pytestmark = pytest.mark.cuda

_SMOKE = Path(__file__).resolve().parents[1] / "chip_smoke.py"
# (case, scenario, view timeout ms, telemetry, replicas)
CASES = (
    ("baseline", "baseline", 60.0, False, 5),
    ("paper-ddos", "paper-ddos", 60.0, False, 5),
    ("leader-ddos", "leader-ddos", 60.0, False, 5),
    ("leader-crash-recover", "leader-crash-recover", 60.0, False, 5),
    ("minority-partition", "minority-partition", 60.0, False, 5),
    ("gray-wan", "gray-wan", 60.0, False, 5),
    ("baseline-300ms", "baseline", 300.0, False, 5),
    ("telemetry-full", "leader-crash-recover", 60.0, True, 5),
    ("n3-baseline", "baseline", 60.0, False, 3),
    ("n3-leader-crash-recover", "leader-crash-recover", 60.0, False, 3),
    ("n9-baseline", "baseline", 60.0, False, 9),
    ("n9-leader-crash-recover", "leader-crash-recover", 60.0, False, 9),
)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", _SMOKE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")


@pytest.fixture(scope="module")
def runs():
    _need_card()
    smoke = _chip_smoke()
    return {case: smoke.sporades_tick_pair(scen, vt, tele, n_replicas=n)
            for case, scen, vt, tele, n in CASES}


@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_kernel_equals_chain_bitwise(runs, case):
    mismatch, _, _ = runs[case]
    assert mismatch is None, mismatch


def test_every_transition_fires(runs):
    """No branch of the kernel goes unchecked: across the cases each
    transition of the op chain fired at least once."""
    total = {}
    for _, counts, _ in runs.values():
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
    assert total and all(total.values()), total


def test_telemetry_records_are_compared(runs):
    """The telemetry case compared the flight recorder's ring and counts
    and the monitor's IO gauge every tick; the other cases carry none."""
    mismatch, _, leaves = runs["telemetry-full"]
    assert mismatch is None, mismatch
    assert {"tr.buf", "tr.counts", "mon_io.dropped"} <= set(leaves)
    assert not any(k.startswith(("tr.", "mon_io."))
                   for k in runs["baseline"][2])


def test_graph_holds_one_tick_kernel_node():
    """A captured mandator-sporades tick holds one sporades_tick node and
    two channel_ring commits (Mandator's ring and Sporades'); the span
    counters show the kernel route taken for the warm-up tick and the
    capture, and the op chain never."""
    _need_card()
    from repro_torch.configs.smr import SMRConfig
    from repro_torch.core import compile_cache, spans
    from repro_torch.core.experiment import SweepSpec, run_sweep
    compile_cache.reset_stats()
    spans.reset()
    run_sweep("mandator-sporades", SMRConfig(sim_seconds=0.3),
              SweepSpec(rates=(100_000, 300_000)), device="cuda")
    replays = compile_cache.stats()["replays"]
    assert replays == 299
    assert compile_cache.graph_kernel_launches("sporades_tick") == replays
    assert compile_cache.graph_kernel_launches("commit_kernel") \
        == 2 * replays
    c = spans.stats()["counters"]
    assert c.get("order.chain_calls", 0) == 0
    assert c["order.kernel_calls"] in (1, 2)     # warm-up (+ a capture)
