"""The captured tick graph on the card: for each scan protocol, a 0.3 s
run through ``harness._scan_body`` as a graph (tick 0 eager, one tick
captured, 299 replays) equals the same run's eager loop
(``harness._eager_on_card``) bit for bit, every carried leaf and every
trace leaf, on the §5.2 baseline, a closed-loop grid and with telemetry
full; the rows of ``run_sweep`` too; the rows of a grid collected while
the grid dispatched after it runs (``collect()`` reads it back on a side
stream and returns before that grid ends) equal each grid's run alone;
and the audit's G1-G4 hold on the card (one capture, ``n_ticks - 1``
replays, the ring kernel launched by its wrapper only for the warm-up
tick and the capture). Skips without a
CUDA device; run it on the card with

    PYTHONPATH=src python -m pytest -q --noconftest <this file>

(``--noconftest``: tests/conftest.py imports the JAX package.)
"""
import contextlib
import dataclasses

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

SIM_S = 0.3
PROTOCOLS = ("mandator-sporades", "mandator-paxos", "multipaxos",
             "mandator")


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (a CUDA graph has no CPU mode)")


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def assert_bitwise(a: dict, b: dict, what: str) -> None:
    """Every leaf of two trees equal bit for bit (floats as their bits).
    A flight recorder's ring (``tr.buf``) is compared without its spill
    slot, the last: every event the tick does not keep is scattered there,
    several to one place, and which lands last is not fixed on the card
    (``obs/trace.py``)."""
    la, lb = dict(_leaves(a)), dict(_leaves(b))
    assert la.keys() == lb.keys(), what
    for k, x in la.items():
        y = lb[k]
        if x is None or y is None:
            assert x is None and y is None, (what, k)
            continue
        assert x.dtype == y.dtype and x.shape == y.shape, (what, k)
        if k.endswith("tr.buf"):
            x, y = x[:, :, :-1], y[:, :, :-1]
        if x.is_floating_point():
            bits = torch.int64 if x.element_size() == 8 else torch.int32
            x, y = x.view(bits), y.view(bits)
        assert torch.equal(x, y), f"{what}: {k} differs"


def _variant(name: str):
    from repro_torch.configs.smr import SMRConfig
    from repro_torch.core.experiment import SweepSpec
    from repro_torch.scenarios import library
    from repro_torch.workloads import library as wlib
    cfg = SMRConfig(sim_seconds=SIM_S)
    scen = (None, library.get("leader-crash-recover", SIM_S))
    if name == "closed":
        return cfg, SweepSpec(rates=(100_000,), scenarios=scen,
                              workloads=(wlib.get("closed-loop", SIM_S),
                                         wlib.get("onoff-burst", SIM_S)))
    if name == "telemetry":
        cfg = dataclasses.replace(cfg, trace_level="full",
                                  monitor_level="full")
    return cfg, SweepSpec(rates=(100_000, 300_000), scenarios=scen)


def _run(protocol, cfg, spec, eager: bool):
    from repro_torch.core import experiment, harness, netsim
    dev = torch.device("cuda")
    _, rcfg, mode, env, rate_b, seeds = experiment._lower(
        cfg, spec, dev, canonical=True)
    arr = harness.make_arrivals(
        rcfg, mode, rate_b.tolist(), seeds, dev,
        experiment._lower_workloads(rcfg, spec, canonical=True))
    ctx = harness._eager_on_card() if eager else contextlib.nullcontext()
    with ctx:
        st, trace = harness._scan_body(protocol, rcfg, netsim.sim_ticks(rcfg),
                                       env, arr, len(seeds), dev)
    torch.cuda.synchronize()
    return st, trace


@pytest.mark.parametrize("variant", ["baseline", "closed", "telemetry"])
@pytest.mark.parametrize("protocol", PROTOCOLS)
def test_graph_equals_eager_bitwise(protocol, variant):
    _need_card()
    from repro_torch.core import compile_cache
    cfg, spec = _variant(variant)
    before = compile_cache.stats()
    g_st, g_tr = _run(protocol, cfg, spec, eager=False)
    d = compile_cache.delta(before)
    assert d["graph_runs"] == 1 and d["replays"] == 299, d
    e_st, e_tr = _run(protocol, cfg, spec, eager=True)
    assert_bitwise(g_st, e_st, f"{protocol} {variant} carry")
    assert_bitwise(g_tr, e_tr, f"{protocol} {variant} trace")
    # a second run replays the stored program: nothing captured, same bits
    before = compile_cache.stats()
    again_st, again_tr = _run(protocol, cfg, spec, eager=False)
    d = compile_cache.delta(before)
    assert d["captures"] == 0 and d["hits"] == 1, d
    assert_bitwise(again_st, e_st, f"{protocol} {variant} carry, replayed")
    assert_bitwise(again_tr, e_tr, f"{protocol} {variant} trace, replayed")


@pytest.mark.parametrize("protocol", PROTOCOLS)
def test_rows_graph_equal_eager(protocol):
    _need_card()
    from repro_torch.core import harness
    from repro_torch.core.experiment import run_sweep
    cfg, spec = _variant("baseline")
    graph = run_sweep(protocol, cfg, spec)
    with harness._eager_on_card():
        eager = run_sweep(protocol, cfg, spec)
    assert_rows_equal(graph, eager, protocol)


def assert_rows_equal(got, want, what: str) -> None:
    """Rows of two sweeps equal value for value, floats as their bits."""
    assert len(got) == len(want), what
    for g, e in zip(got, want):
        assert g.keys() == e.keys()
        for k in g:
            x, y = np.asarray(g[k]), np.asarray(e[k])
            if x.dtype.kind == "f":
                x, y = (v.astype(np.float32).view(np.uint32)
                        for v in (x, y))
            assert np.array_equal(x, y), (what, k)


def test_a_grid_reads_back_while_the_next_one_runs():
    _need_card()
    from repro_torch.configs.smr import SMRConfig
    from repro_torch.core.experiment import (SweepSpec, dispatch_sweep,
                                             run_sweep)
    small = (SMRConfig(sim_seconds=SIM_S), SweepSpec(rates=(100_000,)))
    # 64 lanes, 4 000 ticks: its replays outlast its host enqueue by far
    big = (SMRConfig(sim_seconds=4.0),
           SweepSpec(rates=(50_000, 150_000, 300_000, 450_000),
                     seeds=tuple(range(16))))
    # each alone; this also captures both programs
    alone = [run_sweep("mandator-sporades", *g) for g in (small, big)]
    pa = dispatch_sweep("mandator-sporades", *small)
    pb = dispatch_sweep("mandator-sporades", *big)
    rows_a = pa.collect()
    assert not pb._marks.events["end"].query(), \
        "collect() waited for the grid dispatched after its own"
    rows_b = pb.collect()
    assert_rows_equal(rows_a, alone[0], "small grid")
    assert_rows_equal(rows_b, alone[1], "big grid")


def test_audit_on_the_card():
    _need_card()
    from repro_torch.analysis import graph_lint
    v = graph_lint.audit(protocols=PROTOCOLS, sim_seconds=SIM_S,
                         device="cuda")
    assert v["ok"], graph_lint.format_verdict(v)
    for p in PROTOCOLS:
        d = v["protocols"][p]
        assert d["replays"] == int(SIM_S * 1000) - 1, d
        assert d["captures"] <= 1, d
