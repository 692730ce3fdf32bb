"""The port's flight recorder (repro_torch/obs): the properties of
tests/test_obs.py on the port — trace_level off/counters/full give the
same metrics bit for bit for every scan protocol, the event ring keeps the
newest ``cap`` events with a saturating dropped counter, decode
round-trips a hand-built ring, mode-switch events fire under paper-ddos
and not on the baseline, the four phase latencies telescope to the
end-to-end latency, the analytic models emit phases, the Chrome trace
validates — and, against the JAX reference on the CPU with its arrival
draws replayed (tests/torch_sim_parity.py, 1 s, 100k tx/s, a 16-event
ring that overflows): every ring, counter, pointer and dropped count, and
the phase breakdown of the rows, bit for bit."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_sim_parity as P
from torch_sim_parity import single_thread  # noqa: F401
from repro.obs import trace as jtrace
from repro_torch.configs.smr import SMRConfig
from repro_torch.core.experiment import SweepSpec, run_sweep
from repro_torch.core.harness import PROTOCOLS
from repro_torch.obs import decode, export
from repro_torch.obs.trace import (
    DEFAULT_SPEC,
    PHASES,
    TraceLevel,
    _SAT,
    init_trace,
    public_view,
    record,
    record_env,
)
from repro_torch.scenarios import Crash, Scenario
from repro_torch.scenarios import library as scenario_library

SIM_S = 1.0
RATE = 50_000.0
CPU = torch.device("cpu")
# a crash mid-run so the equivalence also covers the env-event recording
# path (crash/recover edges, drop masks under dead links)
CRASH = Scenario("half-crash", (Crash(start_s=SIM_S / 2, targets=(0,)),))
SCENARIOS = {"baseline": None, "crash": CRASH}

METRIC_KEYS = ("throughput", "median_ms", "p99_ms", "committed", "timeline",
               "origin_median_ms", "origin_p99_ms", "origin_timeline",
               "origin_lat_ms_timeline")


def _lane0(ts):
    """One lane of a port trace state, as decode reads a result row."""
    return {k: v[0].numpy() for k, v in public_view(ts).items()}


def _run(protocol, cfg, rate=RATE, scenarios=(None,)):
    return run_sweep(protocol, cfg, SweepSpec(rates=(rate,),
                                              scenarios=scenarios),
                     device="cpu")


# ----------------------------------------------- off == traced, bitwise --

@pytest.fixture(scope="module")
def leveled():
    cache = {}

    def get(protocol, level):
        if (protocol, level) not in cache:
            cfg = SMRConfig(sim_seconds=SIM_S, trace_level=level,
                            trace_events=32)
            cache[protocol, level] = _run(protocol, cfg,
                                          scenarios=tuple(SCENARIOS.values()))
        return cache[protocol, level]

    return get


@pytest.mark.parametrize("protocol", PROTOCOLS)
@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_trace_level_off_is_bitwise_inert(leveled, protocol, scenario):
    """Every metric is bit-identical across off/counters/full: the
    recorder only reads protocol state, and at off it is not run."""
    i = list(SCENARIOS).index(scenario)
    off = leveled(protocol, TraceLevel.OFF)[i]
    for level in (TraceLevel.COUNTERS, TraceLevel.FULL):
        on = leveled(protocol, level)[i]
        for k in METRIC_KEYS:
            np.testing.assert_array_equal(np.asarray(off[k]),
                                          np.asarray(on[k]),
                                          err_msg=f"{protocol}/{level}/{k}")
        assert on["obs"]
        assert on["phase_med_ms"].shape == (len(PHASES),)
    assert "obs" not in off and "phase_med_ms" not in off


def test_off_config_is_the_default():
    assert SMRConfig().trace_level == TraceLevel.OFF


# ----------------------------------------------- ring overflow semantics --

def test_ring_overflow_keeps_newest_and_saturates():
    """10 events into a cap-4 ring: the ring holds the newest 4 in order,
    dropped counts the 6 evicted, and a saturated counter stays put."""
    n, cap = 2, 4
    ts = init_trace(DEFAULT_SPEC, TraceLevel.FULL, n, cap, 1, CPU)
    mask = torch.tensor([[True, False]])  # replica 1 stays silent
    for i in range(10):
        ts = record(DEFAULT_SPEC, ts, "commit", mask, t=i, a=100 + i, b=i)
    reps = decode.decode_ring(_lane0(ts))
    assert [e["tick"] for e in reps[0]["events"]] == [6, 7, 8, 9]
    assert [e["args"]["key"] for e in reps[0]["events"]] == [106, 107, 108,
                                                             109]
    assert reps[0]["dropped"] == 6
    assert reps[0]["counts"]["commit"] == 10
    assert reps[1]["events"] == [] and reps[1]["dropped"] == 0
    ts = dict(ts)
    ts["dropped"] = torch.full((1, n), _SAT, dtype=torch.int32)
    ts = record(DEFAULT_SPEC, ts, "commit", mask, t=11)
    assert torch.all(ts["dropped"] == _SAT)


def test_ring_exact_capacity_no_drop():
    ts = init_trace(DEFAULT_SPEC, TraceLevel.FULL, 1, 3, 1, CPU)
    for i in range(3):
        ts = record(DEFAULT_SPEC, ts, "view_change", torch.tensor([[True]]),
                    t=i, a=i)
    rep = decode.decode_ring(_lane0(ts))[0]
    assert [e["tick"] for e in rep["events"]] == [0, 1, 2]
    assert rep["dropped"] == 0


@pytest.mark.parametrize("cap", (3, 8, 64))
def test_one_pass_equals_reference_one_by_one(cap):
    """A tick's events recorded in one pass (record_env) equal the
    reference's ``record`` called once per event, then ``record_env``:
    ring, pointers, counters and dropped counts, lane by lane — with more
    events in a tick than the ring holds (cap 3), and past 2^31 - 1
    dropped events."""
    rng = np.random.RandomState(cap)
    B, n, ticks = 3, 4, 40
    names = ("view_change", "commit", "batch_create", "mode_switch")
    ts = init_trace(DEFAULT_SPEC, TraceLevel.FULL, n, cap, B, CPU)
    ts["dropped"][1] = _SAT - 5
    refs = [jtrace.init_trace(jtrace.DEFAULT_SPEC, "full", n, cap)
            for _ in range(B)]
    refs[1]["dropped"] = jnp.full((n,), _SAT - 5, jnp.int32)
    for t in range(ticks):
        masks = rng.rand(len(names), B, n) < 0.6
        a = rng.randint(-5, 1 << 26, (len(names), B, n))
        b = rng.rand(len(names), B, n) * 100.0        # floats truncate
        alive = rng.rand(B, n) < 0.8
        cut = rng.randint(0, 3, (B, n))
        events = [(x, torch.from_numpy(masks[j]), torch.from_numpy(a[j]),
                   torch.from_numpy(b[j].astype(np.float32)))
                  for j, x in enumerate(names)]
        ts = record_env(DEFAULT_SPEC, ts, torch.from_numpy(alive), t,
                        a=t, b=torch.from_numpy(cut), dropped_links=torch.
                        from_numpy(cut), events=events)
        for lane in range(B):
            r = refs[lane]
            for j, x in enumerate(names):
                r = jtrace.record(jtrace.DEFAULT_SPEC, r, x,
                                  jnp.asarray(masks[j, lane]), jnp.int32(t),
                                  a=jnp.asarray(a[j, lane]),
                                  b=jnp.asarray(b[j, lane], jnp.float32))
            refs[lane] = jtrace.record_env(
                jtrace.DEFAULT_SPEC, r, jnp.asarray(alive[lane]),
                jnp.int32(t), a=t, b=jnp.asarray(cut[lane]),
                dropped_links=jnp.asarray(cut[lane]))
    got = public_view(ts)
    for lane in range(B):
        ref = jtrace.public_view(refs[lane])
        for k in ("counts", "buf", "ptr", "dropped"):
            np.testing.assert_array_equal(np.asarray(ref[k]),
                                          got[k][lane].numpy(),
                                          err_msg=f"{lane}/{k}")
    assert int(got["dropped"][1].max()) == _SAT


def test_decode_round_trip_hand_built_sequence():
    seq = [("view_change", 3, {"view": 1, "round": 7}),
           ("mode_switch", 5, {"is_async": 1, "view": 1}),
           ("commit", 9, {"key": 2**26, "total": 123}),  # int32-range key
           ("crash", 12, {"view": 2, "round": 9})]
    ts = init_trace(DEFAULT_SPEC, TraceLevel.FULL, 1, 8, 1, CPU)
    for name, t, args in seq:
        an, bn = DEFAULT_SPEC.args_of(name)
        ts = record(DEFAULT_SPEC, ts, name, torch.tensor([[True]]), t=t,
                    a=args[an], b=args[bn])
    rep = decode.decode_ring(_lane0(ts))[0]
    assert [(e["name"], e["tick"], e["args"]) for e in rep["events"]] == seq
    assert rep["counts"]["commit"] == 1 and rep["counts"]["crash"] == 1


# ----------------------------------------------- mode-switch semantics ----

def test_mode_switch_fires_under_ddos_not_baseline():
    cfg = SMRConfig(sim_seconds=2.0, trace_level=TraceLevel.COUNTERS)
    ddos = scenario_library.get("paper-ddos", 2.0)
    base, attacked = _run("mandator-sporades", cfg, 200_000.0, (None, ddos))
    kind = DEFAULT_SPEC.kind("mode_switch")
    assert int(base["obs"]["sporades"]["counts"][:, kind].sum()) == 0
    assert int(attacked["obs"]["sporades"]["counts"][:, kind].sum()) >= 1
    assert attacked["async_frac"] > 0


# ----------------------------------------------- phase accounting ---------

@pytest.mark.parametrize("protocol", PROTOCOLS)
def test_phases_telescope_to_end_to_end(protocol):
    """Per committed batch: the marks are ordered, every phase is
    non-negative, and the phases sum to the arrival -> delivery latency
    (the marks telescope; one tick of slack for quantization)."""
    cfg = SMRConfig(sim_seconds=SIM_S, trace_level=TraceLevel.FULL)
    r, = _run(protocol, cfg)
    marks, arr, cnt = r["batch_marks_t"], r["batch_arr_t"], r["batch_n"]
    ok = np.isfinite(marks).all(axis=0) & (cnt > 0)
    assert ok.sum() > 0
    create, stable, commit, deliver = (marks[j][ok] for j in range(4))
    assert np.all(create <= stable + 1e-6)
    assert np.all(stable <= commit + 1e-6)
    assert np.all(commit <= deliver + 1e-6)
    phases = np.stack([create - arr[ok], stable - create, commit - stable,
                       deliver - commit]) * cfg.tick_ms
    assert np.all(phases >= -1e-6)
    np.testing.assert_allclose(phases.sum(axis=0),
                               (deliver - arr[ok]) * cfg.tick_ms,
                               atol=cfg.tick_ms)
    assert np.all(np.isfinite(r["phase_med_ms"]))
    assert r["phase_origin_med_ms"].shape == (len(PHASES), cfg.n_replicas)


def test_analytic_baselines_emit_phases():
    for proto, rate in (("epaxos", 5_000.0), ("rabia", 800.0)):
        cfg = SMRConfig(sim_seconds=2.0, trace_level=TraceLevel.COUNTERS)
        r, = run_sweep(proto, cfg, SweepSpec(rates=(rate,)))
        assert export.phases_dict(r) is not None, proto
        assert len(r["phase_med_ms"]) == len(PHASES)
        r0, = run_sweep(proto, SMRConfig(sim_seconds=2.0),
                        SweepSpec(rates=(rate,)))
        assert "phase_med_ms" not in r0


# ----------------------------------------------- export schema ------------

def test_chrome_trace_export_validates(tmp_path):
    cfg = SMRConfig(sim_seconds=SIM_S, trace_level=TraceLevel.FULL)
    r, = _run("mandator-sporades", cfg, scenarios=(CRASH,))
    trace = export.chrome_trace(r, cfg, "mandator-sporades", scenario=CRASH)
    export.validate(trace)
    names = {e["name"] for e in trace["traceEvents"]}
    assert {"dissemination", "consensus", "Crash"} <= names
    assert {"M", "X", "C"} <= {e["ph"] for e in trace["traceEvents"]}
    assert export.write(tmp_path / "t.json", trace).stat().st_size > 0
    assert "queue" in export.phase_table(r)


def test_chrome_trace_requires_full_level():
    r, = _run("mandator-sporades", SMRConfig(sim_seconds=SIM_S))
    with pytest.raises(ValueError, match="flight-recorder"):
        export.chrome_trace(r, SMRConfig(sim_seconds=SIM_S),
                            "mandator-sporades")


# ----------------------------------------------- against the reference ----

@pytest.fixture(scope="module")
def parity():
    cache = {}

    def get(protocol):
        if protocol not in cache:
            cache[protocol] = P.run_both_workloads(
                protocol, ("baseline", "leader-crash-recover"),
                ("poisson-open",), sim_s=1.0, trace_level="full",
                trace_events=16)
        return cache[protocol]

    return get


LAYERS = {"mandator-sporades": ("mandator", "sporades"),
          "mandator-paxos": ("mandator", "paxos"),
          "multipaxos": ("paxos",), "mandator": ("mandator",)}
PHASE_KEYS = ("phase_med_ms", "phase_p99_ms", "phase_origin_med_ms",
              "phase_origin_p99_ms", "batch_marks_t", "batch_arr_t",
              "batch_n")


@pytest.mark.parametrize("protocol", PROTOCOLS)
def test_rings_equal_reference(parity, protocol):
    """Every carried leaf — the layers' rings, counters, pointers, dropped
    counts and crash detectors among them — and the trace, bit for bit;
    the rings overflowed, so the wrap-around is covered."""
    r = parity(protocol)
    P.assert_state_bitwise(r)
    for k in r["port_trace"]:
        P.assert_trace_bitwise(r, k)
    dropped = [r["port_state"][part]["tr.dropped"].max()
               for part in r["port_state"]]
    assert max(dropped) > 0


@pytest.mark.parametrize("protocol", PROTOCOLS)
def test_row_obs_and_phases_equal_reference(parity, protocol):
    """The rows' ``obs`` (per layer: counts, ring, ptr, dropped) and the
    phase breakdown bit for bit (NaN equal to NaN)."""
    r = parity(protocol)
    for ref, got in zip(r["ref_rows"], r["port_rows"]):
        assert set(ref["obs"]) == set(got["obs"]) == set(LAYERS[protocol])
        for layer, ring in ref["obs"].items():
            assert set(ring) == set(got["obs"][layer])
            for k, v in ring.items():
                np.testing.assert_array_equal(np.asarray(v),
                                              got["obs"][layer][k],
                                              err_msg=f"{layer}/{k}")
        for k in PHASE_KEYS:
            a, b = np.asarray(ref[k]), got[k]
            assert a.dtype == b.dtype and a.shape == b.shape, k
            np.testing.assert_array_equal(a.view(np.uint32),
                                          b.view(np.uint32), err_msg=k)
        ev = decode.decode_result(got)
        assert decode.event_summary(ev) == decode.event_summary(
            decode.decode_result({"obs": {
                layer: {k: np.asarray(v) for k, v in ring.items()}
                for layer, ring in ref["obs"].items()}}))
