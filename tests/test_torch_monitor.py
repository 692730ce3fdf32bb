"""The port's health monitor (repro_torch/obs/monitor): the properties of
tests/test_monitor.py on the port — monitor_level off/gauges/full give the
same metrics bit for bit for every scan protocol, full monitoring reports
no violation across the scenario library and for all six protocols, each
seeded violation trips exactly its own counter, the stall watchdog fires
on a frozen leader only, and the gauges flow into the verdict and the
Chrome trace — and, against the JAX reference on the CPU with its arrival
draws replayed (tests/torch_sim_parity.py, 1 s, 100k tx/s, open and
closed lanes on baseline and paper-ddos): every leaf of the monitor's
state and of the rows' ``mon`` bit for bit, float gauges included; and
Mandator-Paxos's agreement counts on the robustness matrix (2 s, whole
library, both rates), the reference's own fault, equal to the reference's
and to the table chip_smoke.py holds the card to."""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_sim_parity as P
from torch_sim_parity import single_thread  # noqa: F401
from repro_torch.configs.smr import SMRConfig
from repro_torch.core import netsim
from repro_torch.core.experiment import (
    ANALYTIC_PROTOCOLS,
    SweepSpec,
    run_sweep,
)
from repro_torch.core.harness import PROTOCOLS
from repro_torch.obs import export, monitor
from repro_torch.obs.monitor import VIOLATIONS, HostMonitor, MonitorLevel
from repro_torch.obs.trace import TraceLevel
from repro_torch.scenarios import Partition, Scenario
from repro_torch.scenarios import library as scenario_library

SIM_S = 1.0
RATE = 50_000.0
CPU = torch.device("cpu")
SCENARIOS = ("baseline", "paper-ddos")

METRIC_KEYS = ("throughput", "median_ms", "p99_ms", "committed", "timeline",
               "origin_median_ms", "origin_p99_ms", "origin_timeline",
               "origin_lat_ms_timeline")

VIDX = {name: i for i, name in enumerate(VIOLATIONS)}


def _chip_smoke():
    """chip_smoke.py as a module (its robustness constants)."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(protocol, cfg, rate=RATE, scenarios=(None,)):
    return run_sweep(protocol, cfg, SweepSpec(rates=(rate,),
                                              scenarios=scenarios),
                     device="cpu")


# ----------------------------------------- off == monitored, bitwise -----

@pytest.fixture(scope="module")
def leveled():
    cache = {}

    def get(protocol, level):
        if (protocol, level) not in cache:
            cfg = SMRConfig(sim_seconds=SIM_S, monitor_level=level)
            scens = tuple(scenario_library.get(x, SIM_S) for x in SCENARIOS)
            cache[protocol, level] = _run(protocol, cfg, scenarios=scens)
        return cache[protocol, level]

    return get


@pytest.mark.parametrize("protocol", PROTOCOLS)
@pytest.mark.parametrize("scenario", SCENARIOS)
def test_monitor_level_off_is_bitwise_inert(leveled, protocol, scenario):
    """Every metric is bit-identical across off/gauges/full: the monitor
    only reads protocol state, and at off it is not run."""
    i = SCENARIOS.index(scenario)
    off = leveled(protocol, MonitorLevel.OFF)[i]
    for level in (MonitorLevel.GAUGES, MonitorLevel.FULL):
        on = leveled(protocol, level)[i]
        for k in METRIC_KEYS:
            np.testing.assert_array_equal(np.asarray(off[k]),
                                          np.asarray(on[k]),
                                          err_msg=f"{protocol}/{level}/{k}")
    assert "mon" not in off
    assert "viol" not in leveled(protocol, MonitorLevel.GAUGES)[i]["mon"]
    full = leveled(protocol, MonitorLevel.FULL)[i]["mon"]
    assert full["viol"].shape == (len(VIOLATIONS),)
    assert not full["viol"].any(), full["viol"]


def test_off_config_is_the_default():
    assert SMRConfig().monitor_level == MonitorLevel.OFF


# ----------------------------------------- zero violations, full library --

def test_full_monitor_is_silent_across_scenario_library():
    """Every curated adversary x mandator-sporades, one batched sweep:
    zero violations."""
    cfg = SMRConfig(sim_seconds=SIM_S, monitor_level=MonitorLevel.FULL)
    lib = scenario_library.scenarios(SIM_S, cfg.n_replicas)
    rows = _run("mandator-sporades", cfg, scenarios=tuple(lib.values()))
    for name, r in zip(lib, rows):
        counts = r["mon"]["viol"]
        assert not counts.any(), \
            f"{name}: " + " ".join(f"{v}={counts[VIDX[v]]}"
                                   for v in VIOLATIONS if counts[VIDX[v]])
        v = monitor.verdict(r)
        assert v["ok"] and v["level"] == MonitorLevel.FULL
    merged = monitor.merge_verdicts([monitor.verdict(r) for r in rows])
    assert merged["ok"] and merged["points"] == len(lib)
    assert monitor.format_verdict(merged) == f"monitor OK ({len(lib)} pts)"


def test_full_monitor_is_silent_for_all_six_protocols():
    cfg = SMRConfig(sim_seconds=SIM_S, monitor_level=MonitorLevel.FULL)
    for proto in PROTOCOLS:
        r, = _run(proto, cfg)
        assert not r["mon"]["viol"].any(), (proto, r["mon"]["viol"])
    for proto, rate in zip(ANALYTIC_PROTOCOLS, (5_000.0, 800.0)):
        r, = run_sweep(proto, cfg, SweepSpec(rates=(rate,)))
        v = monitor.verdict(r)
        assert v is not None and v["ok"], (proto, v)


# ----------------------------------------- seeded violations, unit --------

def _views(n, cvc=None, commit_seq=None, view=None, formed=None,
           stable=None, commit_tot=0.0, pending=True, ring_occ=0.0,
           dropped=None):
    """One lane's monitor view (leaves [1, ...])."""
    def i32(x):
        return torch.tensor(np.asarray(x)[None], dtype=torch.int32)

    return {
        "cvc": None if cvc is None else i32(cvc),
        "commit_seq": None if commit_seq is None else i32(commit_seq),
        "view": None if view is None else i32(view),
        "formed": i32(formed if formed is not None else [10] * n),
        "stable": i32(stable if stable is not None else [0] * n),
        "commit_tot": torch.tensor([commit_tot], dtype=torch.float32),
        "pending": torch.tensor([pending]),
        "ring_occ": torch.tensor([ring_occ], dtype=torch.float32),
        "dropped": i32(dropped if dropped is not None else [0] * n),
    }


def _env(cfg):
    return netsim.stack_envs([netsim.build_env(cfg, device="cpu")])


class TestSeededViolations:
    """Each hand-built state mutation trips exactly its own counter."""
    N = 3

    def _run(self, views0, views1, cfg_kw=None, upd_kw=None, repeats=1):
        cfg = SMRConfig(n_replicas=self.N, sim_seconds=SIM_S,
                        monitor_level=MonitorLevel.FULL, **(cfg_kw or {}))
        env = _env(cfg)
        grace = monitor.stall_grace_ticks(cfg, env)
        mon = monitor.init_monitor(cfg, 100, views0)
        for t in range(repeats):
            mon = monitor.update(mon, t, cfg, env, views1, grace,
                                 **(upd_kw or {}))
        return mon["viol"][0].numpy()

    def _assert_only(self, counts, name, expect=None):
        assert counts[VIDX[name]] > 0, (name, counts)
        if expect is not None:
            assert counts[VIDX[name]] == expect, (name, counts)
        others = [v for v in VIOLATIONS if v != name]
        assert not any(counts[VIDX[v]] for v in others), (name, counts)

    def test_agreement(self):
        z = np.zeros((self.N, self.N), np.int32)
        div = np.array([[2, 0, 0], [0, 2, 0], [0, 0, 0]], np.int32)
        counts = self._run(_views(self.N, cvc=z, formed=[2, 2, 0]),
                           _views(self.N, cvc=div, formed=[2, 2, 0]))
        self._assert_only(counts, "agreement", expect=1)

    def test_prefix_retraction(self):
        ones = np.ones((self.N, self.N), np.int32)
        counts = self._run(_views(self.N, cvc=ones),
                           _views(self.N, cvc=np.zeros_like(ones)))
        self._assert_only(counts, "prefix", expect=1)

    def test_commit_once_phantom(self):
        claim = np.tile(np.array([3, 0, 0], np.int32), (self.N, 1))
        counts = self._run(_views(self.N, cvc=np.zeros_like(claim),
                                  formed=[2, 2, 2]),
                           _views(self.N, cvc=claim, formed=[2, 2, 2]))
        self._assert_only(counts, "commit_once", expect=1)

    def test_view_monotone(self):
        counts = self._run(_views(self.N, view=[1, 1, 1]),
                           _views(self.N, view=[0, 1, 1]))
        self._assert_only(counts, "view_monotone", expect=1)

    def test_inflight_cap(self):
        wlt = {"cap": torch.tensor([2.0]), "closed": torch.tensor([1.0])}
        counts = self._run(
            _views(self.N), _views(self.N),
            upd_kw=dict(wlt=wlt, inflight=torch.tensor([[5.0, 0.0, 0.0]]),
                        check_cap=True))
        self._assert_only(counts, "inflight_cap", expect=1)

    def test_stall_watchdog(self):
        # healthy cluster, work pending, commit_tot frozen: 8 armed ticks
        # against a 5-tick grace window -> exactly 3 violating ticks
        tick_ms = SMRConfig().tick_ms
        counts = self._run(
            _views(self.N), _views(self.N),
            cfg_kw=dict(monitor_stall_grace_ms=5.0 * tick_ms), repeats=8)
        self._assert_only(counts, "stall", expect=3)

    def test_progress_disarms_watchdog(self):
        cfg = SMRConfig(n_replicas=self.N, sim_seconds=SIM_S,
                        monitor_level=MonitorLevel.FULL,
                        monitor_stall_grace_ms=5.0 * SMRConfig().tick_ms)
        env = _env(cfg)
        grace = monitor.stall_grace_ticks(cfg, env)
        mon = monitor.init_monitor(cfg, 100, _views(self.N))
        for t in range(20):  # a commit lands every 4th tick
            mon = monitor.update(mon, t, cfg, env,
                                 _views(self.N, commit_tot=float(t // 4)),
                                 grace)
        assert not mon["viol"].any()


# ----------------------------------------- seeded violations, e2e ---------

def test_frozen_leader_trips_stall_watchdog_only():
    """Multipaxos with its view-0 leader partitioned away and view changes
    disabled: the majority side is healthy and loaded but never commits —
    the watchdog fires, every safety counter stays zero. With the default
    view timeout the views rotate and the same partition is silent."""
    sim_s = 1.5
    frozen = Scenario("frozen-leader", (
        Partition(start_s=0.0, end_s=sim_s,
                  groups=((0,), (1, 2, 3, 4))),))
    cfg = SMRConfig(sim_seconds=sim_s, monitor_level=MonitorLevel.FULL,
                    view_timeout_ms=10_000.0, monitor_stall_grace_ms=100.0)
    r, = _run("multipaxos", cfg, 10_000.0, (frozen,))
    counts = r["mon"]["viol"]
    assert counts[VIDX["stall"]] > 0, counts
    for name in ("agreement", "prefix", "commit_once", "view_monotone"):
        assert counts[VIDX[name]] == 0, (name, counts)
    cfg_ok = SMRConfig(sim_seconds=sim_s, monitor_level=MonitorLevel.FULL)
    r_ok, = _run("multipaxos", cfg_ok, 10_000.0, (frozen,))
    assert not r_ok["mon"]["viol"].any(), r_ok["mon"]["viol"]


# ----------------------------------------- host-side checks ---------------

def test_check_cvc_trace_flags_mutated_slot():
    T, n = 20, 3
    base = np.cumsum(np.ones((T, n, n), np.int64), axis=0)
    assert monitor.check_cvc_trace(base) == {"agreement": 0, "prefix": 0}
    bad = base.copy()
    bad[10, 1] = [0, 99, 0]   # divergent AND a retraction vs t=9
    res = monitor.check_cvc_trace(bad)
    assert res["agreement"] >= 1 and res["prefix"] >= 1


def test_check_cvc_trace_silent_on_a_sporades_run():
    r, = _run("mandator-sporades", SMRConfig(sim_seconds=SIM_S))
    assert monitor.check_cvc_trace(r["cvc_all"]) == {"agreement": 0,
                                                     "prefix": 0}


def test_host_monitor_commit_once_and_clean_flow():
    hm = HostMonitor(3)
    cut = np.array([3, 2, 1])
    hm.observe_commit(0, view=1, rnd=1, cut=cut)
    hm.observe_commit(1, view=1, rnd=1, cut=cut)
    assert hm.verdict()["ok"]
    hm.observe_commit(2, view=1, rnd=1, cut=np.array([9, 9, 9]))
    v = hm.verdict()
    assert not v["ok"] and "commit_once" in v["violations"]


def test_host_monitor_completion_order():
    hm = HostMonitor(2)
    hm.observe_completion(0, 1)
    hm.observe_completion(0, 2)
    assert hm.verdict()["ok"]
    hm.observe_completion(0, 2)                        # repeat -> once
    hm.observe_completion(0, 5)                        # gap -> prefix
    assert hm.verdict()["violations"] == {"commit_once": 1, "prefix": 1}


# ----------------------------------------- gauges + export ----------------

def test_gauges_flow_into_verdict_and_export():
    cfg = SMRConfig(sim_seconds=SIM_S, trace_level=TraceLevel.FULL,
                    monitor_level=MonitorLevel.FULL)
    r, = _run("mandator-sporades", cfg)
    v = monitor.verdict(r)
    g = v["gauges"]
    assert 0.0 < g["ring_occ_max"] <= 1.0
    assert 0.0 < g["ring_occ_mean"] <= g["ring_occ_max"]
    assert g["dropped_sends"] == 0
    assert len(g["inflight_hwm"]) == cfg.n_replicas
    assert len(g["starved_max"]) == cfg.n_replicas
    assert g["stall_max_ticks"] >= 0
    trace = export.chrome_trace(r, cfg, "mandator-sporades")
    export.validate(trace)
    counters = [e for e in trace["traceEvents"] if e["ph"] == "C"]
    assert {"ring occupancy", "dropped sends/s"} <= {e["name"]
                                                     for e in counters}
    occ = [e for e in counters if e["name"] == "ring occupancy"]
    assert max(e["args"]["occupancy"] for e in occ) > 0.0
    assert monitor.format_verdict(v).startswith("monitor OK")
    assert "health: monitor OK" in monitor.health_table(r)


def test_validate_rejects_bad_counter_args():
    cfg = SMRConfig(sim_seconds=SIM_S, trace_level=TraceLevel.FULL,
                    monitor_level=MonitorLevel.GAUGES)
    r, = _run("mandator-sporades", cfg)
    trace = export.chrome_trace(r, cfg, "mandator-sporades")
    trace["traceEvents"].append({"ph": "C", "pid": 0, "tid": 2,
                                 "name": "bad", "ts": 0.0,
                                 "args": {"x": float("nan")}})
    with pytest.raises(ValueError, match="finite numeric"):
        export.validate(trace)


# ----------------------------------------- against the reference ----------

@pytest.mark.parametrize("protocol", PROTOCOLS)
def test_monitor_equals_reference(protocol):
    """The monitor's carried state (gauges, timelines, violation counts,
    stall run, previous views) and the rows' ``mon`` bit for bit, on an
    open and a closed lane (the in-flight cap checked where it is exact)
    under baseline and paper-ddos; every verdict clean."""
    r = P.run_both_workloads(protocol, SCENARIOS,
                             ("poisson-open", "closed-loop"), sim_s=1.0,
                             monitor_level="full")
    P.assert_state_bitwise(r)
    assert "mon" in r["port_state"]
    for ref, got in zip(r["ref_rows"], r["port_rows"]):
        assert set(ref["mon"]) == set(got["mon"])
        for k, v in ref["mon"].items():
            a, b = np.asarray(v), got["mon"][k]
            assert a.dtype == b.dtype, k
            if a.dtype.kind == "f":
                a, b = a.view(np.uint32), b.view(np.uint32)
            np.testing.assert_array_equal(a, b, err_msg=k)
        assert monitor.verdict(got) == monitor.verdict(
            {"mon": {k: np.asarray(v) for k, v in ref["mon"].items()}})
        assert monitor.verdict(got)["ok"]


@pytest.mark.parametrize("rate", (50_000.0, 200_000.0))
def test_mandator_paxos_agreement_fault_reproduced(rate):
    """The reference's own monitor flags Mandator-Paxos on the robustness
    matrix (2 s, the robustness suite's two rates, the whole scenario
    library): a leader of a later view commits a vector clock that does
    not dominate an earlier leader's. The port reproduces it bit for bit —
    state, counters, rows — and the counts are exactly those chip_smoke.py
    accepts on the card (``KNOWN_VIOLATIONS``; none elsewhere; ROADMAP
    Queue C)."""
    smoke = _chip_smoke()
    assert smoke.ROBUST_S == 2.0
    assert rate in smoke.ROBUST_RATES["mandator-paxos"]
    names = tuple(scenario_library.scenarios(smoke.ROBUST_S,
                                             SMRConfig().n_replicas))
    r = P.run_both_workloads("mandator-paxos", names, ("poisson-open",),
                             sim_s=smoke.ROBUST_S, rate=rate,
                             monitor_level="full")
    P.assert_state_bitwise(r)
    flagged = set()
    for name, ref, got in zip(names, r["ref_rows"], r["port_rows"]):
        viol = got["mon"]["viol"]
        np.testing.assert_array_equal(np.asarray(ref["mon"]["viol"]), viol,
                                      err_msg=name)
        counts = {v: int(viol[VIDX[v]]) for v in VIOLATIONS if viol[VIDX[v]]}
        assert counts == smoke.KNOWN_VIOLATIONS.get(("mandator-paxos", name),
                                                    {}), name
        flagged |= {name} if counts else set()
    assert flagged == {s for p, s in smoke.KNOWN_VIOLATIONS
                       if p == "mandator-paxos"}
