"""The tick as the captured graph runs it, on the CPU: the tick index is a
0-dim int32 tensor that no op reads back.

- For every scan protocol and workload mode (trivial, table, closed),
  40 ticks of the port's loop (``harness._scan_body``, the device ``t``
  advanced in place) from the reference's own arrival counts equal the
  reference's scan leaf for leaf, bit for bit, with telemetry full and
  off: the reference runs with both the flight recorder and the monitor
  on, and since they only read the protocol state, the port's run with
  both off must equal the reference's leaves it carries.
- The plain ring commit with the slot taken from a tensor ``t`` equals
  the reference's ``ring_commit``, past the ring's wrap too.
- The program store's accounting on the CPU: nothing captured, the loop
  counted eager; the copy-back's rules (in-place leaves skipped, aliased
  leaves copied out first, a changed dtype raising); canonical lowering
  leaves the rows unchanged; and the repairs of this slice: a closed
  lane's epoch check per lane, ``device.resolve`` past the card count.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_sim_parity as P
from torch_sim_parity import single_thread  # noqa: F401

from repro.configs.smr import SMRConfig as JCfg
from repro.core import channel as jch
from repro.core import harness as jharness
from repro.core import netsim as jnetsim
from repro.scenarios import library as jlib
from repro_torch import device as _device
from repro_torch.configs.smr import SMRConfig
from repro_torch.core import channel as ch
from repro_torch.core import compile_cache, experiment, harness
from repro_torch.core import workload as wlmod
from repro_torch.core.experiment import SweepSpec, run_sweep
from repro_torch.scenarios import library

PROTOCOLS = ("mandator-sporades", "mandator-paxos", "multipaxos",
             "mandator")
SIM_S = 0.3
TICKS = 40
SCENS = ("baseline", "leader-crash-recover")
WORKLOADS = {"trivial": (None,), "table": ("onoff-burst",),
             "closed": ("closed-loop", "onoff-burst")}
CPU = torch.device("cpu")


def _reference(protocol, wl_names, cfg_kw):
    """The reference's scan of TICKS ticks over SCENS x ``wl_names`` (one
    vmapped program), its arrival counts logged. Returns (final state as
    flat numpy leaves per part, trace, draws [B, TICKS, n])."""
    from repro import workloads as jwlc
    from repro.core import workload as jwl
    from repro.workloads import library as jwlib
    jbase = JCfg(sim_seconds=SIM_S, **cfg_kw)
    scens = [jlib.get(x, SIM_S) for x in SCENS]
    jwls = [jwlib.get(x, SIM_S) if x else None for x in wl_names]
    jcfg = jnetsim.resolve_horizon(jbase, scens)
    n_windows = max(int(jnetsim.build_env(jcfg, s)["alive_tab"].shape[0])
                    for s in scens)
    envs = [jnetsim.build_env(jcfg, s, n_windows) for s in scens]
    pad = max(jwlc.compile.n_windows(jcfg, w) for w in jwls)
    tabs = [{k: v for k, v in jwlc.lower(jcfg, w, pad_windows=pad).items()
             if k != "win_start"} for w in jwls]
    mode = jwlc.mode_of([jwlc.lower(jcfg, w) for w in jwls])
    lanes = [(fi, wi) for fi in range(len(scens))
             for wi in range(len(jwls))]
    env_b = jax.tree.map(lambda *xs: jnp.stack(xs),
                         *[envs[fi] for fi, _ in lanes])
    wl_b = jax.tree.map(lambda *xs: jnp.stack(xs),
                        *[tabs[wi] for _, wi in lanes])
    lam = jnp.float32(np.float32(P.RATE / 1000.0 / P.N))
    init_workload, arrive = P._arrive_logged(jwl, jwlc)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jwl, "init_workload", init_workload)
        mp.setattr(jwl, "arrive", arrive)
        body = jax.jit(jax.vmap(lambda env, wlt: jharness._scan_body(
            protocol, jcfg, TICKS, lam, env, jnp.int32(P.SEED), wlt,
            mode)))
        state, trace = jax.tree.map(np.asarray, body(env_b, wl_b))
    part = "p" if protocol == "multipaxos" else "m"
    draws = np.ascontiguousarray(
        state[part]["wl"].pop("cnt_log").transpose(0, 2, 1))
    if protocol == "mandator-paxos":
        state["p"]["wl"].pop("cnt_log")
    return ({k: dict(P._leaves(sub)) for k, sub in state.items()}, trace,
            draws)


def _port(protocol, wl_names, cfg_kw, draws):
    """The port's loop over the same lanes from the reference's counts."""
    from repro_torch.workloads import library as wlib
    spec = SweepSpec(rates=(P.RATE,), seeds=(P.SEED,),
                     scenarios=tuple(library.get(x, SIM_S) for x in SCENS),
                     workloads=tuple(wlib.get(x, SIM_S) if x else None
                                     for x in wl_names))
    base = SMRConfig(sim_seconds=SIM_S, **cfg_kw)
    _, cfg, mode, env, rate_b, _ = experiment._lower(base, spec, CPU)
    wlt = harness._lane_tables(experiment._lower_workloads(cfg, spec),
                               spec.size, CPU)
    arr = wlmod.Arrivals(
        torch.from_numpy(draws), mode, None if mode.trivial else wlt,
        torch.from_numpy(rate_b), None,
        torch.zeros(spec.size, dtype=torch.bool) if mode.closed else None)
    st, trace = harness._scan_body(protocol, cfg, TICKS, env, arr,
                                   spec.size, CPU)
    return ({k: {n: v.numpy() for n, v in P._leaves(sub)}
             for k, sub in st.items()},
            {k: v.numpy() for k, v in trace.items()})


@pytest.mark.parametrize("mode", list(WORKLOADS))
@pytest.mark.parametrize("protocol", PROTOCOLS)
def test_device_tick_matches_reference(protocol, mode):
    full = dict(trace_level="full", monitor_level="full")
    ref_state, ref_trace, draws = _reference(protocol, WORKLOADS[mode], full)
    for cfg_kw in (full, {}):
        state, trace = _port(protocol, WORKLOADS[mode], cfg_kw, draws)
        ref = {part: {k: v for k, v in ref_state[part].items()
                      if k in state[part]}
               for part in ref_state if part in state}
        P.assert_state_bitwise({"ref_state": ref, "port_state": state})
        for k in trace:
            if k in ref_trace:
                np.testing.assert_array_equal(ref_trace[k], trace[k],
                                              err_msg=k)
    part = "p" if protocol == "multipaxos" else "m"
    assert "mon" in ref_state and "tr.buf" in ref_state[part]


@pytest.mark.parametrize("layout", ["sporades", "additive"])
def test_plain_commit_with_tensor_slot_matches_reference(layout):
    """The plain commit and the slot pop take the slot from a 0-dim int32
    tensor ``t``; over 3 laps of a 16-slot ring (so t % D wraps) they
    equal the reference's ``ring_commit`` (jnp path) and ``ring_deliver``
    bit for bit, and never move ``t``."""
    import test_torch_channel_ring as R
    channels, names = R.LAYOUTS[layout]
    jspec, tspec = R._specs(channels)
    rng = np.random.RandomState(5)
    dmax, n = 16, 5
    ring_j = jch.make_ring(jspec, dmax, n)
    ring_t = ch.make_ring(tspec, dmax, n, 1, CPU)
    for t in range(3 * dmax):
        tt = torch.tensor(t, dtype=torch.int32)
        want = jch.ring_deliver(jspec, ring_j, jnp.int32(t))
        got = ch.ring_deliver(tspec, ring_t, tt)
        for name, (fl, pay) in want.items():
            np.testing.assert_array_equal(np.asarray(fl), got[name][0][0])
            np.testing.assert_array_equal(R._bits(pay),
                                          R._bits(got[name][1][0]))
        sends, drop = R._traffic(rng, tspec, names, n, dmax, 1)
        ring_j = jch.ring_commit(
            jspec, ring_j, jnp.int32(t),
            [jch.Send(nm, jnp.asarray(p[0]), jnp.asarray(d[0]),
                      jnp.asarray(m[0])) for nm, p, d, m in sends],
            drop=jnp.asarray(drop[0]), backend="jnp")
        ring_t = ch.ring_commit(
            tspec, ring_t, tt,
            [ch.Send(nm, torch.from_numpy(p), torch.from_numpy(d),
                     torch.from_numpy(m)) for nm, p, d, m in sends],
            drop=torch.from_numpy(drop), backend="ref")
        assert int(tt) == t
        np.testing.assert_array_equal(R._bits(ring_j["buf"]),
                                      R._bits(ring_t["buf"][0].numpy()),
                                      err_msg=f"t={t}")


def test_cpu_runs_are_eager_and_counted():
    compile_cache.reset_stats()
    experiment.reset_capture_counts()
    cfg = SMRConfig(sim_seconds=0.05, delay_horizon_ticks=256)
    rows = run_sweep("multipaxos", cfg, SweepSpec(rates=(10_000,)),
                     device="cpu")
    assert rows[0]["committed"] >= 0
    s = compile_cache.stats()
    assert (s["captures"], s["replays"], s["graph_runs"], s["hits"]) == \
        (0, 0, 0, 0)
    assert (s["eager_runs"], s["eager_ticks"]) == (1, 50)
    rep = experiment.compile_report()
    assert rep["captures"] == {} and rep["programs"] == {"multipaxos": 1}
    (sig,) = rep["signatures"]["multipaxos"]
    assert (sig.ticks, sig.lanes, sig.horizon, sig.trivial) == \
        (50, 1, 256, True)
    d = compile_cache.delta(s)
    assert not any(d.values())


def test_cpu_loop_never_reaches_the_graph(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the CPU loop reached the tick graph")
    monkeypatch.setattr(compile_cache, "run", refuse)
    monkeypatch.setattr(compile_cache, "start", refuse)
    run_sweep("mandator", SMRConfig(sim_seconds=0.05,
                                    delay_horizon_ticks=256),
              SweepSpec(rates=(10_000,)), device="cpu")


def test_copy_back_rules():
    """Inside a capture the static carry takes the tick's new leaves: a
    leaf updated in place is skipped, a leaf that is another static leaf
    (or a view of one) is copied out before any buffer is written, and a
    leaf whose dtype or shape changed raises."""
    a = torch.arange(4.0)
    b = torch.full((4,), 10.0)
    ring = torch.zeros(3)
    static = {"a": a, "b": b, "ring": ring, "none": None}
    ring += 1                                    # updated in place
    compile_cache._copy_back(static, {"a": b, "b": a[[1, 0, 3, 2]] * 0 + b,
                                      "ring": ring, "none": None})
    assert torch.equal(static["a"], torch.full((4,), 10.0))
    assert torch.equal(static["b"], torch.full((4,), 10.0))
    static = {"a": torch.arange(4.0), "b": torch.full((4,), 10.0)}
    compile_cache._copy_back(static, {"a": static["b"], "b": static["a"]})
    assert torch.equal(static["a"], torch.full((4,), 10.0))
    assert torch.equal(static["b"], torch.arange(4.0))
    with pytest.raises(ValueError, match="returns"):
        compile_cache._copy_back({"a": torch.zeros(2)},
                                 {"a": torch.zeros(2, dtype=torch.int32)})
    with pytest.raises(ValueError, match="structure"):
        compile_cache._copy_back({"a": torch.zeros(2)}, {"b": torch.zeros(2)})


def test_canonical_lowering_leaves_rows_unchanged():
    """Window tables padded to 32 rows and a ring of at least 256 slots
    give the same rows, bit for bit, as the exact shapes."""
    cfg = SMRConfig(sim_seconds=0.4)
    spec = SweepSpec(rates=(100_000,), scenarios=(
        None, library.get("leader-crash-recover", 0.4)))
    _, c1, _, env, _, _ = experiment._lower(cfg, spec, CPU, canonical=True)
    _, c0, _, env0, _, _ = experiment._lower(cfg, spec, CPU)
    assert env["alive_tab"].shape[1] == 32 > env0["alive_tab"].shape[1]
    assert c1.delay_horizon_ticks >= max(256, c0.delay_horizon_ticks)
    a = run_sweep("mandator-sporades", cfg, spec, device="cpu")
    b = run_sweep("mandator-sporades", cfg, spec, device="cpu",
                  canonical=False)
    for x, y in zip(a, b):
        for k in ("throughput", "median_ms", "p99_ms", "committed",
                  "timeline", "cvc_all", "commit_key"):
            u, v = np.asarray(x[k]), np.asarray(y[k])
            if u.dtype.kind == "f":
                u, v = (w.astype(np.float32).view(np.uint32)
                        for w in (u, v))
            np.testing.assert_array_equal(u, v, err_msg=k)


def test_signature_matches_the_reference():
    """The port's ProgramSignature equals the reference's ``_lower(...)
    [-1]`` field by field where they mean the same thing: the lanes are
    the grid's width (the reference's non-canonical lowering's), the rest
    the canonical lowering's."""
    from repro.core import experiment as jexp
    from repro.scenarios import library as jlibrary
    from repro.workloads import library as jwlib
    from repro_torch.workloads import library as wlib
    for wl in (None, "onoff-burst"):
        jspec = jexp.SweepSpec(
            rates=(50_000.0, 300_000.0),
            scenarios=(None, jlibrary.get("symmetric-partition", 2.0)),
            workloads=(jwlib.get(wl, 2.0) if wl else None,))
        spec = SweepSpec(
            rates=(50_000.0, 300_000.0),
            scenarios=(None, library.get("symmetric-partition", 2.0)),
            workloads=(wlib.get(wl, 2.0) if wl else None,))
        ref = jexp._lower(JCfg(sim_seconds=2.0), jspec)[-1]
        ref_lanes = jexp._lower(JCfg(sim_seconds=2.0), jspec,
                                canonical=False)[-1].lanes
        got = experiment._signature(SMRConfig(sim_seconds=2.0), spec)
        for f in dataclasses.fields(ref):
            want = ref_lanes if f.name == "lanes" else getattr(ref, f.name)
            assert getattr(got, f.name) == want, (wl, f.name)
        assert got.epoch_slots == 0


def test_epoch_check_reads_each_lanes_own_stream():
    """A closed lane whose stream is shorter than its neighbour's (its
    row padded with +inf) is checked against its own last epoch: running
    past it raises, where a check of the last column alone saw +inf."""
    from repro_torch.workloads.compile import WorkloadMode
    epochs = torch.full((2, 1, 8), float("inf"), dtype=torch.float64)
    epochs[0, 0] = torch.arange(1.0, 9.0)
    epochs[1, 0, :3] = torch.arange(1.0, 4.0)
    arr = wlmod.Arrivals(None, WorkloadMode(trivial=False, closed=True),
                         epochs=epochs)
    wl = {"cl_lam_cum": torch.tensor([[5.0], [2.5]], dtype=torch.float64)}
    wlmod.check_epochs(wl, arr)
    wl["cl_lam_cum"][1, 0] = 3.0
    with pytest.raises(RuntimeError, match="epoch stream"):
        wlmod.check_epochs(wl, arr)
    assert wlmod.epoch_slots(1) == 64 and wlmod.epoch_slots(65) == 128


def test_resolve_refuses_a_card_index_past_the_count(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert _device.resolve("cuda:0") == torch.device("cuda:0")
    with pytest.raises(RuntimeError, match="1 CUDA device"):
        _device.resolve("cuda:1")


def test_tick_index():
    t = torch.tensor(3, dtype=torch.int32)
    assert _device.tick_index(t, CPU) is t
    x = _device.tick_index(7, CPU)
    assert x.dtype == torch.int32 and x.dim() == 0 and int(x) == 7
    with pytest.raises(ValueError, match=">= 0"):
        _device.tick_index(-1, CPU)
    spec = ch.RingSpec(ch.ChannelSpec("a", 1))
    with pytest.raises(ValueError, match=">= 0"):
        ch.ring_commit(spec, ch.make_ring(spec, 4, 2, 1, CPU), -1, [])
