"""Shared harness of the scan-protocol parity tests (test_torch_paxos.py,
test_torch_mandator_alone.py): one protocol on several scenarios, run by
the JAX reference and by the port on the CPU from the reference's own
arrival draws.

The reference draws arrivals inside its scan from
``poisson(fold_in(PRNGKey(seed), t), lam)``; open-loop ``lam`` does not
depend on state, so the table is computed with JAX up front and replayed
into the port (tests/test_torch_slice.py checks the table against the
draws ``workload.arrive`` makes in a scan). Each protocol runs:

- the reference's ``_scan_body`` (final carry and per-tick trace) on the
  scenarios stacked as lanes of one vmapped program, beside the port's
  ``harness._scan_body`` on the same lanes;
- the reference's ``run_sweep`` beside the port's, for the result rows.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.smr import SMRConfig as JCfg
from repro.core import harness as jharness
from repro.core import netsim as jnetsim
from repro.core.experiment import SweepSpec as JSpec
from repro.core.experiment import run_sweep as jax_run_sweep
from repro.scenarios import library as jlib
from repro_torch.configs.smr import SMRConfig
from repro_torch.core import experiment, harness
from repro_torch.core.experiment import SweepSpec, run_sweep
from repro_torch.scenarios import library

SIM_S = 1.5
RATE = 100_000.0
SEED = 0
N = 5
T = int(SIM_S * 1000)
LAM = np.float32(RATE / 1000.0 / N)


@pytest.fixture(autouse=True, scope="module")
def single_thread():
    """Run a module's tests on one torch thread (import this fixture into
    the module to use it). The test workers share the CPU, and torch's
    intra-op pools, one thread per core in every worker, then wait on each
    other: with the monitor on, a 0.5 s mandator-paxos run took 175 s in
    each of six processes started together, and 2.2 s on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jax_draw_table(seed: int = SEED, ticks: int = T, lam=LAM,
                   n: int = N) -> np.ndarray:
    """[T, n] the reference's per-tick Poisson draws for one lane at
    ``lam`` arrivals a tick and replica."""
    base = jax.random.PRNGKey(seed)
    lam = jnp.broadcast_to(jnp.float32(lam), (n,))
    draw = lambda t: jax.random.poisson(  # noqa: E731
        jax.random.fold_in(base, t), lam).astype(jnp.float32)
    return np.asarray(jax.lax.map(draw, jnp.arange(ticks, dtype=jnp.int32)))


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def run_both(protocol: str, names) -> dict:
    """Reference and port on ``names`` (scenario library names), SIM_S s at
    RATE, seed SEED. Returns {"ref_state", "ref_trace", "port_state",
    "port_trace" (numpy, leading lane axis = scenario), "ref_rows",
    "port_rows"}."""
    table = jax_draw_table()
    draws = np.stack([table] * len(names))
    scens = [jlib.get(x, SIM_S) for x in names]
    jcfg = jnetsim.resolve_horizon(JCfg(sim_seconds=SIM_S), scens)
    n_windows = max(int(jnetsim.build_env(jcfg, s)["alive_tab"].shape[0])
                    for s in scens)
    envs = [jnetsim.build_env(jcfg, s, n_windows) for s in scens]
    env_b = jax.tree.map(lambda *xs: jnp.stack(xs), *envs)
    body = jax.jit(jax.vmap(lambda env: jharness._scan_body(
        protocol, jcfg, T, jnp.float32(LAM), env, jnp.int32(SEED))))
    ref_state, ref_trace = jax.tree.map(np.asarray, body(env_b))

    spec = SweepSpec(rates=(RATE,), seeds=(SEED,),
                     scenarios=tuple(library.get(x, SIM_S) for x in names))
    dev = torch.device("cpu")
    _, cfg, _, env, _, _ = experiment._lower(SMRConfig(sim_seconds=SIM_S),
                                             spec, dev)
    assert cfg.delay_horizon_ticks == jcfg.delay_horizon_ticks
    st, trace = harness._scan_body(protocol, cfg, T, env,
                                   torch.from_numpy(draws), len(names), dev)
    to_np = lambda x: x.numpy()  # noqa: E731
    port_state = {k: dict((n, to_np(v)) for n, v in _leaves(sub))
                  for k, sub in st.items()}
    port_trace = {k: to_np(v) for k, v in trace.items()}

    ref_rows = jax_run_sweep(
        protocol, JCfg(sim_seconds=SIM_S),
        JSpec(rates=(RATE,), seeds=(SEED,), scenarios=tuple(scens)))
    port_rows = run_sweep(protocol, SMRConfig(sim_seconds=SIM_S), spec,
                          device="cpu", draws=draws)
    ref_state = {k: dict(_leaves(sub)) for k, sub in ref_state.items()}
    return {"ref_state": ref_state, "ref_trace": ref_trace,
            "port_state": port_state, "port_trace": port_trace,
            "ref_rows": ref_rows, "port_rows": port_rows}


def assert_state_bitwise(runs: dict) -> None:
    """Every carried leaf of the final state equal bit for bit, integer,
    bool and float alike (floats compared as their bits). Two leaves
    differ by design: the port's sporades coin table is int64 (its values
    are compared), and its trace rings hold one spill slot past ``cap``
    (``obs.trace``; compared without it). The port's closed-loop sampler
    state (``wl.cl_lam_cum``, ``wl.cl_drawn``) has no reference leaf: a
    replay leaves it at zero."""
    ref, got = runs["ref_state"], runs["port_state"]
    sampler = ("wl.cl_lam_cum", "wl.cl_drawn")
    got = {part: {k: v for k, v in leaves.items() if k not in sampler}
           for part, leaves in got.items()}
    assert ref.keys() == got.keys()
    for part in ref:
        assert ref[part].keys() == got[part].keys(), part
        for name, r in ref[part].items():
            g = got[part][name]
            if name == "coins":
                r = r.astype(np.int64)
            if name == "tr.buf":
                g = g[:, :, :-1]
            assert r.dtype == g.dtype, (part, name, r.dtype, g.dtype)
            if r.dtype.kind == "f":
                r, g = r.view(np.uint32), g.view(np.uint32)
            np.testing.assert_array_equal(r, g, err_msg=f"{part}.{name}")


def assert_trace_bitwise(runs: dict, key: str) -> None:
    np.testing.assert_array_equal(runs["ref_trace"][key],
                                  runs["port_trace"][key], err_msg=key)


def _one_neighbour_apart(ref_v, got_v, lat_sorted) -> bool:
    i, j = (np.searchsorted(lat_sorted, v) for v in (ref_v, got_v))
    return (ref_v in lat_sorted and got_v in lat_sorted
            and abs(int(i) - int(j)) <= 1)


def assert_metrics(runs: dict, i: int, lat_sorted=None) -> None:
    """Point i's metrics within tests/test_torch_slice.py's tolerances:
    throughput and committed within 1e-6 relative; median_ms and p99_ms
    equal, or one sorted neighbour apart among ``lat_sorted`` (the
    weighed latencies); the timelines within 1e-6 of their largest
    bucket; the per-origin quantiles bitwise."""
    r, p = runs["ref_rows"][i], runs["port_rows"][i]
    for k in ("throughput", "committed"):
        assert abs(p[k] - r[k]) <= 1e-6 * abs(r[k]), (k, r[k], p[k])
    for k in ("median_ms", "p99_ms"):
        if not (r[k] == p[k] or (np.isnan(r[k]) and np.isnan(p[k]))):
            assert lat_sorted is not None and _one_neighbour_apart(
                np.float32(r[k]), np.float32(p[k]), lat_sorted), (k, r[k],
                                                                 p[k])
    for k in ("timeline", "origin_timeline"):
        tl_r, tl_p = np.asarray(r[k]), np.asarray(p[k])
        np.testing.assert_allclose(tl_p, tl_r, rtol=0,
                                   atol=1e-6 * float(np.max(tl_r)),
                                   err_msg=k)
    for k in ("origin_median_ms", "origin_p99_ms"):
        np.testing.assert_array_equal(np.asarray(r[k]), p[k], err_msg=k)


def port_latencies(runs: dict, protocol: str, i: int) -> np.ndarray:
    """Sorted distinct latencies (ms) of the batches the port's quantiles
    weigh for point i, from the port's own final state and trace."""
    wl = runs["port_state"]["p" if protocol == "multipaxos" else "m"]
    key = {"multipaxos": "committed_slot", "mandator": "own_round"}.get(
        protocol, "cvc")
    commit_t = harness._vc_commit_ticks(
        torch.from_numpy(runs["port_trace"][key][i:i + 1]), T)[0].numpy()
    count = wl["wl.batch_count"][i]
    ok = np.isfinite(commit_t) & (count > 0) & (commit_t >= 0.15 * T)
    return np.unique((commit_t - wl["wl.batch_arr_mean"][i])[ok])


def row_keys_equal(runs: dict) -> None:
    for r, p in zip(runs["ref_rows"], runs["port_rows"]):
        assert set(r) == set(p), (sorted(set(r) ^ set(p)))


# ---------------------------------------------------------------------------
# workloads: table and closed mode, with the reference's counts replayed
# ---------------------------------------------------------------------------

def _arrive_logged(jwl, jwlc):
    """The reference's ``init_workload`` / ``arrive`` with each tick's
    arrival count (after the alive mask and, in closed mode, the cap)
    written into an extra ``cnt_log`` [n, T] leaf of ``wl``. ``arrive``
    is the reference's body (src/repro/core/workload.py), unchanged but
    for the log line; the protocols call both through the module, so
    monkeypatching the module takes."""
    orig_init = jwl.init_workload

    def init_workload(cfg, n_ticks, closed=False):
        wl = orig_init(cfg, n_ticks, closed=closed)
        wl["cnt_log"] = jnp.zeros((cfg.n_replicas, n_ticks), jnp.float32)
        return wl

    def arrive(wl, key, t, rate_per_tick, alive, wlt=None,
               mode=jwlc.TRIVIAL_MODE):
        wl = dict(wl)
        if mode.trivial:
            lam = jnp.broadcast_to(rate_per_tick, alive.shape)
            cnt = jax.random.poisson(key, lam).astype(jnp.float32) * alive
        else:
            mult = wlt["rate_of"][wlt["win_of_tick"][t]]
            lam = rate_per_tick * mult
            if mode.closed:
                inflight = wl["cl_submitted"] - wl["cl_done"]
                clients = rate_per_tick * wlt["think_ticks"] * mult
                lam_cl = jnp.clip(clients - inflight, 0.0) \
                    / wlt["think_ticks"]
                lam = jnp.where(wlt["closed"] > 0, lam_cl, lam)
            cnt = jax.random.poisson(key, lam).astype(jnp.float32) * alive
            if mode.closed:
                room = jnp.clip(wlt["cap"] - inflight, 0.0)
                cnt = jnp.where(wlt["closed"] > 0, jnp.minimum(cnt, room),
                                cnt)
                wl["cl_submitted"] = wl["cl_submitted"] + cnt
        wl["buffer"] = wl["buffer"] + cnt
        wl["buffer_tsum"] = wl["buffer_tsum"] + cnt * t
        wl["cnt_log"] = wl["cnt_log"].at[:, t].set(cnt)
        return wl

    return init_workload, arrive


def run_both_workloads(protocol: str, scen_names, wl_names, sim_s=SIM_S,
                       rate=RATE, **cfg_kw) -> dict:
    """Reference and port on the grid scenarios x workloads (library
    names; lanes in ``SweepSpec.points()`` order), ``sim_s`` s at ``rate``,
    seed SEED, ``cfg_kw`` (e.g. trace_level) on both. The reference's
    scan runs with its arrival counts logged (``_arrive_logged``); the
    port replays them (``workload.Arrivals`` with those ``draws``, which
    in closed mode are the counts after the cap). Returns run_both's dict
    plus "draws" [B, T, n], "cut" (the port's cap cut a replayed count)
    and "mode"."""
    from repro import workloads as jwlc
    from repro.core import workload as jwl
    from repro.workloads import library as jwlib
    from repro_torch.core import workload as wlmod
    from repro_torch.workloads import library as wlib

    ticks = int(sim_s * 1000)
    jbase = JCfg(sim_seconds=sim_s, **cfg_kw)
    scens = [jlib.get(x, sim_s) for x in scen_names]
    jwls = [jwlib.get(x, sim_s) for x in wl_names]
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
    lam = jnp.float32(np.float32(rate / 1000.0 / N))
    init_workload, arrive = _arrive_logged(jwl, jwlc)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jwl, "init_workload", init_workload)
        mp.setattr(jwl, "arrive", arrive)
        body = jax.jit(jax.vmap(lambda env, wlt: jharness._scan_body(
            protocol, jcfg, ticks, lam, env, jnp.int32(SEED), wlt, mode)))
        ref_state, ref_trace = jax.tree.map(np.asarray, body(env_b, wl_b))
    part = "p" if protocol == "multipaxos" else "m"
    draws = np.ascontiguousarray(
        ref_state[part]["wl"].pop("cnt_log").transpose(0, 2, 1))
    if protocol == "mandator-paxos":
        ref_state["p"]["wl"].pop("cnt_log")

    spec = SweepSpec(rates=(rate,), seeds=(SEED,),
                     scenarios=tuple(library.get(x, sim_s)
                                     for x in scen_names),
                     workloads=tuple(wlib.get(x, sim_s) for x in wl_names))
    dev = torch.device("cpu")
    base = SMRConfig(sim_seconds=sim_s, **cfg_kw)
    _, cfg, pmode, env, rate_b, _ = experiment._lower(base, spec, dev)
    assert cfg.delay_horizon_ticks == jcfg.delay_horizon_ticks
    assert (pmode.trivial, pmode.closed) == (mode.trivial, mode.closed)
    wlt = harness._lane_tables(experiment._lower_workloads(cfg, spec),
                               len(lanes), dev)
    arr = wlmod.Arrivals(
        torch.from_numpy(draws), pmode, None if pmode.trivial else wlt,
        torch.from_numpy(rate_b), None,
        torch.zeros(len(lanes), dtype=torch.bool))
    st, trace = harness._scan_body(protocol, cfg, ticks, env, arr,
                                   len(lanes), dev)
    port_state = {k: dict((n, v.numpy()) for n, v in _leaves(sub))
                  for k, sub in st.items()}
    port_trace = {k: v.numpy() for k, v in trace.items()}

    ref_rows = jax_run_sweep(
        protocol, jbase,
        JSpec(rates=(rate,), seeds=(SEED,), scenarios=tuple(scens),
              workloads=tuple(jwls)))
    port_rows = run_sweep(protocol, base, spec, device="cpu", draws=draws)
    ref_state = {k: dict(_leaves(sub)) for k, sub in ref_state.items()}
    return {"ref_state": ref_state, "ref_trace": ref_trace,
            "port_state": port_state, "port_trace": port_trace,
            "ref_rows": ref_rows, "port_rows": port_rows, "draws": draws,
            "cut": arr.cut.numpy() if pmode.closed else None,
            "mode": pmode}
