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


def jax_draw_table(seed: int = SEED, ticks: int = T) -> np.ndarray:
    """[T, n] the reference's per-tick Poisson draws for one lane."""
    base = jax.random.PRNGKey(seed)
    lam = jnp.broadcast_to(jnp.float32(LAM), (N,))
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
    bool and float alike (floats compared as their bits)."""
    ref, got = runs["ref_state"], runs["port_state"]
    assert ref.keys() == got.keys()
    for part in ref:
        assert ref[part].keys() == got[part].keys(), part
        for name, r in ref[part].items():
            g = got[part][name]
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
