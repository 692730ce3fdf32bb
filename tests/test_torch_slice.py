"""The port's main path end to end against the JAX reference, on the CPU,
with the reference's own arrival draws replayed into the port.

The reference draws arrivals inside its scan from
``poisson(fold_in(PRNGKey(seed), t), lam)``; open-loop ``lam`` does not
depend on state, so the test computes that table with JAX up front (and
checks it once against the draws the reference's ``workload.arrive`` makes
in a scan), then runs both packages on ``baseline`` and
``leader-crash-recover`` at n=5, 1.5 s, 100k tx/s:

- cvc_all, commit_key, views and async_frac: bitwise equal;
- throughput: relative error <= 1e-6 (XLA and torch sum in another order);
- median_ms / p99_ms: equal, or one sorted neighbour apart (the quantile
  CDF is a float32 cumsum, whose association differs between XLA-CPU and
  torch; batch counts are fractional, so the last ulp may move the
  searchsorted index by one);
- timeline: within 1e-6 relative of its largest bucket.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs.smr import SMRConfig as JCfg
from repro.core import workload as jworkload
from repro.core.experiment import SweepSpec as JSpec
from repro.core.experiment import run_sweep as jax_run_sweep
from repro.scenarios import library as jlib
from repro_torch.configs.smr import SMRConfig
from repro_torch.core.experiment import SweepSpec, run_sweep
from repro_torch.scenarios import library

SIM_S = 1.5
RATE = 100_000.0
SEED = 0
N = 5
T = int(SIM_S * 1000)
NAMES = ("baseline", "leader-crash-recover")
LAM = np.float32(RATE / 1000.0 / N)


def jax_draw_table(seed: int) -> np.ndarray:
    """[T, n] the reference's per-tick Poisson draws for one lane."""
    base = jax.random.PRNGKey(seed)
    lam = jnp.broadcast_to(jnp.float32(LAM), (N,))
    draw = lambda t: jax.random.poisson(  # noqa: E731
        jax.random.fold_in(base, t), lam).astype(jnp.float32)
    return np.asarray(jax.lax.map(draw, jnp.arange(T, dtype=jnp.int32)))


@pytest.fixture(scope="module")
def runs():
    table = jax_draw_table(SEED)
    ref = jax_run_sweep(
        "mandator-sporades", JCfg(sim_seconds=SIM_S),
        JSpec(rates=(RATE,), seeds=(SEED,),
              scenarios=tuple(jlib.get(x, SIM_S) for x in NAMES)))
    port = run_sweep(
        "mandator-sporades", SMRConfig(sim_seconds=SIM_S),
        SweepSpec(rates=(RATE,), seeds=(SEED,),
                  scenarios=tuple(library.get(x, SIM_S) for x in NAMES)),
        device="cpu", draws=np.stack([table] * len(NAMES)))
    return table, ref, port


def test_draw_table_equals_in_scan_draws(runs):
    """The replayed table equals what the reference's workload.arrive adds
    to its buffer, tick by tick, under the harness's key derivation."""
    table = runs[0]
    cfg = JCfg(sim_seconds=SIM_S)

    @jax.jit
    def scan(seed):
        base = jax.random.PRNGKey(seed)
        wl0 = jworkload.init_workload(cfg, 4)

        def step(wl, t):
            new = jworkload.arrive(wl, jax.random.fold_in(base, t), t,
                                   jnp.float32(LAM), jnp.ones((N,), bool))
            return new, new["buffer"] - wl["buffer"]

        return jax.lax.scan(step, wl0, jnp.arange(T, dtype=jnp.int32))[1]

    np.testing.assert_array_equal(np.asarray(scan(jnp.int32(SEED))), table)


@pytest.mark.parametrize("i", range(len(NAMES)), ids=NAMES)
def test_protocol_traces_bitwise(runs, i):
    _, ref, port = runs
    r, p = ref[i], port[i]
    np.testing.assert_array_equal(np.asarray(r["cvc_all"]), p["cvc_all"])
    np.testing.assert_array_equal(np.asarray(r["commit_key"]),
                                  p["commit_key"])
    assert r["views"] == p["views"]
    assert r["async_frac"] == p["async_frac"]
    if NAMES[i] == "leader-crash-recover":
        assert p["async_frac"] > 0 and p["views"] >= 1
    else:
        assert p["async_frac"] == 0.0


def _port_latencies(table, i):
    """Sorted distinct latencies (ms) of the batches the port's quantiles
    weigh for point i, from the port's own pipeline."""
    import torch

    from repro_torch.core import experiment, harness
    spec = SweepSpec(rates=(RATE,), seeds=(SEED,),
                     scenarios=(library.get(NAMES[i], SIM_S),))
    _, cfg, _, env, _, _ = experiment._lower(
        SMRConfig(sim_seconds=SIM_S), spec, torch.device("cpu"))
    st, trace = harness._scan_body("mandator-sporades", cfg, T, env,
                                   torch.from_numpy(table[None]), 1,
                                   torch.device("cpu"))
    wl = st["m"]["wl"]
    commit_t = harness._vc_commit_ticks(trace["cvc"], T)
    ok = (torch.isfinite(commit_t) & (wl["batch_count"] > 0)
          & (commit_t >= 0.15 * T))
    return np.unique(((commit_t - wl["batch_arr_mean"]) * 1.0)[ok].numpy())


def _one_neighbour_apart(ref_v, got_v, lat_sorted):
    i, j = (np.searchsorted(lat_sorted, v) for v in (ref_v, got_v))
    return (ref_v in lat_sorted and got_v in lat_sorted
            and abs(int(i) - int(j)) <= 1)


@pytest.mark.parametrize("i", range(len(NAMES)), ids=NAMES)
def test_metrics_within_stated_tolerance(runs, i):
    table, ref, port = runs
    r, p = ref[i], port[i]
    assert p["committed"] > 0
    assert abs(p["throughput"] - r["throughput"]) <= 1e-6 * r["throughput"]
    assert abs(p["committed"] - r["committed"]) <= 1e-6 * r["committed"]
    for k in ("median_ms", "p99_ms"):
        if r[k] != p[k]:
            lat = _port_latencies(table, i)
            assert _one_neighbour_apart(np.float32(r[k]), np.float32(p[k]),
                                        lat), (k, r[k], p[k])
    tl_r, tl_p = np.asarray(r["timeline"]), p["timeline"]
    np.testing.assert_allclose(tl_p, tl_r, rtol=0,
                               atol=1e-6 * float(np.max(tl_r)))


def test_row_keys_equal_reference(runs):
    """A mandator-sporades row carries exactly the reference's keys."""
    _, ref, port = runs
    for r, p in zip(ref, port):
        assert set(r) == set(p), sorted(set(r) ^ set(p))
