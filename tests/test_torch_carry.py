"""State carry-over: run the reference's ticks for 300 steps, carry env and
state across with repro_torch.convert, run 200 more ticks in both packages
on the same arrival draws, and require equal state: every leaf bitwise,
integer, bool and float alike (rounds, views, vector clocks, commit keys,
ring contents, and the request arrival-time sums buffer_tsum and
batch_arr_mean). XLA on the CPU contracts the reference's
``buffer_tsum - buffer_tsum * frac`` (workload.form_batches) into one fused
multiply-add; the port computes that remainder in float64 and rounds it
once to float32, which gives the same bits. The scenario crashes the
leader at 50 ms, so the 200 carried ticks include the view timeout and the
asynchronous path."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs.smr import SMRConfig as JCfg
from repro.core import mandator as jmandator
from repro.core import netsim as jnetsim
from repro.core import sporades as jsporades
from repro.scenarios import Crash as JCrash
from repro.scenarios import Scenario as JScenario
from repro_torch import convert
from repro_torch.configs.smr import SMRConfig
from repro_torch.core import harness

SIM_S = 0.5
T = int(SIM_S * 1000)
T0 = 300
RATE = 100_000.0
SEED = 3
N = 5


def _jax_run(cfg, env, rate, st, t0, t1):
    base = jax.random.PRNGKey(SEED)

    def step(carry, t):
        key = jax.random.fold_in(base, t)
        m = jmandator.tick(carry["m"], t, key, env, cfg, rate)
        s = jsporades.tick(carry["s"], t, env, cfg,
                           jmandator.get_client_requests(m))
        return {"m": m, "s": s}, None

    run = jax.jit(lambda c: jax.lax.scan(
        step, c, jnp.arange(t0, t1, dtype=jnp.int32))[0])
    return run(st)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def test_state_carry_over_matches_reference():
    scen = JScenario("crash-early", (JCrash(0.05, targets="leader",
                                            end_s=0.45),))
    jcfg = jnetsim.resolve_horizon(JCfg(sim_seconds=SIM_S), [scen])
    env = jnetsim.build_env(jcfg, scen)
    rate = jnp.float32(RATE / 1000.0 / N)
    st = {"m": jmandator.init_state(jcfg, T),
          "s": jsporades.init_state(jcfg, T)}
    st = _jax_run(jcfg, env, rate, st, 0, T0)

    port = convert.state_from_reference(jax.tree.map(np.asarray, st),
                                        device="cpu")
    penv = convert.env_from_reference(jax.tree.map(np.asarray, env),
                                      device="cpu")
    pcfg = dataclasses.replace(SMRConfig(sim_seconds=SIM_S),
                               delay_horizon_ticks=jcfg.delay_horizon_ticks)

    # the reference's arrival draws for the carried ticks
    base = jax.random.PRNGKey(SEED)
    lam = jnp.broadcast_to(rate, (N,))
    draws = np.zeros((1, T, N), np.float32)
    draws[0, T0:] = np.asarray(jax.lax.map(
        lambda t: jax.random.poisson(jax.random.fold_in(base, t),
                                     lam).astype(jnp.float32),
        jnp.arange(T0, T, dtype=jnp.int32)))
    draws = torch.from_numpy(draws)

    st = _jax_run(jcfg, env, rate, st, T0, T)
    for t in range(T0, T):
        port = harness.step(port, t, draws, penv, pcfg)

    ref = jax.tree.map(np.asarray, st)
    got = convert.state_to_numpy(port)
    assert bool(np.any(ref["s"]["is_async"])) or int(
        np.max(ref["s"]["v_cur"])) > 0, "scenario never left view 0"
    ref_leaves = dict(_leaves(ref))
    got_leaves = dict(_leaves(got))
    assert ref_leaves.keys() == got_leaves.keys()
    for name, r in ref_leaves.items():
        g = got_leaves[name][0]
        if name == "s.coins":
            r = r.astype(np.int64)
        assert r.dtype == g.dtype, name
        np.testing.assert_array_equal(r, g, err_msg=name)
