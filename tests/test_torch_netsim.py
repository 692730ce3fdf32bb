"""The port's host-side lowering and netsim (repro_torch.scenarios,
repro_torch.core.netsim) against the JAX reference: for every library
scenario, the lowered tables, the resolved horizon and every build_env leaf
are exactly equal; the per-tick accessors agree on a batched env."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import scenarios as jsc
from repro.configs.smr import SMRConfig as JCfg
from repro.core import netsim as jnetsim
from repro.scenarios import library as jlib
from repro_torch import scenarios as sc
from repro_torch import workloads as wlc
from repro_torch.configs.smr import SMRConfig
from repro_torch.core import netsim
from repro_torch.scenarios import library

CPU = torch.device("cpu")
SIM_S = 1.5


def _cfgs(**kw):
    return JCfg(sim_seconds=SIM_S, **kw), SMRConfig(sim_seconds=SIM_S, **kw)


@pytest.mark.parametrize("name", jlib.NAMES)
def test_lowering_horizon_and_env_match_reference(name):
    jcfg, tcfg = _cfgs()
    jtab = jsc.lower(jcfg, jlib.get(name, SIM_S))
    ttab = sc.lower(tcfg, library.get(name, SIM_S))
    assert jtab.keys() == ttab.keys()
    for k in jtab:
        assert jtab[k].dtype == ttab[k].dtype, k
        np.testing.assert_array_equal(jtab[k], ttab[k], err_msg=k)
    # the reference's canonical=True floor serves its XLA compile cache,
    # which the port does not have
    assert (jnetsim.resolve_horizon(jcfg, tabs=[jtab], canonical=False)
            .delay_horizon_ticks
            == netsim.resolve_horizon(tcfg, tabs=[ttab]).delay_horizon_ticks)
    jenv = jnetsim.build_env(jcfg, jlib.get(name, SIM_S), n_windows=40)
    tenv = netsim.build_env(tcfg, library.get(name, SIM_S), n_windows=40,
                            device=CPU)
    assert jenv.keys() == tenv.keys()
    for k in jenv:
        j = np.asarray(jenv[k])
        t = tenv[k].numpy()
        assert j.dtype == t.dtype and j.shape == t.shape, k
        np.testing.assert_array_equal(j, t, err_msg=k)


def test_pinned_horizon_too_small_raises():
    _, tcfg = _cfgs(delay_horizon_ticks=64)
    with pytest.raises(ValueError, match="delay_horizon_ticks"):
        netsim.build_env(tcfg, library.get("leader-ddos", SIM_S), device=CPU)


def test_accessors_match_reference_on_batched_env():
    """alive / link_delay / link_drop / nic_rate / egress_delay of a B=3
    env (three scenarios) equal the reference's per-lane values,
    bitwise."""
    jcfg, tcfg = _cfgs()
    names = ("baseline", "gray-wan", "throttled-nic")
    jenvs = [jnetsim.build_env(jcfg, jlib.get(x, SIM_S), n_windows=40)
             for x in names]
    env = netsim.stack_envs([netsim.build_env(tcfg, library.get(x, SIM_S),
                                              n_windows=40, device=CPU)
                             for x in names])
    rng = np.random.RandomState(0)
    for t in (0, 300, 777, 1499):
        for jfn, tfn in ((jnetsim.alive, netsim.alive),
                         (jnetsim.link_delay, netsim.link_delay),
                         (jnetsim.link_drop, netsim.link_drop),
                         (jnetsim.nic_rate, netsim.nic_rate)):
            got = tfn(env, t).numpy()
            for b, jenv in enumerate(jenvs):
                np.testing.assert_array_equal(
                    np.asarray(jfn(jenv, jnp.int32(t))), got[b])
        busy = rng.uniform(t - 5, t + 5, (3, 5)).astype(np.float32)
        # as in the simulator, a sender puts the same bytes on every link
        # (the reference's cumsum associates in another order than
        # torch's, which only rows of distinct values could tell apart)
        out = np.repeat(rng.uniform(0, 3, (3, 5, 1)), 5, axis=2
                        ).astype(np.float32)
        tb, td = netsim.egress_delay(torch.from_numpy(busy), t,
                                     torch.from_numpy(out))
        for b in range(3):
            jb, jd = jnetsim.egress_delay(jnp.asarray(busy[b]), jnp.int32(t),
                                          jnp.asarray(out[b]))
            np.testing.assert_array_equal(np.asarray(jb), tb[b].numpy())
            np.testing.assert_array_equal(np.asarray(jd), td[b].numpy())


def test_trivial_workload_lowering_matches_reference():
    from repro import workloads as jwl
    jcfg, tcfg = _cfgs()
    jt, tt = jwl.lower(jcfg, None), wlc.lower(tcfg, None)
    for k in jt:
        np.testing.assert_array_equal(np.asarray(jt[k]), np.asarray(tt[k]))
    assert wlc.mode_of([tt]) == wlc.TRIVIAL_MODE
