"""The port's training control plane (repro_torch.runtime) against the
reference's (repro.runtime), exactly: every scenario of
tests/test_runtime.py runs through both packages, and the two must agree
on what each state machine holds and emits — Mandator's own rounds and
lastCompletedRounds, Sporades' commit records (view, round, cut, mode)
and controller views, the flight recorder's events and the health
monitor's verdicts — and on ``common_coin_flip`` for every view of a
range. The reference's own assertions run on the port's results too."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

try:
    from hypothesis import given, settings, strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:                      # degrade: only property tests skip
    HAVE_HYPOTHESIS = False

from repro.core import coin as jcoin
from repro.runtime import elastic as j_el
from repro.runtime import mandator_rt as j_mrt
from repro.runtime import sporades_rt as j_srt
from repro_torch.core import coin
from repro_torch.runtime import elastic as p_el
from repro_torch.runtime import mandator_rt as p_mrt
from repro_torch.runtime import sporades_rt as p_srt

PKGS = {"ref": (j_mrt, j_srt, j_el), "port": (p_mrt, p_srt, p_el)}


def _plain(x):
    """A comparable, exact view of a runtime value."""
    if isinstance(x, np.ndarray):
        return (str(x.dtype), x.tolist())
    if isinstance(x, (np.integer, np.floating)):
        return x.item()
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, set):
        return sorted(x)
    return x


def _record(rec):
    if rec is None:
        return None
    return {"view": rec.view, "round": rec.round, "cut": _plain(rec.cut),
            "mode": rec.mode}


def _mandator(m) -> dict:
    return {"pods": [{"own_round": p.own_round, "awaiting": p.awaiting,
                      "lcr": _plain(p.lcr),
                      "votes": {r: sorted(v) for r, v in p.votes.items()}}
                     for p in m.pods],
            "events": _plain(m.trace.events),
            "verdict": _plain(m.monitor.verdict())}


def _sporades(s, recs) -> dict:
    return {"records": [_record(r) for r in recs],
            "view": s.view, "round": s.round,
            "ctl": [{"alive": c.alive, "straggling": c.straggling,
                     "v_cur": c.v_cur, "r_cur": c.r_cur,
                     "committed": [_record(r) for r in c.committed]}
                    for c in s.ctl],
            "events": _plain(s.trace.events),
            "verdict": _plain(s.monitor.verdict())}


# -------------------------------------------- tests/test_runtime.py cases ----

def _completion_and_vc(mrt, srt, el):
    m = mrt.MandatorRuntime(5)
    first = [m.write(pod) for pod in range(5)]
    assert first == [1] * 5
    for pod in range(5):
        assert m.pods[pod].own_round == 1 and not m.pods[pod].awaiting
    second = [m.write(pod) for pod in range(5)]
    assert second == [2] * 5
    vc = m.get_client_requests(0)
    assert (vc >= 1).all() and vc[0] == 2
    return {"writes": first + second, "vc": _plain(vc), **_mandator(m)}


def _minority_drops(mrt, srt, el):
    m = mrt.MandatorRuntime(5)
    m.drop[0, 3] = m.drop[0, 4] = True
    assert m.write(0) == 1
    assert m.pods[0].own_round == 1 and m.pods[3].lcr[0] == 0
    return _mandator(m)


def _blocks_without_quorum(mrt, srt, el):
    m = mrt.MandatorRuntime(5)
    m.drop[0, 1:] = True
    r = m.write(0)
    assert m.pods[0].awaiting and m.pods[0].own_round == 0
    return {"write": r, "cut": _plain(m.committed_cut(
        [m.get_client_requests(i) for i in range(5)])), **_mandator(m)}


def _sync_path(mrt, srt, el):
    s = srt.SporadesRuntime(4)
    rec = s.commit_step({i: np.array([1, 1, 1, 1]) for i in range(4)})
    assert rec is not None and rec.mode == "sync"
    return _sporades(s, [rec])


def _async_on_leader_straggle(mrt, srt, el):
    s = srt.SporadesRuntime(4, seed=1)
    s.set_straggler(s.leader(0))
    recs = []
    for step in range(8):
        cuts = {i: np.array([step] * 4) for i in range(4) if s.ctl[i].alive}
        recs.append(s.commit_step(cuts))
    assert sum(r is not None for r in recs) >= 4
    return _sporades(s, recs)


def _no_quorum_blocks(mrt, srt, el):
    s = srt.SporadesRuntime(5)
    for i in (1, 2, 3):
        s.crash(i)
    rec = s.commit_step({0: np.zeros(5), 4: np.zeros(5)})
    assert rec is None
    return _sporades(s, [rec])


def _crash_then_recover(mrt, srt, el):
    s = srt.SporadesRuntime(3, seed=2)
    s.crash(0)
    recs = [s.commit_step({i: np.array([step] * 3) for i in (1, 2)})
            for step in range(6)]
    assert any(r is not None and r.mode == "async" for r in recs)
    s.recover(0)
    cuts = {i: np.array([9] * 3) for i in range(3)}
    for _ in range(4):
        recs.append(s.commit_step(cuts))
        if recs[-1] is not None and recs[-1].mode == "sync":
            break
    else:
        pytest.fail("sync path never resumed after recovery")
    return _sporades(s, recs)


def _elastic_replan(mrt, srt, el):
    a, b = el.replan(10, [0, 2, 3]), el.replan(10, [3, 2, 0])
    assert a == b and a.n_shards == 3
    return {"plan": [a.step, a.n_pods, list(a.pods), a.shard_of],
            "scale": el.grad_scale(3, 4)}


def _straggler_policy(mrt, srt, el):
    p = el.StragglerPolicy(deadline_ms=100.0)
    out = [p.decide(arr, 4) for arr in ({0: 10, 1: 20, 2: 30, 3: 40},
                                        {0: 10, 1: 20, 2: 30, 3: 400},
                                        {0: 10, 1: 400, 2: 500, 3: 600})]
    assert out[0] == ([0, 1, 2, 3], False)
    assert out[1] == ([0, 1, 2], True) and out[2][1] and len(out[2][0]) == 4
    return _plain(out)


SCENARIOS = {f.__name__.lstrip("_"): f for f in (
    _completion_and_vc, _minority_drops, _blocks_without_quorum,
    _sync_path, _async_on_leader_straggle, _no_quorum_blocks,
    _crash_then_recover, _elastic_replan, _straggler_policy)}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_matches_reference(name):
    ref, port = (SCENARIOS[name](*PKGS[k]) for k in ("ref", "port"))
    assert port == ref


def _commit_needs_quorum(srt, n, dead):
    s = srt.SporadesRuntime(n, seed=3)
    for d in dead:
        s.crash(d)
    live = [i for i in range(n) if i not in dead]
    rec = s.commit_step({i: np.zeros(n) for i in live})
    if len(live) < n - (n - 1) // 2:
        assert rec is None
    return _sporades(s, [rec])


def _quorum_case(n, dead):
    assert _commit_needs_quorum(p_srt, n, dead) == \
        _commit_needs_quorum(j_srt, n, dead)


if HAVE_HYPOTHESIS:
    @settings(max_examples=20, deadline=None)
    @given(st.integers(2, 9), st.data())
    def test_commit_needs_quorum_property_matches_reference(n, data):
        _quorum_case(n, data.draw(st.sets(st.integers(0, n - 1),
                                          max_size=n)))
else:
    def test_commit_needs_quorum_property_matches_reference():
        """Degraded fixed-case variant (hypothesis not installed)."""
        for n, dead in ((5, set()), (5, {0, 1, 2}), (3, {0, 1}), (9, {4})):
            _quorum_case(n, dead)


@pytest.mark.parametrize("n", (3, 5, 7, 9))
def test_common_coin_flip_matches_reference(n):
    """v in 0..999 at seeds 0 and 2: the port's host threefry equals the
    reference's jax.random draw, and the port's own coin table."""
    views = np.arange(1000)
    for seed in (0, 2):
        ref = np.asarray(jax.vmap(lambda v: jcoin.common_coin_flip(
            v, n, seed))(jnp.asarray(views, jnp.uint32)))
        table = coin.coin_table_np(1000, n, seed)
        got = np.array([coin.common_coin_flip(int(v), n, seed)
                        for v in views])
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(got, table)
        assert got.dtype == np.int32 and 0 <= got.min() and got.max() < n
