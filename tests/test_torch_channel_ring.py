"""The port's packed channel ring (repro_torch.core.channel and the plain
PyTorch commit, repro_torch.kernels.channel_ring.ref) against the JAX
reference's ``ring_commit(backend="jnp")``: bitwise equal buffers over
random tick traffic, on the CPU."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import channel as jch
from repro.core import mandator as jmandator
from repro.core import sporades as jsporades
from repro_torch.core import channel as ch
from repro_torch.core import mandator, sporades
from repro_torch.kernels.channel_ring import ops

CPU = torch.device("cpu")

# (channels, sends per tick in order) — the additive layout of
# tests/test_kernels.py, and the two rings of the main path
LAYOUTS = {
    "additive": ((("a", 2, False), ("fw", 2, True), ("b", 3, False)),
                 ("a", "fw", "b", "a")),
    "sporades": (tuple((c.name, c.width, c.additive)
                       for c in jsporades.ring_spec(5).channels),
                 ("vote", "prop", "to", "pa", "va", "pa", "ac", "vote")),
    "mandator": (tuple((c.name, c.width, c.additive)
                       for c in jmandator.ring_spec().channels),
                 ("vote", "batch")),
}


def _specs(channels):
    return (jch.RingSpec(*(jch.ChannelSpec(*c) for c in channels)),
            ch.RingSpec(*(ch.ChannelSpec(*c) for c in channels)))


def _traffic(rng, spec, names, n, dmax, batch):
    """One tick of random traffic for ``batch`` lanes: payloads in
    [-1, 50), delays in [0, 2*dmax) (so slots collide and clip), random
    masks and drops — as numpy arrays [batch, ...]."""
    sends = []
    for name in names:
        w = spec[name].width
        sends.append((name,
                      rng.uniform(-1.0, 50.0, (batch, n, n, w)
                                  ).astype(np.float32),
                      rng.randint(0, 2 * dmax, (batch, n, n)).astype(np.int32),
                      rng.rand(batch, n, n) < 0.5))
    return sends, rng.rand(batch, n, n) < 0.2


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("seed", [0, 7])
def test_ref_commit_matches_jax_bitwise(layout, seed):
    """Random traffic with drops, in-slot collisions and the slot clear:
    the torch plain commit equals the reference's jnp commit, bitwise,
    after every tick (float32 buffers compared exactly)."""
    channels, names = LAYOUTS[layout]
    jspec, tspec = _specs(channels)
    rng = np.random.RandomState(seed)
    dmax, n = 32, 5
    ring_j = jch.make_ring(jspec, dmax, n)
    ring_t = ch.make_ring(tspec, dmax, n, 1, CPU)
    for t in range(2 * dmax):
        sends, drop = _traffic(rng, tspec, names, n, dmax, 1)
        ring_j = jch.ring_commit(
            jspec, ring_j, jnp.int32(t),
            [jch.Send(nm, jnp.asarray(p[0]), jnp.asarray(d[0]),
                      jnp.asarray(m[0])) for nm, p, d, m in sends],
            drop=jnp.asarray(drop[0]), backend="jnp")
        ring_t = ch.ring_commit(
            tspec, ring_t, t,
            [ch.Send(nm, torch.from_numpy(p), torch.from_numpy(d),
                     torch.from_numpy(m)) for nm, p, d, m in sends],
            drop=torch.from_numpy(drop), backend="ref")
        np.testing.assert_array_equal(np.asarray(ring_j["buf"]),
                                      ring_t["buf"][0].numpy(),
                                      err_msg=f"t={t}")


@pytest.mark.parametrize("layout", ["additive", "sporades"])
def test_batched_commit_equals_single_lanes(layout):
    """A B=3 commit equals three single-lane commits of the same traffic,
    bitwise: lanes do not interact."""
    channels, names = LAYOUTS[layout]
    _, spec = _specs(channels)
    rng = np.random.RandomState(3)
    dmax, n, batch = 16, 5, 3
    ring_b = ch.make_ring(spec, dmax, n, batch, CPU)
    lanes = [ch.make_ring(spec, dmax, n, 1, CPU) for _ in range(batch)]
    for t in range(2 * dmax):
        sends, drop = _traffic(rng, spec, names, n, dmax, batch)
        ring_b = ch.ring_commit(
            spec, ring_b, t,
            [ch.Send(nm, torch.from_numpy(p), torch.from_numpy(d),
                     torch.from_numpy(m)) for nm, p, d, m in sends],
            drop=torch.from_numpy(drop))
        for b in range(batch):
            lanes[b] = ch.ring_commit(
                spec, lanes[b], t,
                [ch.Send(nm, torch.from_numpy(p[b:b + 1]),
                         torch.from_numpy(d[b:b + 1]),
                         torch.from_numpy(m[b:b + 1]))
                 for nm, p, d, m in sends],
                drop=torch.from_numpy(drop[b:b + 1]))
    for b in range(batch):
        assert torch.equal(ring_b["buf"][b], lanes[b]["buf"][0]), b


def test_deliver_and_fold_match_reference():
    """ring_occupancy, ring_deliver's (flags, payload) per channel and
    fold_state equal the reference's on a ring holding random traffic."""
    channels, names = LAYOUTS["sporades"]
    jspec, tspec = _specs(channels)
    rng = np.random.RandomState(1)
    dmax, n = 16, 5
    buf = rng.uniform(-1.0, 3.0, (dmax, n, n, tspec.k)).astype(np.float32)
    assert (float(jch.ring_occupancy(jspec, {"buf": jnp.asarray(buf)}))
            == float(ch.ring_occupancy(tspec,
                                       {"buf": torch.from_numpy(buf)[None]})))
    for t in (0, 5, 31):
        jm = jch.ring_deliver(jspec, {"buf": jnp.asarray(buf)}, jnp.int32(t))
        tm = ch.ring_deliver(tspec, {"buf": torch.from_numpy(buf)[None]}, t)
        for name in jm:
            np.testing.assert_array_equal(np.asarray(jm[name][0]),
                                          tm[name][0][0].numpy())
            np.testing.assert_array_equal(np.asarray(jm[name][1]),
                                          tm[name][1][0].numpy())
            state = rng.uniform(-1, 3, jm[name][1].shape).astype(np.float32)
            np.testing.assert_array_equal(
                np.asarray(jch.fold_state(jnp.asarray(state), *jm[name])),
                ch.fold_state(torch.from_numpy(state)[None],
                              *tm[name])[0].numpy())


def test_ring_specs_match_reference():
    """K, fill vector and per-channel layouts of both protocol rings."""
    for jspec, tspec in ((jsporades.ring_spec(5), sporades.ring_spec(5)),
                         (jsporades.ring_spec(9), sporades.ring_spec(9)),
                         (jmandator.ring_spec(), mandator.ring_spec())):
        assert jspec.k == tspec.k
        np.testing.assert_array_equal(jspec.fill(), tspec.fill())
        for c in jspec.channels:
            assert jspec.layout(c.name) == tspec.layout(c.name)


def test_backend_selection_and_guards():
    """"auto" follows the ring's device; "cuda" on a CPU ring raises;
    unknown names raise; an additive channel sent twice in a tick
    raises."""
    assert ops.resolve_backend("auto", CPU) == "ref"
    assert ops.resolve_backend("ref", CPU) == "ref"
    with pytest.raises(ValueError, match="CUDA"):
        ops.resolve_backend("cuda", CPU)
    with pytest.raises(ValueError, match="channel backend"):
        ops.resolve_backend("pallas", CPU)
    _, spec = _specs(LAYOUTS["additive"][0])
    ring = ch.make_ring(spec, 8, 3, 1, CPU)
    z = torch.zeros((1, 3, 3, 2))
    d = torch.ones((1, 3, 3), dtype=torch.int32)
    m = torch.ones((1, 3, 3), dtype=torch.bool)
    with pytest.raises(ValueError, match="additive"):
        ch.ring_commit(spec, ring, 0, [ch.Send("fw", z, d, m),
                                       ch.Send("fw", z, d, m)])
    with pytest.raises(ValueError, match="CUDA"):
        ch.ring_commit(spec, ring, 0, [ch.Send("a", z, d, m)],
                       backend="cuda")
