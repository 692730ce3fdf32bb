"""The port's packed channel ring (repro_torch.core.channel and the plain
PyTorch commit, repro_torch.kernels.channel_ring.ref) against the JAX
reference's ``ring_commit(backend="jnp")``: bitwise equal buffers over
random tick traffic, on the CPU, and over adversarial traffic that pins
the semantics the fused CUDA commit keeps. Also the fused kernel's
host-side send descriptor on CPU tensors, and a numpy emulation of its
per-column fold held against the plain commit."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import channel as jch
from repro.core import mandator as jmandator
from repro.core import sporades as jsporades
from repro_torch.core import channel as ch
from repro_torch.core import mandator, sporades
from repro_torch.kernels.channel_ring import kernel, ops, ref

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


def _traffic(rng, spec, names, n, dmax, batch, p_mask=0.5, rows=False):
    """One tick of random traffic for ``batch`` lanes: payloads in
    [-1, 50), delays in [0, 2*dmax) (so slots collide and clip), random
    masks (on with probability ``p_mask``) and drops — as numpy arrays
    [batch, ...]. With ``rows`` each payload is [batch, n, 1, w]: one row
    per sender, to be broadcast to every receiver."""
    sends = []
    for name in names:
        w = spec[name].width
        sends.append((name,
                      rng.uniform(-1.0, 50.0, (batch, n, 1 if rows else n, w)
                                  ).astype(np.float32),
                      rng.randint(0, 2 * dmax, (batch, n, n)).astype(np.int32),
                      rng.rand(batch, n, n) < p_mask))
    return sends, rng.rand(batch, n, n) < 0.2


def _adversarial_buf(rng, spec, dmax, n):
    """A ring [dmax, n, n, K] the simulator never holds: every cell in
    [-3, 2), so that the neutral -1 of masked-out sends raises the cells
    below it, and additive payload fields -0.0 in half of the cells, which
    an added 0.0 turns into +0.0."""
    buf = rng.uniform(-3.0, 2.0, (dmax, n, n, spec.k)).astype(np.float32)
    for c in spec.channels:
        if c.additive:
            off = spec.offset(c.name)
            field = buf[..., off:off + c.width]
            field[rng.rand(*field.shape) < 0.5] = -0.0
    return buf


def _bits(x) -> np.ndarray:
    """The float32 bit patterns: -0.0 differs from +0.0."""
    return np.ascontiguousarray(np.asarray(x, np.float32)).view(np.int32)


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


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_ref_commit_matches_jax_on_adversarial_traffic(layout):
    """Masked-out sends (80% of them) over cells below -1, additive cells
    holding -0.0, and payloads that are expanded views (stride 0 over the
    receivers) every other tick: the plain commit's bits equal the
    reference's after every tick, the sign of every zero included."""
    channels, names = LAYOUTS[layout]
    jspec, tspec = _specs(channels)
    rng = np.random.RandomState(11)
    dmax, n = 16, 5
    buf = _adversarial_buf(rng, tspec, dmax, n)
    ring_j = {"buf": jnp.asarray(buf)}
    ring_t = {"buf": torch.from_numpy(buf.copy())[None]}
    for t in range(dmax + 3):
        rows = t % 2 == 0
        sends, drop = _traffic(rng, tspec, names, n, dmax, 1, p_mask=0.2,
                               rows=rows)
        ring_j = jch.ring_commit(
            jspec, ring_j, jnp.int32(t),
            [jch.Send(nm, jnp.asarray(np.broadcast_to(p, (1, n, n,
                                                          p.shape[3]))[0]),
                      jnp.asarray(d[0]), jnp.asarray(m[0]))
             for nm, p, d, m in sends],
            drop=jnp.asarray(drop[0]), backend="jnp")
        tsends = [ch.Send(nm, torch.from_numpy(p).expand(1, n, n, p.shape[3]),
                          torch.from_numpy(d), torch.from_numpy(m))
                  for nm, p, d, m in sends]
        if rows:
            assert all(s.payload.stride(2) == 0 for s in tsends)
        ring_t = ch.ring_commit(tspec, ring_t, t, tsends,
                                drop=torch.from_numpy(drop), backend="ref")
        np.testing.assert_array_equal(_bits(ring_j["buf"]),
                                      _bits(ring_t["buf"][0].numpy()),
                                      err_msg=f"t={t}")
    if any(c.additive for c in tspec.channels):
        # the -0.0 cells that an added neutral 0.0 met are +0.0 now
        assert (_bits(ring_t["buf"].numpy()) == 0).any()


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


def _expanded_sends(spec, names, n, batch, rng):
    """A tick's sends as the sporades tick makes them: payload rows
    broadcast over the receivers, one shared delay tensor, masks as a
    sender's flag broadcast over the receivers."""
    delay = torch.from_numpy(rng.randint(0, 40, (batch, n, n)
                                         ).astype(np.int32))
    sends = []
    for name in names:
        w = spec[name].width
        pay = torch.from_numpy(rng.uniform(-1, 50, (batch, n, 1, w)
                                           ).astype(np.float32))
        mask = torch.from_numpy(rng.rand(batch, n) < 0.5)
        sends.append(ch.Send(name, pay.expand(batch, n, n, w), delay,
                             mask[:, :, None].expand(batch, n, n)))
    return sends


def test_fused_descriptor_on_cpu_tensors():
    """The fused kernel's parameter struct, built on CPU tensors: the
    sends' element strides as they lie (0 on the broadcast dims), the
    static layout, the data pointers; built once per shapes and strides
    and refilled with the next tick's pointers."""
    spec = sporades.ring_spec(5)
    names = ("vote", "prop", "to", "pa", "va", "pa", "ac", "vote")
    rng = np.random.RandomState(4)
    batch, n, dmax = 2, 5, 8
    buf = ch.make_ring(spec, dmax, n, batch, CPU)["buf"]
    drop = torch.from_numpy(rng.rand(batch, n, n) < 0.2)
    layout = ch.send_layout(spec, names)
    sends = _expanded_sends(spec, names, n, batch, rng)
    before = kernel.launch_count
    p = kernel.describe(buf, sends, drop, layout)
    assert (p.B, p.D, p.n, p.K, p.E) == (batch, dmax, n, spec.k, len(names))
    for e, (s, (off, w, flag_off, additive)) in enumerate(zip(sends, layout)):
        ent = p.e[e]
        assert tuple(ent.ps) == s.payload.stride()
        assert ent.ps[2] == 0 and ent.ms[2] == 0
        assert tuple(ent.ds) == s.delay_ticks.stride()
        assert tuple(ent.ms) == s.mask.stride()
        assert (ent.off, ent.w, ent.flag_off, ent.additive) == \
            (off, w, flag_off, int(additive))
        assert ent.pay == s.payload.data_ptr()
        assert ent.delay == s.delay_ticks.data_ptr()
        assert ent.mask == s.mask.data_ptr()
    assert tuple(p.drs) == drop.stride() and p.drop == drop.data_ptr()
    nxt = _expanded_sends(spec, names, n, batch, rng)
    q = kernel.describe(buf, nxt, None, layout)     # other shape of drop
    assert q is not p and q.drop is None
    r = kernel.describe(buf, nxt, drop, layout)
    assert r is p and p.e[3].pay == nxt[3].payload.data_ptr()
    assert kernel.launch_count == before


def test_fused_descriptor_refuses_before_any_launch():
    """More than MAX_ENTRIES sends, a payload, delay or mask of a dtype
    the tick does not send, and an additive channel sent twice raise on
    the host; so does a CPU ring at the launch. Nothing is launched."""
    _, spec = _specs(LAYOUTS["additive"][0])
    rng = np.random.RandomState(5)
    batch, n = 1, 3
    buf = ch.make_ring(spec, 8, n, batch, CPU)["buf"]
    raw, drop = _traffic(rng, spec, ("a", "fw", "b"), n, 8, batch)
    sends = [ch.Send(nm, torch.from_numpy(p), torch.from_numpy(d),
                     torch.from_numpy(m)) for nm, p, d, m in raw]
    drop = torch.from_numpy(drop)
    layout = ch.send_layout(spec, ("a", "fw", "b"))
    before = kernel.launch_count
    many = [sends[0]] * (kernel.MAX_ENTRIES + 1)
    with pytest.raises(ValueError, match="at most"):
        kernel.describe(buf, many, drop, (layout[0],) * len(many))
    for field, bad in (("payload", sends[0].payload.double()),
                       ("delay_ticks", sends[0].delay_ticks.long()),
                       ("mask", sends[0].mask.to(torch.uint8))):
        with pytest.raises(TypeError, match="dtype"):
            kernel.describe(buf, [sends[0]._replace(**{field: bad})],
                            drop, layout[:1])
    with pytest.raises(TypeError, match="dtype"):
        kernel.describe(buf, sends, drop.to(torch.uint8), layout)
    with pytest.raises(ValueError, match="additive"):
        kernel.describe(buf, sends + [sends[1]], drop,
                        layout + (layout[1],))
    with pytest.raises(ValueError, match="CUDA"):
        kernel.ring_commit_fused(buf, 0, ch.fill_tensor(spec, CPU), sends,
                                 drop, layout)
    assert kernel.launch_count == before


def _fold_emulation(buf, t, fill, sends, drop, layout):
    """numpy twin of the fused kernel's per-column algorithm
    (csrc/channel_ring.cu): per (b, i, j, k), the covering entries' slots
    and values, grouped by slot in entry order; each group's cell read
    once before any store (``fill[k]`` for a target at slot t % D); the
    clear stored, then each group folded in entry order and stored."""
    B, D, n, _, K = buf.shape
    out = buf.copy()
    ts = t % D
    for b in range(B):
        for i in range(n):
            for j in range(n):
                live_all = [bool(m[b, i, j]) and not bool(drop[b, i, j])
                            for _, _, m in sends]
                for k in range(K):
                    ents = []
                    for (pay, dl, _), (off, w, flag_off, additive), live in \
                            zip(sends, layout, live_all):
                        in_pay = off <= k < off + w
                        if not (in_pay or k == flag_off):
                            continue
                        slot = (t + min(max(int(dl[b, i, j]), 1), D - 1)) % D
                        if in_pay:
                            val = (pay[b, i, j, k - off] if live else
                                   np.float32(0.0 if additive else -1.0))
                        else:
                            val = np.float32(1.0 if live else 0.0)
                        ents.append((slot, np.float32(val),
                                     in_pay and additive))
                    cells = {}
                    for slot, _, _ in ents:
                        if slot not in cells:
                            cells[slot] = (fill[k] if slot == ts
                                           else buf[b, slot, i, j, k])
                    out[b, ts, i, j, k] = fill[k]
                    for slot in cells:
                        c = np.float32(cells[slot])
                        for s2, val, add in ents:
                            if s2 == slot:
                                c = (np.float32(c + val) if add
                                     else (val if val > c else c))
                        out[b, slot, i, j, k] = c
    return out


@pytest.mark.parametrize("dmax", [1, 4])
def test_fold_emulation_matches_plain_commit_on_colliding_slots(dmax):
    """The kernel's order of work (group by slot, read each cell once,
    fold in entry order) against ring_commit_ref, bitwise, with delays in
    [0, 3 * dmax) so that most entries of a column collide; dmax = 1
    sends everything to the slot being cleared, which the fold reads as
    ``fill[k]``. Adversarial cells (below -1, additive -0.0) too."""
    _, spec = _specs(LAYOUTS["additive"][0])
    names = ("a", "fw", "b", "a", "b", "a")
    layout = ch.send_layout(spec, names)
    rng = np.random.RandomState(dmax)
    batch, n = 2, 3
    buf = np.stack([_adversarial_buf(rng, spec, dmax, n)
                    for _ in range(batch)])
    fill = spec.fill()
    for t in range(3):
        raw, drop = _traffic(rng, spec, names, n, dmax, batch, p_mask=0.4)
        np_sends = [(p, rng.randint(0, 3 * dmax, d.shape).astype(np.int32),
                     m) for _, p, d, m in raw]
        want = _fold_emulation(buf, t, fill, np_sends, drop, layout)
        sends = [ch.Send(nm, torch.from_numpy(p), torch.from_numpy(d),
                         torch.from_numpy(m))
                 for nm, (p, d, m) in zip(names, np_sends)]
        entries, lay = ch.commit_entries(spec, dmax, t, sends,
                                         torch.from_numpy(drop))
        got = torch.from_numpy(buf.copy())
        ops.ring_commit(got, t, torch.from_numpy(fill), entries, lay)
        np.testing.assert_array_equal(_bits(want), _bits(got.numpy()),
                                      err_msg=f"t={t}")
        buf = want
    assert ref.as_layout(lay) == layout
