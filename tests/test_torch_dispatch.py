"""The port's asynchronous sweep dispatch (``experiment.dispatch_sweep``,
``PendingSweep.collect``, ``run_sweeps``) and its last public entry
points (``harness.run_sim``, ``SCAN_PROTOCOLS``, ``netsim.env_windows``,
the unpacked ``channel.make_channel`` / ``send`` / ``deliver``,
``configs.smr.PAPER_CLAIMS``, ``experiment.shard_signatures``, the
``timing_stats`` buckets), on the CPU:

- nothing inside ``dispatch_sweep`` reads results back (``_to_numpy`` is
  counted); ``collect()`` does, once, and raises the runs' checks;
- ``run_sweeps`` and pending dispatches of one program, collected in any
  order, give ``run_sweep``'s rows bit for bit;
- the reduced path dispatches every block before it collects any and
  keeps its rows bit for bit;
- the entry points equal the reference's (``run_sim`` with the
  reference's draws replayed, at tests/test_torch_slice.py's
  tolerances; the channel bit for bit on tests/test_channel.py's cases).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smr as jsmr
from repro.configs.smr import SMRConfig as JCfg
from repro.core import channel as jch
from repro.core import harness as jharness
from repro.core import netsim as jnetsim
from repro.scenarios import library as jlib
from repro_torch.configs import smr
from repro_torch.configs.smr import SMRConfig
from repro_torch.core import channel as ch
from repro_torch.core import experiment, harness, netsim
from repro_torch.core.experiment import SweepSpec, dispatch_sweep, run_sweep
from repro_torch.scenarios import library
from repro_torch.workloads import ClosedLoop, Workload
from torch_sim_parity import (assert_metrics, jax_draw_table,  # noqa: F401
                              single_thread)

CPU = torch.device("cpu")
CFG = SMRConfig(sim_seconds=0.3)
SPEC = SweepSpec(rates=(40_000, 120_000))
N = CFG.n_replicas


def _leaf_equal(a, b, path="row"):
    """Equal bit for bit: dicts key for key, arrays by dtype, shape and
    bytes, scalars by type and value (NaN equal to NaN)."""
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _leaf_equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, np.ndarray):
        assert (a.dtype, a.shape) == (b.dtype, b.shape), path
        assert a.tobytes() == b.tobytes(), path
    else:
        assert type(a) is type(b), path
        assert a == b or (a != a and b != b), (path, a, b)


def _rows_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _leaf_equal(g, w)


# ------------------------------------------------------------ dispatch ----

def test_dispatch_reads_nothing_back_and_collect_caches(monkeypatch):
    calls = []
    real = experiment._to_numpy
    monkeypatch.setattr(experiment, "_to_numpy",
                        lambda tree: calls.append(1) or real(tree))
    pending = dispatch_sweep("mandator-sporades", CFG, SPEC, device="cpu")
    assert calls == []
    rows = pending.collect()
    assert calls and pending.collect() is rows
    n = len(calls)
    pending.collect()
    assert len(calls) == n
    _rows_equal(rows, run_sweep("mandator-sporades", CFG, SPEC,
                                device="cpu"))


def test_run_sweeps_equals_run_sweep_rows():
    """Four scan protocols and epaxos, dispatched before any is
    collected: each request's rows bitwise those of its own run_sweep."""
    requests = [(p, CFG, SPEC) for p in harness.SCAN_PROTOCOLS]
    requests.append(("epaxos", SMRConfig(), SweepSpec(rates=(5_000,))))
    got = experiment.run_sweeps(requests, device="cpu")
    assert len(got) == len(requests)
    for r, rows in zip(requests, got):
        assert rows and rows[0]["protocol"] == r[0]
        _rows_equal(rows, run_sweep(*r, device="cpu"))


def test_two_pending_sweeps_of_one_program_collected_in_reverse():
    """Equal ProgramSignatures (same protocol and shape, other rates) both
    pending; collected last-first, each equals its own run_sweep."""
    a = SweepSpec(rates=(30_000, 60_000))
    b = SweepSpec(rates=(90_000, 150_000))
    assert experiment._signature(CFG, a) == experiment._signature(CFG, b)
    pa = dispatch_sweep("mandator-paxos", CFG, a, device="cpu")
    pb = dispatch_sweep("mandator-paxos", CFG, b, device="cpu")
    rows_b, rows_a = pb.collect(), pa.collect()
    _rows_equal(rows_a, run_sweep("mandator-paxos", CFG, a, device="cpu"))
    _rows_equal(rows_b, run_sweep("mandator-paxos", CFG, b, device="cpu"))


class _FakeRun:
    """A block whose replays take ``chunks`` turns; logs what it does."""

    def __init__(self, log, name, chunks):
        self.log, self.name, self.left = log, name, chunks
        log.append(f"start {name}")

    def advance(self, n):
        self.log.append(f"advance {self.name}")
        self.left -= 1
        return self.left > 0

    def finish(self):
        self.log.append(f"finish {self.name}")
        return self.name


def test_reduced_blocks_interleave_across_devices():
    """Each device's blocks one after another; the devices' replays in
    turns: device b's block starts and enqueues before device a's first
    block finishes."""
    log = []
    starts = [lambda: _FakeRun(log, "a0", 3), lambda: _FakeRun(log, "b0", 3),
              lambda: _FakeRun(log, "a1", 1)]
    assert experiment._interleave(starts, ["a", "b", "a"]) == \
        ["a0", "b0", "a1"]
    assert log == ["start a0", "advance a0", "start b0", "advance b0",
                   "advance a0", "advance b0", "advance a0", "finish a0",
                   "start a1", "advance a1", "finish a1", "advance b0",
                   "finish b0"]


def test_reduced_path_rows_unchanged(monkeypatch):
    """mesh=[cpu] * 2 over a 3-point grid (padded to 4): both blocks are
    dispatched (on one device, one after the other) before anything is
    read back, and the rows equal those of each block run on its own
    through sim_point(..., reduced=True) (the serial blocks' rows) bit for
    bit, and the unreduced scalars."""
    spec = SweepSpec(rates=(40_000, 80_000, 120_000))
    cfg = SMRConfig(sim_seconds=0.2)
    calls = []
    real = experiment._to_numpy
    monkeypatch.setattr(experiment, "_to_numpy",
                        lambda tree: calls.append(1) or real(tree))
    experiment.reset_capture_counts()
    pending = dispatch_sweep("mandator-sporades", cfg, spec,
                             mesh=[CPU, CPU])
    assert calls == [] and len(pending._points) == 2
    rows = pending.collect()
    sig = experiment._signature(cfg, spec)
    assert experiment.shard_signatures() == {
        "mandator-sporades": ((sig, 2),)}
    # the serial blocks: each device's block through sim_point
    pts, rcfg, mode, env, rate_b, seeds = experiment._lower(
        cfg, spec, CPU, canonical=True)
    wlt = experiment._lower_workloads(rcfg, spec, canonical=True)
    outs = [experiment._to_numpy(harness.sim_point(
        "mandator-sporades", rcfg, experiment._take(env, blk),
        rate_b[blk].tolist(), np.asarray(seeds)[blk].tolist(), mode=mode,
        device="cpu", wlt=experiment._take(wlt, blk), reduced=True))
        for blk in experiment._blocks(len(pts), 2)]
    want = experiment._rows("mandator-sporades", pts, [rows[0]["workload"]],
                            experiment._take(experiment._concat(outs),
                                             slice(len(pts))))
    _rows_equal(rows, want)
    plain = run_sweep("mandator-sporades", cfg, spec, device="cpu")
    for r, p in zip(rows, plain):
        assert not set(harness.REDUCED_DROPS) & set(r)
        for k in ("throughput", "median_ms", "p99_ms", "committed",
                  "async_frac", "views"):
            _leaf_equal(r[k], p[k], k)


def test_checks_raise_from_collect():
    """The replay cap's and the epoch stream's checks read the card, so
    they raise from collect(), before any row, with the same messages."""
    cfg = SMRConfig(sim_seconds=0.3)
    tight = Workload("tight", (ClosedLoop(think_ms=20.0, cap=8.0),))
    spec = SweepSpec(rates=(10_000,), workloads=(tight,))
    pending = dispatch_sweep("mandator", cfg, spec, device="cpu",
                             draws=np.full((1, 300, N), 50.0, np.float32))
    with pytest.raises(ValueError, match="the cap cut one: the replayed"):
        pending.collect()
    closed = Workload("closed", (ClosedLoop(think_ms=50.0),))
    epochs = np.cumsum(np.ones((1, N, 64)), axis=-1)     # 64 epochs only
    pending = dispatch_sweep("mandator", cfg, SweepSpec(
        rates=(50_000,), workloads=(closed,)), device="cpu", epochs=epochs)
    with pytest.raises(RuntimeError, match="ran past its epoch stream"):
        pending.collect()


def test_timing_stats_has_the_reference_buckets():
    experiment.reset_timing_stats()
    run_sweep("multipaxos", CFG, SPEC, device="cpu")
    stats = experiment.timing_stats()["multipaxos"]
    assert set(stats) == {"compile_s", "run_s", "dispatches", "horizon"}
    # the CPU runs its grid inside the dispatch: no capture, run time
    assert stats["dispatches"] == 1 and stats["compile_s"] == 0.0
    assert stats["run_s"] > 0 and stats["horizon"] == 256


# --------------------------------------------------------- entry points ----

SIM_S = 0.5
RATE = 100_000.0


@pytest.mark.parametrize("protocol", ("epaxos", "rabia"))
def test_run_sim_analytic_equals_reference(protocol):
    rate = 5_000.0 if protocol == "epaxos" else 500.0
    ref = jharness.run_sim(protocol, JCfg(), rate,
                           scenario=jlib.get("paper-ddos", 10.0), seed=3)
    got = harness.run_sim(protocol, SMRConfig(), rate,
                          scenario=library.get("paper-ddos", 10.0), seed=3)
    _leaf_equal({k: np.asarray(v) if isinstance(v, np.ndarray) else v
                 for k, v in got.items()}, dict(ref))


@pytest.mark.parametrize("protocol", harness.SCAN_PROTOCOLS)
def test_run_sim_scan_equals_reference(protocol):
    """The reference's run_sim row against the port's with the
    reference's own draws replayed: keys equal, throughput and committed
    within 1e-6, the quantiles and the integer traces bitwise."""
    assert harness.SCAN_PROTOCOLS == jharness.SCAN_PROTOCOLS
    ref = jharness.run_sim(protocol, JCfg(sim_seconds=SIM_S), RATE, seed=0)
    draws = jax_draw_table(0, int(SIM_S * 1000))[None]
    got = harness.run_sim(protocol, SMRConfig(sim_seconds=SIM_S), RATE,
                          seed=0, device="cpu", draws=draws)
    assert set(ref) == set(got)
    assert got["committed"] > 0
    assert_metrics({"ref_rows": [ref], "port_rows": [got]}, 0)
    if protocol == "mandator-sporades":
        for k in ("cvc_all", "commit_key"):
            np.testing.assert_array_equal(np.asarray(ref[k]), got[k])
        assert (ref["views"], ref["async_frac"]) == (got["views"],
                                                     got["async_frac"])


def test_env_windows_equal_over_the_library():
    for sim_s in (1.0, 4.0):
        cfg, jcfg = SMRConfig(sim_seconds=sim_s), JCfg(sim_seconds=sim_s)
        assert netsim.env_windows(cfg, None) == \
            jnetsim.env_windows(jcfg, None)
        for name in library.NAMES:
            assert netsim.env_windows(cfg, library.get(name, sim_s)) == \
                jnetsim.env_windows(jcfg, jlib.get(name, sim_s)), name


def test_paper_claims_equal():
    assert smr.PAPER_CLAIMS == jsmr.PAPER_CLAIMS


# ------------------------------------------------ the unpacked channel ----

DMAX, P = 16, 3


class _Both:
    """One channel in both packages, stepped together; every step's ring
    compared bit for bit."""

    def __init__(self, p=P, additive=False):
        self.j = jch.make_channel(DMAX, N, p, additive=additive)
        self.t = ch.make_channel(DMAX, N, p, additive=additive,
                                 device="cpu")
        self.check()

    def check(self):
        for k in ("buf", "flag", "fill"):
            r, g = np.asarray(self.j[k]), self.t[k].numpy()
            assert r.dtype == g.dtype and r.tobytes() == g.tobytes(), k

    def send(self, t, payload, delay, mask, **kw):
        self.j = jch.send(self.j, jnp.int32(t), jnp.asarray(payload),
                          jnp.asarray(delay, jnp.int32), jnp.asarray(mask),
                          **{k: jnp.asarray(v) if k == "drop" else v
                             for k, v in kw.items()})
        self.t = ch.send(self.t, torch.tensor(t, dtype=torch.int32),
                         torch.from_numpy(payload),
                         torch.from_numpy(np.asarray(delay, np.int32)),
                         torch.from_numpy(mask),
                         **{k: torch.from_numpy(v) if k == "drop" else v
                            for k, v in kw.items()})
        self.check()

    def deliver(self, t):
        self.j, jf, jp = jch.deliver(self.j, jnp.int32(t))
        self.t, tf, tp = ch.deliver(self.t, t)
        np.testing.assert_array_equal(np.asarray(jf), tf.numpy())
        assert np.asarray(jp).tobytes() == tp.numpy().tobytes()
        self.check()


@pytest.mark.parametrize("seed", (0, 1, 12345))
def test_channel_round_trip_and_collisions(seed):
    """tests/test_channel.py's round trip (delays past the horizon and 0,
    a random mask, a drop mask) and colliding same-slot sends."""
    rng = np.random.RandomState(seed)
    c = _Both()
    c.send(0, rng.uniform(0.0, 100.0, (N, N, P)).astype(np.float32),
           rng.randint(0, 2 * DMAX, size=(N, N)), rng.rand(N, N) < 0.7,
           drop=rng.rand(N, N) < 0.2)
    for t in range(1, DMAX):
        c.deliver(t)
    delay = np.full((N, N), 5)
    for _ in range(2):
        c.send(3, rng.uniform(0.0, 50.0, (N, N, P)).astype(np.float32),
               delay, np.ones((N, N), bool))
    for t in range(4, 4 + DMAX):
        c.deliver(t)


def test_channel_horizon_edge_and_additive():
    pay = np.ones((N, N, P), np.float32)
    for d in (0, DMAX - 1, DMAX, 3 * DMAX + 2):
        c = _Both()
        c.send(0, pay, np.full((N, N), d), np.ones((N, N), bool))
        for t in range(1, DMAX):
            c.deliver(t)
    c = _Both(p=2, additive=True)
    for _ in range(2):
        c.send(0, np.full((N, N, 2), 3.0, np.float32), np.full((N, N), 4),
               np.ones((N, N), bool), additive=True)
    for t in range(1, 6):
        c.deliver(t)


def test_channel_entry_point_runs_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; nothing to show")
    with pytest.raises(RuntimeError, match="CUDA"):
        ch.make_channel(DMAX, N, P)
