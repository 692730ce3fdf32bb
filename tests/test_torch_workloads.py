"""Workloads in the port (repro_torch.workloads, core/workload.py) against
the JAX reference on the CPU:

- every library workload lowers to tables equal to the reference's, bit for
  bit, padded or not;
- the properties of tests/test_workloads.py, on the port: each primitive
  conserves its analytic load, closed-loop validation, trivial detection,
  the uniform-table path equal to the trivial one bit for bit, the cap
  bounding in-flight requests, the closed loop throttling offered load,
  and a mixed open/closed grid equal to its points run one by one;
- EPaxos and Rabia rows equal the reference's exactly under every library
  workload (both are host numpy);
- the closed-loop sampler (a time-changed unit-rate Poisson process):
  over 8 seeds the mean count per window lies within 4 standard errors of
  the tick's mean, lanes do not depend on their neighbours, and a seed
  gives the same draws every time.
"""
import math

import numpy as np
import pytest
import torch

from repro import workloads as jwlc
from repro.configs.smr import SMRConfig as JCfg
from repro.core.experiment import SweepSpec as JSpec
from repro.core.experiment import run_sweep as jax_run_sweep
from repro.workloads import library as jlib
from repro_torch.configs.smr import SMRConfig
from repro_torch.core import workload as wlmod
from repro_torch.core.experiment import SweepSpec, run_sweep
from repro_torch.scenarios import library as scenario_library
from repro_torch.workloads import (
    ClosedLoop,
    DiurnalRamp,
    FlashCrowd,
    OnOffBurst,
    PoissonOpen,
    RegionSkew,
    Workload,
    WorkloadMode,
    as_workload,
    is_trivial,
    lower,
    mode_of,
)
from repro_torch.workloads import compile as wcompile
from repro_torch.workloads import library
from torch_sim_parity import single_thread  # noqa: F401

CFG = SMRConfig(sim_seconds=2.0)
N = CFG.n_replicas
CPU = torch.device("cpu")
SCALARS = ("throughput", "median_ms", "p99_ms", "committed")


def _offered(cfg, wl):
    """Mean per-origin rate multiplier over the whole run, [n]."""
    tab = lower(cfg, wl)
    return tab["rate_of"][tab["win_of_tick"]].mean(axis=0)


def _assert_point_equal(a, b):
    for k in SCALARS:
        assert (a[k] == b[k]) or (np.isnan(a[k]) and np.isnan(b[k])), \
            f"{k}: {a[k]} != {b[k]}"
    for k in ("timeline", "origin_timeline", "origin_median_ms"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# ------------------------------------------------- tables vs reference ----

@pytest.mark.parametrize("sim_s", (2.0, 4.0))
@pytest.mark.parametrize("name", library.NAMES)
def test_library_tables_equal_reference(name, sim_s):
    """Every leaf of the lowered table, unpadded and padded to the
    library's widest, equal to the reference's: values, dtypes, shapes."""
    cfg, jcfg = SMRConfig(sim_seconds=sim_s), JCfg(sim_seconds=sim_s)
    pad = max(wcompile.n_windows(cfg, w)
              for w in library.workloads(sim_s, N).values())
    assert pad == max(jwlc.compile.n_windows(jcfg, w)
                      for w in jlib.workloads(sim_s, N).values())
    for kw in ({}, {"pad_windows": pad}):
        got = lower(cfg, library.get(name, sim_s, N), **kw)
        ref = jwlc.lower(jcfg, jlib.get(name, sim_s, N), **kw)
        assert got.keys() == ref.keys()
        for k, r in ref.items():
            g = got[k]
            assert np.asarray(r).dtype == np.asarray(g).dtype, k
            np.testing.assert_array_equal(r, g, err_msg=f"{name}/{k}")
        assert is_trivial(got) == jwlc.is_trivial(ref)


# ------------------------------------------------- lowering invariants ----

def test_onoff_burst_conserves_analytic_load():
    """Total offered load == duty*on + (1-duty)*off when the period
    divides the run."""
    for duty, on, off in ((0.5, 2.0, 0.0), (0.4, 2.5, 0.0), (0.25, 2.0, 1.0)):
        wl = Workload("b", (OnOffBurst(period_s=0.5, duty=duty,
                                       on_scale=on, off_scale=off),))
        want = duty * on + (1 - duty) * off
        np.testing.assert_allclose(_offered(CFG, wl), want, rtol=1e-6)


def test_diurnal_ramp_averages_midpoint():
    wl = Workload("d", (DiurnalRamp(period_s=2.0, low=0.25, high=1.75,
                                    step_s=0.125),))
    np.testing.assert_allclose(_offered(CFG, wl), (0.25 + 1.75) / 2,
                               rtol=2e-3)


def test_flash_crowd_rectangle_analytic():
    wl = Workload("f", (FlashCrowd(at_s=0.5, duration_s=0.5, magnitude=8.0,
                                   targets=(2,), decay_s=0.0),))
    want = np.ones(N)
    want[2] = 1.0 + (8.0 - 1.0) * 0.5 / CFG.sim_seconds
    np.testing.assert_allclose(_offered(CFG, wl), want, rtol=1e-6)


def test_region_skew_conserves_and_migrates():
    wl = Workload("s", (RegionSkew(hot_frac=0.8, hot=(0,), migrate_s=0.5),))
    tab = lower(CFG, wl)
    np.testing.assert_allclose(tab["rate_of"].sum(axis=1), N, rtol=1e-6)
    assert tab["rate_of"].argmax(axis=1).tolist() == [0, 1, 2, 3]
    assert tab["rate_of"][0, 0] == pytest.approx(N * 0.8)
    assert tab["rate_of"][0, 1] == pytest.approx(N * 0.2 / (N - 1))


def test_closed_loop_lowering_and_validation():
    tab = lower(CFG, Workload("c", (ClosedLoop(think_ms=40.0, cap=64.0),)))
    assert float(tab["closed"]) == 1.0
    assert float(tab["think_ticks"]) == 40.0 / CFG.tick_ms
    assert float(tab["cap"]) == 64.0
    with pytest.raises(ValueError, match="one ClosedLoop"):
        lower(CFG, Workload("cc", (ClosedLoop(), ClosedLoop())))
    with pytest.raises(ValueError, match="placement"):
        lower(CFG, Workload("cp", (ClosedLoop(placement=(1.0, 2.0)),)))
    w = (0.4, 0.3, 0.15, 0.1, 0.05)
    tab = lower(CFG, Workload("cg", (ClosedLoop(placement=w),)))
    np.testing.assert_allclose(tab["rate_of"][0], np.array(w) * N, rtol=1e-6)


def test_trivial_detection_and_mode():
    assert is_trivial(lower(CFG, None))
    assert is_trivial(lower(CFG, Workload("p", (PoissonOpen(),))))
    assert not is_trivial(lower(CFG, Workload("p2", (PoissonOpen(2.0),))))
    assert not is_trivial(lower(CFG, library.get("onoff-burst", 2.0)))
    mode = mode_of([lower(CFG, None),
                    lower(CFG, library.get("closed-loop", 2.0))])
    assert (mode.trivial, mode.closed) == (False, True)
    mode = mode_of([lower(CFG, library.get("region-skew", 2.0))])
    assert (mode.trivial, mode.closed) == (False, False)
    with pytest.raises(TypeError):
        as_workload("poisson-open")


def test_library_compiles_and_pads():
    lib = library.workloads(CFG.sim_seconds, N)
    assert set(library.NAMES) == set(lib) == set(jlib.NAMES)
    pad = max(wcompile.n_windows(CFG, w) for w in lib.values())
    for w in lib.values():
        assert lower(CFG, w, pad_windows=pad)["rate_of"].shape == (pad, N)
    with pytest.raises(ValueError, match="real windows"):
        lower(CFG, library.get("diurnal", 2.0), pad_windows=2)
    with pytest.raises(KeyError, match="unknown workload"):
        library.get("tsunami", 2.0)


# ------------------------------------------------- simulator semantics ----

def test_trivial_and_uniform_table_paths_agree_bitwise():
    """An all-ones rate table forced down the table path (W > 1) draws the
    same table as the trivial path, so every metric is equal bit for
    bit."""
    cfg = SMRConfig(sim_seconds=1.0)
    uniform = Workload("uniform", (OnOffBurst(period_s=0.25, duty=0.5,
                                              on_scale=1.0, off_scale=1.0),))
    assert not is_trivial(lower(cfg, uniform))
    for proto in ("mandator-sporades", "multipaxos"):
        a, = run_sweep(proto, cfg, SweepSpec(rates=(20_000,)), device="cpu")
        b, = run_sweep(proto, cfg, SweepSpec(rates=(20_000,),
                                             workloads=(uniform,)),
                       device="cpu")
        _assert_point_equal(a, b)


def test_closed_loop_inflight_never_exceeds_cap():
    cfg = SMRConfig(sim_seconds=1.0)
    wl = Workload("tight", (ClosedLoop(think_ms=20.0, cap=64.0),))
    r, = run_sweep("mandator-sporades", cfg,
                   SweepSpec(rates=(200_000,), workloads=(wl,)),
                   device="cpu")
    assert np.all(r["inflight_max"] <= 64.0 + 1e-6), r["inflight_max"]
    # the cap binds under this load (the pool saturates, not idles)
    assert r["inflight_max"].max() == pytest.approx(64.0)
    # Little's law: committed throughput can't exceed the cap's bound
    assert r["throughput"] <= N * 64.0 / (r["median_ms"] / 1000.0) * 1.5


def test_closed_loop_feedback_throttles_offered_load():
    cfg = SMRConfig(sim_seconds=1.0)
    closed, open_ = run_sweep(
        "mandator-sporades", cfg,
        SweepSpec(rates=(100_000,),
                  workloads=(library.get("closed-loop", 1.0, N), None)),
        device="cpu")
    assert closed["committed"] < open_["committed"]
    assert closed["throughput"] > 0


def test_region_skew_reports_per_origin_latency():
    cfg = SMRConfig(sim_seconds=1.0)
    r, = run_sweep("mandator-sporades", cfg, SweepSpec(
        rates=(50_000,), workloads=(Workload("skew", (RegionSkew(
            hot_frac=0.8, hot=(0,)),)),)), device="cpu")
    assert r["origin_median_ms"].shape == (N,)
    assert np.isfinite(r["origin_median_ms"][0])
    per_origin = r["origin_timeline"].sum(axis=1)
    assert per_origin[0] > 0.5 * per_origin.sum()


def test_workload_grid_matches_sequential():
    """workload x scenario x rate through one dispatch: every point equal
    bit for bit to itself run alone — open lanes sharing a closed-mode
    grid with closed lanes included."""
    cfg = SMRConfig(sim_seconds=0.6)
    scen = scenario_library.scenarios(cfg.sim_seconds, N)
    wls = (None, library.get("onoff-burst", cfg.sim_seconds, N),
           library.get("closed-loop", cfg.sim_seconds, N))
    spec = SweepSpec(rates=(10_000, 30_000),
                     scenarios=(scen["baseline"], scen["paper-ddos"]),
                     workloads=wls)
    grid = run_sweep("mandator-sporades", cfg, spec, device="cpu")
    assert len(grid) == spec.size == 12
    for r, (rate, seed, fi, wi) in zip(grid, spec.points()):
        single, = run_sweep("mandator-sporades", cfg, SweepSpec(
            rates=(rate,), seeds=(seed,), scenarios=(spec.scenarios[fi],),
            workloads=(wls[wi],)), device="cpu")
        _assert_point_equal(r, single)
        # a closed-mode grid reports the in-flight high water of every
        # lane, as the reference's does; an open point alone has none
        assert "inflight_max" in r
        assert ("inflight_max" in single) == (wi == 2)
        if wi == 2:
            np.testing.assert_array_equal(r["inflight_max"],
                                          single["inflight_max"])


# ------------------------------------------------- analytic baselines ----

@pytest.mark.parametrize("name", library.NAMES)
@pytest.mark.parametrize("protocol,rate", (("epaxos", 8_000),
                                           ("rabia", 800)))
def test_analytic_rows_equal_reference(protocol, rate, name):
    """benchmarks/figures.py workload_matrix's points of the analytic
    models, keys and values equal exactly."""
    sim_s = 4.0
    ref, = jax_run_sweep(protocol, JCfg(sim_seconds=sim_s),
                         JSpec(rates=(rate,),
                               workloads=(jlib.get(name, sim_s, N),)))
    got, = run_sweep(protocol, SMRConfig(sim_seconds=sim_s),
                     SweepSpec(rates=(rate,),
                               workloads=(library.get(name, sim_s, N),)))
    assert ref.keys() == got.keys()
    for k, r in ref.items():
        g = got[k]
        if isinstance(r, np.ndarray):
            np.testing.assert_array_equal(r, g, err_msg=k)
        else:
            assert type(r) is type(g), k
            assert r == g or (np.isnan(r) and np.isnan(g)), (k, r, g)


# ------------------------------------------------- the closed-loop sampler

def _closed_arrivals(seeds, sim_s=2.0, rate=20.0, wl=None, epochs=None):
    """Arrivals of closed lanes (one per seed) on ``wl`` (default: an
    on/off closed pool), rate per origin per tick ``rate``."""
    cfg = SMRConfig(sim_seconds=sim_s)
    wl = wl or Workload("c", (OnOffBurst(period_s=0.5, duty=0.5,
                                         on_scale=1.5, off_scale=0.5),
                              ClosedLoop(think_ms=10.0, cap=1e9)))
    tab = lower(cfg, wl)
    B = len(seeds)
    wlt = {"rate_of": torch.from_numpy(np.stack([tab["rate_of"]] * B)),
           "win_of_tick": torch.from_numpy(
               np.stack([tab["win_of_tick"]] * B)).long(),
           "closed": torch.ones(B), "cap": torch.full((B,), 1e9),
           "think_ticks": torch.full((B,), float(tab["think_ticks"]))}
    rates = [rate] * B
    ticks = int(sim_s * 1000)
    if epochs is None:
        epochs = wlmod.epoch_stream(rates, seeds, wlt, ticks, N, CPU)
    arr = wlmod.Arrivals(torch.zeros((B, ticks, N)),
                         WorkloadMode(trivial=False, closed=True), wlt,
                         torch.full((B,), rate), epochs)
    return cfg, arr, tab, ticks


def _drive(cfg, arr, ticks, lag=0.0):
    """Run ``workload.arrive`` alone for ``ticks`` ticks; each tick a
    fraction 1 - ``lag`` of the requests in flight completes. Returns
    (counts [B, T, n], the tick means [B, T, n], final state)."""
    B = arr.rate.shape[0]
    wl = wlmod.init_workload(cfg, 4, B, CPU, closed=True)
    alive = torch.ones((B, N), dtype=torch.bool)
    cnts, lams = [], []
    think = arr.wlt["think_ticks"][:, None]
    for t in range(ticks):
        mult = arr.wlt["rate_of"][torch.arange(B),
                                  arr.wlt["win_of_tick"][:, t]]
        inflight = wl["cl_submitted"] - wl["cl_done"]
        lams.append(torch.clamp(arr.rate[:, None] * think * mult - inflight,
                                min=0.0) / think)
        before = wl["cl_submitted"]
        wl = wlmod.arrive(wl, arr, t, alive)
        cnts.append(wl["cl_submitted"] - before)
        wl["cl_done"] = wl["cl_submitted"] - lag * (wl["cl_submitted"]
                                                    - wl["cl_done"])
    return torch.stack(cnts, 1), torch.stack(lams, 1), wl


SEEDS = tuple(range(8))


@pytest.mark.parametrize("lag", (0.0, 0.9), ids=("constant", "gated"))
def test_sampler_counts_are_poisson_at_the_tick_mean(lag):
    """Per window of the rate table (and per origin), over 8 seeds: the
    counts sum to the sum of the tick means within 4 standard errors of
    a Poisson count. With ``lag`` the mean depends on the requests in
    flight, i.e. on earlier draws."""
    cfg, arr, tab, ticks = _closed_arrivals(SEEDS)
    cnt, lam, wl = _drive(cfg, arr, ticks, lag)
    wlmod.check_epochs(wl, arr)
    win = torch.from_numpy(tab["win_of_tick"]).long()
    for w in range(len(tab["win_start"])):
        sel = win == w
        c = cnt[:, sel].double().sum(dim=(0, 1))
        m = lam[:, sel].double().sum(dim=(0, 1))
        z = (c - m) / torch.sqrt(m)
        assert z.abs().max() < 4.0, (w, z)
    if lag:
        # the gate bites: in the off window (ticks 250-500, the pool at
        # 0.5 x 20 a tick) the requests in flight hold the means well
        # below the pool's, varying with the draws
        gated = lam[:, 300:500]
        assert float(gated.mean()) < 0.75 * 10.0
        assert float(gated.std()) > 0.1
    # counts are whole numbers, and their variance is the mean's: the
    # squared deviations sum to the means' sum within 5 standard errors
    # (Var (X - lam)^2 = lam + 2 lam^2 for a Poisson X)
    assert torch.equal(cnt, cnt.round())
    d, m = (cnt - lam).double(), lam.double()
    se = math.sqrt(float((m + 2.0 * m * m).sum()))
    assert abs(float((d * d).sum() - m.sum())) < 5.0 * se


def test_sampler_lanes_independent_of_neighbours():
    """A lane's counts do not depend on the lanes beside it, and
    neighbouring lanes' counts are uncorrelated."""
    cfg, arr, _, ticks = _closed_arrivals(SEEDS, sim_s=1.0)
    cnt, lam, _ = _drive(cfg, arr, ticks)
    cfg1, arr1, _, _ = _closed_arrivals((3,), sim_s=1.0)
    alone, _, _ = _drive(cfg1, arr1, ticks)
    assert torch.equal(cnt[3], alone[0])
    resid = (cnt - lam).double().reshape(len(SEEDS), -1)
    for b in range(len(SEEDS) - 1):
        r = float(torch.corrcoef(resid[b:b + 2])[0, 1])
        assert abs(r) < 4.0 / math.sqrt(resid.shape[1]), (b, r)


def test_sampler_same_seed_same_draws():
    cfg, arr, _, ticks = _closed_arrivals((5, 5, 6), sim_s=0.5)
    cnt, _, _ = _drive(cfg, arr, ticks)
    assert torch.equal(cnt[0], cnt[1])
    assert not torch.equal(cnt[0], cnt[2])
    cfg, again, _, _ = _closed_arrivals((5,), sim_s=0.5)
    assert torch.equal(again.epochs[0], arr.epochs[0])
    cnt2, _, _ = _drive(cfg, again, ticks)
    assert torch.equal(cnt2[0], cnt[0])


def test_sampler_raises_when_the_stream_runs_out():
    cfg, arr, _, ticks = _closed_arrivals((0,), sim_s=0.5)
    short = arr.epochs[..., :ticks]                 # ~1 epoch a tick
    cfg, arr, _, ticks = _closed_arrivals((0,), sim_s=0.5,
                                          epochs=short.contiguous())
    _, _, wl = _drive(cfg, arr, ticks)
    with pytest.raises(RuntimeError, match="epoch stream"):
        wlmod.check_epochs(wl, arr)


def test_replayed_counts_the_cap_cuts_raise():
    """draws replays closed lanes' counts after the cap: a count the cap
    cuts is no replay, and the run says so."""
    cfg = SMRConfig(sim_seconds=0.3)
    wl = Workload("tight", (ClosedLoop(think_ms=20.0, cap=8.0),))
    draws = np.full((1, 300, N), 50.0, np.float32)
    with pytest.raises(ValueError, match="cap cut"):
        run_sweep("mandator", cfg, SweepSpec(rates=(10_000,),
                                             workloads=(wl,)),
                  device="cpu", draws=draws)
