"""The port's reduced sweep path (repro_torch.distributed, ``run_sweep(...,
mesh=...)``) against the JAX reference's sharded engine, on the CPU.

- The 64-bin latency sketch (``distributed/sketch.py``) against
  ``repro.distributed.sketch`` on the reference's own cases
  (tests/test_sharded.py) and on random batched inputs from a numpy seed:
  integer weights with zero-weight entries holding inf and NaN, and tied
  latencies. ``v`` and ``w`` are bitwise (the bucket sums run in index
  order in float32 on both, the running sums are exact for integer
  weights below 2^24; ROADMAP Queue C), and the port decodes the same
  quantiles on the device and on the host.
- ``run_sweep(..., mesh=[cpu] * k)`` against the port's unreduced
  ``run_sweep`` (scalars bitwise, ``REDUCED_DROPS`` absent) and against
  the reference's ``run_sweep(..., mesh=1)`` with the reference's draws
  replayed (the sketch bitwise, the scalars within
  tests/torch_sim_parity.py's tolerances), for mandator-sporades and
  multipaxos on baseline and leader-crash-recover at 0.4 s.
- A grid padded to a multiple of the device count returns its own
  points; the closed loop and the monitor ride along the reduced path.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.smr import SMRConfig as JCfg
from repro.core import harness as jharness
from repro.core.experiment import SweepSpec as JSpec
from repro.core.experiment import run_sweep as jax_run_sweep
from repro.distributed import sketch as jsketch
from repro.scenarios import library as jlib
from repro_torch.configs.smr import SMRConfig
from repro_torch.core import harness
from repro_torch.core.experiment import SweepSpec, run_sweep
from repro_torch.distributed import mesh as dmesh
from repro_torch.distributed import sketch
from repro_torch.scenarios import library
from repro_torch.workloads import library as wlib
from torch_sim_parity import single_thread  # noqa: F401

SCALARS = ("throughput", "median_ms", "p99_ms", "committed")
CPU = torch.device("cpu")
SIM_S = 0.4


def _bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.uint32)


def _same(a, b) -> bool:
    return a == b or (np.isnan(a) and np.isnan(b))


def _both(v, w):
    """The reference's sketch and the port's of one sample."""
    ref = jsketch.build(jnp.asarray(v), jnp.asarray(w))
    got = sketch.build(torch.from_numpy(np.asarray(v, np.float32)),
                       torch.from_numpy(np.asarray(w, np.float32)))
    return ({k: np.asarray(x) for k, x in ref.items()},
            {k: x.numpy() for k, x in got.items()})


def _assert_sketch_bitwise(ref, got):
    for k in ("v", "w"):
        assert got[k].dtype == np.float32 and got[k].shape == ref[k].shape
        np.testing.assert_array_equal(_bits(got[k]), _bits(ref[k]),
                                      err_msg=k)


def _random_sample(seed: int, n: int = 3000):
    """Gamma latencies, integer counts, 20% zero-weight entries holding inf
    or NaN, and a run of tied latencies with other counts."""
    rng = np.random.default_rng(seed)
    v = rng.gamma(2.0, 50.0, n).astype(np.float32)
    w = rng.integers(1, 2000, n).astype(np.float32)
    v[: n // 8] = v[n // 8: 2 * (n // 8)]
    dead = rng.random(n) < 0.2
    w[dead] = 0.0
    v[dead] = np.where(rng.random(int(dead.sum())) < 0.5, np.inf, np.nan)
    return v, w


# ------------------------------------------------------------ the sketch ----

def _case_small():
    return np.linspace(3.0, 99.0, 60, dtype=np.float32), np.ones(60,
                                                                 np.float32)


def _case_weighted():
    rng = np.random.default_rng(7)
    return (rng.gamma(2.0, 10.0, size=5000).astype(np.float32),
            rng.uniform(0.5, 2.0, size=5000).astype(np.float32))


def _case_zero():
    return np.array([1.0, 2.0], np.float32), np.zeros(2, np.float32)


def _case_inert():
    return (np.array([5.0, np.inf, np.nan], np.float32),
            np.array([1.0, 0.0, 0.0], np.float32))


CASES = {"small": _case_small, "weighted": _case_weighted,
         "zero": _case_zero, "inert": _case_inert,
         **{f"random{s}": (lambda s=s: _random_sample(s)) for s in range(3)}}


@pytest.mark.parametrize("case", sorted(CASES))
def test_sketch_matches_reference(case):
    """The reference's cases (tests/test_sharded.py) and random samples:
    build bitwise, and every decoded quantile equal to the reference's
    device decode, on the port's device decode and on its host decode."""
    v, w = CASES[case]()
    ref, got = _both(v, w)
    _assert_sketch_bitwise(ref, got)
    gt = {k: torch.from_numpy(x) for k, x in got.items()}
    for q in (0.01, 0.1, 0.25, 0.5, 0.9, 0.99, 1.0):
        want = float(jsketch.quantile({k: jnp.asarray(x)
                                       for k, x in ref.items()}, q))
        assert _same(float(sketch.quantile(gt, q)), want), (q, want)
        assert _same(sketch.quantile_np(got["v"], got["w"], q), want), q
    if case == "small":
        # distinct equal-weight values decode exactly
        for q in (0.01, 0.1, 0.5, 0.9, 0.99):
            exact = float(jharness._weighted_quantile(jnp.asarray(v),
                                                      jnp.asarray(w), q))
            assert float(sketch.quantile(gt, q)) == exact


def test_sketch_batched_and_merge():
    """build over [B, N] equals B single builds and the reference's, and
    merge (per lane) equals the reference's merge, bitwise."""
    samples = [_random_sample(10 + i, 700) for i in range(4)]
    V = np.stack([s[0] for s in samples])
    W = np.stack([s[1] for s in samples])
    batched = sketch.build(torch.from_numpy(V), torch.from_numpy(W))
    assert batched["v"].shape == (4, sketch.SKETCH_BINS)
    refs = [jsketch.build(jnp.asarray(v), jnp.asarray(w)) for v, w in
            samples]
    for i, ref in enumerate(refs):
        _assert_sketch_bitwise({k: np.asarray(x) for k, x in ref.items()},
                               {k: x[i].numpy() for k, x in
                                batched.items()})
    half = {k: x[:2] for k, x in batched.items()}
    other = {k: x[2:] for k, x in batched.items()}
    merged = sketch.merge(half, other)
    for i in range(2):
        want = jsketch.merge(refs[i], refs[i + 2])
        _assert_sketch_bitwise({k: np.asarray(x) for k, x in want.items()},
                               {k: x[i].numpy() for k, x in merged.items()})


def test_bucket_sums_ref_is_in_index_order():
    """The CPU path of the bucket sums (what the CUDA kernel is held to)
    adds each bucket's entries one after another in float32: a sequential
    numpy sum of every bucket, bit for bit."""
    from repro_torch.kernels.sketch_buckets import ops
    rng = np.random.default_rng(3)
    b = np.sort(rng.integers(0, 64, (3, 5000)), axis=1).astype(np.int32)
    w = rng.gamma(1.0, 3.0, (3, 5000)).astype(np.float32)
    wv = (w * rng.gamma(2.0, 50.0, (3, 5000))).astype(np.float32)
    ws, vs = ops.bucket_sums(torch.from_numpy(b), torch.from_numpy(w),
                             torch.from_numpy(wv), 64)
    for r in range(3):
        for k in range(64):
            for got, src in ((ws, w), (vs, wv)):
                acc = np.float32(0.0)
                for x in src[r][b[r] == k]:
                    acc = np.float32(acc + x)
                assert _bits(got[r, k]) == _bits(acc), (r, k)


def test_grid_mesh_helpers():
    assert dmesh.GRID_AXIS == "grid"
    assert dmesh.as_grid_mesh(None) is None
    assert dmesh.as_grid_mesh([CPU, "cpu"]) == [CPU, CPU]
    assert dmesh.grid_mesh(["cpu"]) == [CPU]
    with pytest.raises(ValueError):
        dmesh.grid_mesh([])
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(ValueError):
        dmesh.grid_mesh(n + 1)
    if n == 0:
        # no silent CPU: without a card the default grid raises
        for call in (dmesh.grid_mesh, dmesh.device_counts):
            with pytest.raises(RuntimeError, match="CUDA"):
                call()
    else:
        counts = dmesh.device_counts()
        assert counts[0] == 1 and counts[-1] == n


# ------------------------------------------------------- reduced sweeps ----

def _jax_draws(pts, ticks: int, n: int = 5) -> np.ndarray:
    """[B, T, n] the reference's per-tick Poisson draws of each lane
    (``poisson(fold_in(PRNGKey(seed), t), rate per replica per tick)``)."""
    out = []
    for rate, seed, _, _ in pts:
        lam = jnp.broadcast_to(jnp.float32(np.float32(rate / 1000.0 / n)),
                               (n,))
        base = jax.random.PRNGKey(seed)
        draw = lambda t, base=base, lam=lam: jax.random.poisson(  # noqa
            jax.random.fold_in(base, t), lam).astype(jnp.float32)
        out.append(np.asarray(jax.lax.map(
            draw, jnp.arange(ticks, dtype=jnp.int32))))
    return np.stack(out)


@pytest.mark.parametrize("proto,k", [("mandator-sporades", 2),
                                     ("multipaxos", 2)])
def test_reduced_sweep_matches_plain_and_reference(proto, k):
    """4 points (2 rates x baseline / leader-crash-recover) over k CPU
    devices: the rows equal the unreduced run's scalars bit for bit,
    carry none of REDUCED_DROPS and a [64] sketch; against the
    reference's mesh=1 rows (its own draws, replayed into the port) the
    sketch is bitwise and the scalars within the parity tolerances."""
    assert harness.REDUCED_DROPS == jharness.REDUCED_DROPS
    names = ("baseline", "leader-crash-recover")
    spec = SweepSpec(rates=(50_000, 150_000), scenarios=tuple(
        library.get(x, SIM_S) for x in names))
    draws = _jax_draws(list(spec.points()), int(SIM_S * 1000))
    cfg = SMRConfig(sim_seconds=SIM_S)
    plain = run_sweep(proto, cfg, spec, device="cpu", draws=draws)
    reduced = run_sweep(proto, cfg, spec, draws=draws, mesh=[CPU] * k)
    ref = jax_run_sweep(proto, JCfg(sim_seconds=SIM_S), JSpec(
        rates=spec.rates, scenarios=tuple(jlib.get(x, SIM_S)
                                          for x in names)), mesh=1)
    assert len(plain) == len(reduced) == len(ref) == spec.size
    extra = ("async_frac", "views") if proto == "mandator-sporades" else ()
    for a, b, r in zip(plain, reduced, ref):
        assert set(b) == set(r), sorted(set(b) ^ set(r))
        for key in SCALARS + extra:
            assert _same(a[key], b[key]), (key, a[key], b[key])
        for key in harness.REDUCED_DROPS:
            assert key not in b, key
        for key in ("v", "w"):
            assert b["sketch"][key].shape == (sketch.SKETCH_BINS,)
            np.testing.assert_array_equal(_bits(b["sketch"][key]),
                                          _bits(r["sketch"][key]),
                                          err_msg=key)
        for key in ("throughput", "committed"):
            assert abs(b[key] - r[key]) <= 1e-6 * abs(r[key]), key
        for key in ("median_ms", "p99_ms") + extra:
            assert _same(b[key], r[key]), (key, b[key], r[key])
        if b["committed"] > 0:
            med = sketch.quantile_np(b["sketch"]["v"], b["sketch"]["w"],
                                     0.5)
            assert med == pytest.approx(b["median_ms"], rel=0.1)


def test_padding_returns_the_grid_points():
    """4 points over 3 devices pad to 6 lanes (the last point repeated)
    and return 4 rows, each equal to its unreduced run's scalars."""
    cfg = SMRConfig(sim_seconds=0.1)
    spec = SweepSpec(rates=(20_000, 60_000), seeds=(0, 1))
    plain = run_sweep("mandator", cfg, spec, device="cpu")
    reduced = run_sweep("mandator", cfg, spec, mesh=[CPU] * 3)
    assert len(reduced) == 4
    for (rate, seed, _, _), a, b in zip(spec.points(), plain, reduced):
        assert (b["rate"], b["seed"]) == (rate, seed)
        for key in SCALARS:
            assert _same(a[key], b[key]), key
        # the sketch weighs the window's commits: throughput x window
        win_s = 0.85 * cfg.sim_seconds
        assert float(np.sum(b["sketch"]["w"], dtype=np.float64)) == \
            pytest.approx(b["throughput"] * win_s, rel=1e-6)
    with pytest.raises(ValueError, match="device= or mesh="):
        run_sweep("mandator", cfg, spec, device="cpu", mesh=[CPU])


@pytest.mark.parametrize("proto,workload,levels", [
    ("mandator", "closed-loop", {"monitor_level": "gauges"}),
    ("mandator-sporades", "poisson-open", {"trace_level": "full"})])
def test_closed_loop_monitor_and_recorder_ride_along(proto, workload,
                                                     levels):
    """Closed-loop feedback (inflight_max), the health monitor's gauges
    and the flight recorder's rings and phase quantiles come through the
    reduced path unchanged; the recorder's per-batch marks are among the
    dropped keys."""
    cfg = SMRConfig(sim_seconds=0.2 if levels.get("trace_level") else SIM_S,
                    **levels)
    spec = SweepSpec(rates=(50_000,),
                     workloads=(wlib.get(workload, cfg.sim_seconds),))
    plain = run_sweep(proto, cfg, spec, device="cpu")
    reduced = run_sweep(proto, cfg, spec, mesh=[CPU])
    for a, b in zip(plain, reduced):
        assert set(b) == (set(a) - set(harness.REDUCED_DROPS)) | {"sketch"}
        for key in SCALARS:
            assert _same(a[key], b[key]), key
        for key in set(b) - set(SCALARS) - {"sketch"}:
            if isinstance(a[key], dict):
                ja, jb = dict(_leaves(a[key])), dict(_leaves(b[key]))
                assert ja.keys() == jb.keys(), key
                for leaf, x in ja.items():
                    np.testing.assert_array_equal(
                        np.asarray(x), np.asarray(jb[leaf]),
                        err_msg=f"{key}.{leaf}")
            elif isinstance(a[key], np.ndarray):
                np.testing.assert_array_equal(a[key], b[key], err_msg=key)
            else:
                assert a[key] == b[key] or _same(a[key], b[key]), key


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v
