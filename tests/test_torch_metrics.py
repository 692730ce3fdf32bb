"""The simulator's metric sums (``core/harness._batch_metrics``) do not
depend on the order of their terms: throughput, committed, the timelines
and the per-origin latency timeline come out bit for bit the same when the
batch records are permuted, as the card's atomics and reductions permute
them, and equal the float64 sums rounded once to float32. Fractional batch
counts, as the simulator's are."""
import numpy as np
import pytest
import torch

from repro_torch.configs.smr import SMRConfig
from repro_torch.core import harness

ORDER_FREE = ("throughput", "committed", "timeline", "origin_timeline",
              "origin_lat_ms_timeline")


def _records(seed: int, B: int = 2, n: int = 5, R: int = 600):
    """(create_t, arr_mean, count, commit_t) [B, n, R] in ticks of a 1 s
    run: fractional counts, a tenth of the batches never committed."""
    rng = np.random.default_rng(seed)
    create = np.sort(rng.uniform(0, 900, (B, n, R)), axis=-1)
    arr = create - rng.uniform(0, 5, (B, n, R))
    commit = create + rng.uniform(50, 400, (B, n, R))
    commit[rng.random((B, n, R)) < 0.1] = np.inf
    count = rng.uniform(0.5, 2000, (B, n, R))
    return tuple(torch.from_numpy(a.astype(np.float32))
                 for a in (create, arr, count, commit))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metric_sums_do_not_depend_on_order(seed):
    cfg = SMRConfig(sim_seconds=1.0)
    recs = _records(seed)
    got = harness._batch_metrics(cfg, *recs)
    perm = torch.from_numpy(np.random.default_rng(seed + 10).permutation(
        recs[0].shape[-1]))
    shuffled = harness._batch_metrics(cfg, *(r[..., perm] for r in recs))
    for k in ORDER_FREE + ("median_ms", "p99_ms"):
        assert torch.equal(got[k].nan_to_num(-1.0),
                           shuffled[k].nan_to_num(-1.0)), k


def test_metric_sums_are_float64_sums_rounded_once():
    cfg = SMRConfig(sim_seconds=1.0)
    create, arr, count, commit = _records(3)
    got = harness._batch_metrics(cfg, create, arr, count, commit)
    ok = np.isfinite(commit.numpy()) & (count.numpy() > 0)
    c = np.where(ok, count.numpy(), 0.0).astype(np.float64)
    want = np.float32(c.reshape(2, -1).sum(axis=1))
    np.testing.assert_array_equal(got["committed"].numpy(), want)
    w0 = 0.15 * 1000
    in_win = ok & (commit.numpy() >= w0)
    tput = np.float32(np.where(in_win, count.numpy(), 0.0).astype(
        np.float64).reshape(2, -1).sum(axis=1))
    np.testing.assert_array_equal(got["throughput"].numpy(),
                                  (torch.from_numpy(tput)
                                   / ((1000 - w0) / 1000.0)).numpy())


@pytest.mark.parametrize("q", [0.5, 0.99])
def test_weighted_quantile_cdf_is_float64_sums_rounded_once(q):
    """The quantile's CDF: running float64 sums rounded to float32, the
    first sorted value whose CDF reaches q."""
    rng = np.random.default_rng(7)
    vals = rng.uniform(0, 900, (3, 4000)).astype(np.float32)
    w = rng.uniform(0.5, 2000, (3, 4000)).astype(np.float32)
    w[:, ::7] = 0.0
    got = harness._weighted_quantile(torch.from_numpy(vals),
                                     torch.from_numpy(w), q)
    order = np.argsort(vals, axis=-1, kind="stable")
    v = np.take_along_axis(vals, order, -1)
    cum = np.cumsum(np.take_along_axis(w, order, -1).astype(np.float64),
                    axis=-1).astype(np.float32)
    cdf = cum / cum[:, -1:]
    want = [v[i, np.searchsorted(cdf[i], np.float32(q))] for i in range(3)]
    np.testing.assert_array_equal(got.numpy(), np.array(want, np.float32))
