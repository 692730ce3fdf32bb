"""Fixed-size mergeable weighted quantile sketch (port of
``repro.distributed.sketch``).

The reduced sweep path (``core/experiment.run_sweep(..., mesh=...)``)
reduces each grid point's latency distribution on the device, so a point
returns O(bins) bytes instead of its batch records' timelines. The sketch
is a rank-space histogram with a uniform centroid budget:

  - ``build`` sorts the (value, weight) pairs (stably: equal latencies keep
    their order, and NaN sorts after +inf), assigns each entry to one of
    ``bins`` equal-probability rank buckets by its CDF *midpoint*
    ``(cum_w - w/2) / total_w``, and emits per-bucket weighted-mean centers
    and total weights. Empty buckets carry ``+inf`` centers at zero weight,
    so they sort last and stay inert.
  - ``quantile`` runs ``core.harness._weighted_quantile``'s algorithm over
    the centroids (an all-zero sketch gives NaN).
  - ``merge`` concatenates two sketches' centroids and re-buckets.

Batched: the last axis is the sample and leading axes are lanes, so
``build`` of ``[B, N]`` returns ``{"v": [B, bins], "w": [B, bins]}``, and
everything stays on the caller's device.

Exactness. The midpoints' CDF is a running sum taken in float64 and
rounded once to float32: for integer weights whose lane total stays below
2^24 (the simulator's counts; the harness asserts it) every partial sum is
exact, so it equals the reference's float32 cumsum whatever the order of
either. A bucket's entries are a contiguous run of the sorted order, and
its two sums go one entry after another in float32 from +0.0
(``kernels/sketch_buckets``: ``index_add_`` on the CPU, the CUDA kernel on
the card), as XLA's CPU backend runs the reference's scatter-adds. So a
sketch of such weights equals the reference's bit for bit, in ``v`` and
``w``, and a sketch built on the card equals the CPU's.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels.sketch_buckets import ops as _buckets

# Default centroid budget: 64 rank buckets resolve quantile ranks to
# ~1/64 (+-0.8%), enough to separate a p99 from a p95 while keeping a
# point's distribution payload at 512 bytes.
SKETCH_BINS = 64

Sketch = Dict[str, torch.Tensor]  # {"v": [..., bins] f32, "w": [..., bins]}


def _cumsum(w: torch.Tensor) -> torch.Tensor:
    """Running sum over the last axis: float64, rounded once to float32
    (exact for integer terms whose total stays below 2^24)."""
    # lint: allow(dtype-hygiene): exact running sums of integer
    # weights below 2^24 (order-free on every device)
    return torch.cumsum(w.double(), dim=-1).float()


def _sorted(v: torch.Tensor, w: torch.Tensor):
    """(v, w) sorted by v along the last axis, stably."""
    v, order = torch.sort(v, dim=-1, stable=True)
    return v, torch.gather(w, -1, order)


def _bucketize(v: torch.Tensor, w: torch.Tensor, bins: int) -> Sketch:
    """Sorted [L, M] (v, w) -> rank-bucketed centroids [L, bins]. Entries
    of zero weight add nothing (their w*v term is masked, not multiplied:
    v may be inf)."""
    cum = _cumsum(w)
    tot = cum[..., -1:]
    mid = (cum - 0.5 * w) / torch.where(tot > 0, tot, 1.0)
    b = torch.clamp((mid * bins).to(torch.int32), 0, bins - 1)
    wv = torch.where(w > 0, w * v, 0.0)
    wsum, vsum = _buckets.bucket_sums(b, w, wv, bins)
    center = torch.where(wsum > 0, vsum / torch.where(wsum > 0, wsum, 1.0),
                         float("inf"))
    return {"v": center, "w": wsum}


def _lanes(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(-1, x.shape[-1])


def build(values: torch.Tensor, weights: torch.Tensor,
          bins: int = SKETCH_BINS) -> Sketch:
    """Sketch a weighted sample per lane: values and weights [..., N] ->
    {"v", "w"} [..., bins] float32 on their device. Zero-weight entries are
    inert (their values may be inf or NaN, as the harness's masked batch
    records are)."""
    lead = values.shape[:-1]
    v = _lanes(values.float())
    w = _lanes(weights.float().expand_as(values))
    v, w = _sorted(v, w)
    sk = _bucketize(v, w, bins)
    return {k: x.reshape(*lead, bins) for k, x in sk.items()}


def merge(a: Sketch, b: Sketch, bins: int = SKETCH_BINS) -> Sketch:
    """Combine two sketches (per lane) into one of the same size, by
    re-bucketing the union of their centroids."""
    lead = a["v"].shape[:-1]
    v = _lanes(torch.cat([a["v"], b["v"]], dim=-1))
    w = _lanes(torch.cat([a["w"], b["w"]], dim=-1))
    v, w = _sorted(v, w)
    sk = _bucketize(v, w, bins)
    return {k: x.reshape(*lead, bins) for k, x in sk.items()}


def quantile(sk: Sketch, q: float) -> torch.Tensor:
    """Decode one quantile per lane ([...] float32, NaN where a lane's
    sketch is empty): ``harness._weighted_quantile``'s algorithm over the
    centroids. ``q`` is compared in float32, as the reference's weak-typed
    ``q`` is."""
    v, w = _sorted(sk["v"], sk["w"])
    cum = _cumsum(w)
    tot = cum[..., -1:]
    cdf = cum / torch.where(tot > 0, tot, 1.0)
    qv = torch.full(cdf.shape[:-1] + (1,), q, dtype=torch.float32,
                    device=cdf.device)
    idx = torch.clamp(torch.searchsorted(cdf.contiguous(), qv, right=False),
                      0, v.shape[-1] - 1)
    out = torch.gather(v, -1, idx)
    return torch.where(tot > 0, out, float("nan"))[..., 0]


def quantile_np(v, w, q: float) -> float:
    """Host-side decode of one collected sketch (numpy inputs). Matches
    the device decode bit for bit: the comparison runs in float32 (a
    float64 q would step one bucket past ranks that land exactly on a
    bucket edge)."""
    import numpy as np
    v = np.asarray(v, np.float32)
    w = np.asarray(w, np.float32)
    order = np.argsort(v, kind="stable")
    v, w = v[order], w[order]
    cum = np.cumsum(w, dtype=np.float32)
    tot = cum[-1]
    if not tot > 0:
        return float("nan")
    cdf = (cum / tot).astype(np.float32)
    idx = min(int(np.searchsorted(cdf, np.float32(q), side="left")),
              len(v) - 1)
    return float(v[idx])
