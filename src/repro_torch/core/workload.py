"""Client arrivals (open loop, trivial §5.2 mode) + batch bookkeeping, batched
over the grid (port of ``repro.core.workload``).

Arrivals are Poisson per tick per origin. The reference draws them inside
the tick from ``fold_in(PRNGKey(seed), t)``; the port reads them from a
**draw table** ``[B, T, n]`` float32 made before the tick loop
(``draw_table``), which works because open-loop rates do not depend on
state. ``draw_table`` seeds one ``torch.Generator`` per lane, so a lane's
draws do not depend on the other lanes of the grid; tests pass in the
table the reference would draw instead.

Batch records are per-lane arrays indexed [lane, origin, round]:
  batch_create_t — tick when the batch was formed
  batch_arr_mean — mean arrival tick of its requests (execution latency)
  batch_count    — number of requests in the batch
Commit times are reconstructed after the run from the per-tick committed
vector-clock trace (harness._vc_commit_ticks).
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

from repro_torch.configs.smr import SMRConfig


def init_workload(cfg: SMRConfig, n_ticks: int, batch: int,
                  device: torch.device) -> Dict[str, torch.Tensor]:
    n = cfg.n_replicas
    z = lambda *s: torch.zeros(s, dtype=torch.float32,  # noqa: E731
                               device=device)
    return {
        "buffer": z(batch, n),         # pending request count
        "buffer_tsum": z(batch, n),    # sum of arrival ticks
        "last_batch_t": z(batch, n),
        "cpu_tokens": z(batch, n),
        "batch_create_t": torch.full((batch, n, n_ticks), float("inf"),
                                     dtype=torch.float32, device=device),
        "batch_arr_mean": z(batch, n, n_ticks),
        "batch_count": z(batch, n, n_ticks),
    }


def draw_table(rate_per_tick: Sequence[float], seeds: Sequence[int],
               n_ticks: int, n: int, device: torch.device) -> torch.Tensor:
    """[B, T, n] float32 Poisson arrival counts: lane b draws from its own
    ``torch.Generator`` seeded with ``seeds[b]`` at mean
    ``rate_per_tick[b]`` per origin per tick."""
    rows = []
    for lam, seed in zip(rate_per_tick, seeds):
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed))
        rate = torch.full((n_ticks, n), float(lam), dtype=torch.float32,
                          device=device)
        rows.append(torch.poisson(rate, generator=gen))
    return torch.stack(rows)


def arrive(wl: Dict, draws_t: torch.Tensor, t: int,
           alive: torch.Tensor) -> Dict:
    """This tick's Poisson arrivals at each origin's clients. draws_t:
    [B, n] row t of the draw table; a down replica takes no requests."""
    wl = dict(wl)
    cnt = draws_t * alive
    wl["buffer"] = wl["buffer"] + cnt
    wl["buffer_tsum"] = wl["buffer_tsum"] + cnt * t
    return wl


def refill_cpu(wl: Dict, cpu_req_per_tick: torch.Tensor) -> Dict:
    """cpu_req_per_tick: [B]."""
    wl = dict(wl)
    wl["cpu_tokens"] = torch.clamp(
        wl["cpu_tokens"] + cpu_req_per_tick[:, None], max=1e7)
    return wl


def form_batches(wl: Dict, t: int, can_form: torch.Tensor,
                 round_idx: torch.Tensor, batch_size: int,
                 batch_ticks: float
                 ) -> Tuple[Dict, torch.Tensor, torch.Tensor]:
    """can_form: [B, n] bool (protocol gate, e.g. ~awaitingAcks & alive).
    round_idx: [B, n] int32 — the chain round the new batch would get.
    Returns (wl, formed [B, n] bool, count [B, n] float). The batch
    records are updated in place."""
    wl = dict(wl)
    inf = float("inf")
    size_ok = wl["buffer"] >= batch_size
    time_ok = (t - wl["last_batch_t"] >= batch_ticks) & (wl["buffer"] > 0)
    formed = can_form & (size_ok | time_ok) & (wl["cpu_tokens"] >= 1.0)
    count = torch.where(
        formed, torch.minimum(torch.clamp(wl["buffer"], max=batch_size),
                              wl["cpu_tokens"]), 0.0)
    frac = torch.where(wl["buffer"] > 0,
                       count / torch.clamp(wl["buffer"], min=1.0), 0.0)
    tsum_taken = wl["buffer_tsum"] * frac
    arr_mean = torch.where(count > 0,
                           tsum_taken / torch.clamp(count, min=1.0), 0.0)
    idx = torch.clamp(round_idx, 0, wl["batch_create_t"].shape[2] - 1
                      ).long()[..., None]
    wl["batch_create_t"].scatter_reduce_(
        2, idx, torch.where(formed, float(t), inf)[..., None], "amin",
        include_self=True)
    wl["batch_arr_mean"].scatter_add_(
        2, idx, torch.where(formed, arr_mean, 0.0)[..., None])
    wl["batch_count"].scatter_add_(2, idx, count[..., None])
    wl["buffer"] = wl["buffer"] - count
    # the reference's `buffer_tsum - tsum_taken` (src/repro/core/workload.py
    # :106,122) is contracted by XLA on the CPU into one fused multiply-add
    # of buffer_tsum and frac, rounded once; the float32 product of two
    # float32 values is exact in float64, so this rounds as the FMA does
    tsum = wl["buffer_tsum"].double()
    wl["buffer_tsum"] = (tsum - tsum * frac.double()).float()
    wl["cpu_tokens"] = wl["cpu_tokens"] - count
    wl["last_batch_t"] = torch.where(formed, float(t), wl["last_batch_t"])
    return wl, formed, count
