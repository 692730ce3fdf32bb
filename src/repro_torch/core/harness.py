"""SMR simulation harness: drives mandator-sporades over the WAN sim and
produces the paper's metrics (throughput, median/p99 execution latency,
timelines). Port of ``repro.core.harness`` for the main path.

``sim_point`` runs the tick loop for every lane of a batched env at once —
a Python loop over ticks whose per-tick outputs land in preallocated
``[B, T, ...]`` tensors — then extracts the metrics on the device
(searchsorted commit reconstruction, weighted quantiles, timelines).

The port runs ``protocol="mandator-sporades"`` with the trivial §5.2
workload and tracing/monitoring off; anything else raises
``NotImplementedError`` naming the ROADMAP item that brings it.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch

from repro_torch import device as _device
from repro_torch.configs.smr import SMRConfig
from repro_torch.core import mandator, netsim, sporades
from repro_torch.core import workload as wlmod
from repro_torch.workloads.compile import TRIVIAL_MODE, WorkloadMode

PROTOCOLS = ("mandator-sporades",)


def check_supported(protocol: str, cfg: SMRConfig,
                    mode: WorkloadMode = TRIVIAL_MODE) -> None:
    """Raise NotImplementedError for what this port does not run yet."""
    if protocol not in PROTOCOLS:
        item = ("Queue A item 12" if protocol in ("epaxos", "rabia")
                else "Queue A item 10")
        raise NotImplementedError(
            f"protocol {protocol!r} is not ported yet (ROADMAP {item}); "
            f"the port runs {PROTOCOLS}")
    if not mode.trivial or mode.closed:
        raise NotImplementedError(
            "windowed and closed-loop workloads are not ported yet "
            "(ROADMAP Queue A item 11); the port runs the trivial §5.2 "
            "Poisson workload")
    if cfg.trace_level != "off" or cfg.monitor_level != "off":
        raise NotImplementedError(
            "the flight recorder and health monitor are not ported yet "
            "(ROADMAP Queue A item 13); use trace_level='off' and "
            "monitor_level='off'")


def init_carry(cfg: SMRConfig, n_ticks: int, batch: int,
               device: torch.device) -> Dict:
    """The scan carry {"m": mandator state, "s": sporades state}."""
    return {"m": mandator.init_state(cfg, n_ticks, batch, device),
            "s": sporades.init_state(cfg, n_ticks, batch, device)}


def step(carry: Dict, t: int, draws: torch.Tensor, env: Dict,
         cfg: SMRConfig) -> Dict:
    """One tick of the composed protocol: Mandator then Sporades, which
    orders Mandator's lastCompletedRounds."""
    m = mandator.tick(carry["m"], t, draws[:, t], env, cfg)
    s = sporades.tick(carry["s"], t, env, cfg,
                      mandator.get_client_requests(m))
    return {"m": m, "s": s}


def _scan_body(cfg: SMRConfig, n_ticks: int, env: Dict, draws: torch.Tensor,
               batch: int, device: torch.device):
    """The tick loop. Returns (final carry, trace) with trace leaves
    [B, T, ...]: cvc (cluster max committed VC), cvc_all, commit_key,
    is_async, v_cur."""
    n = cfg.n_replicas
    carry = init_carry(cfg, n_ticks, batch, device)

    def buf(*shape, dtype=torch.int32):
        return torch.empty((batch, n_ticks, *shape), dtype=dtype,
                           device=device)

    trace = {"cvc": buf(n), "cvc_all": buf(n, n), "commit_key": buf(n),
             "is_async": buf(n, dtype=torch.bool), "v_cur": buf(n)}
    for t in range(n_ticks):
        carry = step(carry, t, draws, env, cfg)
        s = carry["s"]
        trace["cvc"][:, t] = s["cvc"].amax(dim=1)
        trace["cvc_all"][:, t] = s["cvc"]
        trace["commit_key"][:, t] = s["commit_key"]
        trace["is_async"][:, t] = s["is_async"]
        trace["v_cur"][:, t] = s["v_cur"]
    return carry, trace


def _weighted_quantile(vals: torch.Tensor, weights: torch.Tensor,
                       q: float) -> torch.Tensor:
    """Weighted quantile over the last axis; zero-weight entries are inert
    (they only flatten the CDF). vals, weights: [..., M] -> [...].

    The CDF's running sums are float64 sums rounded to float32, as the
    CPU's float32 cumsum gives them; CUDA's float32 cumsum scans in
    float32 in another order."""
    order = torch.argsort(vals, dim=-1, stable=True)
    v = torch.gather(vals, -1, order)
    w = torch.gather(weights, -1, order)
    cum = torch.cumsum(w.double(), dim=-1).float()
    tot = cum[..., -1:]
    cdf = cum / torch.where(tot > 0, tot, 1.0)
    qv = torch.full(cdf.shape[:-1] + (1,), q, dtype=cdf.dtype,
                    device=cdf.device)
    idx = torch.clamp(torch.searchsorted(cdf.contiguous(), qv, right=False),
                      0, v.shape[-1] - 1)
    out = torch.gather(v, -1, idx)
    return torch.where(tot > 0, out, float("nan"))[..., 0]


def _batch_metrics(cfg: SMRConfig, create_t, arr_mean, count, commit_t,
                   warmup_frac=0.15, bucket_ms=500.0) -> Dict:
    """Metrics over batch records [B, n, R] (ticks -> ms via cfg.tick_ms),
    on the device, per lane.

    The sums of float32 terms (throughput, committed, the timelines and
    the per-origin latency sums) are taken in float64 and rounded once to
    float32. A float64 sum of float32 terms is exact unless they span more
    than 53 bits (a total above 2^30 with terms below 2^-22 in it), so in
    the simulator's range no order of summation can move the result. In
    float32 the CUDA reduction and the CPU's add in other orders, and
    ``scatter_add_`` adds by atomics in no fixed order on the card (the
    per-origin latency timeline differed from run to run)."""
    B, n = count.shape[:2]
    n_ticks = netsim.sim_ticks(cfg)
    ok = torch.isfinite(commit_t) & (count > 0) & torch.isfinite(create_t)
    lat_ms = (commit_t - arr_mean) * cfg.tick_ms
    w0 = warmup_frac * n_ticks
    in_win = ok & (commit_t >= w0)
    win_s = (n_ticks - w0) * cfg.tick_ms / 1000.0
    w_o = torch.where(in_win, count, 0.0)                     # [B, n, R]
    w = w_o.reshape(B, -1)
    if win_s > 0:
        # a tensor divisor: CUDA divides by a Python scalar as a product
        # with its float32 reciprocal, one ulp off the CPU's quotient
        tot = w.double().sum(dim=1).float()
        tput = tot / torch.full_like(tot, win_s)
    else:
        tput = torch.zeros(B, dtype=torch.float32, device=count.device)
    lat_flat = lat_ms.reshape(B, -1)
    med = _weighted_quantile(lat_flat, w, 0.5)
    p99 = _weighted_quantile(lat_flat, w, 0.99)
    nbuck = int(math.ceil(n_ticks * cfg.tick_ms / bucket_ms))
    b = torch.where(ok, commit_t * (cfg.tick_ms / bucket_ms), 0.0
                    ).to(torch.int32).clamp(0, nbuck - 1).long()
    cnt_ok = torch.where(ok, count, 0.0)

    def bucket_sum(*shape, index, src):
        """scatter_add_ of float32 ``src`` along the last axis, exact."""
        return torch.zeros(shape, dtype=torch.float64, device=count.device
                           ).scatter_add_(len(shape) - 1, index,
                                          src.double()).float()

    timeline = bucket_sum(B, nbuck, index=b.reshape(B, -1),
                          src=cnt_ok.reshape(B, -1))
    timeline = timeline / (bucket_ms / 1000.0)
    # per-origin client-perceived latency: where is the latency paid?
    med_o = _weighted_quantile(lat_ms, w_o, 0.5)
    p99_o = _weighted_quantile(lat_ms, w_o, 0.99)
    tl_o = bucket_sum(B, n, nbuck, index=b, src=cnt_ok)
    lat_sum = bucket_sum(B, n, nbuck, index=b,
                         src=cnt_ok * torch.where(ok, lat_ms, 0.0))
    lat_tl_o = torch.where(tl_o > 0, lat_sum / torch.clamp(tl_o, min=1e-9),
                           float("nan"))
    return {"throughput": tput, "median_ms": med, "p99_ms": p99,
            "timeline": timeline,
            "committed": cnt_ok.reshape(B, -1).double().sum(dim=1).float(),
            "origin_median_ms": med_o, "origin_p99_ms": p99_o,
            "origin_timeline": tl_o / (bucket_ms / 1000.0),
            "origin_lat_ms_timeline": lat_tl_o}


def _vc_commit_ticks(cvc_trace: torch.Tensor, r_max: int) -> torch.Tensor:
    """cvc_trace: [B, T, n] monotone. Returns [B, n, r_max] where column r
    is the commit tick of batch (k, r); rounds are 1-based so column 0 is
    inf, and inf marks rounds that never commit."""
    B, ticks, n = cvc_trace.shape
    seq = cvc_trace.transpose(1, 2).contiguous()              # [B, n, T]
    rs = torch.arange(r_max, dtype=seq.dtype, device=seq.device)
    idx = torch.searchsorted(seq, rs.expand(B, n, r_max).contiguous(),
                             right=False)
    valid = (idx < ticks) & (rs >= 1)
    return torch.where(valid, idx.float(), float("inf"))


def sim_point(protocol: str, cfg: SMRConfig, env: Dict,
              rate_per_tick: Sequence[float], seeds: Sequence[int],
              draws: Optional[torch.Tensor] = None,
              mode: WorkloadMode = TRIVIAL_MODE, device=None) -> Dict:
    """Every lane of a batched grid, end to end: tick loop + on-device
    metric extraction. env: batched env (leaves [B, ...], see
    netsim.stack_envs); rate_per_tick, seeds: per lane; draws: optional
    [B, T, n] arrival table (default: ``workload.draw_table`` from the
    seeds). ``cfg.delay_horizon_ticks`` must be resolved to an int.
    Returns a dict of [B, ...] tensors."""
    check_supported(protocol, cfg, mode)
    dev = _device.resolve(device)
    if not isinstance(cfg.delay_horizon_ticks, int):
        raise ValueError("sim_point needs a resolved horizon; call "
                         "netsim.resolve_horizon first")
    n_ticks = netsim.sim_ticks(cfg)
    batch = len(seeds)
    env = {k: v.to(dev) for k, v in env.items()}
    if draws is None:
        draws = wlmod.draw_table(rate_per_tick, seeds, n_ticks,
                                 cfg.n_replicas, dev)
    draws = torch.as_tensor(draws, dtype=torch.float32, device=dev)
    if tuple(draws.shape) != (batch, n_ticks, cfg.n_replicas):
        raise ValueError(f"draws must be [B, T, n] = "
                         f"{(batch, n_ticks, cfg.n_replicas)}, got "
                         f"{tuple(draws.shape)}")
    st, trace = _scan_body(cfg, n_ticks, env, draws, batch, dev)
    wl = st["m"]["wl"]
    commit_t = _vc_commit_ticks(trace["cvc"], wl["batch_count"].shape[2])
    out = _batch_metrics(cfg, wl["batch_create_t"], wl["batch_arr_mean"],
                         wl["batch_count"], commit_t)
    out["async_frac"] = trace["is_async"].float().flatten(1).mean(dim=1)
    out["views"] = trace["v_cur"].flatten(1).amax(dim=1)
    out["cvc_all"] = trace["cvc_all"]          # [B, ticks, n, n]
    out["commit_key"] = trace["commit_key"]    # [B, ticks, n]
    return out
