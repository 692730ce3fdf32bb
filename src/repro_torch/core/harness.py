"""SMR simulation harness: drives a protocol over the WAN sim and produces
the paper's metrics (throughput, median/p99 execution latency, timelines).
Port of ``repro.core.harness`` for the scan protocols:

  mandator-sporades  — Alg 1 + Algs 2/3 (full tick-level state machines)
  mandator-paxos     — Alg 1 + Multi-Paxos ordering the vector clock
  multipaxos         — monolithic Multi-Paxos (batches inside consensus)
  mandator           — dissemination layer alone (completion throughput)

The analytic baselines (epaxos, rabia) have no tick loop; the sweep engine
(core/experiment.py) runs them on the host.

``sim_point`` runs the tick loop for every lane of a batched env at once —
a Python loop over ticks whose per-tick outputs land in preallocated
``[B, T, ...]`` tensors — then extracts the metrics on the device
(searchsorted commit reconstruction, weighted quantiles, timelines). Every
workload mode runs: the §5.2 baseline, windowed rate tables and closed
loops (whose in-flight feedback, ``_closed_feedback``, runs after the
protocol ticks); so does every ``trace_level`` (the layers' flight
recorders, ``_phase_breakdown``) and ``monitor_level`` (the health
monitor, fed by ``_monitor_views``). Recording and monitoring only read
the protocol state, so the metrics do not depend on either level.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch

from repro_torch import device as _device
from repro_torch.configs.smr import SMRConfig
from repro_torch.core import channel as ch
from repro_torch.core import mandator, netsim, paxos, sporades
from repro_torch.core import workload as wlmod
from repro_torch.obs import monitor as hmon
from repro_torch.obs import trace as obs
from repro_torch.workloads.compile import TRIVIAL_MODE, WorkloadMode

PROTOCOLS = ("mandator-sporades", "mandator-paxos", "multipaxos",
             "mandator")


def check_supported(protocol: str, cfg: SMRConfig,
                    mode: WorkloadMode = TRIVIAL_MODE) -> None:
    """Raise ValueError for a name that is no scan protocol, a trace or
    monitor level that does not exist, or a mode no grid lowers to
    (``workloads.mode_of``: a closed grid is never trivial). Every mode a
    grid lowers to runs."""
    if protocol not in PROTOCOLS:
        raise ValueError(f"{protocol!r} is not a scan protocol; the "
                         f"harness runs {PROTOCOLS}")
    obs.TraceLevel.check(cfg.trace_level)
    hmon.MonitorLevel.check(cfg.monitor_level)
    if mode.trivial and mode.closed:
        raise ValueError(f"{mode}: a closed-loop grid is never trivial")


def init_carry(cfg: SMRConfig, n_ticks: int, batch: int,
               device: torch.device,
               protocol: str = "mandator-sporades", closed: bool = False
               ) -> Dict:
    """The carry of ``protocol``: {"m": mandator state} for the protocols
    built on Mandator, plus "s" (sporades) or "p" (paxos in mandator
    mode); {"p": paxos state} for multipaxos. ``closed`` shapes the
    workload state where the clients' requests arrive. The health
    monitor's state ("mon") is added by ``_scan_body``."""
    carry = {}
    if protocol != "multipaxos":
        carry["m"] = mandator.init_state(cfg, n_ticks, batch, device,
                                         closed)
    if protocol == "mandator-sporades":
        carry["s"] = sporades.init_state(cfg, n_ticks, batch, device)
    elif protocol in ("mandator-paxos", "multipaxos"):
        carry["p"] = paxos.init_state(
            cfg, n_ticks, protocol == "mandator-paxos", batch, device,
            closed)
    return carry


def _sum_origins(x: torch.Tensor) -> torch.Tensor:
    """[B, n] -> [B]: a float32 sum over origins in origin order, one
    rounding per add, as XLA's CPU reduction loop adds."""
    acc = x[:, 0]
    for i in range(1, x.shape[1]):
        acc = acc + x[:, i]
    return acc


def _closed_feedback(protocol: str, carry: Dict):
    """Closed-loop commit feedback: a request is in flight from its
    submission until the batch carrying it commits. ``cl_done`` is the
    cumulative per-origin committed request count, recovered from the
    batch records' prefix sums at the protocol's committed rounds (both
    monotone). Returns (carry, in-flight [B, n])."""
    wl_key = "p" if protocol == "multipaxos" else "m"
    carry = dict(carry)
    part = dict(carry[wl_key])
    wl = dict(part["wl"])
    if protocol == "mandator":
        cvc_o = carry["m"]["own_round"]
    elif protocol == "mandator-sporades":
        cvc_o = carry["s"]["cvc"].amax(dim=1)
    elif protocol == "mandator-paxos":
        cvc_o = carry["p"]["cvc"].amax(dim=1)
    else:
        cvc_o = carry["p"]["committed_slot"]
    # cumulative committed count = the prefix sum at the committed round
    cum = wl["batch_count_cum"]
    idx = torch.clamp(cvc_o, 0, cum.shape[2] - 1).long()[..., None]
    done = torch.gather(cum, 2, idx)[..., 0]
    sub = wl["cl_submitted"]
    if protocol == "multipaxos":
        # batch rows live at the (rotating) leader, not the submitting
        # origin: apportion the global committed total pro rata by
        # cumulative submissions (an estimate, so no per-origin ratchet)
        share = sub / torch.clamp(_sum_origins(sub), min=1.0)[:, None]
        done = _sum_origins(done)[:, None] * share
        wl["cl_done"] = torch.minimum(torch.clamp(done, min=0.0), sub)
    else:
        wl["cl_done"] = torch.minimum(
            torch.clamp(torch.maximum(wl["cl_done"], done), min=0.0), sub)
    part["wl"] = wl
    carry[wl_key] = part
    return carry, sub - wl["cl_done"]


def _monitor_views(protocol: str, cfg: SMRConfig, carry: Dict) -> Dict:
    """Protocol-state projection the health monitor consumes
    (``obs.monitor.update``), leaves [B, ...]: per-replica committed
    vector clocks / monotone commit keys / views where the protocol has
    them (None leaves out the check), per-origin formed vs stable rounds,
    a cluster commit total, a pending-work flag, packed-ring occupancy,
    and the per-tick dropped-send counts the ticks stash in ``mon_io``."""
    n = cfg.n_replicas
    views: Dict = {"cvc": None, "commit_seq": None, "view": None}
    rings = []
    dropped = []
    if protocol in ("mandator-sporades", "mandator-paxos", "mandator"):
        m = carry["m"]
        rings.append((mandator.ring_spec(), m["ring"]))
        dropped.append(m["mon_io"]["dropped"])
        views["formed"] = m["formed_round"]
        views["stable"] = m["own_round"]
        pending = (m["wl"]["buffer"] > 0).any(dim=1)
    if protocol == "mandator":
        # lcr rows are per-replica knowledge vectors: no agreement check;
        # completion order still is one
        views["commit_seq"] = m["own_round"]
        views["commit_tot"] = m["own_round"].sum(dim=1).float()
        views["pending"] = pending | (m["formed_round"]
                                      > m["own_round"]).any(dim=1)
    elif protocol == "mandator-sporades":
        s = carry["s"]
        rings.append((sporades.ring_spec(n), s["ring"]))
        dropped.append(s["mon_io"]["dropped"])
        views["cvc"] = s["cvc"]
        views["commit_seq"] = s["commit_key"]
        views["view"] = s["v_cur"]
        views["commit_tot"] = s["cvc"].flatten(1).sum(dim=1).float()
        views["pending"] = pending | (m["formed_round"]
                                      > s["cvc"].amax(dim=1)).any(dim=1)
    elif protocol == "mandator-paxos":
        p = carry["p"]
        rings.append((paxos.ring_spec(n, True), p["ring"]))
        dropped.append(p["mon_io"]["dropped"])
        views["cvc"] = p["cvc"]
        views["view"] = p["view"]
        views["commit_tot"] = p["cvc"].flatten(1).sum(dim=1).float()
        views["pending"] = pending | (m["formed_round"]
                                      > p["cvc"].amax(dim=1)).any(dim=1)
    elif protocol == "multipaxos":
        p = carry["p"]
        rings.append((paxos.ring_spec(n, False), p["ring"]))
        dropped.append(p["mon_io"]["dropped"])
        # per-replica slot counters are each leader's own ledger
        views["formed"] = p["slot"]
        views["stable"] = p["committed_slot"]
        views["commit_seq"] = p["committed_slot"]
        views["view"] = p["view"]
        views["commit_tot"] = p["committed_slot"].sum(dim=1).float()
        views["pending"] = ((p["wl"]["buffer"] > 0).any(dim=1)
                            | p["outstanding"].any(dim=1))
    occ = [ch.ring_occupancy(spec, ring) for spec, ring in rings]
    views["ring_occ"] = occ[0] if len(occ) == 1 else torch.maximum(*occ)
    views["dropped"] = dropped[0] if len(dropped) == 1 \
        else dropped[0] + dropped[1]
    return views


def _arrivals(draws) -> wlmod.Arrivals:
    """A bare [B, T, n] draw table is the trivial mode's Arrivals."""
    if isinstance(draws, wlmod.Arrivals):
        return draws
    return wlmod.Arrivals(draws)


def _tick(carry: Dict, t: int, arr: wlmod.Arrivals, env: Dict,
          cfg: SMRConfig, protocol: str, grace: Optional[torch.Tensor]):
    """One tick of ``protocol``; returns (carry, per-tick outputs that are
    not read off the carry: the closed loop's in-flight counts)."""
    carry = dict(carry)
    out = {}
    if "m" in carry:
        carry["m"] = mandator.tick(carry["m"], t, arr, env, cfg)
        lcr = mandator.get_client_requests(carry["m"])
    if protocol == "mandator-sporades":
        carry["s"] = sporades.tick(carry["s"], t, env, cfg, lcr)
    elif protocol == "mandator-paxos":
        carry["p"] = paxos.tick(carry["p"], t, None, env, cfg, True, lcr=lcr)
    elif protocol == "multipaxos":
        carry["p"] = paxos.tick(carry["p"], t, arr, env, cfg, False)
    if arr.mode.closed:
        carry, out["inflight"] = _closed_feedback(protocol, carry)
    if "mon" in carry:
        carry["mon"] = hmon.update(
            carry["mon"], t, cfg, env, _monitor_views(protocol, cfg, carry),
            grace, wlt=arr.wlt, inflight=out.get("inflight"),
            # multipaxos closed-loop completion is a pro-rata estimate
            # (see _closed_feedback): the cap is checkable only where done
            # is exact
            check_cap=arr.mode.closed and protocol != "multipaxos")
    return carry, out


def step(carry: Dict, t: int, draws, env: Dict, cfg: SMRConfig,
         protocol: str = "mandator-sporades",
         grace: Optional[torch.Tensor] = None) -> Dict:
    """One tick of ``protocol``. Mandator runs first where it is composed;
    Sporades or Paxos then orders its lastCompletedRounds. ``draws`` is a
    [B, T, n] draw table (trivial mode) or a ``workload.Arrivals``; the
    clients' arrivals land in Mandator or (multipaxos) Paxos. ``grace``:
    the monitor's stall window, where the carry holds a monitor (default:
    ``monitor.stall_grace_ticks``)."""
    if grace is None and "mon" in carry:
        grace = hmon.stall_grace_ticks(cfg, env)
    return _tick(carry, t, _arrivals(draws), env, cfg, protocol, grace)[0]


def _trace_leaves(protocol: str, cfg: SMRConfig) -> Dict:
    """The per-tick trace of ``protocol``: {name: (per-lane shape, dtype,
    function of the carry)}. ``cvc`` is the cluster max committed VC;
    with tracing on, the Mandator compositions add ``own_round`` and
    mandator-paxos each origin's own committed-VC view ``cvc_own`` (the
    phase breakdown's stability and delivery boundaries)."""
    n = cfg.n_replicas
    i32 = torch.int32
    own = {"own_round": ((n,), i32, lambda c: c["m"]["own_round"])}
    traced = cfg.trace_level != obs.TraceLevel.OFF
    if protocol == "mandator":
        return own
    if protocol == "mandator-paxos":
        leaves = {"cvc": ((n,), i32, lambda c: c["p"]["cvc"].amax(dim=1))}
        if traced:
            leaves.update(own, cvc_own=(
                (n,), i32, lambda c: c["p"]["cvc"].diagonal(dim1=1,
                                                            dim2=2)))
        return leaves
    if protocol == "multipaxos":
        return {"committed_slot": ((n,), i32,
                                   lambda c: c["p"]["committed_slot"])}
    leaves = {"cvc": ((n,), i32, lambda c: c["s"]["cvc"].amax(dim=1)),
              "cvc_all": ((n, n), i32, lambda c: c["s"]["cvc"]),
              "commit_key": ((n,), i32, lambda c: c["s"]["commit_key"]),
              "is_async": ((n,), torch.bool, lambda c: c["s"]["is_async"]),
              "v_cur": ((n,), i32, lambda c: c["s"]["v_cur"])}
    if traced:
        leaves.update(own)
    return leaves


def init_run(protocol: str, cfg: SMRConfig, n_ticks: int, env: Dict,
             draws, batch: int, device: torch.device):
    """A run's tick-0 carry and the monitor's stall window (None with the
    monitor off). ``draws``: a [B, T, n] draw table (trivial mode) or a
    ``workload.Arrivals``."""
    arr = _arrivals(draws)
    carry = init_carry(cfg, n_ticks, batch, device, protocol,
                       arr.mode.closed)
    grace = None
    if hmon.on(cfg.monitor_level):
        # absent from the carry at the default monitor_level="off"
        grace = hmon.stall_grace_ticks(cfg, env)
        carry["mon"] = hmon.init_monitor(
            cfg, n_ticks, _monitor_views(protocol, cfg, carry))
    return carry, grace


def _scan_body(protocol: str, cfg: SMRConfig, n_ticks: int, env: Dict,
               draws, batch: int, device: torch.device):
    """The tick loop. ``draws``: a [B, T, n] draw table (trivial mode) or
    a ``workload.Arrivals``. Returns (final carry, trace) with trace
    leaves [B, T, ...] (``_trace_leaves``, plus ``inflight`` [B, T, n] in
    closed mode)."""
    arr = _arrivals(draws)
    carry, grace = init_run(protocol, cfg, n_ticks, env, arr, batch, device)
    leaves = _trace_leaves(protocol, cfg)
    trace = {k: torch.empty((batch, n_ticks, *shape), dtype=dtype,
                            device=device)
             for k, (shape, dtype, _) in leaves.items()}
    if arr.mode.closed:
        trace["inflight"] = torch.empty((batch, n_ticks, cfg.n_replicas),
                                        dtype=torch.float32, device=device)
    for t in range(n_ticks):
        carry, out = _tick(carry, t, arr, env, cfg, protocol, grace)
        for k, (_, _, leaf) in leaves.items():
            trace[k][:, t] = leaf(carry)
        if arr.mode.closed:
            trace["inflight"][:, t] = out["inflight"]
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


def _lane_tables(wlt: Dict, batch: int, device: torch.device) -> Dict:
    """The grid's workload tables on ``device``: rate_of [B, W, n] and
    think_ticks / cap / closed [B] float32, win_of_tick [B, T] int64."""
    out = {}
    for k in ("rate_of", "closed", "think_ticks", "cap"):
        out[k] = torch.as_tensor(wlt[k], dtype=torch.float32, device=device)
    out["win_of_tick"] = torch.as_tensor(wlt["win_of_tick"], device=device
                                         ).long()
    if out["rate_of"].shape[0] != batch:
        raise ValueError(f"wlt holds {out['rate_of'].shape[0]} lanes, the "
                         f"grid {batch}")
    return out


def make_arrivals(cfg: SMRConfig, mode: WorkloadMode,
                  rate_per_tick: Sequence[float], seeds: Sequence[int],
                  device: torch.device, wlt: Optional[Dict] = None,
                  draws=None, epochs=None) -> wlmod.Arrivals:
    """The arrivals of a grid's run (see ``sim_point``): open lanes read
    ``draws`` ([B, T, n]; default ``workload.draw_table`` from the seeds),
    closed lanes sample ``epochs`` ([B, n, M] float64; default
    ``workload.epoch_stream`` from the seeds) — unless ``draws`` is given
    and ``epochs`` is not: then every lane replays ``draws``."""
    n_ticks, batch, n = netsim.sim_ticks(cfg), len(seeds), cfg.n_replicas
    if mode.trivial:
        wlt = None
    elif wlt is None:
        raise ValueError(f"{mode} needs the grid's workload tables (wlt)")
    else:
        wlt = _lane_tables(wlt, batch, device)
    replay = mode.closed and draws is not None and epochs is None
    if draws is None:
        draws = wlmod.draw_table(rate_per_tick, seeds, n_ticks, n, device,
                                 wlt)
    draws = torch.as_tensor(draws, dtype=torch.float32, device=device)
    if tuple(draws.shape) != (batch, n_ticks, n):
        raise ValueError(f"draws must be [B, T, n] = {(batch, n_ticks, n)}, "
                         f"got {tuple(draws.shape)}")
    if mode.closed and not replay:
        if epochs is None:
            epochs = wlmod.epoch_stream(rate_per_tick, seeds, wlt, n_ticks,
                                        n, device)
        epochs = torch.as_tensor(epochs, dtype=torch.float64,
                                 device=device).contiguous()
        if epochs.dim() != 3 or tuple(epochs.shape[:2]) != (batch, n):
            raise ValueError(f"epochs must be [B, n, M] with (B, n) = "
                             f"{(batch, n)}, got {tuple(epochs.shape)}")
    else:
        epochs = None
    rate = torch.tensor(list(rate_per_tick), dtype=torch.float32,
                        device=device)
    cut = torch.zeros(batch, dtype=torch.bool, device=device) \
        if replay else None
    return wlmod.Arrivals(draws, mode, wlt, rate, epochs, cut)


def sim_point(protocol: str, cfg: SMRConfig, env: Dict,
              rate_per_tick: Sequence[float], seeds: Sequence[int],
              draws: Optional[torch.Tensor] = None,
              mode: WorkloadMode = TRIVIAL_MODE, device=None,
              wlt: Optional[Dict] = None,
              epochs: Optional[torch.Tensor] = None) -> Dict:
    """Every lane of a batched grid, end to end: tick loop + on-device
    metric extraction. env: batched env (leaves [B, ...], see
    netsim.stack_envs); rate_per_tick, seeds: per lane; ``mode``: the
    grid's workload mode, ``wlt`` its workload tables stacked per lane
    (``experiment._lower_workloads``; required unless ``mode.trivial``).
    ``cfg.delay_horizon_ticks`` must be resolved to an int.

    Arrivals (``make_arrivals``): open lanes read ``draws`` ([B, T, n]
    counts; default ``workload.draw_table`` from the seeds). Closed lanes
    sample ``epochs`` ([B, n, M] float64, ``workload.epoch_stream``;
    default from the seeds) — unless ``draws`` is given and ``epochs`` is
    not: then every lane replays ``draws``, closed lanes' counts being the
    counts after the cap, and a cap that cuts one raises ValueError.

    Returns a dict of [B, ...] tensors: the metrics of every protocol,
    plus async_frac, views, cvc_all and commit_key for mandator-sporades;
    ``inflight_max`` in closed mode; the phase breakdown and ``obs`` (the
    layers' trace rings) with tracing on; ``mon`` with monitoring on."""
    check_supported(protocol, cfg, mode)
    dev = _device.resolve(device)
    if not isinstance(cfg.delay_horizon_ticks, int):
        raise ValueError("sim_point needs a resolved horizon; call "
                         "netsim.resolve_horizon first")
    n_ticks = netsim.sim_ticks(cfg)
    batch = len(seeds)
    env = {k: v.to(dev) for k, v in env.items()}
    arr = make_arrivals(cfg, mode, rate_per_tick, seeds, dev, wlt, draws,
                        epochs)
    st, trace = _scan_body(protocol, cfg, n_ticks, env, arr, batch, dev)
    wl = st["p" if protocol == "multipaxos" else "m"]["wl"]
    if arr.cut is not None and bool(arr.cut.any()):
        raise ValueError("draws replays the closed lanes' counts after the "
                         "cap, but the cap cut one: the replayed counts are "
                         "not this run's")
    wlmod.check_epochs(wl, arr)
    if protocol == "mandator":
        # dissemination completion = "commit" for availability accounting
        cvc = trace["own_round"]
    elif protocol == "multipaxos":
        cvc = trace["committed_slot"]
    else:
        # batch r commits once the committed VC reaches r (1-based rounds)
        cvc = trace["cvc"]
    commit_t = _vc_commit_ticks(cvc, wl["batch_count"].shape[2])
    out = _batch_metrics(cfg, wl["batch_create_t"], wl["batch_arr_mean"],
                         wl["batch_count"], commit_t)
    if protocol == "mandator-sporades":
        out["async_frac"] = trace["is_async"].float().flatten(1).mean(dim=1)
        out["views"] = trace["v_cur"].flatten(1).amax(dim=1)
        out["cvc_all"] = trace["cvc_all"]          # [B, ticks, n, n]
        out["commit_key"] = trace["commit_key"]    # [B, ticks, n]
    if mode.closed:
        out["inflight_max"] = trace["inflight"].amax(dim=1)      # [B, n]
    if cfg.trace_level != obs.TraceLevel.OFF:
        out.update(_phase_breakdown(protocol, cfg, wl, trace, commit_t,
                                    n_ticks))
        out["obs"] = {layer: obs.public_view(st[k]["tr"])
                      for k, layer in (("m", "mandator"), ("s", "sporades"),
                                       ("p", "paxos"))
                      if k in st and "tr" in st[k]}
    if hmon.on(cfg.monitor_level):
        out["mon"] = hmon.public_view(st["mon"], n_ticks)
    return out


def _phase_breakdown(protocol: str, cfg: SMRConfig, wl: Dict, trace: Dict,
                     commit_t: torch.Tensor, n_ticks: int,
                     warmup_frac: float = 0.15) -> Dict:
    """Latency-breakdown accounting (``obs.PHASES``): split each committed
    batch's end-to-end latency at three protocol boundaries — batch
    creation at the origin (queue | dissemination), stability (n-f
    dissemination votes; dissemination | consensus), and global commit
    (consensus | delivery, the origin's own observation). The four phase
    marks telescope back to the client-perceived latency of
    ``_batch_metrics``: same arrival mean, same commit reconstruction."""
    r_max = wl["batch_count"].shape[2]
    create_t, arr_t = wl["batch_create_t"], wl["batch_arr_mean"]
    cnt = wl["batch_count"]
    if protocol == "mandator":
        # dissemination IS the protocol: completion == commit == delivery
        stable_t = deliv_t = commit_t
    elif protocol in ("mandator-sporades", "mandator-paxos"):
        # stability = the origin's own chain completing the round
        stable_t = _vc_commit_ticks(trace["own_round"], r_max)
        own_cvc = (trace["cvc_all"].diagonal(dim1=2, dim2=3)
                   if protocol == "mandator-sporades" else trace["cvc_own"])
        deliv_t = _vc_commit_ticks(own_cvc, r_max)
    else:  # multipaxos: monolithic — the slot batch enters consensus as
        # it forms, and commit is observed at the committing leader
        stable_t = create_t
        deliv_t = commit_t
    marks = torch.stack([create_t, stable_t, commit_t, deliv_t], dim=1)
    prev = torch.stack([arr_t, create_t, stable_t, commit_t], dim=1)
    phases_ms = torch.clamp(marks - prev, min=0.0) * cfg.tick_ms  # [B,4,n,R]
    ok = torch.isfinite(marks).all(dim=1) & (cnt > 0)
    in_win = ok & (commit_t >= warmup_frac * n_ticks)   # same window as
    w = torch.where(in_win, cnt, 0.0)                   # _batch_metrics
    flat = phases_ms.flatten(2)                                  # [B,4,nR]
    w_flat = w.flatten(1)[:, None, :].expand_as(flat)
    w_orig = w[:, None].expand_as(phases_ms)
    out = {"phase_med_ms": _weighted_quantile(flat, w_flat, 0.5),  # [B, 4]
           "phase_p99_ms": _weighted_quantile(flat, w_flat, 0.99),
           "phase_origin_med_ms": _weighted_quantile(phases_ms, w_orig,
                                                     0.5),   # [B, 4, n]
           "phase_origin_p99_ms": _weighted_quantile(phases_ms, w_orig,
                                                     0.99)}
    if cfg.trace_level == obs.TraceLevel.FULL:
        out["batch_marks_t"] = marks      # absolute ticks, inf = never
        out["batch_arr_t"] = arr_t
        out["batch_n"] = cnt
    return out
