"""Mandator (Algorithm 1) — consensus-agnostic asynchronous request
dissemination, batched over the grid (port of ``repro.core.mandator``):

- every replica runs its own chain of Mandator-batches,
- a batch is broadcast, voted, and *completed* once n-f <Mandator-vote>s
  arrive; the next batch is only formed after completion (awaitingAcks
  gate), with up to ``mandator_lanes`` outstanding (§4 child processes),
- getClientRequests() returns the replica's lastCompletedRounds[] vector
  clock — the only thing the consensus layer ever orders.

Every state tensor carries a leading lane axis ``B``. The tick takes a
0-dim int32 tensor ``t`` (a Python int is converted) and does no host
sync. With ``trace_level`` or ``monitor_level`` on, the state also
carries the layer's flight recorder (``tr``) and the monitor's per-tick
IO gauges (``mon_io``); the tick's last step records into them and reads
nothing they hold.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch import device as _device
from repro_torch.configs.smr import SMRConfig
from repro_torch.core import channel as ch
from repro_torch.core import netsim, workload
from repro_torch.obs import monitor as hmon
from repro_torch.obs import trace as obs


def ring_spec() -> ch.RingSpec:
    """Packed delivery ring: both message types in one fused buffer."""
    return ch.RingSpec(
        ch.ChannelSpec("batch", 2),    # (round, lastCompleted)
        ch.ChannelSpec("vote", 1),
    )


def init_state(cfg: SMRConfig, n_ticks: int, batch: int = 1,
               device=None, closed: bool = False) -> Dict:
    """Tick-0 state of ``batch`` lanes on ``device`` (None = CUDA).
    ``cfg.delay_horizon_ticks`` must be resolved to an int. ``closed`` shapes
    the workload state (``workload.init_workload``)."""
    dev = _device.resolve(device)
    n = cfg.n_replicas
    zi = lambda *s: torch.zeros((batch, *s), dtype=torch.int32,  # noqa: E731
                                device=dev)
    # flight recorder and monitor IO: absent at trace_level / monitor_level
    # "off", so the untraced tick runs exactly the untraced ops
    extra = {}
    tr = obs.init_trace(obs.DEFAULT_SPEC, cfg.trace_level, n,
                        cfg.trace_events, batch, dev)
    if tr is not None:
        extra["tr"] = tr
    if hmon.on(cfg.monitor_level):
        extra["mon_io"] = {"dropped": zi(n)}
    return {
        **extra,
        "wl": workload.init_workload(cfg, n_ticks, batch, dev, closed),
        "own_round": zi(n),       # last completed round
        "formed_round": zi(n),    # last formed round
        "lcr": zi(n, n),          # i's lastCompletedRounds
        "seen_round": zi(n, n),   # i's max batch seen from j
        "vote_max": zi(n, n),     # votes i received from j
        "ring": ch.make_ring(ring_spec(), int(cfg.delay_horizon_ticks), n,
                             batch, dev),
        "egress_busy": torch.zeros((batch, n), dtype=torch.float32,
                                   device=dev),
    }


def tick(st: Dict, t: torch.Tensor, arr: workload.Arrivals, env: Dict,
         cfg: SMRConfig) -> Dict:
    """One simulator tick of every lane. arr: the arrivals the tick's
    clients read (``workload.Arrivals``)."""
    n = cfg.n_replicas
    f = (n - 1) // 2
    quorum = n - f
    t = _device.tick_index(t, env["delays"].device)
    alive = netsim.alive(env, t)
    delays = netsim.link_delay(env, t)
    drop = netsim.link_drop(env, t)
    st = dict(st)
    # one fused pop of slot t for every channel; sends buffer up and commit
    # as one fused scatter at the end of the tick (same-tick sends always
    # land at t+1 or later, so the reorder is exact — channel.py)
    spec = ring_spec()
    msgs = ch.ring_deliver(spec, st["ring"], t)
    sends = []

    # 1) client arrivals + cpu refill
    wl = workload.arrive(st["wl"], arr, t, alive)
    wl = workload.refill_cpu(wl, env["cpu_req_per_tick"])

    # 2) deliver <new-Mandator-batch>: update seen rounds + lcr, send votes
    bflags, bpayload = msgs["batch"]
    folded = ch.fold_state(
        torch.stack([st["seen_round"], st["lcr"]], dim=-1).float(),
        bflags, bpayload)
    seen = folded[..., 0].to(torch.int32)
    # batch carries its creator's lastCompletedRounds (parent link, line 15)
    lcr = folded[..., 1].to(torch.int32)
    # vote for every newly seen batch (line 16): cumulative vote = max round
    vote_mask = bflags.transpose(1, 2) & alive[:, :, None]   # [voter, owner]
    vote_payload = seen.float()[..., None]                   # [B, n, n, 1]
    delays_i = delays.to(torch.int32)
    sends.append(ch.Send("vote", vote_payload, delays_i, vote_mask))

    # 3) deliver votes; in-order completion check (lines 17-19); with lanes,
    #    several rounds may complete back-to-back in one tick
    vflags, vpayload = msgs["vote"]
    vote_max = ch.fold_state(st["vote_max"].float()[..., None], vflags,
                             vpayload)[..., 0].to(torch.int32)
    own_round = st["own_round"]
    for _ in range(cfg.mandator_lanes):
        await_round = own_round + 1
        votes = torch.sum(vote_max >= await_round[:, :, None], dim=2)
        done = (st["formed_round"] >= await_round) & (votes >= quorum)
        own_round = torch.where(done, await_round, own_round)
    lcr.diagonal(dim1=1, dim2=2).copy_(own_round)

    # 4) form + broadcast next batch (lines 8-12); §4 child processes allow
    #    up to `mandator_lanes` outstanding batches per chain
    can_form = alive & (st["formed_round"] - own_round < cfg.mandator_lanes)
    wl, formed, count = workload.form_batches(
        wl, t, can_form, st["formed_round"] + 1, cfg.batch_mandator,
        cfg.max_batch_ms / cfg.tick_ms)
    formed_round = torch.where(formed, st["formed_round"] + 1,
                               st["formed_round"])
    # child processes serialize on their own NIC share; the replica NIC is
    # modelled as the shared egress
    bytes_out = ((count * cfg.request_bytes + 100.0)[..., None]
                 * formed[..., None]).expand(-1, n, n) \
        / netsim.nic_rate(env, t)[..., None]
    busy, ser_delay = netsim.egress_delay(st["egress_busy"], t, bytes_out)
    busy = torch.where(formed, busy, st["egress_busy"])
    total_delay = (delays + torch.where(formed[..., None], ser_delay, 0.0)
                   ).to(torch.int32)
    bpay = torch.stack([formed_round, own_round], dim=-1).float()[:, :, None]
    sends.append(ch.Send("batch", bpay.expand(-1, n, n, 2), total_delay,
                         formed[:, :, None].expand(-1, n, n)))

    ring = ch.ring_commit(spec, st["ring"], t, sends, drop=drop,
                          backend=cfg.channel_backend)

    # ---- flight recorder + monitor IO (absent => not run) ---------------
    tr = st.get("tr")
    if tr is not None or "mon_io" in st:
        cut = (vote_mask & drop).sum(dim=2) + (formed[..., None]
                                               & drop).sum(dim=2)
    if tr is not None:
        completed = own_round - st["own_round"]
        done = completed > 0
        st["tr"] = obs.record_env(
            obs.DEFAULT_SPEC, tr, alive, t, a=own_round, b=formed_round,
            dropped_links=cut, events=(
                ("batch_ack", done, own_round, quorum),
                ("batch_stable", done, own_round, completed),
                ("batch_create", formed, formed_round, count),
                ("batch_disseminate", formed, formed_round,
                 ser_delay.amax(dim=2))))
    if "mon_io" in st:
        st["mon_io"] = {"dropped": cut.int()}

    st.update(wl=wl, own_round=own_round, formed_round=formed_round, lcr=lcr,
              seen_round=seen, vote_max=vote_max, ring=ring,
              egress_busy=busy)
    return st


def get_client_requests(st: Dict) -> torch.Tensor:
    """lastCompletedRounds — the consensus payload (lines 20-21).
    [B, n, n]."""
    return st["lcr"]
