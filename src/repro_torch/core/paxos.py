"""Multi-Paxos baseline (§5's monolithic leader-based protocol) and its
Mandator composition (Mandator-Paxos), batched over the grid (port of
``repro.core.paxos``).

Plain mode: clients forward requests to the current leader; the leader runs
one consensus slot at a time (no pipelining, §5.2) carrying the request
batch *in* the accept message (the monolithic anti-pattern the paper
targets) — throughput is bound by batch/slot-RTT and the leader's NIC.

Mandator mode: the slot payload is the leader's lastCompletedRounds vector
clock (meta_bytes), committing every disseminated batch it dominates.

View change: follower timeout -> view++ (rotating leader); a new leader
runs phase-1 (modeled as one majority-RTT delay) before proposing.
Requests forwarded to a failed leader are lost to the count (client retry
is not modeled).

Every state tensor carries a leading lane axis ``B``; matrices are
[B, replica, replica, ...]. The tick takes a 0-dim int32 tensor ``t`` (a
Python int is converted) and does no host sync. With tracing or monitoring on, the state also carries the
layer's flight recorder (``tr``) and the monitor's IO gauges
(``mon_io``), written at the end of the tick.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.configs.smr import SMRConfig
from repro_torch.core import channel as ch
from repro_torch.core import netsim, workload
from repro_torch.obs import monitor as hmon
from repro_torch.obs import trace as obs

I32 = torch.int32


def _phase1_ticks(cfg: SMRConfig) -> np.ndarray:
    """Majority RTT per prospective leader (modeled phase-1 cost), [n]
    float32, from float64 host arithmetic as the reference has it."""
    d = cfg.delays_ms() / cfg.tick_ms
    maj = cfg.n_replicas // 2 + 1
    return np.sort(2 * d, axis=1)[:, maj - 1].astype(np.float32)


def ring_spec(n: int, mandator_mode: bool) -> ch.RingSpec:
    """Packed delivery ring. The additive request-forward channel only
    exists in plain mode (mandator mode orders vector clocks, clients
    never forward), so its fields drop out of the ring entirely there."""
    channels = () if mandator_mode else (
        ch.ChannelSpec("fw", 2, additive=True),)      # (count, tsum)
    return ch.RingSpec(
        *channels,
        ch.ChannelSpec("acc", 3 + n),                 # (view, slot, ., vc)
        ch.ChannelSpec("ack", 1),
    )


def init_state(cfg: SMRConfig, n_ticks: int, mandator_mode: bool,
               batch: int = 1, device=None, closed: bool = False
               ) -> Dict:
    """Tick-0 state of ``batch`` lanes on ``device`` (None = CUDA).
    ``cfg.delay_horizon_ticks`` must be resolved to an int. ``closed`` shapes
    the workload state of plain mode, where the
    clients' requests arrive (``workload.init_workload``)."""
    dev = _device.resolve(device)
    n = cfg.n_replicas

    def z(*s, dtype=I32):
        return torch.zeros((batch, *s), dtype=dtype, device=dev)

    phase1 = _device.to_device(_phase1_ticks(cfg), dev)
    # flight recorder and monitor IO: absent when off (see mandator)
    extra = {}
    tr = obs.init_trace(obs.DEFAULT_SPEC, cfg.trace_level, n,
                        cfg.trace_events, batch, dev)
    if tr is not None:
        extra["tr"] = tr
    if hmon.on(cfg.monitor_level):
        extra["mon_io"] = {"dropped": z(n)}
    closed = closed and not mandator_mode
    return {
        **extra,
        "wl": workload.init_workload(cfg, n_ticks, batch, dev, closed),
        "view": z(n),
        "last_heard": z(n, dtype=torch.float32),
        "ready_at": z(n, dtype=torch.float32),
        "slot": z(n),                          # leader's last started
        "outstanding": z(n, dtype=torch.bool),
        "acks": z(n, n),                       # max slot acked by j
        "committed_slot": z(n),
        "cvc": z(n, n),                        # mandator mode commit VC
        "slot_vc": z(n, 1 + n, dtype=torch.float32),  # outstanding payload
        "ring": ch.make_ring(ring_spec(n, mandator_mode),
                             int(cfg.delay_horizon_ticks), n, batch, dev),
        "egress_busy": z(n, dtype=torch.float32),
        "phase1": phase1.expand(batch, n).contiguous(),
    }


def _sum_senders(x: torch.Tensor) -> torch.Tensor:
    """[B, snd, rcv, P] -> [B, rcv, P]: a float32 sum over senders in
    sender order, one rounding per add, as XLA's CPU reduction loop adds
    (``0 + x_0 + x_1 + ...``). A forwarded ``buffer_tsum`` passes 2^24
    above Multi-Paxos's saturation, where the order decides the bits; a
    library sum may add in another order, on the card in a tree."""
    acc = x[:, 0]
    for i in range(1, x.shape[1]):
        acc = acc + x[:, i]
    return acc


def tick(st: Dict, t: torch.Tensor, arr: Optional[workload.Arrivals],
         env: Dict, cfg: SMRConfig, mandator_mode: bool,
         lcr: Optional[torch.Tensor] = None) -> Dict:
    """One simulator tick of every lane. arr: the arrivals the clients
    read (``workload.Arrivals``), plain mode only; lcr: Mandator's
    getClientRequests() [B, n, n], mandator mode only."""
    n = cfg.n_replicas
    maj = n // 2 + 1
    t = _device.tick_index(t, env["delays"].device)
    alive = netsim.alive(env, t)
    delays = netsim.link_delay(env, t).to(I32)
    drop = netsim.link_drop(env, t)
    to_ticks = float(cfg.view_timeout_ms / cfg.tick_ms)
    tf = t.float()
    st = dict(st)
    dev = alive.device
    rows = torch.arange(n, device=dev, dtype=I32)
    B = alive.shape[0]

    view = st["view"]
    leader = view % n
    i_am_leader = (leader == rows) & alive
    # one fused pop of slot t for every channel; sends buffer up and commit
    # as one fused scatter at the end of the tick (same-tick sends always
    # land at t+1 or later, so the reorder is exact — channel.py)
    spec = ring_spec(n, mandator_mode)
    msgs = ch.ring_deliver(spec, st["ring"], t)
    sends = []

    wl = workload.refill_cpu(st["wl"], env["cpu_req_per_tick"])

    # ---- request forwarding (plain mode) ----------------------------------
    if not mandator_mode:
        wl = workload.arrive(wl, arr, t, alive)
        # forward whole local buffer to my current leader
        cnt = wl["buffer"]
        tsum = wl["buffer_tsum"]
        fw_pay = torch.stack([cnt, tsum], dim=-1)[:, :, None, :].expand(
            B, n, n, 2)
        # the leader keeps local arrivals in its own pool (no self-forward)
        fw_mask = ((rows[None, None, :] == leader[..., None])
                   & (alive & (cnt > 0) & (rows != leader))[..., None])
        sends.append(ch.Send("fw", fw_pay, delays, fw_mask))
        # the forward channel is additive (counters), so a scenario-dropped
        # link is NOT a tolerable omission: keep the batch buffered and
        # retry next tick instead of destroying the requests
        sent = (fw_mask & ~drop).any(dim=2)
        # leader pools forwarded requests
        ffl, fpay = msgs["fw"]
        pool = _sum_senders(torch.where(ffl[..., None], fpay, 0.0))
        wl = dict(wl)
        wl["buffer"] = torch.where(sent, 0.0, cnt) + pool[..., 0]
        wl["buffer_tsum"] = torch.where(sent, 0.0, tsum) + pool[..., 1]

    # ---- deliver acks; leader commit ---------------------------------------
    afl, apay = msgs["ack"]
    acks = ch.fold_state(st["acks"].float()[..., None], afl, apay
                         )[..., 0].to(I32)
    ack_cnt = torch.sum(acks >= st["slot"][..., None], dim=2)
    commit = i_am_leader & st["outstanding"] & (ack_cnt >= maj)
    committed_slot = torch.where(commit, st["slot"], st["committed_slot"])
    outstanding = st["outstanding"] & ~commit
    # advance the committed VC (mandator); plain-mode commit times are
    # recorded post hoc from the committed_slot trace
    if mandator_mode:
        cvc = torch.where(commit[..., None],
                          torch.maximum(st["cvc"],
                                        st["slot_vc"][..., 1:].to(I32)),
                          st["cvc"])
    else:
        cvc = st["cvc"]
    # ---- leader proposes next slot -----------------------------------------
    can_prop = i_am_leader & ~outstanding & (tf >= st["ready_at"])
    if mandator_mode:
        have = (lcr > cvc).any(dim=2) & can_prop
        slot = torch.where(have, st["slot"] + 1, st["slot"])
        pay_vc = torch.where(have[..., None], lcr.float(),
                             st["slot_vc"][..., 1:])
        slot_vc = torch.cat([slot.float()[..., None], pay_vc], dim=-1)
        size_bytes = torch.where(have, float(cfg.meta_bytes), 0.0)
        formed = have
        count = 0
    else:
        wl, formed, count = workload.form_batches(
            wl, t, can_prop, st["slot"] + 1, cfg.batch_paxos,
            cfg.max_batch_ms / cfg.tick_ms)
        slot = torch.where(formed, st["slot"] + 1, st["slot"])
        slot_vc = st["slot_vc"]
        # exact whatever the contraction: request_bytes scales count by a
        # power of two
        size_bytes = torch.where(formed, count * cfg.request_bytes + 100.0,
                                 0.0)
    outstanding = outstanding | formed
    # egress serialization (monolithic payload cost)
    bytes_out = size_bytes[..., None].expand(B, n, n) \
        / netsim.nic_rate(env, t)[..., None]
    busy, ser = netsim.egress_delay(st["egress_busy"], t, bytes_out)
    busy = torch.where(formed, busy, st["egress_busy"])
    total_delay = (delays + torch.where(formed[..., None], ser, 0.0)
                   ).to(I32)
    acc_pay = torch.cat([
        view.float()[..., None], slot.float()[..., None],
        torch.zeros((B, n, 1), device=dev),
        slot_vc[..., 1:] if mandator_mode
        else torch.zeros((B, n, n), device=dev)], dim=-1)
    sends.append(ch.Send("acc", acc_pay[:, :, None, :].expand(B, n, n, 3 + n),
                         total_delay, formed[..., None].expand(B, n, n)))

    # ---- follower: deliver accepts, ack, heartbeat --------------------------
    cfl, cpay = msgs["acc"]
    arr = cpay.transpose(1, 2)                        # [B, rcv, snd, P]
    afl2 = cfl.transpose(1, 2)
    got = afl2.any(dim=2)
    mx = torch.where(afl2[..., None], arr, -1.0).amax(dim=2)
    acc_view = mx[..., 0].to(I32)
    acc_slot = mx[..., 1].to(I32)
    fresh = got & (acc_view >= view) & alive
    view = torch.where(fresh, acc_view, view)
    last_heard = torch.where(fresh, tf, st["last_heard"])
    # ack to the slot's leader
    ack_mask = fresh[..., None] & (rows[None, None, :]
                                   == (view % n)[..., None])
    ack_pay = acc_slot.float()[..., None, None].expand(B, n, n, 1)
    sends.append(ch.Send("ack", ack_pay, delays, ack_mask))

    # ---- view change --------------------------------------------------------
    expired = alive & (tf - last_heard > to_ticks)
    view = torch.where(expired, view + 1, view)
    last_heard = torch.where(expired, tf, last_heard)
    became_leader = expired & ((view % n) == rows)
    ready_at = torch.where(became_leader, tf + st["phase1"], st["ready_at"])

    ring = ch.ring_commit(spec, st["ring"], t, sends, drop=drop,
                          backend=cfg.channel_backend)

    # ---- flight recorder + monitor IO (absent => not run) ---------------
    tr = st.get("tr")
    if tr is not None or "mon_io" in st:
        sent_any = sends[0].mask
        for snd in sends[1:]:
            sent_any = sent_any | snd.mask
        cut = (sent_any & drop).sum(dim=2)
    if tr is not None:
        st["tr"] = obs.record_env(
            obs.DEFAULT_SPEC, tr, alive, t, a=view, b=slot,
            dropped_links=cut, events=(
                ("view_change", view != st["view"], view, slot),
                ("leader_change", became_leader, view % n, view),
                ("commit", commit, committed_slot, ack_cnt),
                ("batch_create", formed, slot, count),
                ("batch_disseminate", formed, slot, ser.amax(dim=2))))
    if "mon_io" in st:
        st["mon_io"] = {"dropped": cut.int()}

    st.update(wl=wl, view=view, last_heard=last_heard, ready_at=ready_at,
              slot=slot, outstanding=outstanding, acks=acks,
              committed_slot=committed_slot, cvc=cvc, slot_vc=slot_vc,
              ring=ring, egress_busy=busy)
    return st
