"""Sporades (Algorithms 2 + 3) — dual-mode omission-fault-tolerant consensus,
composed with Mandator: block payloads are Mandator vector clocks. Port of
``repro.core.sporades``, batched over the grid.

Faithful protocol, simulator-native encoding:
- rank (v, r) is packed into an int key  v*RS + r  (lexicographic order
  preserved; RS bounds rounds-per-view); float32 channel payloads stay
  exact below 2^24.
- every message type is a monotone payload (see channel.py); receivers keep
  *latest-state* matrices and triggers fire on state predicates, not message
  events.
- the common coin is the pre-generated table of core/coin.py (§3.2.1).

Every state tensor carries a leading lane axis ``B``; matrices are
[B, receiver, sender, ...]. Integer ``//`` and ``%`` are floor division and
Python-style remainder, as in jnp; ``torch.argmax`` takes the first
maximum, as ``jnp.argmax`` does; float-to-int casts truncate. The tick
takes a 0-dim int32 tensor ``t`` (a Python int is converted) and
does no host sync. With tracing or
monitoring on, the state also carries the layer's flight recorder
(``tr``) and the monitor's IO gauges (``mon_io``), written at the end of
the tick.

Two routes run the tick, picked by where the state lives (the rule of
``kernels/_dispatch.py``): on the card one CUDA kernel
(``kernels/sporades_tick``, ``_tick_kernel``), which updates the state in
place, and on the CPU the op chain (``_tick_chain``), which returns new
tensors. Both give the same state bit for bit.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch import device as _device
from repro_torch.configs.smr import SMRConfig
from repro_torch.core import channel as ch
from repro_torch.core import netsim, spans
from repro_torch.core.coin import coin_table
from repro_torch.kernels.sporades_tick import kernel as tick_kernel
from repro_torch.obs import monitor as hmon
from repro_torch.obs import trace as obs

RS = 1 << 14                    # rounds-per-view bound (rank key packing)
MAX_VIEWS = 4096
I32 = torch.int32


def key(v, r):
    return v * RS + r


def ring_spec(n: int) -> ch.RingSpec:
    """Packed delivery ring: all six Sporades message types in one fused
    [B, Dmax, n, n, K] buffer."""
    return ch.RingSpec(
        ch.ChannelSpec("prop", 2 + 2 * n),
        ch.ChannelSpec("vote", 2 + n),
        ch.ChannelSpec("to", 2 + n),
        ch.ChannelSpec("pa", 1 + n),
        ch.ChannelSpec("va", n),
        ch.ChannelSpec("ac", 2 + n),
    )


def init_state(cfg: SMRConfig, n_ticks: int, batch: int = 1,
               device=None) -> Dict:
    """Tick-0 state of ``batch`` lanes on ``device`` (None = CUDA).
    ``cfg.delay_horizon_ticks`` must be resolved to an int."""
    dev = _device.resolve(device)
    n = cfg.n_replicas
    B = batch

    def full(shape, value, dtype):
        return torch.full((B, *shape), value, dtype=dtype, device=dev)

    z = lambda *s: full(s, 0, I32)  # noqa: E731
    coins = coin_table(MAX_VIEWS, n, device=dev)
    # flight recorder and monitor IO: absent when off (see mandator)
    extra = {}
    tr = obs.init_trace(obs.DEFAULT_SPEC, cfg.trace_level, n,
                        cfg.trace_events, B, dev)
    if tr is not None:
        extra["tr"] = tr
    if hmon.on(cfg.monitor_level):
        extra["mon_io"] = {"dropped": z(n)}
    return {
        **extra,
        "v_cur": z(n), "r_cur": z(n),
        "is_async": full((n,), False, torch.bool),
        "bh_key": z(n), "bh_vc": z(n, n),
        "commit_key": z(n), "cvc": z(n, n),
        "prop_key": z(n), "last_vote_trig": full((n,), -1, I32),
        # first deadline = one view timeout from t=0
        "deadline": full((n,), cfg.view_timeout_ms / cfg.tick_ms,
                         torch.float32),
        "timeout_sent_v": full((n,), -1, I32),
        "async_phase": z(n), "my_r": z(n), "my_avc": z(n, n),
        "exited_view": full((n,), -1, I32),
        "ac_tick": full((n, n), float("inf"), torch.float32),
        "ac_v_seen": full((n, n), -1, I32),
        # latest-state matrices [receiver, sender, fields]
        "vote_st": full((n, n, 2 + n), 0.0, torch.float32),
        "to_st": full((n, n, 2 + n), -1.0, torch.float32),
        "pa_st": full((n, n, 1 + n), -1.0, torch.float32),
        # vote-async is broadcast; field p of a voter's payload is the key of
        # the latest block from proposer p it voted for (Theorem-9 catch-up)
        "va_st": full((n, n, n), -1.0, torch.float32),
        "ac_st": full((n, n, 2 + n), -1.0, torch.float32),
        # all six message types share ONE packed delivery ring
        "ring": ch.make_ring(ring_spec(n), int(cfg.delay_horizon_ticks), n,
                             B, dev),
        "coins": coins.expand(B, MAX_VIEWS).contiguous(),
    }


def _leader_of(v, n):
    return v % n


def _bcast(x: torch.Tensor, n: int) -> torch.Tensor:
    """[B, n, P] per-sender payload -> [B, n, n, P] (same to every
    receiver)."""
    return x[:, :, None, :].expand(-1, -1, n, -1)


def _row_mask(m: torch.Tensor, n: int) -> torch.Tensor:
    """[B, n] per-sender send flag -> [B, n, n] to every receiver."""
    return m[:, :, None].expand(-1, -1, n)


def _at(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, n, n, ...] at column idx[b, i] of each row -> [B, n, ...]
    (take_along_axis over the sender axis)."""
    ix = idx.long().view(*idx.shape, 1, *([1] * (x.dim() - 3)))
    ix = ix.expand(*idx.shape, 1, *x.shape[3:])
    return torch.gather(x, 2, ix).squeeze(2)


def tick(st: Dict, t: torch.Tensor, env: Dict, cfg: SMRConfig,
         lcr: torch.Tensor) -> Dict:
    """One simulator tick of every lane. lcr: Mandator getClientRequests()
    per replica [B, n, n] (row i = replica i's vector clock).

    A state on a CUDA device takes the kernel (``_tick_kernel``), one on
    the CPU the op chain (``_tick_chain``). The kernel updates every
    Sporades leaf of ``st`` in place (the ring too, as both routes do), so
    the dict returned holds the same tensors, and a captured tick graph
    (``compile_cache._copy_back``) copies nothing back for them; the op
    chain returns new tensors. Each call adds one to the counter
    ``order.kernel_calls`` or ``order.chain_calls`` (``core/spans.py``):
    Python calls only (a warm-up tick, a capture, an eager loop), never a
    replay."""
    if st["v_cur"].device.type == "cuda":
        spans.count("order.kernel_calls", 1)
        return _tick_kernel(st, t, env, cfg, lcr)
    spans.count("order.chain_calls", 1)
    return _tick_chain(st, t, env, cfg, lcr)[0]


def _tick_kernel(st: Dict, t: torch.Tensor, env: Dict, cfg: SMRConfig,
                 lcr: torch.Tensor) -> Dict:
    """The tick as one launch of ``kernels/sporades_tick`` (state in
    place, sends into its scratch buffers), then the ring's commit of
    those sends. With telemetry on, the tick-entry values the flight
    recorder compares with are copied before the launch, and the cut
    links come from the kernel's ``cut`` output."""
    n = cfg.n_replicas
    t = _device.tick_index(t, env["delays"].device)
    spec = ring_spec(n)
    telemetry = st.get("tr") is not None or "mon_io" in st
    if telemetry:
        entry = tuple(st[k].clone() for k in ("v_cur", "is_async",
                                              "commit_key"))
    out = tick_kernel.sporades_tick(
        st, t, env, lcr, cfg.view_timeout_ms / cfg.tick_ms,
        [(spec.offset(c), spec.flag(c)) for c in tick_kernel.CHANNELS])
    sends = [ch.Send(name, pay, out["delay"], mask)
             for name, pay, mask in out["sends"]]
    st = dict(st)
    st["ring"] = ch.ring_commit(spec, st["ring"], t, sends, drop=out["drop"],
                                backend=cfg.channel_backend)
    if telemetry:
        _telemetry(st, netsim.alive(env, t), t, n, out["cut"].clone(), entry,
                   (st["v_cur"], st["r_cur"], st["is_async"],
                    st["commit_key"], st["cvc"].float()))
    return st


def _telemetry(st: Dict, alive: torch.Tensor, t: torch.Tensor, n: int,
               cut: torch.Tensor, entry: tuple, new: tuple) -> None:
    """Write the flight recorder (``tr``) and the monitor's IO gauges
    (``mon_io``) of the tick into ``st``, where present. ``cut`` [B, n]:
    each sender's sends lost to cut links; ``entry``: (v_cur, is_async,
    commit_key) at the tick's entry; ``new``: (v_cur, r_cur, is_async,
    commit_key, cvc as float32) at its end."""
    v0, a0, c0 = entry
    v_cur, r_cur, is_async, commit_key, cvc = new
    tr = st.get("tr")
    if tr is not None:
        vchg = v_cur != v0
        st["tr"] = obs.record_env(
            obs.DEFAULT_SPEC, tr, alive, t, a=v_cur, b=r_cur,
            dropped_links=cut, events=(
                ("view_change", vchg, v_cur, r_cur),
                ("leader_change", vchg, _leader_of(v_cur, n), v_cur),
                # sync<->async transitions: a=1 entering the async path
                ("mode_switch", is_async != a0, is_async, v_cur),
                ("commit", commit_key > c0, commit_key, cvc.sum(dim=2))))
    if "mon_io" in st:
        st["mon_io"] = {"dropped": cut.int()}


def _tick_chain(st: Dict, t: torch.Tensor, env: Dict, cfg: SMRConfig,
                lcr: torch.Tensor) -> Tuple[Dict, Dict]:
    """The tick as a chain of PyTorch ops (the plain version of
    ``kernels/sporades_tick``). Returns (the new state, the transitions
    that fired: {name: [B, n] bool})."""
    n = cfg.n_replicas
    f = (n - 1) // 2
    q = n - f
    t = _device.tick_index(t, env["delays"].device)
    alive = netsim.alive(env, t)
    delays = netsim.link_delay(env, t).to(I32)
    drop = netsim.link_drop(env, t)
    to_ticks = float(cfg.view_timeout_ms / cfg.tick_ms)
    st = dict(st)
    tf = t.float()
    dev = lcr.device
    rows = torch.arange(n, device=dev, dtype=I32)
    lcr_f = lcr.float()
    inf = float("inf")
    spec = ring_spec(n)
    msgs = ch.ring_deliver(spec, st["ring"], t)
    sends = []

    v_cur, r_cur = st["v_cur"], st["r_cur"]
    is_async = st["is_async"]
    bh_key, bh_vc = st["bh_key"], st["bh_vc"].float()
    commit_key, cvc = st["commit_key"], st["cvc"].float()
    deadline = st["deadline"]

    # ---- 1) deliver <propose> (Alg2 lines 20-26) --------------------------
    pfl, ppay = msgs["prop"]
    arr = ppay.transpose(1, 2)                          # [B, rcv, snd, P]
    afl = pfl.transpose(1, 2)
    ps = torch.where(afl[..., None], arr, -1.0).amax(dim=2)   # [B, rcv, P]
    got_prop = afl.any(dim=2)
    pb_key = ps[..., 0].to(I32)
    pc_key = ps[..., 1].to(I32)
    p_vc = ps[..., 2:2 + n]
    p_cvc = ps[..., 2 + n:]
    accept = got_prop & alive & ~is_async & (pb_key > key(v_cur, r_cur))
    cvc = torch.where(accept[..., None], torch.maximum(cvc, p_cvc), cvc)
    commit_key = torch.where(accept, torch.maximum(commit_key, pc_key),
                             commit_key)
    v_cur = torch.where(accept, pb_key // RS, v_cur)
    r_cur = torch.where(accept, pb_key % RS, r_cur)
    bh_key = torch.where(accept, pb_key, bh_key)
    bh_vc = torch.where(accept[..., None], p_vc, bh_vc)
    deadline = torch.where(accept, tf + to_ticks, deadline)
    # send <vote> to L_v (line 25)
    bh_key_f = bh_key[..., None].float()
    vote_pay = torch.cat([bh_key_f, bh_key_f, bh_vc], dim=-1)
    vote_mask = accept[..., None] & (rows[None, None, :]
                                     == _leader_of(v_cur, n)[..., None])
    sends.append(ch.Send("vote", _bcast(vote_pay, n), delays, vote_mask))

    # ---- 2) deliver <vote>; leader trigger (Alg2 lines 9-19) --------------
    vfl, vpay = msgs["vote"]
    vote_st = ch.fold_state(st["vote_st"], vfl, vpay)
    voted = vote_st[..., 0].to(I32)                     # [B, ldr, voter]
    kmax = voted.amax(dim=2)
    match = voted == kmax[..., None]
    cnt = match.sum(dim=2)
    lead_trig = (alive & ~is_async & (cnt >= q)
                 & (kmax >= key(v_cur, r_cur)) & (kmax > st["last_vote_trig"])
                 & (_leader_of(kmax // RS, n) == rows))
    vbh = vote_st[..., 1].to(I32)
    bh_new = torch.where(match, vbh, -1).amax(dim=2)
    vvc = vote_st[..., 2:]
    bh_vc_new = torch.where(match[..., None], vvc, -1.0).amax(dim=2)
    # commit check (line 11): n-f votes whose block_high rank == voted rank
    cnt_bh = (match & (vbh == kmax[..., None])).sum(dim=2)
    lead_commit = lead_trig & (cnt_bh >= q)
    commit_key = torch.where(lead_commit, torch.maximum(commit_key, kmax),
                             commit_key)
    cvc = torch.where(lead_commit[..., None], torch.maximum(cvc, bh_vc_new),
                      cvc)
    v_cur = torch.where(lead_trig, kmax // RS, v_cur)
    r_cur = torch.where(lead_trig, kmax % RS, r_cur)
    bh_key = torch.where(lead_trig, torch.maximum(bh_key, bh_new), bh_key)
    bh_vc = torch.where(lead_trig[..., None], torch.maximum(bh_vc, bh_vc_new),
                        bh_vc)
    # form + broadcast new block (lines 15-18)
    new_key = key(v_cur, r_cur + 1)
    prop_vc = torch.maximum(lcr_f, bh_vc)
    prop_pay = torch.cat([new_key[..., None].float(),
                          commit_key[..., None].float(), prop_vc, cvc],
                         dim=-1)
    sends.append(ch.Send("prop", _bcast(prop_pay, n), delays,
                         _row_mask(lead_trig, n)))
    prop_key = torch.where(lead_trig, new_key, st["prop_key"])
    # (leader's own block_high advances via self-delivery of its propose)
    last_vote_trig = torch.where(lead_trig, kmax, st["last_vote_trig"])

    # ---- 3) timeout (Alg2 lines 27-28) ------------------------------------
    fire = (alive & ~is_async & (tf >= deadline)
            & (st["timeout_sent_v"] < v_cur))
    to_pay = torch.cat([v_cur[..., None].float(), bh_key[..., None].float(),
                        bh_vc], dim=-1)
    sends.append(ch.Send("to", _bcast(to_pay, n), delays,
                         _row_mask(fire, n)))
    timeout_sent_v = torch.where(fire, v_cur, st["timeout_sent_v"])

    # ---- 4) deliver <timeout>; async entry (Alg3 lines 1-7) ---------------
    tfl, tpay = msgs["to"]
    to_st = ch.fold_state(st["to_st"], tfl, tpay)
    to_v = to_st[..., 0].to(I32)
    tvmax = to_v.amax(dim=2)
    tmatch = to_v == tvmax[..., None]
    tcnt = tmatch.sum(dim=2)
    enter = alive & ~is_async & (tcnt >= q) & (tvmax >= v_cur)
    tbh = torch.where(tmatch, to_st[..., 1].to(I32), -1).amax(dim=2)
    tbh_vc = torch.where(tmatch[..., None], to_st[..., 2:], -1.0).amax(dim=2)
    bh_key = torch.where(enter, torch.maximum(bh_key, tbh), bh_key)
    bh_vc = torch.where(enter[..., None], torch.maximum(bh_vc, tbh_vc), bh_vc)
    v_cur = torch.where(enter, tvmax, v_cur)
    r_cur = torch.where(enter, torch.maximum(r_cur, bh_key % RS), r_cur)
    is_async = is_async | enter
    # height-1 async block (lines 5-7)
    r1 = r_cur + 1
    avc = torch.maximum(lcr_f, bh_vc)
    pa_key1 = (v_cur * 2 + 1) * RS + r1
    pa_pay = torch.cat([pa_key1[..., None].float(), avc], dim=-1)
    sends.append(ch.Send("pa", _bcast(pa_pay, n), delays,
                         _row_mask(enter, n)))
    async_phase = torch.where(enter, 1, st["async_phase"])
    my_r = torch.where(enter, r1, st["my_r"])
    my_avc = torch.where(enter[..., None], avc, st["my_avc"].float())
    deadline = torch.where(enter, inf, deadline)

    # ---- 5) deliver <propose-async>; vote (Alg3 lines 8-14) ---------------
    pafl, papay = msgs["pa"]
    pa_st = ch.fold_state(st["pa_st"], pafl, papay)
    pa_arr = pafl.transpose(1, 2)                       # [B, rcv, snd]
    pa_k = pa_st[..., 0].to(I32)
    pa_vh = pa_k // RS
    pa_h = 2 - (pa_vh % 2 == 1).to(I32)                 # 1 if odd, else 2
    pa_v = (pa_vh - pa_h) // 2
    pa_r = pa_k % RS
    va_vote = (pa_arr & alive[..., None] & is_async[..., None]
               & (pa_v == v_cur[..., None]) & (pa_r > r_cur[..., None]))
    # broadcast vote: field p = key of p's block being voted (else -1)
    va_fields = torch.where(va_vote, pa_k.float(), -1.0)    # [B, i, p]
    sends.append(ch.Send("va", _bcast(va_fields, n), delays,
                         _row_mask(va_vote.any(dim=2), n)))

    # ---- 6) deliver <vote-async>; heights (Alg3 lines 15-23) --------------
    vafl, vapay = msgs["va"]
    va_st = ch.fold_state(st["va_st"], vafl, vapay)
    # va_st[b, i, :, i]: the votes receiver i holds for its own blocks
    va_own = torch.diagonal(va_st, dim1=1, dim2=3).transpose(1, 2).to(I32)
    my_h1_key = (v_cur * 2 + 1) * RS + my_r
    my_h2_key = (v_cur * 2 + 2) * RS + my_r
    cnt_h1 = (va_own == my_h1_key[..., None]).sum(dim=2)
    cnt_h2 = (va_own == my_h2_key[..., None]).sum(dim=2)
    to_h2 = alive & is_async & (async_phase == 1) & (cnt_h1 >= q)
    # Theorem-9 catch-up: adopt any height-1 block of this view that
    # gathered n-f votes, if our own h1 is not getting votes
    va_all = va_st.to(I32)                              # [B, rcv, voter, p]
    k_p = va_all.amax(dim=2)                            # [B, rcv, p]
    cnt_p = (va_all == k_p[:, :, None, :]).sum(dim=2)   # [B, rcv, p]
    kp_vh = k_p // RS
    kp_is_h1 = (kp_vh % 2 == 1) & ((kp_vh - 1) // 2 == v_cur[..., None])
    adoptable = (cnt_p >= q) & kp_is_h1 & (k_p % RS >= my_r[..., None])
    adopt_cand = torch.where(adoptable, k_p, -1)
    adopt_key = adopt_cand.amax(dim=2)
    adopt_p = torch.argmax(adopt_cand, dim=2)           # first maximum
    adopt = alive & is_async & (async_phase == 1) & ~to_h2 & (adopt_key >= 0)
    # vc for the adopted parent, if we have its propose-async
    pa_p_key = _at(pa_k, adopt_p)
    pa_p_vc = _at(pa_st[..., 1:], adopt_p)
    adopt_vc = torch.where((pa_p_key == adopt_key)[..., None], pa_p_vc,
                           my_avc)
    go_h2 = to_h2 | adopt
    r2 = torch.where(adopt, adopt_key % RS + 1, my_r + 1)
    avc2 = torch.maximum(lcr_f, torch.where(adopt[..., None], adopt_vc,
                                            my_avc))
    pa_key2 = (v_cur * 2 + 2) * RS + r2
    pa_pay2 = torch.cat([pa_key2[..., None].float(), avc2], dim=-1)
    sends.append(ch.Send("pa", _bcast(pa_pay2, n), delays,
                         _row_mask(go_h2, n)))
    my_r = torch.where(go_h2, r2, my_r)
    my_avc = torch.where(go_h2[..., None], avc2, my_avc)
    async_phase = torch.where(go_h2, 2, async_phase)
    to_ac = alive & is_async & (async_phase == 2) & (cnt_h2 >= q)
    ac_pay = torch.cat([v_cur[..., None].float(), my_r[..., None].float(),
                        my_avc], dim=-1)
    sends.append(ch.Send("ac", _bcast(ac_pay, n), delays,
                         _row_mask(to_ac, n)))
    async_phase = torch.where(to_ac, 3, async_phase)

    # ---- 7) deliver <asynchronous-complete>; exit (Alg3 lines 24-36) ------
    acfl, acpay = msgs["ac"]
    ac_st = ch.fold_state(st["ac_st"], acfl, acpay)
    ac_arr = acfl.transpose(1, 2)
    ac_v = ac_st[..., 0].to(I32)
    newer = ac_arr & (ac_v > st["ac_v_seen"])
    ac_tick = torch.where(newer, tf, st["ac_tick"])
    ac_v_seen = torch.where(newer, ac_v, st["ac_v_seen"])
    acm = ac_v == v_cur[..., None]                      # matching this view
    ac_cnt = acm.sum(dim=2)
    exit_ = alive & is_async & (ac_cnt >= q) & (st["exited_view"] < v_cur)
    leader = torch.gather(st["coins"], 1,
                          torch.clamp(v_cur, 0, MAX_VIEWS - 1).long())
    # first n-f rule: leader's ac among the q earliest arrival ticks
    tick_m = torch.where(acm, ac_tick, inf)
    thr = torch.sort(tick_m, dim=2).values[..., q - 1]
    ldr_tick = _at(tick_m, leader)
    ldr_in = _at(acm, leader) & (ldr_tick <= thr)
    ac_r = ac_st[..., 1].to(I32)
    ldr_r = _at(ac_r, leader)
    ldr_vc = _at(ac_st[..., 2:], leader)
    do_commit = exit_ & ldr_in
    commit_key = torch.where(do_commit,
                             torch.maximum(commit_key, key(v_cur, ldr_r)),
                             commit_key)
    cvc = torch.where(do_commit[..., None], torch.maximum(cvc, ldr_vc), cvc)
    bh_key = torch.where(do_commit, key(v_cur, ldr_r), bh_key)
    bh_vc = torch.where(do_commit[..., None], ldr_vc, bh_vc)
    # Bfall catch-up (lines 29-31): leader's height-2 seen via propose-async
    ldr_pa_v = _at(pa_v, leader)
    ldr_pa_h = _at(pa_h, leader)
    ldr_pa_r = _at(pa_r, leader)
    ldr_pa_vc = _at(pa_st[..., 1:], leader)
    bfall = exit_ & ~ldr_in & (ldr_pa_v == v_cur) & (ldr_pa_h == 2)
    bh_key = torch.where(bfall, key(v_cur, ldr_pa_r), bh_key)
    bh_vc = torch.where(bfall[..., None], ldr_pa_vc, bh_vc)
    exited_view = torch.where(exit_, v_cur, st["exited_view"])
    r_cur = torch.where(exit_, bh_key % RS, r_cur)
    v_cur = torch.where(exit_, v_cur + 1, v_cur)
    is_async = is_async & ~exit_
    async_phase = torch.where(exit_, 0, async_phase)
    deadline = torch.where(exit_, tf + to_ticks, deadline)
    # vote to the next view's leader (line 35)
    ex_vote_pay = torch.cat([key(v_cur, r_cur)[..., None].float(),
                             bh_key[..., None].float(), bh_vc], dim=-1)
    ex_vote_mask = exit_[..., None] & (rows[None, None, :]
                                       == _leader_of(v_cur, n)[..., None])
    sends.append(ch.Send("vote", _bcast(ex_vote_pay, n), delays,
                         ex_vote_mask))

    ring = ch.ring_commit(spec, st["ring"], t, sends, drop=drop,
                          backend=cfg.channel_backend)

    # ---- flight recorder + monitor IO (absent => not run) ---------------
    # st[...] still holds the tick-entry values here (locals were rebound,
    # the dict is only updated below), so the masks are true transitions.
    if st.get("tr") is not None or "mon_io" in st:
        sent_any = sends[0].mask
        for snd in sends[1:]:
            sent_any = sent_any | snd.mask
        _telemetry(st, alive, t, n, (sent_any & drop).sum(dim=2),
                   (st["v_cur"], st["is_async"], st["commit_key"]),
                   (v_cur, r_cur, is_async, commit_key, cvc))

    st.update(
        v_cur=v_cur, r_cur=r_cur, is_async=is_async, bh_key=bh_key,
        bh_vc=bh_vc.to(I32), commit_key=commit_key,
        cvc=cvc.to(I32), prop_key=prop_key,
        last_vote_trig=last_vote_trig, deadline=deadline,
        timeout_sent_v=timeout_sent_v, async_phase=async_phase, my_r=my_r,
        my_avc=my_avc.to(I32), exited_view=exited_view,
        ac_tick=ac_tick, ac_v_seen=ac_v_seen, vote_st=vote_st, to_st=to_st,
        pa_st=pa_st, va_st=va_st, ac_st=ac_st, ring=ring)
    fired = {"accept": accept, "lead_trig": lead_trig,
             "lead_commit": lead_commit, "timeout": fire, "enter": enter,
             "to_h2": to_h2, "adopt": adopt, "to_ac": to_ac, "exit": exit_,
             "exit_commit": do_commit, "bfall": bfall}
    return st, fired
