"""The plain reference: the paper's WAN simulation, written out in NumPy.

It simulates Mandator's request dissemination (Algorithm 1) under Sporades
ordering (Algorithms 2 and 3) or under Multi-Paxos ordering of Mandator's
vector clocks, tick by tick, on the WAN of a configuration file, with
open-loop arrivals read from the benchmark's own draw table. Each lane runs
under its scenario's windowed tables (``plainscen.lower``; the fault-free
network is one window with every replica up, no link cut or delayed and
every NIC at its full rate). At every tick a lane reads its window's row:
a replica that is down takes no requests and forms, votes, proposes and
times out nothing (what reaches it is still delivered), a cut link drops
what is sent on it, extra delay adds to the link's before the truncation
to whole ticks, and a throttled sender's NIC runs at its rate times the
scale. It is written from the protocol rules as the simulator states them
(the JAX package's ``core/{mandator,sporades,paxos,netsim,channel,
workload,harness}.py`` were read as the specification and are not
imported); it shares no code with the port and imports nothing but NumPy.

The lanes of one call run side by side as the leading axis of every array;
lanes never mix. Numbers follow the simulator's arithmetic: float32 state,
int32 counters and rounds, a message's delay truncated to whole ticks and
held between 1 and the horizon less one, and sums of float32 terms taken
in float64 and rounded once.

``lane_rows`` returns one row per lane, the keys and types of the rows of
the port's ``PendingSweep.collect()``. ``precision="bfloat16"`` is the
control: the same run with every float32 array of its state rounded to
bfloat16 after each tick.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

F32 = np.float32
I32 = np.int32
NEG = F32(-1.0)                 # an absent payload field
RS = 1 << 14                    # rounds a view: a rank (v, r) is v * RS + r
MAX_VIEWS = 4096                # the views the common coin is drawn for
HORIZON_MARGIN = 16             # ticks past the provable delay bound
CANONICAL_HORIZON = 256         # the floor of the sweep engine's horizon
WARMUP_FRAC = 0.15              # commits before this share are not counted
BUCKET_MS = 500.0               # the timelines' bucket



def messages(layer: str, n: int):
    """The message kinds of a layer at n replicas: (kind, payload fields,
    sends a tick)."""
    return {
        "mandator": (("batch", 2, 1), ("vote", 1, 1)),
        "sporades": (("prop", 2 + 2 * n, 1), ("vote", 2 + n, 2),
                     ("to", 2 + n, 1), ("pa", 1 + n, 2), ("va", n, 1),
                     ("ac", 2 + n, 1)),
        "paxos": (("acc", 3 + n, 1), ("ack", 1, 1)),
    }[layer]


LAYERS = {"mandator-sporades": ("mandator", "sporades"),
          "mandator-paxos": ("mandator", "paxos")}


@dataclass(frozen=True)
class Deployment:
    """The numbers of a configuration file that the simulation reads."""
    n: int
    delays: np.ndarray          # [n, n] float32 one-way delay, ticks
    ticks: int
    tick_ms: float
    horizon: int                # delay-line slots
    request_bytes: int
    batch: int                  # a Mandator batch, requests
    batch_ticks: float          # a batch forms after this many ticks
    lanes_per_chain: int        # Mandator batches outstanding a replica
    bytes_per_tick: np.float32  # NIC egress
    cpu_per_tick: np.float32    # requests a replica's CPU admits a tick
    meta_bytes: int
    timeout_ticks: np.float32   # the view timeout
    phase1: np.ndarray          # [n] float32 Paxos phase-1 cost, ticks


def deployment(config: Dict, overrides: Optional[Dict] = None,
               tables: Sequence[Dict] = ()) -> Deployment:
    """The deployment of a configuration file (``rtt_ms``, ``smr``), with
    a traffic mix's run length over it. An "auto" delay horizon is sized
    over ``tables``, the scenario tables of every lane of the grid: their
    largest extra delay, and the NIC backlog at their smallest NIC
    scale."""
    s = {**config["smr"], **(overrides or {})}
    n = int(s["n_replicas"])
    tick_ms = float(s["tick_ms"])
    one_way = np.asarray(config["rtt_ms"], np.float64)[:n, :n] / 2.0
    d64 = one_way / tick_ms
    ticks = int(float(s["sim_seconds"]) * 1000 / tick_ms)
    bytes_per_tick = float(s["nic_gbps"]) * 1e9 / 8.0 * tick_ms / 1000.0
    horizon = s["delay_horizon_ticks"]
    if horizon == "auto":
        # the largest link delay and extra delay, the NIC backlog of every
        # chain's outstanding batches at full size through the slowest
        # NIC, a margin; at most the run; a power of two
        extra = max([0.0] + [float(np.max(t["extra_delay"], initial=0.0))
                             for t in tables])
        scale = min([1.0] + [float(np.min(t["nic_scale"], initial=1.0))
                             for t in tables])
        biggest = max(s["batch_paxos"], s["batch_mandator"],
                      s["batch_sporades"]) * s["request_bytes"] + 100.0
        backlog = (max(1, s["mandator_lanes"]) * n * biggest
                   / (bytes_per_tick * scale)) if scale > 0.0 else math.inf
        bound = min(float(np.max(one_way) / tick_ms + extra + backlog
                          + HORIZON_MARGIN), float(ticks + 1))
        horizon = max(64, 1 << max(0, math.ceil(bound) - 1).bit_length(),
                      CANONICAL_HORIZON)
    maj = n // 2 + 1
    return Deployment(
        n=n, delays=d64.astype(F32), ticks=ticks, tick_ms=tick_ms,
        horizon=int(horizon), request_bytes=int(s["request_bytes"]),
        batch=int(s["batch_mandator"]),
        batch_ticks=float(s["max_batch_ms"]) / tick_ms,
        lanes_per_chain=int(s["mandator_lanes"]),
        bytes_per_tick=F32(bytes_per_tick),
        cpu_per_tick=F32(tick_ms * 1000.0 / float(s["cpu_us_per_request"])),
        meta_bytes=int(s["meta_bytes"]),
        timeout_ticks=F32(float(s["view_timeout_ms"]) / tick_ms),
        phase1=np.sort(2 * d64, axis=1)[:, maj - 1].astype(F32))


class Network:
    """Each lane's network: the windowed tables of its scenario, stacked
    on a leading lane axis (``plainscen.stack``)."""

    def __init__(self, dep: Deployment, tables: Dict):
        self.dep, self.tab = dep, tables
        self.lane = np.arange(tables["win_of_tick"].shape[0])

    def at(self, t: int) -> "Links":
        """Every lane's row of tick t's window."""
        w = self.tab["win_of_tick"][:, t]

        def row(k):
            return self.tab[k][self.lane, w]
        return Links(alive=row("alive"), drop=row("drop"),
                     delay=self.dep.delays + row("extra_delay"),
                     rate=self.dep.bytes_per_tick * row("nic_scale"))


@dataclass(frozen=True)
class Links:
    """One tick's network, per lane: replicas up [B, n], links cut [B,
    sender, receiver], link delay with the extra delay [B, n, n] float32
    ticks, NIC egress [B, n] float32 bytes a tick."""
    alive: np.ndarray
    drop: np.ndarray
    delay: np.ndarray
    rate: np.ndarray


# ---------------------------------------------------------------- the coin

def _rotl(x, d):
    return (x << np.uint32(d)) | (x >> np.uint32(32 - d))


def threefry2x32(key, x0, x1):
    """The Threefry-2x32 block cipher (20 rounds) on uint32 arrays; the key
    is a pair of uint32 words or arrays."""
    k0, k1 = np.asarray(key[0], np.uint32), np.asarray(key[1], np.uint32)
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    rot = ((13, 15, 26, 6), (17, 29, 16, 24))
    with np.errstate(over="ignore"):
        a = np.asarray(x0, np.uint32) + ks[0]
        b = np.asarray(x1, np.uint32) + ks[1]
        for g in range(5):
            for r in rot[g % 2]:
                a = a + b
                b = _rotl(b, r) ^ a
            a = a + ks[(g + 1) % 3]
            b = b + ks[(g + 2) % 3] + np.uint32(g + 1)
    return a, b


def coin_table(views: int, n: int, seed: int = 0) -> np.ndarray:
    """The common coin of views 0 .. views-1: a leader in [0, n) drawn
    from the shared seed and the view, as ``jax.random.randint(fold_in(
    PRNGKey(seed), v), (), 0, n)`` draws it (the partitionable Threefry
    stream): fold the view into the key, split it in two, draw 32 bits
    from each and reduce them modulo n."""
    v = np.arange(views, dtype=np.uint32)
    zero = np.zeros_like(v)
    key = threefry2x32((seed >> 32, seed & 0xFFFFFFFF), zero, v)

    def bits(sub):
        a, b = threefry2x32(sub, zero, zero)
        return a ^ b
    hi = bits(threefry2x32(key, zero, zero))
    lo = bits(threefry2x32(key, zero, zero + np.uint32(1)))
    span = np.uint32(n)
    mult = np.uint32(((1 << 16) % n) ** 2 % n)
    with np.errstate(over="ignore"):
        out = ((hi % span) * mult + lo % span) % span
    return out.astype(I32)


# ---------------------------------------------------------- the delay line

class DelayLine:
    """Messages of one kind in flight on every link of every lane: for each
    arrival tick, whether any message arrives on a link and the elementwise
    maximum of the payloads that do (every payload is monotone, so merged
    arrivals keep the newest state). A message sent at tick t with delay d
    arrives at t + d, d held between 1 and the horizon less one."""

    def __init__(self, horizon: int, lanes: int, n: int, width: int):
        self.horizon = horizon
        self.pay = np.full((horizon, lanes, n, n, width), NEG, F32)
        self.flag = np.zeros((horizon, lanes, n, n), bool)
        self.b, self.i, self.j = np.indices((lanes, n, n))
        self.bf16 = False           # the control: payloads in bfloat16

    def pop(self, t: int):
        """(flags [B, sender, receiver], payloads [B, sender, receiver, w])
        arriving at tick t; the slot is free again."""
        s = t % self.horizon
        flag, pay = self.flag[s].copy(), self.pay[s].copy()
        self.flag[s] = False
        self.pay[s] = NEG
        return flag, pay

    def send(self, t: int, payload, delay, mask, drop) -> None:
        """payload [B, sender, receiver, w], delay [B, n, n] ticks, mask
        [B, sender, receiver]: which links send; drop: which links are
        cut, where the send is lost. A send on no link leaves the line as
        it was."""
        mask = mask & ~drop
        if not mask.any():
            return
        d = np.clip(delay, 1, self.horizon - 1)
        slot = np.broadcast_to((t + d) % self.horizon, mask.shape)
        at = (slot, self.b, self.i, self.j)
        vals = np.where(mask[..., None], payload, NEG)
        if self.bf16:
            vals = _round_bf16(vals)
        self.pay[at] = np.maximum(self.pay[at], vals)
        self.flag[at] |= mask


def _received(flag, pay, state):
    """Fold arrivals into a receiver's latest-state matrix [B, rcv, snd,
    w]: the maximum of what it held and what arrived on each link."""
    fl = flag.transpose(0, 2, 1)[..., None]
    return np.where(fl, np.maximum(state, pay.transpose(0, 2, 1, 3)), state)


def _bcast(rows, n):
    """Per-sender payload rows [B, n, w] sent alike to every receiver."""
    return np.broadcast_to(rows[:, :, None, :],
                           (rows.shape[0], n, n, rows.shape[-1]))


def _egress(busy, t, nbytes):
    """NIC serialization of one payload of ``nbytes`` [B, n] bytes-ticks
    (bytes over the NIC rate) to each receiver in turn: (the NIC's new free
    tick [B, n], each receiver's extra delay [B, n, n])."""
    tf = F32(t)
    n = nbytes.shape[-1]
    cum = np.cumsum(np.broadcast_to(nbytes[..., None],
                                    nbytes.shape + (n,)), axis=-1, dtype=F32)
    start = np.maximum(busy, tf)
    return start + cum[..., -1], (start[..., None] + cum) - tf


# ---------------------------------------------------------------- Mandator

class Mandator:
    """Each replica's chain of batches: formed from its clients' requests,
    broadcast, voted for by every replica that sees it, complete (stable)
    once n - f votes are in, in round order, with up to ``lanes_per_chain``
    batches outstanding. The consensus layer orders the replicas'
    lastCompletedRounds vectors."""

    def __init__(self, dep: Deployment, lanes: int):
        n, T = dep.n, dep.ticks
        self.dep = dep
        z = lambda *s: np.zeros(s, I32)     # noqa: E731
        self.own, self.formed = z(lanes, n), z(lanes, n)
        self.lcr, self.seen, self.vote_max = (z(lanes, n, n), z(lanes, n, n),
                                              z(lanes, n, n))
        self.busy = np.zeros((lanes, n), F32)
        self.buffer = np.zeros((lanes, n), F32)
        self.tsum = np.zeros((lanes, n), F32)
        self.last_batch = np.zeros((lanes, n), F32)
        self.cpu = np.zeros((lanes, n), F32)
        self.create_t = np.full((lanes, n, T), np.inf, F32)
        self.arr_mean = np.zeros((lanes, n, T), F32)
        self.count = np.zeros((lanes, n, T), F32)
        self.batches = DelayLine(dep.horizon, lanes, n, 2)
        self.votes = DelayLine(dep.horizon, lanes, n, 1)
        self.ln, self.rn = np.indices((lanes, n))

    def tick(self, t: int, arrivals, net: Links) -> None:
        dep, n = self.dep, self.dep.n
        quorum = n - (n - 1) // 2
        tf = F32(t)
        alive = net.alive
        bfl, bpay = self.batches.pop(t)
        vfl, vpay = self.votes.pop(t)
        # clients' requests (a replica that is down takes none), and the
        # CPU's budget
        arrivals = arrivals * alive
        self.buffer = self.buffer + arrivals
        self.tsum = self.tsum + arrivals * tf
        self.cpu = np.minimum(self.cpu + dep.cpu_per_tick, F32(1e7))
        # new batches: the highest round seen from each owner and the
        # owner's lastCompletedRounds; a vote back for each
        held = np.stack([self.seen, self.lcr], -1).astype(F32)
        got = _received(bfl, bpay, held)
        seen, lcr = got[..., 0].astype(I32), got[..., 1].astype(I32)
        voted = bfl.transpose(0, 2, 1) & alive[..., None]  # [B, voter, owner]
        self.votes.send(t, seen.astype(F32)[..., None],
                        net.delay.astype(I32), voted, net.drop)
        # votes: a round completes once n - f replicas voted for it
        vote_max = _received(vfl, vpay, self.vote_max.astype(F32)[..., None]
                             )[..., 0].astype(I32)
        own = self.own
        for _ in range(dep.lanes_per_chain):
            nxt = own + 1
            votes = np.sum(vote_max >= nxt[..., None], axis=-1)
            own = np.where((self.formed >= nxt) & (votes >= quorum), nxt, own)
        lcr[:, np.arange(n), np.arange(n)] = own
        # the next batch
        can = alive & ((self.formed - own) < dep.lanes_per_chain)
        formed, count = self._form(t, can, self.formed + 1)
        formed_round = np.where(formed, self.formed + 1, self.formed)
        nbytes = (count * F32(dep.request_bytes) + F32(100.0)) * formed
        busy, ser = _egress(self.busy, t, nbytes / net.rate)
        self.busy = np.where(formed, busy, self.busy)
        delay = (net.delay + np.where(formed[..., None], ser, F32(0.0))
                 ).astype(I32)
        pay = np.stack([formed_round, own], -1).astype(F32)
        self.batches.send(t, _bcast(pay, n), delay,
                          np.broadcast_to(formed[..., None], delay.shape),
                          net.drop)
        self.own, self.formed, self.lcr = own, formed_round, lcr
        self.seen, self.vote_max = seen, vote_max

    def _form(self, t, can, rnd):
        """A batch forms where the chain allows one, the CPU has a request
        of budget, and the buffer holds a full batch or has waited the
        batch time; it takes the buffer's oldest share, recorded at its
        round."""
        dep = self.dep
        tf = F32(t)
        buf = self.buffer
        size_ok = buf >= F32(dep.batch)
        time_ok = ((tf - self.last_batch) >= F32(dep.batch_ticks)) \
            & (buf > 0)
        formed = can & (size_ok | time_ok) & (self.cpu >= F32(1.0))
        count = np.where(formed, np.minimum(np.minimum(buf, F32(dep.batch)),
                                            self.cpu), F32(0.0))
        frac = np.where(buf > 0, count / np.maximum(buf, F32(1.0)), F32(0.0))
        taken = self.tsum * frac
        mean = np.where(count > 0, taken / np.maximum(count, F32(1.0)),
                        F32(0.0))
        at = (self.ln, self.rn, np.clip(rnd, 0, dep.ticks - 1))
        self.create_t[at] = np.minimum(self.create_t[at],
                                       np.where(formed, tf, F32(np.inf)))
        self.arr_mean[at] = self.arr_mean[at] + np.where(formed, mean,
                                                         F32(0.0))
        self.count[at] = self.count[at] + count
        self.buffer = buf - count
        # what stays of the arrival-tick sum: the exact difference, rounded
        # once
        tsum = self.tsum.astype(np.float64)
        self.tsum = (tsum - tsum * frac.astype(np.float64)).astype(F32)
        self.cpu = self.cpu - count
        self.last_batch = np.where(formed, tf, self.last_batch)
        return formed, count


# ---------------------------------------------------------------- Sporades

def _key(v, r):
    return v * RS + r


def _pick(a, idx):
    """a[b, i, idx[b, i], ...]: each replica's entry of a per-replica
    column."""
    b, i = np.indices(idx.shape)
    return a[b, i, idx]


class Sporades:
    """Sporades over Mandator's vector clocks: the synchronous path (the
    view's leader proposes, n - f votes commit), the view timeout, and the
    asynchronous path (two heights of async blocks, asynchronous-complete,
    the common coin electing the view's leader, the catch-up rules)."""

    def __init__(self, dep: Deployment, lanes: int):
        n = dep.n
        self.dep = dep
        z = lambda *s: np.zeros(s, I32)     # noqa: E731
        full = lambda s, v, dt: np.full(s, v, dt)   # noqa: E731
        B = lanes
        self.v_cur, self.r_cur = z(B, n), z(B, n)
        self.is_async = np.zeros((B, n), bool)
        self.bh_key, self.bh_vc = z(B, n), z(B, n, n)
        self.commit_key, self.cvc = z(B, n), z(B, n, n)
        self.last_vote_trig = full((B, n), -1, I32)
        self.deadline = full((B, n), dep.timeout_ticks, F32)
        self.timeout_sent_v = full((B, n), -1, I32)
        self.async_phase, self.my_r, self.my_avc = z(B, n), z(B, n), \
            z(B, n, n)
        self.exited_view = full((B, n), -1, I32)
        self.ac_tick = full((B, n, n), np.inf, F32)
        self.ac_v_seen = full((B, n, n), -1, I32)
        self.vote_st = np.zeros((B, n, n, 2 + n), F32)
        self.to_st = full((B, n, n, 2 + n), -1.0, F32)
        self.pa_st = full((B, n, n, 1 + n), -1.0, F32)
        self.va_st = full((B, n, n, n), -1.0, F32)
        self.ac_st = full((B, n, n, 2 + n), -1.0, F32)
        self.lines = {k: DelayLine(dep.horizon, B, n, w)
                      for k, w, _ in messages("sporades", n)}
        self.coins = coin_table(MAX_VIEWS, n)

    def tick(self, t: int, lcr, net: Links) -> None:
        dep, n = self.dep, self.dep.n
        q = n - (n - 1) // 2
        B = lcr.shape[0]
        tf = F32(t)
        rows = np.arange(n)
        every = np.ones((B, n, n), bool)
        alive = net.alive
        delays = net.delay.astype(I32)
        to_ticks = dep.timeout_ticks
        lcr_f = lcr.astype(F32)
        msgs = {k: line.pop(t) for k, line in self.lines.items()}
        sends = []
        v_cur, r_cur, is_async = self.v_cur, self.r_cur, self.is_async
        bh_key, bh_vc = self.bh_key, self.bh_vc.astype(F32)
        commit_key, cvc = self.commit_key, self.cvc.astype(F32)
        deadline = self.deadline

        def col(x):
            return x[..., None]

        # 1) <propose>: accept a higher-ranked block, vote for it
        pfl, ppay = msgs["prop"]
        afl = pfl.transpose(0, 2, 1)
        ps = np.max(np.where(afl[..., None], ppay.transpose(0, 2, 1, 3), NEG),
                    axis=2)
        got_prop = afl.any(axis=2)
        pb_key, pc_key = ps[..., 0].astype(I32), ps[..., 1].astype(I32)
        p_vc, p_cvc = ps[..., 2:2 + n], ps[..., 2 + n:]
        accept = (got_prop & alive & ~is_async
                  & (pb_key > _key(v_cur, r_cur)))
        cvc = np.where(col(accept), np.maximum(cvc, p_cvc), cvc)
        commit_key = np.where(accept, np.maximum(commit_key, pc_key),
                              commit_key)
        v_cur = np.where(accept, pb_key // RS, v_cur)
        r_cur = np.where(accept, pb_key % RS, r_cur)
        bh_key = np.where(accept, pb_key, bh_key)
        bh_vc = np.where(col(accept), p_vc, bh_vc)
        deadline = np.where(accept, tf + to_ticks, deadline)
        bkf = col(bh_key.astype(F32))
        sends.append(("vote", np.concatenate([bkf, bkf, bh_vc], -1),
                      col(accept) & (rows == col(v_cur % n))))

        # 2) <vote>: the leader counts n - f votes for its rank, commits
        # when they agree on block_high, and proposes the next block
        vfl, vpay = msgs["vote"]
        vote_st = _received(vfl, vpay, self.vote_st)
        voted = vote_st[..., 0].astype(I32)
        kmax = np.max(voted, axis=2)
        match = voted == col(kmax)
        lead = (alive & ~is_async & (match.sum(axis=2) >= q)
                & (kmax >= _key(v_cur, r_cur)) & (kmax > self.last_vote_trig)
                & ((kmax // RS) % n == rows))
        vbh = vote_st[..., 1].astype(I32)
        bh_new = np.max(np.where(match, vbh, -1), axis=2)
        bh_vc_new = np.max(np.where(match[..., None], vote_st[..., 2:], NEG),
                           axis=2)
        lead_commit = lead & (np.sum(match & (vbh == col(kmax)), axis=2)
                              >= q)
        commit_key = np.where(lead_commit, np.maximum(commit_key, kmax),
                              commit_key)
        cvc = np.where(col(lead_commit), np.maximum(cvc, bh_vc_new), cvc)
        v_cur = np.where(lead, kmax // RS, v_cur)
        r_cur = np.where(lead, kmax % RS, r_cur)
        bh_key = np.where(lead, np.maximum(bh_key, bh_new), bh_key)
        bh_vc = np.where(col(lead), np.maximum(bh_vc, bh_vc_new), bh_vc)
        new_key = _key(v_cur, r_cur + 1)
        sends.append(("prop", np.concatenate(
            [col(new_key.astype(F32)), col(commit_key.astype(F32)),
             np.maximum(lcr_f, bh_vc), cvc], -1), col(lead) & every))
        last_vote_trig = np.where(lead, kmax, self.last_vote_trig)

        # 3) the view timeout
        fire = (alive & ~is_async & (tf >= deadline)
                & (self.timeout_sent_v < v_cur))
        sends.append(("to", np.concatenate(
            [col(v_cur.astype(F32)), col(bh_key.astype(F32)), bh_vc], -1),
            col(fire) & every))
        timeout_sent_v = np.where(fire, v_cur, self.timeout_sent_v)

        # 4) <timeout>: n - f timeouts of a view enter the async path, with
        # a height-1 async block
        tfl, tpay = msgs["to"]
        to_st = _received(tfl, tpay, self.to_st)
        to_v = to_st[..., 0].astype(I32)
        tvmax = np.max(to_v, axis=2)
        tmatch = to_v == col(tvmax)
        enter = (alive & ~is_async & (tmatch.sum(axis=2) >= q)
                 & (tvmax >= v_cur))
        tbh = np.max(np.where(tmatch, to_st[..., 1].astype(I32), -1), axis=2)
        tbh_vc = np.max(np.where(tmatch[..., None], to_st[..., 2:], NEG),
                        axis=2)
        bh_key = np.where(enter, np.maximum(bh_key, tbh), bh_key)
        bh_vc = np.where(col(enter), np.maximum(bh_vc, tbh_vc), bh_vc)
        v_cur = np.where(enter, tvmax, v_cur)
        r_cur = np.where(enter, np.maximum(r_cur, bh_key % RS), r_cur)
        is_async = is_async | enter
        r1 = r_cur + 1
        avc = np.maximum(lcr_f, bh_vc)
        sends.append(("pa", np.concatenate(
            [col(((v_cur * 2 + 1) * RS + r1).astype(F32)), avc], -1),
            col(enter) & every))
        async_phase = np.where(enter, 1, self.async_phase)
        my_r = np.where(enter, r1, self.my_r)
        my_avc = np.where(col(enter), avc, self.my_avc.astype(F32))
        deadline = np.where(enter, F32(np.inf), deadline)

        # 5) <propose-async>: vote for a block of this view past our round
        pafl, papay = msgs["pa"]
        pa_st = _received(pafl, papay, self.pa_st)
        pa_arr = pafl.transpose(0, 2, 1)
        pa_k = pa_st[..., 0].astype(I32)
        pa_vh = pa_k // RS
        pa_h = np.where(pa_vh % 2 == 1, 1, 2)
        pa_v = (pa_vh - pa_h) // 2
        pa_r = pa_k % RS
        va_vote = (pa_arr & col(alive) & col(is_async) & (pa_v == col(v_cur))
                   & (pa_r > col(r_cur)))
        va_fields = np.where(va_vote, pa_k.astype(F32), NEG)
        sends.append(("va", va_fields, col(va_vote.any(axis=2)) & every))

        # 6) <vote-async>: n - f votes on our height-1 block move to height
        # 2 (or adopt one that gathered them); on height 2, complete
        vafl, vapay = msgs["va"]
        va_st = _received(vafl, vapay, self.va_st)
        va_all = va_st.astype(I32)                   # [B, rcv, voter, p]
        va_own = va_all[:, rows[:, None], rows[None, :], rows[:, None]]
        cnt_h1 = np.sum(va_own == col((v_cur * 2 + 1) * RS + my_r), axis=2)
        cnt_h2 = np.sum(va_own == col((v_cur * 2 + 2) * RS + my_r), axis=2)
        to_h2 = alive & is_async & (async_phase == 1) & (cnt_h1 >= q)
        k_p = np.max(va_all, axis=2)                 # [B, rcv, p]
        cnt_p = np.sum(va_all == k_p[:, :, None, :], axis=2)
        kp_vh = k_p // RS
        adoptable = ((cnt_p >= q) & (kp_vh % 2 == 1)
                     & ((kp_vh - 1) // 2 == col(v_cur))
                     & (k_p % RS >= col(my_r)))
        cand = np.where(adoptable, k_p, -1)
        adopt_key = np.max(cand, axis=2)
        adopt_p = np.argmax(cand, axis=2)
        adopt = (alive & is_async & (async_phase == 1) & ~to_h2
                 & (adopt_key >= 0))
        pa_p_vc = _pick(pa_st[..., 1:], adopt_p)
        adopt_vc = np.where(col(_pick(pa_k, adopt_p) == adopt_key), pa_p_vc,
                            my_avc)
        go_h2 = to_h2 | adopt
        r2 = np.where(adopt, adopt_key % RS + 1, my_r + 1)
        avc2 = np.maximum(lcr_f, np.where(col(adopt), adopt_vc, my_avc))
        sends.append(("pa", np.concatenate(
            [col(((v_cur * 2 + 2) * RS + r2).astype(F32)), avc2], -1),
            col(go_h2) & every))
        my_r = np.where(go_h2, r2, my_r)
        my_avc = np.where(col(go_h2), avc2, my_avc)
        async_phase = np.where(go_h2, 2, async_phase)
        to_ac = alive & is_async & (async_phase == 2) & (cnt_h2 >= q)
        sends.append(("ac", np.concatenate(
            [col(v_cur.astype(F32)), col(my_r.astype(F32)), my_avc], -1),
            col(to_ac) & every))
        async_phase = np.where(to_ac, 3, async_phase)

        # 7) <asynchronous-complete>: n - f of this view exit it; the coin's
        # leader commits if its block was among the first n - f, else its
        # height-2 block is caught up
        acfl, acpay = msgs["ac"]
        ac_st = _received(acfl, acpay, self.ac_st)
        ac_v = ac_st[..., 0].astype(I32)
        newer = acfl.transpose(0, 2, 1) & (ac_v > self.ac_v_seen)
        ac_tick = np.where(newer, tf, self.ac_tick)
        ac_v_seen = np.where(newer, ac_v, self.ac_v_seen)
        acm = ac_v == col(v_cur)
        exit_ = (alive & is_async & (acm.sum(axis=2) >= q)
                 & (self.exited_view < v_cur))
        leader = self.coins[np.clip(v_cur, 0, MAX_VIEWS - 1)]
        tick_m = np.where(acm, ac_tick, F32(np.inf))
        thr = np.sort(tick_m, axis=2)[..., q - 1]
        ldr_in = _pick(acm, leader) & (_pick(tick_m, leader) <= thr)
        ldr_r = _pick(ac_st[..., 1].astype(I32), leader)
        ldr_vc = _pick(ac_st[..., 2:], leader)
        do_commit = exit_ & ldr_in
        commit_key = np.where(do_commit,
                              np.maximum(commit_key, _key(v_cur, ldr_r)),
                              commit_key)
        cvc = np.where(col(do_commit), np.maximum(cvc, ldr_vc), cvc)
        bh_key = np.where(do_commit, _key(v_cur, ldr_r), bh_key)
        bh_vc = np.where(col(do_commit), ldr_vc, bh_vc)
        bfall = (exit_ & ~ldr_in & (_pick(pa_v, leader) == v_cur)
                 & (_pick(pa_h, leader) == 2))
        bh_key = np.where(bfall, _key(v_cur, _pick(pa_r, leader)), bh_key)
        bh_vc = np.where(col(bfall), _pick(pa_st[..., 1:], leader), bh_vc)
        exited_view = np.where(exit_, v_cur, self.exited_view)
        r_cur = np.where(exit_, bh_key % RS, r_cur)
        v_cur = np.where(exit_, v_cur + 1, v_cur)
        is_async = is_async & ~exit_
        async_phase = np.where(exit_, 0, async_phase)
        deadline = np.where(exit_, tf + to_ticks, deadline)
        sends.append(("vote", np.concatenate(
            [col(_key(v_cur, r_cur).astype(F32)), col(bh_key.astype(F32)),
             bh_vc], -1), col(exit_) & (rows == col(v_cur % n))))

        for kind, rows_pay, mask in sends:
            self.lines[kind].send(t, _bcast(rows_pay, n), delays, mask,
                                  net.drop)
        self.v_cur, self.r_cur, self.is_async = v_cur, r_cur, is_async
        self.bh_key, self.bh_vc = bh_key, bh_vc.astype(I32)
        self.commit_key, self.cvc = commit_key, cvc.astype(I32)
        self.last_vote_trig, self.deadline = last_vote_trig, deadline
        self.timeout_sent_v, self.async_phase = timeout_sent_v, async_phase
        self.my_r, self.my_avc = my_r, my_avc.astype(I32)
        self.exited_view, self.ac_tick, self.ac_v_seen = (exited_view,
                                                          ac_tick, ac_v_seen)
        self.vote_st, self.to_st, self.pa_st = vote_st, to_st, pa_st
        self.va_st, self.ac_st = va_st, ac_st

    def trace(self) -> Dict:
        return {"cvc": self.cvc.max(axis=1), "cvc_all": self.cvc,
                "commit_key": self.commit_key, "is_async": self.is_async,
                "v_cur": self.v_cur}


# ------------------------------------------------------------------- Paxos

class Paxos:
    """Multi-Paxos ordering Mandator's vector clocks: the view's leader
    runs one slot at a time, its payload its lastCompletedRounds vector
    (``meta_bytes`` on the wire), committed on a majority of acks; a
    follower that hears nothing for a view timeout moves to the next view,
    whose leader pays a majority round trip (phase 1) before it
    proposes."""

    def __init__(self, dep: Deployment, lanes: int):
        n = dep.n
        self.dep = dep
        z = lambda *s: np.zeros(s, I32)     # noqa: E731
        self.view, self.slot = z(lanes, n), z(lanes, n)
        self.last_heard = np.zeros((lanes, n), F32)
        self.ready_at = np.zeros((lanes, n), F32)
        self.outstanding = np.zeros((lanes, n), bool)
        self.acks, self.cvc = z(lanes, n, n), z(lanes, n, n)
        self.committed_slot = z(lanes, n)
        self.slot_vc = np.zeros((lanes, n, 1 + n), F32)
        self.busy = np.zeros((lanes, n), F32)
        self.lines = {k: DelayLine(dep.horizon, lanes, n, w)
                      for k, w, _ in messages("paxos", n)}

    def tick(self, t: int, lcr, net: Links) -> None:
        dep, n = self.dep, self.dep.n
        maj = n // 2 + 1
        tf = F32(t)
        rows = np.arange(n)
        alive = net.alive
        delays = net.delay.astype(I32)
        cfl, cpay = self.lines["acc"].pop(t)
        afl, apay = self.lines["ack"].pop(t)
        view = self.view
        i_lead = ((view % n) == rows) & alive
        # acks: a majority commits the leader's slot
        acks = _received(afl, apay, self.acks.astype(F32)[..., None]
                         )[..., 0].astype(I32)
        commit = i_lead & self.outstanding & (
            np.sum(acks >= self.slot[..., None], axis=2) >= maj)
        committed_slot = np.where(commit, self.slot, self.committed_slot)
        outstanding = self.outstanding & ~commit
        cvc = np.where(commit[..., None],
                       np.maximum(self.cvc, self.slot_vc[..., 1:].astype(I32)),
                       self.cvc)
        # the leader proposes the next slot when it has news
        can = i_lead & ~outstanding & (tf >= self.ready_at)
        have = (lcr > cvc).any(axis=2) & can
        slot = np.where(have, self.slot + 1, self.slot)
        pay_vc = np.where(have[..., None], lcr.astype(F32),
                          self.slot_vc[..., 1:])
        slot_vc = np.concatenate([slot[..., None].astype(F32), pay_vc], -1)
        outstanding = outstanding | have
        nbytes = np.where(have, F32(dep.meta_bytes), F32(0.0))
        busy, ser = _egress(self.busy, t, nbytes / net.rate)
        self.busy = np.where(have, busy, self.busy)
        delay = (delays.astype(F32) + np.where(have[..., None], ser,
                                               F32(0.0))).astype(I32)
        acc = np.concatenate([view[..., None].astype(F32),
                              slot[..., None].astype(F32),
                              np.zeros(view.shape + (1,), F32), pay_vc], -1)
        self.lines["acc"].send(t, _bcast(acc, n), delay,
                               np.broadcast_to(have[..., None], delay.shape),
                               net.drop)
        # followers: a fresh accept sets the view and is acked
        fl = cfl.transpose(0, 2, 1)
        mx = np.max(np.where(fl[..., None], cpay.transpose(0, 2, 1, 3), NEG),
                    axis=2)
        acc_view, acc_slot = mx[..., 0].astype(I32), mx[..., 1].astype(I32)
        fresh = fl.any(axis=2) & (acc_view >= view) & alive
        view = np.where(fresh, acc_view, view)
        last_heard = np.where(fresh, tf, self.last_heard)
        self.lines["ack"].send(
            t, np.broadcast_to(acc_slot.astype(F32)[:, :, None, None],
                               fl.shape + (1,)),
            delays, fresh[..., None] & (rows == (view % n)[..., None]),
            net.drop)
        # the view timeout
        expired = alive & ((tf - last_heard) > dep.timeout_ticks)
        view = np.where(expired, view + 1, view)
        last_heard = np.where(expired, tf, last_heard)
        became = expired & ((view % n) == rows)
        self.ready_at = np.where(became, tf + dep.phase1, self.ready_at)
        self.view, self.last_heard, self.slot = view, last_heard, slot
        self.outstanding, self.acks = outstanding, acks
        self.committed_slot, self.cvc, self.slot_vc = (committed_slot, cvc,
                                                       slot_vc)

    def trace(self) -> Dict:
        return {"cvc": self.cvc.max(axis=1)}


# ----------------------------------------------------------------- metrics

def _round_bf16(x: np.ndarray) -> np.ndarray:
    """float32 values rounded to the nearest bfloat16 (ties to even)."""
    u = x.view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    out = u.astype(np.uint32).view(F32)
    return np.where(np.isnan(x), x, out)


def _round_state(obj) -> None:
    """The control's step: every float32 array of a layer's state rounded
    to bfloat16 (its delay lines round each payload as it is sent, which
    leaves them as rounding them after every tick would)."""
    for k, v in vars(obj).items():
        if isinstance(v, np.ndarray) and v.dtype == F32:
            setattr(obj, k, _round_bf16(v))
        elif isinstance(v, DelayLine):
            v.bf16 = True
    for line in getattr(obj, "lines", {}).values():
        line.bf16 = True


def weighted_quantile(vals: np.ndarray, w: np.ndarray, q: float):
    """The value at which the weights' running share, taken in value order
    (ties in place order), first reaches q; NaN with no weight. Running
    sums are float64 sums rounded to float32."""
    order = np.argsort(vals, kind="stable")
    cum = np.cumsum(w[order].astype(np.float64)).astype(F32)
    tot = cum[-1]
    if not tot > 0:
        return F32(np.nan)
    cdf = cum / tot
    i = min(int(np.searchsorted(cdf, F32(q), side="left")), vals.size - 1)
    return vals[order][i]


def commit_ticks(cvc: np.ndarray, rounds: int) -> np.ndarray:
    """[T, n] committed rounds of each origin -> [n, rounds] the first tick
    at which round r of each origin is committed (inf: never; round 0
    does not exist)."""
    T, n = cvc.shape
    out = np.full((n, rounds), np.inf, F32)
    rs = np.arange(rounds)
    for k in range(n):
        idx = np.searchsorted(cvc[:, k], rs, side="left")
        ok = (idx < T) & (rs >= 1)
        out[k, ok] = idx[ok].astype(F32)
    return out


def lane_metrics(dep: Deployment, create_t, arr_mean, count, commit_t
                 ) -> Dict:
    """Throughput, latency quantiles and timelines of one lane's batches
    [n, R], counted in the window after warm-up."""
    T, n = dep.ticks, dep.n
    ok = np.isfinite(commit_t) & (count > 0) & np.isfinite(create_t)
    lat = (commit_t - arr_mean) * F32(dep.tick_ms)
    w0 = WARMUP_FRAC * T
    in_win = ok & (commit_t >= w0)
    win_s = (T - w0) * dep.tick_ms / 1000.0
    w = np.where(in_win, count, F32(0.0))
    cnt_ok = np.where(ok, count, F32(0.0))
    tput = F32(np.sum(w, dtype=np.float64)) / F32(win_s)
    nb = int(math.ceil(T * dep.tick_ms / BUCKET_MS))
    b = np.clip(np.where(ok, commit_t * F32(dep.tick_ms / BUCKET_MS),
                         F32(0.0)).astype(I32), 0, nb - 1)

    def buckets(src):                                 # [n, R] -> [n, nb]
        return np.stack([np.bincount(b[k], weights=src[k].astype(np.float64),
                                     minlength=nb) for k in range(n)]
                        ).astype(F32)
    tl_o = buckets(cnt_ok)
    lat_sum = buckets(cnt_ok * np.where(ok, lat, F32(0.0)))
    with np.errstate(invalid="ignore", divide="ignore"):
        lat_tl = np.where(tl_o > 0, lat_sum / np.maximum(tl_o, F32(1e-9)),
                          F32(np.nan))
    per_s = F32(BUCKET_MS / 1000.0)
    return {
        "throughput": float(tput),
        "median_ms": float(weighted_quantile(lat.ravel(), w.ravel(), 0.5)),
        "p99_ms": float(weighted_quantile(lat.ravel(), w.ravel(), 0.99)),
        "committed": float(F32(np.sum(cnt_ok, dtype=np.float64))),
        "timeline": np.bincount(b.ravel(), weights=cnt_ok.ravel().astype(
            np.float64), minlength=nb).astype(F32) / per_s,
        "origin_median_ms": np.array(
            [weighted_quantile(lat[k], w[k], 0.5) for k in range(n)], F32),
        "origin_p99_ms": np.array(
            [weighted_quantile(lat[k], w[k], 0.99) for k in range(n)], F32),
        "origin_timeline": tl_o / per_s,
        "origin_lat_ms_timeline": lat_tl}


# ------------------------------------------------------------------- a run

def run(protocol: str, dep: Deployment, arrivals: np.ndarray,
        tables: Dict, precision: str = "float32") -> Dict:
    """Simulate lanes side by side: ``arrivals`` [B, T, n] requests per
    origin per tick, ``tables`` the lanes' scenario tables, stacked.
    Returns the per-tick traces [B, T, ...] and the final Mandator
    layer."""
    if protocol not in LAYERS:
        raise ValueError(f"the reference simulates {sorted(LAYERS)}, "
                         f"not {protocol!r}")
    B, T = arrivals.shape[0], dep.ticks
    m = Mandator(dep, B)
    order = Sporades(dep, B) if protocol == "mandator-sporades" \
        else Paxos(dep, B)
    net = Network(dep, tables)
    traces: Dict[str, np.ndarray] = {}
    for t in range(T):
        links = net.at(t)
        m.tick(t, arrivals[:, t], links)
        order.tick(t, m.lcr, links)
        if precision == "bfloat16":
            _round_state(m)
            _round_state(order)
        for k, v in order.trace().items():
            if k not in traces:
                traces[k] = np.empty((B, T) + v.shape[1:], v.dtype)
            traces[k][:, t] = v
    return {"trace": traces, "mandator": m}


def lane_rows(protocol: str, dep: Deployment, arrivals: np.ndarray,
              tables: Dict, labels: Sequence[Dict],
              precision: str = "float32") -> List[Dict]:
    """One row per lane: ``labels[b]`` (protocol, rate, seed, workload)
    with the lane's metrics; under Sporades also the share of replica-ticks
    on the async path, the highest view, and the committed vector clocks
    and commit keys of every tick."""
    out = run(protocol, dep, arrivals, tables, precision)
    tr, m = out["trace"], out["mandator"]
    rows = []
    for b, label in enumerate(labels):
        ct = commit_ticks(tr["cvc"][b], m.count.shape[2])
        row = dict(label)
        row.update(lane_metrics(dep, m.create_t[b], m.arr_mean[b],
                                m.count[b], ct))
        if protocol == "mandator-sporades":
            asy = tr["is_async"][b]
            row["async_frac"] = float(F32(np.count_nonzero(asy) / asy.size))
            row["views"] = int(tr["v_cur"][b].max())
            row["cvc_all"] = tr["cvc_all"][b]
            row["commit_key"] = tr["commit_key"][b]
        rows.append(row)
    return rows


def ring_bytes(protocol: str, dep: Deployment, lanes: int) -> float:
    """Least bytes a tick's delay-line commit moves on the device, per
    commit, averaged over the protocol's layers (one commit each a tick):
    the arriving slot cleared (written once), each send's per-sender
    payload rows, delays and masks read once, and each kind's cells of
    its target slots read and written once (one slot a link at the
    least)."""
    n = dep.n
    total = 0.0
    for layer in LAYERS[protocol]:
        kinds = messages(layer, n)
        k = sum(w + 1 for _, w, _ in kinds)
        cleared = n * n * k * 4
        sends = sum(s * (n * w * 4 + n * n * (4 + 1)) for _, w, s in kinds)
        cells = sum((w + 1) * n * n * 8 for _, w, _ in kinds)
        total += lanes * (cleared + sends + cells)
    return total / len(LAYERS[protocol])
