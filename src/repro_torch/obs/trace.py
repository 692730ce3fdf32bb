"""On-device protocol flight recorder: fixed-shape event rings, batched over
the grid (port of ``repro.obs.trace``).

Every scan protocol carries one trace state per layer (mandator /
sporades / paxos) inside its carry. The event taxonomy is declared once as
a ``TraceSpec`` (declaration order = kind id); the ring is an int32 buffer
``[B, n, cap, 4]`` of (kind, tick, a, b) rows per lane and replica, and
recording is a masked scatter.

Gating follows ``SMRConfig.trace_level``: at ``TraceLevel.OFF`` (the
default) ``init_trace`` returns None and every ``record`` call passes None
through, so call sites stay unbranched and the tick runs exactly the ops
of an untraced build. ``COUNTERS`` keeps only the per-kind event counters;
``FULL`` adds the event ring.

Overflow semantics: the ring keeps the **newest** ``cap`` events. Event
number ``p`` of a replica (``ptr`` counts them) lands in slot
``p % cap``, which is exactly the oldest live entry once ``p >= cap`` —
overwriting it drops the oldest event and bumps a ``dropped`` counter
that saturates at 2^31 - 1. ``obs/decode.py`` unwraps the ring back into
arrival order.

``record_env`` records a layer's events of one tick in one pass: event j
of the tick takes position ``ptr + (events before it)``, as the
reference's one-by-one ``record`` calls give it. The state's buffer has
one slot past ``cap`` that takes the writes of masked-out events and of
events the same tick overwrites again, so one scatter with distinct live
targets does the tick; ``public_view`` drops that slot.

Payloads are int32 throughout: sporades rank keys reach
``MAX_VIEWS * RS = 2**26``, past float32's exact-integer range.
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Sequence, Tuple

import torch


class TraceLevel:
    """Trace gate. OFF leaves the recorder out entirely; COUNTERS keeps
    per-kind event counts; FULL adds the event ring."""
    OFF = "off"
    COUNTERS = "counters"
    FULL = "full"
    ORDER = (OFF, COUNTERS, FULL)

    @staticmethod
    def check(level: str) -> str:
        if level not in TraceLevel.ORDER:
            raise ValueError(
                f"trace_level {level!r}; expected one of {TraceLevel.ORDER}")
        return level


TRACE_ENV = "REPRO_TRACE"  # benchmarks read the level from the environment


def level_from_env(default: str = TraceLevel.OFF) -> str:
    """Trace level from ``REPRO_TRACE`` (off/counters/full)."""
    return TraceLevel.check(os.environ.get(TRACE_ENV, default))


class TraceSpec:
    """The event taxonomy: a tuple of (name, (arg_a, arg_b)) pairs.
    Declaration order is the on-device kind id."""

    def __init__(self, *events: Tuple[str, Tuple[str, str]]):
        self.events = tuple(events)
        self.names = tuple(name for name, _ in events)
        self._kind = {name: i for i, (name, _) in enumerate(events)}
        if len(self._kind) != len(events):
            raise ValueError("duplicate event names")

    @property
    def n_kinds(self) -> int:
        return len(self.events)

    def kind(self, name: str) -> int:
        return self._kind[name]

    def args_of(self, name_or_kind) -> Tuple[str, str]:
        if isinstance(name_or_kind, str):
            return self.events[self._kind[name_or_kind]][1]
        return self.events[int(name_or_kind)][1]


# One shared taxonomy for every protocol layer; a layer records the subset
# that exists in its state machine (e.g. multipaxos never mode-switches).
DEFAULT_SPEC = TraceSpec(
    ("view_change", ("view", "round")),       # consensus view/round advance
    ("mode_switch", ("is_async", "view")),    # sporades sync<->async
    ("leader_change", ("leader", "view")),
    ("batch_create", ("round", "count")),     # round/slot formed
    ("batch_disseminate", ("round", "egress_ticks")),
    ("batch_ack", ("round", "quorum")),       # quorum of votes reached
    ("batch_stable", ("round", "completed")),  # completion (stable) point
    ("commit", ("key", "total")),             # ordered/committed
    ("crash", ("view", "round")),             # alive -> down transition
    ("recover", ("view", "round")),           # down -> alive transition
    ("drop", ("links", "view")),              # sends cut by partition/drop
)

# Event-ring record fields, in buffer order (buf[..., i]).
FIELDS = ("kind", "tick", "a", "b")

# Latency-breakdown phases (harness.sim_point), in output order: a
# committed batch's end-to-end latency = queue (client arrival -> batch
# create at the origin) + dissemination (create -> n-f votes / stable) +
# consensus (stable -> ordered anywhere) + delivery (ordered -> the
# origin itself observes the commit).
PHASES = ("queue", "dissemination", "consensus", "delivery")

_SAT = 2**31 - 1  # saturation bound of the dropped counter

# Event = (name, mask [B, n] bool, a, b): a and b are ints or tensors that
# broadcast to [B, n] (floats truncate toward zero, as the reference casts)
Event = Tuple[str, torch.Tensor, object, object]

_KINDS: Dict[tuple, torch.Tensor] = {}


def init_trace(spec: TraceSpec, level: str, n: int, cap: int, batch: int,
               device: torch.device) -> Optional[Dict[str, torch.Tensor]]:
    """Per-layer trace state of ``batch`` lanes, or None at TraceLevel.OFF
    (so carrying it in protocol state dicts costs nothing when tracing is
    off)."""
    TraceLevel.check(level)
    if level == TraceLevel.OFF:
        return None
    zi = lambda *s: torch.zeros((batch, *s), dtype=torch.int32,  # noqa: E731
                                device=device)
    ts = {
        "counts": zi(n, spec.n_kinds),
        # crash/recover edge detection (netsim.alive is the level signal)
        "prev_alive": torch.ones((batch, n), dtype=torch.bool,
                                 device=device),
    }
    if level == TraceLevel.FULL:
        if cap < 1:
            raise ValueError(f"trace_events must be >= 1, got {cap}")
        ts["buf"] = zi(n, cap + 1, len(FIELDS))   # + the spill slot
        ts["ptr"] = zi(n)
        ts["dropped"] = zi(n)
    return ts


def _i32(x, like: torch.Tensor) -> torch.Tensor:
    """x as int32 broadcast to ``like``'s [B, n]."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int32).expand_as(like)
    return torch.full_like(like, int(x), dtype=torch.int32)


def _kinds(spec: TraceSpec, names: Sequence[str],
           device: torch.device) -> torch.Tensor:
    """[E] int64 kind ids, made once per (names, device)."""
    key = (id(spec), tuple(names), str(device))
    k = _KINDS.get(key)
    if k is None:
        k = torch.tensor([spec.kind(x) for x in names], dtype=torch.int64,
                         device=device)
        _KINDS[key] = k
    return k


def _record_events(spec: TraceSpec, ts: Optional[Dict],
                   events: Sequence[Event], t: int) -> Optional[Dict]:
    """Record ``events`` in order at tick ``t``: each for every lane and
    replica where its mask is set. Equals the reference's ``record``
    called once per event; the counters and the ring are updated in
    place. None trace state (level off) passes straight through."""
    if ts is None or not events:
        return ts
    counts = ts["counts"]
    B, n = counts.shape[:2]
    like = counts[..., 0]
    masks = torch.stack([m.expand(B, n) for _, m, _, _ in events], dim=-1)
    inc = masks.to(torch.int32)                                  # [B, n, E]
    kinds = _kinds(spec, [name for name, _, _, _ in events], counts.device)
    counts.index_add_(2, kinds, inc)
    if "buf" not in ts:
        return ts
    ts = dict(ts)
    buf = ts["buf"]
    cap = buf.shape[2] - 1
    rank = torch.cumsum(inc, dim=-1) - inc       # events before, this tick
    tot = rank[..., -1] + inc[..., -1]
    pos = ts["ptr"][..., None] + rank            # the event's number
    # only the tick's newest `cap` events survive it; the rest, and the
    # masked-out events, write the spill slot
    live = masks & (rank >= tot[..., None] - cap)
    slot = torch.where(live, torch.remainder(pos, cap), cap).long()
    E = len(events)
    rec = torch.stack([
        kinds.to(torch.int32).expand(B, n, E),
        torch.full_like(inc, int(t)),
        torch.stack([_i32(a, like) for _, _, a, _ in events], dim=-1),
        torch.stack([_i32(b, like) for _, _, _, b in events], dim=-1)],
        dim=-1)                                                  # [B,n,E,4]
    buf.scatter_(2, slot[..., None].expand(B, n, E, len(FIELDS)), rec)
    evicted = (inc * (pos >= cap)).sum(dim=-1)
    ts["dropped"] = torch.clamp(ts["dropped"].long() + evicted,
                                max=_SAT).to(torch.int32)
    ts["ptr"] = ts["ptr"] + tot.to(torch.int32)
    return ts


def record(spec: TraceSpec, ts: Optional[Dict], name: str,
           mask: torch.Tensor, t: int, a=0, b=0) -> Optional[Dict]:
    """Record event ``name`` for every lane and replica where ``mask``
    ([B, n] bool) is set, with int payloads ``a``/``b`` (ints or tensors
    broadcasting to [B, n]; floats are truncated). None trace state (level
    off) passes straight through."""
    return _record_events(spec, ts, [(name, mask, a, b)], t)


def record_env(spec: TraceSpec, ts: Optional[Dict], alive: torch.Tensor,
               t: int, a=0, b=0,
               dropped_links: Optional[torch.Tensor] = None,
               events: Sequence[Event] = ()) -> Optional[Dict]:
    """A layer's events of tick ``t`` in one pass: first ``events`` (the
    protocol's own, in order), then the environment-driven ones shared by
    every layer — crash/recover edges of ``netsim.alive`` and sends cut by
    link drops (``dropped_links``: per-sender count)."""
    if ts is None:
        return None
    prev = ts["prev_alive"]
    env = [("crash", prev & ~alive, a, b), ("recover", ~prev & alive, a, b)]
    if dropped_links is not None:
        env.append(("drop", dropped_links > 0, dropped_links, a))
    ts = dict(_record_events(spec, ts, list(events) + env, t))
    ts["prev_alive"] = alive
    return ts


class HostTrace:
    """Host-side sibling of the device ring, for the pure-numpy paths (the
    analytic rabia slot loop): same event taxonomy, plain-list storage, no
    capacity games. ``events`` is already in arrival order."""

    def __init__(self, spec: TraceSpec = DEFAULT_SPEC):
        self.spec = spec
        self.events: list = []

    def record(self, name: str, tick, who: int = 0, **args) -> None:
        self.spec.kind(name)  # unknown names fail fast, like the ring
        self.events.append({"name": name, "tick": float(tick),
                            "who": int(who),
                            "args": {k: (float(v) if isinstance(v, float)
                                         else int(v))
                                     for k, v in args.items()}})

    def counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for e in self.events:
            out[e["name"]] = out.get(e["name"], 0) + 1
        return out


def public_view(ts: Optional[Dict]) -> Optional[Dict]:
    """The trace leaves worth surfacing out of the tick loop (everything
    but the edge-detector scratch and the spill slot), [B, ...]."""
    if ts is None:
        return None
    out = {k: v for k, v in ts.items() if k != "prev_alive"}
    if "buf" in out:
        out["buf"] = out["buf"][:, :, :-1]
    return out
