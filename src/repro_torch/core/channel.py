"""Delayed-delivery message channels for the tick-based WAN simulator: the
packed ring of ``repro.core.channel``, batched over the grid.

ALL of a protocol's channels are concatenated along the field axis into one
ring ``buf [B, D, n, n, K]`` (lane, arrival slot, sender, receiver, field;
one flag field per channel). Sender i's message to j sent at tick t lands
in slot ``(t + clip(delay_ij, 1, D-1)) % D``. All protocol payloads are
monotone, so colliding deliveries merge by elementwise max (additive
counter channels by add); the receive side folds arrivals into
"latest state" matrices with elementwise max (``fold_state``).

A whole tick's traffic is one fused commit (``ring_commit``): the slot
clear, one scatter-max and one scatter-add, through
``repro_torch.kernels.channel_ring``. On the card one CUDA launch reads
the tick's sends where they lie; the plain PyTorch version (the CPU path)
first merges each send with its mask (``commit_entries``) and packs the
entries. The port updates the ring in place.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.kernels.channel_ring import kernel as ring_kernel
from repro_torch.kernels.channel_ring import ops as ring_ops

NEG = -1.0  # "absent" payload fill


def fold_state(state: torch.Tensor, flags: torch.Tensor,
               payload: torch.Tensor) -> torch.Tensor:
    """Merge arrivals into the latest-state matrix [B, n, n, P] (receiver,
    sender). flags [B, n, n] and payload [B, n, n, P] are (sender,
    receiver)."""
    arr = payload.transpose(1, 2)
    fl = flags.transpose(1, 2)[..., None]
    return torch.where(fl, torch.maximum(state, arr), state)


class ChannelSpec(NamedTuple):
    """One logical channel inside a packed ring."""
    name: str
    width: int                 # payload fields
    additive: bool = False     # add-merge (counters) instead of max-merge


@dataclass(frozen=True)
class RingSpec:
    """Static field layout of a protocol's packed ring.

    Channels are laid out in declaration order, each as its payload fields
    immediately followed by its own flag field — K = sum(width_c + 1).
    Max-merged payload fields clear to ``NEG``; additive payload fields and
    all flag fields clear to 0.0 (flags merge by max either way).
    """
    channels: Tuple[ChannelSpec, ...]

    def __init__(self, *channels: ChannelSpec):
        object.__setattr__(self, "channels", tuple(channels))
        assert len({c.name for c in channels}) == len(channels), channels

    @property
    def k(self) -> int:
        return sum(c.width + 1 for c in self.channels)

    def offset(self, name: str) -> int:
        off = 0
        for c in self.channels:
            if c.name == name:
                return off
            off += c.width + 1
        raise KeyError(name)

    def flag(self, name: str) -> int:
        return self.offset(name) + self[name].width

    def __getitem__(self, name: str) -> ChannelSpec:
        for c in self.channels:
            if c.name == name:
                return c
        raise KeyError(name)

    def fill(self) -> np.ndarray:
        """Per-field clear value [K]: merge-neutral of each field."""
        f = np.zeros((self.k,), np.float32)
        for c in self.channels:
            if not c.additive:
                f[self.offset(c.name):self.offset(c.name) + c.width] = NEG
        return f

    def layout(self, name: str) -> Tuple[int, int, int, bool]:
        """(payload offset, width, flag field, additive) — the static
        per-entry layout the kernels consume."""
        c = self[name]
        return (self.offset(name), c.width, self.flag(name), c.additive)


@functools.lru_cache(maxsize=32)
def fill_tensor(spec: RingSpec, device: torch.device) -> torch.Tensor:
    """``spec.fill()`` on ``device``, made once so a tick copies nothing
    from the host."""
    return torch.as_tensor(spec.fill(), device=device)


def ring_occupancy(spec: RingSpec, ring: Dict[str, torch.Tensor]
                   ) -> torch.Tensor:
    """[B] fraction of (slot, sender, receiver, channel) entries holding an
    undelivered message (flag fields > 0.5), the health monitor's ring
    gauge. The count is exact in float32; XLA-CPU takes the reference's
    ``jnp.mean`` as the count times the float32 reciprocal of the size,
    and so does this, on the CPU and on the card alike (torch's CPU
    ``mean`` divides instead)."""
    buf = ring["buf"]
    full = (buf[..., _flag_index(spec, buf.device)] > 0.5).flatten(1)
    held = full.sum(dim=1).float()
    return held * _reciprocal(held, full.shape[1])


@functools.lru_cache(maxsize=64)
def _flag_index(spec: RingSpec, device: torch.device) -> torch.Tensor:
    """The flag fields' offsets in the packed ring, on ``device``."""
    return torch.tensor([spec.flag(c.name) for c in spec.channels],
                        dtype=torch.int64, device=device)


def _reciprocal(like: torch.Tensor, size: int) -> torch.Tensor:
    """float32 1/size as a tensor like ``like``."""
    return torch.full_like(like, float(np.float32(1.0) / np.float32(size)))


class Send(NamedTuple):
    """One buffered send of a tick: channel name + payload, per-link delay
    and mask. The per-tick send list of a protocol is static (same channels
    in the same order every tick)."""
    name: str
    payload: torch.Tensor      # [B, n, n, P]
    delay_ticks: torch.Tensor  # [B, n, n] int32 >= 1 (clipped to [1, D-1])
    mask: torch.Tensor         # [B, n, n] bool


def make_ring(spec: RingSpec, dmax: int, n: int, batch: int,
              device: torch.device) -> Dict[str, torch.Tensor]:
    buf = fill_tensor(spec, device).expand(batch, dmax, n, n, spec.k)
    return {"buf": buf.contiguous()}


def ring_deliver(spec: RingSpec, ring: Dict[str, torch.Tensor], t: int
                 ) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
    """Read slot t of every channel at once. Returns {name: (flags
    [B, n, n] bool, payload [B, n, n, P])}. The slot is copied out: the
    in-place ``ring_commit`` clears it later in the tick (sends never
    target slot t, so the clear commutes across the tick)."""
    slot = ring["buf"][:, t % ring["buf"].shape[1]].clone()   # [B,n,n,K]
    out = {}
    for c in spec.channels:
        off = spec.offset(c.name)
        out[c.name] = (slot[..., spec.flag(c.name)] > 0.5,
                       slot[..., off:off + c.width])
    return out


@functools.lru_cache(maxsize=64)
def send_layout(spec: RingSpec, names: Tuple[str, ...]
                ) -> Tuple[Tuple[int, int, int, bool], ...]:
    """Each send's ``spec.layout``, for a tick's static send list."""
    return tuple(spec.layout(n) for n in names)


def commit_entries(spec: RingSpec, dmax: int, t: int, sends: List[Send],
                   drop: torch.Tensor | None = None):
    """A tick's sends as the commit's entries and static layout: per send,
    (target slot [B, n, n] int32, payload with the merge-neutral value
    where the send mask — less ``drop``, the scenario's cut links — is
    off, flag [B, n, n] float32)."""
    # the kernel's order-free semantics (and the fused scatter-add's)
    # require additive channels to send at most once per tick; max-merged
    # channels may repeat freely, max is order-free
    add_names = [s.name for s in sends if spec[s.name].additive]
    if len(add_names) != len(set(add_names)):
        raise ValueError(f"additive channel sent twice in one tick: "
                         f"{add_names}")
    entries, layout = [], []
    for s in sends:
        c = spec[s.name]
        mask = s.mask if drop is None else s.mask & ~drop
        slot = (t + torch.clamp(s.delay_ticks, 1, dmax - 1)) % dmax
        neutral = 0.0 if c.additive else NEG
        vals = torch.where(mask[..., None], s.payload, neutral)
        entries.append((slot, vals, mask.float()))
        layout.append(spec.layout(s.name))
    return entries, layout


def ring_commit(spec: RingSpec, ring: Dict[str, torch.Tensor], t: int,
                sends: List[Send], drop: torch.Tensor | None = None,
                backend: str = "auto") -> Dict[str, torch.Tensor]:
    """Fused commit of one tick, in place: clear the delivered slot
    ``t % D`` and merge every buffered send. ``drop`` is the tick's
    scenario link-cut mask, applied to every send (silent omission)."""
    buf = ring["buf"]
    fill = fill_tensor(spec, buf.device)
    if ring_ops.resolve_backend(backend, buf.device) == "cuda":
        layout = send_layout(spec, tuple(s.name for s in sends))
        ring_kernel.ring_commit_fused(buf, t, fill, sends, drop, layout)
        return {"buf": buf}
    entries, layout = commit_entries(spec, buf.shape[1], t, sends, drop)
    return {"buf": ring_ops.ring_commit(buf, t, fill, entries, layout)}
