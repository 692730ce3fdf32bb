"""Delayed-delivery message channels for the tick-based WAN simulator: the
packed ring of ``repro.core.channel``, batched over the grid.

ALL of a protocol's channels are concatenated along the field axis into one
ring ``buf [B, D, n, n, K]`` (lane, arrival slot, sender, receiver, field;
one flag field per channel). Sender i's message to j sent at tick t lands
in slot ``(t + clip(delay_ij, 1, D-1)) % D``. All protocol payloads are
monotone, so colliding deliveries merge by elementwise max (additive
counter channels by add); the receive side folds arrivals into
"latest state" matrices with elementwise max (``fold_state``). The
reference's unpacked per-channel API (``make_channel``, ``send``,
``deliver``: one ring per message type, unbatched) is kept beside it.

A whole tick's traffic is one fused commit (``ring_commit``): the slot
clear, one scatter-max and one scatter-add, through
``repro_torch.kernels.channel_ring``. On the card one CUDA launch reads
the tick's sends where they lie; the plain PyTorch version (the CPU path)
first merges each send with its mask (``commit_entries``) and packs the
entries. The port updates the ring in place.

The tick ``t`` is a 0-dim int32 tensor on the ring's device (a Python int
is converted): the delivered slot ``t % D`` and every target slot are
computed on the device, and the CUDA kernel reads ``t`` from device
memory, so a tick captured as a CUDA graph replays at any ``t``.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch import device as _device
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


# --------------------------------------------------------------------------
# The per-channel ring (the reference's unpacked API): one ring dict per
# message type, unbatched, the semantics the packed ring is pinned against
# --------------------------------------------------------------------------

def make_channel(dmax: int, n: int, p: int, additive: bool = False,
                 device=None) -> Dict[str, torch.Tensor]:
    """One channel's ring on ``device`` (None = CUDA): ``buf`` [dmax, n, n,
    p] float32 at its fill (``NEG``; 0.0 when ``additive``), ``flag``
    [dmax, n, n] bool, ``fill`` a 0-dim float32."""
    dev = _device.resolve(device)
    fill = 0.0 if additive else NEG
    return {"buf": torch.full((dmax, n, n, p), fill, dtype=torch.float32,
                              device=dev),
            "flag": torch.zeros((dmax, n, n), dtype=torch.bool, device=dev),
            "fill": torch.tensor(fill, dtype=torch.float32, device=dev)}


def send(ch: Dict[str, torch.Tensor], t, payload: torch.Tensor,
         delay_ticks: torch.Tensor, mask: torch.Tensor,
         additive: bool = False, drop=None) -> Dict[str, torch.Tensor]:
    """payload: [n, n, P] (sender, receiver, fields); delay_ticks: [n, n]
    int, clipped to [1, dmax - 1]; mask: [n, n] bool, the (i, j) that send
    this tick; drop: optional [n, n] bool, links the scenario cuts (a
    silent omission). Merges by elementwise max, or adds when
    ``additive``. Each (i, j) writes one slot, so no index repeats and the
    result is the same on every device. Returns a new channel."""
    if drop is not None:
        mask = mask & ~drop
    buf, flag = ch["buf"].clone(), ch["flag"].clone()
    dmax, n = buf.shape[0], payload.shape[0]
    t = _device.tick_index(t, buf.device)
    slot = (t.long() + torch.clamp(delay_ticks.long(), 1, dmax - 1)) % dmax
    ii, jj = torch.meshgrid(torch.arange(n, device=buf.device),
                            torch.arange(n, device=buf.device),
                            indexing="ij")
    at = (slot, ii, jj)
    if additive:
        buf[at] = buf[at] + torch.where(mask[..., None], payload, 0.0)
    else:
        buf[at] = torch.maximum(buf[at], torch.where(mask[..., None],
                                                     payload, NEG))
    flag[at] = flag[at] | mask
    return {"buf": buf, "flag": flag, "fill": ch["fill"]}


def deliver(ch: Dict[str, torch.Tensor], t
            ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor, torch.Tensor]:
    """Pop slot ``t % dmax``: returns (the channel with the slot cleared,
    flags [n, n], payload [n, n, P]), indexed on the device."""
    dmax = ch["buf"].shape[0]
    slot = (_device.tick_index(t, ch["buf"].device).long() % dmax).view(1)
    flags = ch["flag"].index_select(0, slot)[0]
    payload = ch["buf"].index_select(0, slot)[0]
    buf = ch["buf"].index_fill(0, slot, ch["fill"])
    flag = ch["flag"].index_fill(0, slot, False)
    return {"buf": buf, "flag": flag, "fill": ch["fill"]}, flags, payload


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


# The caches below that hold device tensors are unbounded: a captured tick
# graph (core/compile_cache.py) reads them where they lie, so none may be
# evicted and freed while a graph lives. Their keys are a protocol's few
# layouts and devices.
@functools.lru_cache(maxsize=None)
def fill_tensor(spec: RingSpec, device: torch.device) -> torch.Tensor:
    """``spec.fill()`` on ``device``, made once so a tick copies nothing
    from the host."""
    return _device.to_device(spec.fill(), device)


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


@functools.lru_cache(maxsize=None)
def _flag_index(spec: RingSpec, device: torch.device) -> torch.Tensor:
    """The flag fields' offsets in the packed ring, on ``device``."""
    return _device.to_device([spec.flag(c.name) for c in spec.channels],
                             device, torch.int64)


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


def ring_deliver(spec: RingSpec, ring: Dict[str, torch.Tensor],
                 t: torch.Tensor
                 ) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
    """Read slot t of every channel at once. Returns {name: (flags
    [B, n, n] bool, payload [B, n, n, P])}. The slot is copied out: the
    in-place ``ring_commit`` clears it later in the tick (sends never
    target slot t, so the clear commutes across the tick)."""
    buf = ring["buf"]
    t = _device.tick_index(t, buf.device)
    at = (t % buf.shape[1]).long().view(1)
    slot = buf.index_select(1, at)[:, 0]                      # [B,n,n,K]
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


def commit_entries(spec: RingSpec, dmax: int, t: torch.Tensor,
                   sends: List[Send],
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
    if sends:
        t = _device.tick_index(t, sends[0].delay_ticks.device)
    for s in sends:
        c = spec[s.name]
        mask = s.mask if drop is None else s.mask & ~drop
        slot = (t + torch.clamp(s.delay_ticks, 1, dmax - 1)) % dmax
        neutral = 0.0 if c.additive else NEG
        vals = torch.where(mask[..., None], s.payload, neutral)
        entries.append((slot, vals, mask.float()))
        layout.append(spec.layout(s.name))
    return entries, layout


def ring_commit(spec: RingSpec, ring: Dict[str, torch.Tensor],
                t: torch.Tensor,
                sends: List[Send], drop: torch.Tensor | None = None,
                backend: str = "auto") -> Dict[str, torch.Tensor]:
    """Fused commit of one tick, in place: clear the delivered slot
    ``t % D`` and merge every buffered send. ``drop`` is the tick's
    scenario link-cut mask, applied to every send (silent omission)."""
    buf = ring["buf"]
    fill = fill_tensor(spec, buf.device)
    t = _device.tick_index(t, buf.device)
    if ring_ops.resolve_backend(backend, buf.device) == "cuda":
        layout = send_layout(spec, tuple(s.name for s in sends))
        ring_kernel.ring_commit_fused(buf, t, fill, sends, drop, layout)
        return {"buf": buf}
    entries, layout = commit_entries(spec, buf.shape[1], t, sends, drop)
    return {"buf": ring_ops.ring_commit(buf, t, fill, entries, layout)}
