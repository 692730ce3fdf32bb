"""Dispatch helpers for the channel-ring commit.

``core/channel.ring_commit`` calls one of two routes once per protocol per
tick, picked from where the ring lives by the rule of
``kernels/_dispatch.py`` (``resolve_backend``): ``"auto"`` is the CUDA
kernel for a CUDA ring and the plain PyTorch version for a CPU ring;
``"ref"`` is the plain version anywhere; ``"cuda"`` is the kernel and
raises for a CPU ring. There is no fallback from the kernel to the plain
version.

  * the kernel (``kernel.ring_commit_fused``) takes the tick's sends as
    they lie;
  * the plain version (``ring_commit``) takes them as entries already
    merged with their masks (``core/channel.commit_entries``), packs them
    into contiguous tensors (``pack_entries``) and runs ``ref.py``.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

from repro_torch.kernels import _dispatch
from repro_torch.kernels.channel_ring.ref import (EntryLayout, as_layout,
                                                  ring_commit_ref)


# per-tick send entry, already mask-merged: (slot [B,n,n] int32,
# vals [B,n,n,w] float32 with merge-neutral at masked-out links,
# flag [B,n,n] float32 1.0/0.0)
Entry = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def resolve_backend(backend: str, device: torch.device) -> str:
    """"ref" or "cuda" for a ring on ``device``."""
    return _dispatch.resolve_backend(backend, device, "channel")


def pack_entries(entries: Sequence[Entry]
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Stack a tick's entries into slots [B,n,n,E] int32, vals
    [B,n,n,sum(w)] float32 and flags [B,n,n,E] float32."""
    slots = torch.stack([e[0] for e in entries], dim=-1).to(torch.int32)
    vals = torch.cat([e[1] for e in entries], dim=-1).float().contiguous()
    flags = torch.stack([e[2] for e in entries], dim=-1).float()
    return slots.contiguous(), vals, flags.contiguous()


def ring_commit(buf: torch.Tensor, t: int, fill: torch.Tensor,
                entries: Sequence[Entry],
                layout: Sequence[EntryLayout]) -> torch.Tensor:
    """The plain version of one tick's commit into ``buf`` [B, D, n, n, K],
    in place: slot-clear of the delivered slot ``t % D`` + one scatter-max
    + one scatter-add (see ref.py). Returns ``buf``."""
    slots, vals, flags = pack_entries(entries)
    return ring_commit_ref(buf, t, fill, slots, vals, flags,
                           as_layout(layout))
