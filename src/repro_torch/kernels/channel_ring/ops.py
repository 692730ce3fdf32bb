"""Dispatch wrapper for the fused channel-ring commit.

Called from ``core/channel.ring_commit`` once per protocol per tick. It
packs the tick's send entries into the contiguous tensors the kernel takes
and picks the backend from where the ring lives, by the rule of
``kernels/_dispatch.py``: ``"auto"`` is the CUDA kernel (kernel.py) for a
CUDA ring and the plain PyTorch version (ref.py) for a CPU ring; ``"ref"``
is the plain version anywhere; ``"cuda"`` is the kernel and raises for a
CPU ring. There is no fallback from the kernel to the plain version.
"""
from __future__ import annotations

import functools
from typing import Sequence, Tuple

import torch

from repro_torch.kernels import _dispatch
from repro_torch.kernels.channel_ring import kernel
from repro_torch.kernels.channel_ring.ref import (EntryLayout, as_layout,
                                                  ring_commit_ref)


# per-tick send entry, already mask-merged: (slot [B,n,n] int32,
# vals [B,n,n,w] float32 with merge-neutral at masked-out links,
# flag [B,n,n] float32 1.0/0.0)
Entry = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def resolve_backend(backend: str, device: torch.device) -> str:
    """"ref" or "cuda" for a ring on ``device``."""
    return _dispatch.resolve_backend(backend, device, "channel")


@functools.lru_cache(maxsize=64)
def layout_table(layout: Tuple[EntryLayout, ...], device: torch.device
                 ) -> torch.Tensor:
    """[E, 5] int32 per-entry (off, w, flag_off, additive, value offset),
    built once per layout and device so a tick copies nothing from the
    host."""
    rows, voff = [], 0
    for off, w, flag_off, additive in layout:
        rows.append([off, w, flag_off, int(additive), voff])
        voff += w
    return torch.tensor(rows, dtype=torch.int32, device=device)


def pack_entries(entries: Sequence[Entry]
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Stack a tick's entries into slots [B,n,n,E] int32, vals
    [B,n,n,sum(w)] float32 and flags [B,n,n,E] float32."""
    slots = torch.stack([e[0] for e in entries], dim=-1).to(torch.int32)
    vals = torch.cat([e[1] for e in entries], dim=-1).float().contiguous()
    flags = torch.stack([e[2] for e in entries], dim=-1).float()
    return slots.contiguous(), vals, flags.contiguous()


def ring_commit(buf: torch.Tensor, t: int, fill: torch.Tensor,
                entries: Sequence[Entry], layout: Sequence[EntryLayout],
                backend: str = "auto") -> torch.Tensor:
    """Fused commit of one tick's sends into ``buf`` [B, D, n, n, K], in
    place: slot-clear of the delivered slot ``t % D`` + one scatter-max +
    one scatter-add (see ref.py). Returns ``buf``."""
    layout = as_layout(layout)
    slots, vals, flags = pack_entries(entries)
    if resolve_backend(backend, buf.device) == "ref":
        return ring_commit_ref(buf, t, fill, slots, vals, flags, layout)
    return kernel.ring_commit_cuda(buf, t, fill, slots, vals, flags,
                                   layout_table(layout, buf.device))
