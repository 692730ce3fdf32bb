"""Plain PyTorch version of the fused channel-ring commit.

One simulator tick's worth of channel traffic against the packed ring
``buf [B, D, n, n, K]`` (all of a protocol's channels concatenated along the
field axis, each channel's flag field right after its payload — see
core/channel.RingSpec), as the reference's ``ring_commit_ref`` does it:

  1. slot-clear: slot ``t % D`` (the slot the tick just delivered) is reset
     to the per-field fill vector (``t`` is a 0-dim int32 tensor on the
     ring's device, so the slot is chosen on the device);
  2. ONE scatter-max over every max-merged payload field and every flag
     field of the tick's sends;
  3. ONE scatter-add over the additive payload fields (request counters).

The tick's E send entries arrive packed as the CUDA kernel takes them
(ops.pack_entries): ``slots [B, n, n, E]`` int32 target slot, ``vals
[B, n, n, sum(w_e)]`` float32 merged payloads (merge-neutral where the send
mask is off), ``flags [B, n, n, E]`` float32 (1.0 where the mask is set),
and the static per-entry ``layout`` ``(off, w, flag_off, additive)``.

Duplicate scatter targets (two sends on one channel colliding in a slot)
merge by max, which is order-free; additive channels send once per tick, so
no target of the scatter-add repeats and its result does not depend on the
order of the adds. This is the CPU path of ``ops.ring_commit`` and the
yardstick the CUDA kernel (kernel.py) is held to, bitwise.
"""
from __future__ import annotations

import functools
from typing import Sequence, Tuple

import torch

from repro_torch import device as _device

# static per-entry layout: (payload offset, width, flag field, additive)
EntryLayout = Tuple[int, int, int, bool]


def as_layout(layout: Sequence[EntryLayout]) -> Tuple[EntryLayout, ...]:
    """The layout as a hashable tuple of Python ints and bools."""
    return tuple((int(o), int(w), int(f), bool(a)) for o, w, f, a in layout)


def _groups(layout: Tuple[EntryLayout, ...]):
    """Static (field, source column, entry) index lists of the max group
    and the add group. Source columns index ``cat([vals, flags], -1)``."""
    n_vals = sum(w for _, w, _, _ in layout)
    mx, ad = ([], [], []), ([], [], [])
    voff = 0
    for e, (off, w, flag_off, additive) in enumerate(layout):
        grp = ad if additive else mx
        for c in range(w):
            grp[0].append(off + c)
            grp[1].append(voff + c)
            grp[2].append(e)
        mx[0].append(flag_off)
        mx[1].append(n_vals + e)
        mx[2].append(e)
        voff += w
    return mx, ad


# unbounded: a captured tick graph reads these index tensors where they
# lie (core/channel.py)
@functools.lru_cache(maxsize=None)
def _plan(layout: Tuple[EntryLayout, ...], shape: Tuple[int, ...],
          device: torch.device):
    """Per (layout, ring shape, device): for the max and the add group, the
    flat index of every (b, slot 0, i, j, field) target [B, n, n, F], the
    entry of each field and its source column. Built once, so that a tick
    copies nothing from the host."""
    B, D, n, _, K = shape
    plans = []
    for fields, cols, entries in _groups(layout):
        if not fields:
            plans.append(None)
            continue
        f = torch.tensor(fields, dtype=torch.int64, device=device)
        b = torch.arange(B, device=device).view(B, 1, 1, 1)
        ij = torch.arange(n * n, device=device).view(1, n, n, 1)
        base = (b * (D * n * n) + ij) * K + f
        plans.append((base,
                      torch.tensor(entries, dtype=torch.int64, device=device),
                      torch.tensor(cols, dtype=torch.int64, device=device)))
    return plans


def ring_commit_ref(buf: torch.Tensor, t: torch.Tensor, fill: torch.Tensor,
                    slots: torch.Tensor, vals: torch.Tensor,
                    flags: torch.Tensor,
                    layout: Sequence[EntryLayout]) -> torch.Tensor:
    """Commit one tick into ``buf`` in place and return it.
    buf: [B, D, n, n, K] float32 contiguous; fill: [K]; t: the tick, a
    0-dim int32 tensor (a Python int is converted)."""
    B, D, n, _, K = buf.shape
    mx, ad = _plan(as_layout(layout), tuple(buf.shape), buf.device)
    t = _device.tick_index(t, buf.device)
    buf.index_copy_(1, (t % D).long().view(1),                   # slot-clear
                    fill.view(1, 1, 1, 1, K).expand(B, 1, n, n, K))
    src = torch.cat([vals, flags], dim=-1)
    flat = buf.view(-1)
    stride = n * n * K                                   # one slot of a lane
    base, ent, col = mx
    idx = base + slots.index_select(3, ent).long() * stride
    flat.scatter_reduce_(0, idx.reshape(-1),
                         src.index_select(3, col).reshape(-1), "amax",
                         include_self=True)
    if ad is not None:
        base, ent, col = ad
        idx = base + slots.index_select(3, ent).long() * stride
        flat.scatter_add_(0, idx.reshape(-1),
                          src.index_select(3, col).reshape(-1))
    return buf
