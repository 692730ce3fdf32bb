"""Plain PyTorch version of the sketch's rank-bucket sums: two float32
``index_add_`` over the flattened lanes. On the CPU ``index_add_`` adds one
entry after another in index order, as XLA's CPU backend runs the
reference's scatter-adds (``repro.distributed.sketch._bucketize``), so the
sums are the reference's bit for bit; this is the CPU path of
``ops.bucket_sums`` and the yardstick the CUDA kernel is held to. On a CUDA
device ``index_add_`` adds by atomics in no fixed order: the same sums up
to float32 rounding, not bit for bit."""
from __future__ import annotations

import torch


def bucket_sums_ref(b: torch.Tensor, w: torch.Tensor, wv: torch.Tensor,
                    bins: int):
    """b: [L, M] integer buckets in [0, bins); w, wv: [L, M] float32.
    Returns (wsum, vsum), each [L, bins] float32: the sums of w and wv over
    the entries of each bucket, from +0.0 in index order."""
    lanes = b.shape[0]
    flat = (b.long() + bins * torch.arange(lanes, device=b.device)[:, None]
            ).reshape(-1)
    out = []
    for x in (w, wv):
        acc = torch.zeros(lanes * bins, dtype=torch.float32, device=b.device)
        acc.index_add_(0, flat, x.reshape(-1))
        out.append(acc.reshape(lanes, bins))
    return out[0], out[1]
