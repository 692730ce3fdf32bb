"""Dispatch wrapper for the sketch's rank-bucket sums.

Called from ``distributed/sketch._bucketize`` once per ``build`` or
``merge``: on the reduced sweep path (``core/harness.sim_point(...,
reduced=True)``) once per block of lanes a device runs. The CUDA kernel
runs for CUDA tensors, the plain version for CPU tensors; no fallback.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.sketch_buckets import kernel
from repro_torch.kernels.sketch_buckets.ref import bucket_sums_ref


def bucket_sums(b: torch.Tensor, w: torch.Tensor, wv: torch.Tensor,
                bins: int):
    """b: [L, M] buckets, each row non-decreasing in [0, bins); w, wv:
    [L, M] float32. Returns (wsum, vsum) [L, bins] float32, each bucket's
    sum from +0.0 in index order, one rounding per add."""
    if b.is_cuda:
        return kernel.bucket_sums_cuda(b, w, wv, bins)
    return bucket_sums_ref(b, w, wv, bins)
