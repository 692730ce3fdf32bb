"""Backend choice shared by every kernel's ops module.

  ``"auto"`` — the CUDA kernel for tensors on a CUDA device, the plain
               PyTorch version (``ref.py``) for tensors on the CPU;
  ``"ref"``  — the plain version on any device;
  ``"cuda"`` — the kernel; raises for tensors on the CPU.

The choice follows the device only. A build or launch error raises; there
is no fallback from a kernel to its plain version.
"""
from __future__ import annotations

import torch

BACKENDS = ("auto", "ref", "cuda")


def resolve_backend(backend: str, device: torch.device, what: str) -> str:
    """"ref" or "cuda" for ``what``'s tensors on ``device``."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown {what} backend {backend!r}; "
                         f"one of {BACKENDS}")
    if backend == "auto":
        return "cuda" if device.type == "cuda" else "ref"
    if backend == "cuda" and device.type != "cuda":
        raise ValueError(f"{what} backend 'cuda' needs tensors on a CUDA "
                         f"device, got {device}")
    return backend
