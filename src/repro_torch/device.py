"""Device selection for the port's entry points.

Every entry point takes ``device=None``, which means CUDA. Without a CUDA
device that raises: the port never falls back to the CPU on its own. The
caller asks for the CPU explicitly (``device="cpu"``), as the tests do.
"""
from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on CUDA by default and torch sees no CUDA "
                "device; pass device='cpu' to run the plain PyTorch path on "
                "the CPU")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but torch sees no "
                           "CUDA device")
    return dev
