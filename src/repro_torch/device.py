"""Device selection for the port's entry points, and the tick index.

Every entry point takes ``device=None``, which means CUDA. Without a CUDA
device that raises: the port never falls back to the CPU on its own. The
caller asks for the CPU explicitly (``device="cpu"``), as the tests do.
"""
from __future__ import annotations

import contextlib

import torch


def to_device(x, device, dtype=None) -> torch.Tensor:
    """Host data (numpy, a list, a CPU tensor) as a tensor on ``device``,
    cast to ``dtype`` on the host. A copy to the card goes through pinned
    memory with ``non_blocking=True``, so the host does not wait for the
    card's queue to drain first; a tensor already on ``device`` passes
    through (cast if asked)."""
    if not isinstance(x, torch.Tensor):
        x = torch.tensor(x)
    if dtype is not None:
        x = x.to(dtype)
    dev = torch.device(device)
    if x.device == dev or dev.type != "cuda":
        return x.to(dev)
    if x.device.type != "cpu":
        return x.to(dev, non_blocking=True)
    return x.contiguous().pin_memory().to(dev, non_blocking=True)


def on(device) -> contextlib.AbstractContextManager:
    """Make ``device`` current for the block when it is a card (kernels,
    streams and graph captures follow the current card); a no-op for the
    CPU."""
    dev = torch.device(device)
    return torch.cuda.device(dev) if dev.type == "cuda" \
        else contextlib.nullcontext()


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
    if dev.type == "cuda" and dev.index is not None \
            and dev.index >= torch.cuda.device_count():
        raise RuntimeError(f"device {device!r} requested but torch sees "
                           f"{torch.cuda.device_count()} CUDA device(s)")
    return dev


def tick_index(t: int | torch.Tensor, device) -> torch.Tensor:
    """The tick index as the tick loop carries it: a 0-dim int32 tensor on
    the run's device, which no op of a tick reads back. A tensor passes
    through unchanged; a Python int (a caller stepping ticks by hand) is
    checked and converted once."""
    if isinstance(t, torch.Tensor):
        return t
    if int(t) < 0:
        raise ValueError(f"tick must be >= 0, got {t}")
    return torch.tensor(int(t), dtype=torch.int32, device=device)
