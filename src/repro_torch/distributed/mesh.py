"""The device grid of the reduced sweep path (port of
``repro.distributed.mesh``).

``core/experiment.run_sweep(..., mesh=...)`` splits the flattened
workload x scenario x rate x seed grid's lanes over a 1-D grid of devices
in contiguous blocks; each device runs its block through
``harness.sim_point(..., reduced=True)``. In the port a grid mesh is a
list of ``torch.device``. ``None`` means every CUDA device, an int the
first N; without a card that raises: the port never falls back to the CPU
on its own, and a caller who wants the CPU names it
(``[torch.device("cpu")] * k``, as the tests do).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import torch

GRID_AXIS = "grid"

Mesh = List[torch.device]


def _cuda_devices() -> Mesh:
    if not torch.cuda.is_available():
        raise RuntimeError("grid_mesh: torch sees no CUDA device; pass the "
                           "devices explicitly (e.g. [torch.device('cpu')])"
                           " to run the grid elsewhere")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def grid_mesh(devices: Union[None, int, Sequence] = None) -> Mesh:
    """The 1-D grid mesh: ``devices`` may be None (every CUDA device), an
    int (the first N CUDA devices; ValueError past the count) or an
    explicit sequence of devices (``torch.device`` or names)."""
    if devices is None:
        return _cuda_devices()
    if isinstance(devices, int):
        avail = (torch.cuda.device_count() if torch.cuda.is_available()
                 else 0)
        if devices < 1 or devices > avail:
            raise ValueError(f"grid_mesh: asked for {devices} devices, have "
                             f"{avail}")
        return _cuda_devices()[:devices]
    devs = [torch.device(d) for d in devices]
    if not devs:
        raise ValueError("grid_mesh: an empty device sequence")
    return devs


def as_grid_mesh(mesh) -> Optional[Mesh]:
    """Normalize a ``mesh=`` argument: None stays None (the unreduced
    path), an int becomes an N-device grid mesh, a sequence of devices a
    list of ``torch.device``."""
    if mesh is None:
        return None
    return grid_mesh(mesh if isinstance(mesh, int) else list(mesh))


def device_counts(max_devices: Optional[int] = None) -> Tuple[int, ...]:
    """Power-of-two device counts available for a scaling curve:
    (1, 2, 4, ..., D) up to the CUDA device count (or ``max_devices``),
    with D itself last. Raises without a card."""
    limit = len(_cuda_devices())
    if max_devices is not None:
        limit = min(limit, max_devices)
    counts = []
    d = 1
    while d <= limit:
        counts.append(d)
        d *= 2
    if counts[-1] != limit:
        counts.append(limit)
    return tuple(counts)
