"""Production and debug meshes (port of ``repro.launch.mesh``): a
``torch.distributed`` ``DeviceMesh`` with the reference's shapes and axis
names. Functions, not module constants, so that importing this module
starts no process group.

A mesh of N devices needs a process group of N ranks, one a device,
started by the caller (``torch.distributed.init_process_group`` with its
own address, world size and rank). Where none is started and the mesh has
one device, the mesh starts its own one-rank group on an in-process store
(no network): NCCL on the card, gloo on the CPU. The dry run
(``launch/dryrun.py``) starts its placeholder ranks itself, on the
``fake`` backend.

The meshes run on the card unless the caller asks for the CPU
(``device_type="cpu"``); without a card the default raises.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch import device as _device


def _mesh(shape: Tuple[int, ...], axes: Tuple[str, ...],
          device_type: Optional[str]) -> DeviceMesh:
    dev = _device.resolve("cuda" if device_type is None else device_type)
    if not dist.is_initialized():
        if math.prod(shape) != 1:
            raise RuntimeError(
                f"a {shape} mesh needs a process group of "
                f"{math.prod(shape)} ranks: start one first "
                "(torch.distributed.init_process_group)")
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0,
                                world_size=1)
    return init_device_mesh(dev.type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: Optional[str] = None) -> DeviceMesh:
    """16x16 ("data", "model") = 256 devices; multi-pod adds a pure-DP
    "pod" axis (2x16x16 = 512). Needs that many ranks (the dry run's fake
    ones, say)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device_type)


def make_debug_mesh(n_data: int = 2, n_model: int = 2,
                    device_type: Optional[str] = None) -> DeviceMesh:
    """A small ("data", "model") mesh for tests (needs n_data * n_model
    ranks; 1x1 starts its own one-rank group)."""
    return _mesh((n_data, n_model), ("data", "model"), device_type)
