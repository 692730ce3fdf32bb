"""Configurations of the port (copies of the reference's jax-free configs):
the simulator's ``SMRConfig`` and the model stack's arch registry
(``get_config(name)`` / ``list_archs()`` / ``iter_cells()``)."""
from __future__ import annotations

import importlib
from typing import Dict, Iterator, Tuple

from repro_torch.configs.base import (  # noqa: F401
    SHAPES, CrossAttnConfig, ModelConfig, MoEConfig, ShapeConfig, SSMConfig,
    param_count, shape_supported,
)
from repro_torch.configs.smr import REGIONS, SMRConfig, one_way_delay_ms

_ARCH_MODULES: Dict[str, str] = {
    "dbrx-132b": "dbrx_132b",
    "arctic-480b": "arctic_480b",
    "xlstm-1.3b": "xlstm_1_3b",
    "llama-3.2-vision-11b": "llama_3_2_vision_11b",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
    "smollm-135m": "smollm_135m",
    "qwen3-32b": "qwen3_32b",
    "qwen1.5-110b": "qwen1_5_110b",
    "qwen3-14b": "qwen3_14b",
    "musicgen-medium": "musicgen_medium",
}


def list_archs() -> Tuple[str, ...]:
    return tuple(_ARCH_MODULES)


def get_config(name: str) -> ModelConfig:
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_ARCH_MODULES)}")
    mod = importlib.import_module(
        f"repro_torch.configs.{_ARCH_MODULES[name]}")
    return mod.CONFIG


def iter_cells() -> Iterator[Tuple[ModelConfig, ShapeConfig, bool]]:
    """All 40 (arch x shape) cells; third element = supported (False =>
    skip)."""
    for arch in list_archs():
        cfg = get_config(arch)
        for shape in SHAPES.values():
            yield cfg, shape, shape_supported(cfg, shape)


__all__ = ["REGIONS", "SMRConfig", "one_way_delay_ms", "SHAPES",
           "CrossAttnConfig", "ModelConfig", "MoEConfig", "ShapeConfig",
           "SSMConfig", "param_count", "shape_supported", "get_config",
           "list_archs", "iter_cells"]
