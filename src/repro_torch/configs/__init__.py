"""Configurations of the port (copies of the reference's jax-free configs)."""
from repro_torch.configs.smr import REGIONS, SMRConfig, one_way_delay_ms

__all__ = ["REGIONS", "SMRConfig", "one_way_delay_ms"]
