"""Declarative client traffic (the trivial §5.2 subset of
``repro.workloads``)."""
from repro_torch.workloads import compile
from repro_torch.workloads.compile import (
    TRIVIAL_MODE,
    WorkloadMode,
    as_workload,
    is_trivial,
    lower,
    mode_of,
)
from repro_torch.workloads.primitives import PoissonOpen, Workload

__all__ = [
    "PoissonOpen", "Workload", "WorkloadMode", "TRIVIAL_MODE",
    "as_workload", "compile", "is_trivial", "lower", "mode_of",
]
