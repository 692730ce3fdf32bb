"""Declarative client traffic (a copy of ``repro.workloads``).

A ``Workload`` is a named list of composable traffic-shape primitives
(open-loop Poisson, on/off bursts, diurnal ramps, flash crowds,
WPaxos-style migrating region skew, Atlas-style closed-loop geo-placed
client pools). ``compile.lower`` turns one into fixed-shape windowed
per-origin rate tables that stack along the grid's lane axis
(``experiment.SweepSpec.workloads``), as the scenarios' env tables do.

The bare ``PoissonOpen()`` workload compiles to the all-ones table: the
§5.2 baseline, whose lanes read the trivial draw table.
"""
from repro_torch.workloads import compile
from repro_torch.workloads.compile import (
    TRIVIAL_MODE,
    WorkloadMode,
    as_workload,
    is_trivial,
    lower,
    mode_of,
)
from repro_torch.workloads.primitives import (
    ClosedLoop,
    DiurnalRamp,
    FlashCrowd,
    OnOffBurst,
    PoissonOpen,
    RegionSkew,
    Workload,
)

__all__ = [
    "ClosedLoop", "DiurnalRamp", "FlashCrowd", "OnOffBurst", "PoissonOpen",
    "RegionSkew", "Workload", "WorkloadMode", "TRIVIAL_MODE",
    "as_workload", "compile", "is_trivial", "lower", "mode_of",
]
