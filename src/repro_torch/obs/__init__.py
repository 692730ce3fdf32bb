"""Protocol flight recorder + health monitor (port of ``repro.obs``).

  - ``obs.trace``   — on-device event rings + counters, batched over the
    grid, carried inside the protocol state; gated by
    ``SMRConfig.trace_level`` so ``off`` (the default) runs the ops of an
    untraced build;
  - ``obs.monitor`` — on-device safety/liveness invariant checks +
    resource gauges, same carry, gated by ``SMRConfig.monitor_level``;
  - ``obs.decode``  — host-side ring -> per-replica event timelines;
  - ``obs.export``  — Chrome/Perfetto ``trace_event`` JSON (phase spans,
    event instants, throughput + gauge counter tracks) + the per-phase
    latency table.

The reference's ``obs.history`` (the benchmark ledger and its CI gate)
belongs with ``benchmarks/``, which the port does not carry yet.
"""
from repro_torch.obs import decode, export, monitor  # noqa: F401
from repro_torch.obs.monitor import (  # noqa: F401
    MONITOR_ENV, VIOLATIONS, HostMonitor, MonitorLevel,
)
from repro_torch.obs.trace import (  # noqa: F401
    DEFAULT_SPEC, FIELDS, PHASES, TRACE_ENV, HostTrace, TraceLevel,
    TraceSpec, init_trace, level_from_env, public_view, record, record_env,
)
