"""scen_lower_ms (sweep engine, core/experiment.py): the host time of a
grid's scenario lowering, the span ``lower.scenarios`` inside
``sweep.lower`` (each scenario's window tables, the envs on the device,
the delay horizon, the envs stacked; ``core/spans.py``), the lower median
of the window's grids. Nothing where the port has no such span."""
import pb_spans


def read(obs):
    return pb_spans.span_median_ms(obs, "lower.scenarios")
