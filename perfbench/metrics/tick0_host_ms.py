"""tick0_host_ms (sweep engine, core/harness.py): the host time of a grid's
tick-loop set-up and eager tick 0, the span ``sweep.tick0``
(``core/spans.py``), the lower median of the window's grids. Not the mean:
a grid dispatched while the one before still has replays queued (the
window's second) waits in tick 0 for launch slots, tens to hundreds of
times longer. Nothing where the port has no such span."""
import pb_spans


def read(obs):
    return pb_spans.span_median_ms(obs, "sweep.tick0")
