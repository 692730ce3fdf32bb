"""grid_gap_ms (sweep engine, core/experiment.py): the device's idle time
at a grid boundary in the window's own schedule, grid k+1 dispatched before
grid k is collected: from the moment all of grid k is enqueued to grid
k+1's first graph replay, what of its lowering, eager tick 0 and program
load the queue of grid k's work did not hide. Read from the traced
boundary's device timeline (``pb_trace.gap_us``)."""
import pb_trace


def read(obs):
    tl = obs.get("timeline")
    gap = None if tl is None else pb_trace.gap_us(tl)
    return None if gap is None else gap / 1e3
