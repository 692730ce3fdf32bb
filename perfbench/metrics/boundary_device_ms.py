"""boundary_device_ms (sweep engine, core/experiment.py): the device time
between two grids' replays with no profiler on: over the window's grid
boundaries, the CUDA events' time from grid k's last replay to grid k+1's
first (``core/spans.py``: ``device.boundary_ms``), grid k's results, the
host's work at the boundary (grid k's rows, grid k+1's lowering, tick 0
and load) and any wait on it included, per boundary
(``device.boundaries``). Nothing where the port records no such events."""
import pb_spans


def read(obs):
    return pb_spans.boundary_ms(obs)
