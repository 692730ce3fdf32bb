"""device_idle (device, H100): the share, in percent, of the traced span
(grid k's last replays, the boundary, grid k+1's first replays; see
``pb_trace``) in which no kernel or copy runs on the device, from the
profiler's timeline (``pb_trace.idle_share``). It counts the launch gaps
between a graph's kernels, which the profiler widens."""
import pb_trace


def read(obs):
    tl = obs.get("timeline")
    share = None if tl is None else pb_trace.idle_share(tl)
    return None if share is None else 100.0 * share
