"""tick_device_ms (tick graph): the device's busy time per tick over the
traced graph replays of grid k+1, from the profiler's timeline
(``pb_trace.tick_us``). The profiler adds about a microsecond to each
graph kernel it times, so this reads above the untraced tick."""
import pb_trace


def read(obs):
    tl = obs.get("timeline")
    us = None if tl is None else pb_trace.tick_us(tl, obs["replays"])
    return None if us is None else us / 1e3
