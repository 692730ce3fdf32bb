"""replay_tick_ms (tick graph): the device time of one replayed tick with
no profiler on. Over the window's grids, the CUDA events' time from each
grid's first graph replay to its last (``core/spans.py``: the counter
``device.replay_ms``), over the replays between them (``device.replays``).
Nothing where the port records no such events."""
import pb_spans


def read(obs):
    return pb_spans.ratio(obs, "device.replay_ms", "device.replays")
