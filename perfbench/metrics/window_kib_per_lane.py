"""window_kib_per_lane (sweep engine, core/experiment.py): the bytes of
the batched env's window tables (``win_of_tick``, ``alive_tab``,
``drop_tab``, ``delay_tab``, ``nic_tab``) a grid puts on the device per
lane, in KiB: over the window's grids, the counter ``lower.window_bytes``
over ``lower.lanes`` (``core/spans.py``), over 1024. Nothing where the
port has no such counters."""
import pb_spans


def read(obs):
    return pb_spans.ratio(obs, "lower.window_bytes", "lower.lanes",
                          1 / 1024)
