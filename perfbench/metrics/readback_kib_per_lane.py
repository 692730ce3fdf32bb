"""readback_kib_per_lane (sweep engine, core/experiment.py): the bytes
``collect()`` copies to the host per lane collected, in KiB: over the
window's grids, the counter ``collect.readback_bytes`` over
``collect.lanes`` (``core/spans.py``), over 1024. Nothing where the port
has no such counters."""
import pb_spans


def read(obs):
    return pb_spans.ratio(obs, "collect.readback_bytes", "collect.lanes",
                          1 / 1024)
