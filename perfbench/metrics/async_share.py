"""async_share (protocol ticks, core/sporades.py): the share of a
Sporades grid's replica-ticks spent in the asynchronous view, in %: over
the window's grids, the counter ``order.async_replica_ticks`` over
``order.replica_ticks`` (``core/spans.py``; the counts behind the rows'
``async_frac``), times 100. Nothing where the port has no such
counters."""
import pb_spans


def read(obs):
    return pb_spans.ratio(obs, "order.async_replica_ticks",
                          "order.replica_ticks", 100)
