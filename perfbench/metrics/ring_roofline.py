"""ring_roofline (kernel, csrc/channel_ring.cu): the least bytes one commit
of the grid's delay lines moves (``plainsim.ring_bytes`` at the grid's
lanes and the cell's shapes) at 3.35 TB/s, over the mean device time of the
``channel_ring`` commit kernel in the traced replays
(``pb_trace.ring_us``), in percent."""
import pb_roofline
import pb_trace


def read(obs):
    tl, nbytes = obs.get("timeline"), obs.get("ring_bytes")
    us = None if tl is None else pb_trace.ring_us(tl)
    if not us or not nbytes:
        return None
    return pb_roofline.roofline_pct(nbytes, us / 1e6)
