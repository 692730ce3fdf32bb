"""The card's peak memory bandwidth, and a share of it."""
from __future__ import annotations

# H100 SXM device memory bandwidth (data sheet), at a 700 W power limit
HBM_BYTES_PER_S = 3.35e12


def roofline_pct(nbytes: float, seconds: float) -> float:
    """Share of the bytes' least time at the HBM peak in ``seconds``,
    percent."""
    return 100.0 * nbytes / HBM_BYTES_PER_S / seconds
