"""The reduced sweep engine's helpers (port of ``repro.distributed``'s
``sketch`` and ``mesh``): the 64-bin latency sketch and the device grid a
sweep's lanes split over."""
