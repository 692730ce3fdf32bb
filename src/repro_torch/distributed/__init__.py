"""The port's distributed layer: the reduced sweep engine's helpers
(``sketch``, ``mesh``: the 64-bin latency sketch and the device grid a
sweep's lanes split over), the model stack's sharding rules as DTensor
placements (``sharding``), its train / prefill / decode steps (``steps``)
and what a step or a captured tick costs (``graph_analysis``)."""
