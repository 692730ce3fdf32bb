"""PyTorch/CUDA port of the Mandator-Sporades WAN simulator.

Mirrors the layout of the JAX package ``repro`` (configs/, scenarios/,
workloads/, core/, kernels/) and imports nothing of it. The entry points
(``core.experiment.run_sweep``, ``core.harness.sim_point``,
``core.netsim.build_env``, ``core.mandator.init_state``,
``core.sporades.init_state``) run on CUDA unless the caller passes
``device="cpu"``.
"""
