"""The tick-level WAN simulator of the port: netsim, channels, workload,
Mandator, Sporades, the harness and the sweep engine."""
