"""The training control plane (port of ``repro.runtime``): Mandator's
vector-clock artifact rounds, Sporades' dual-mode step commit and the
elastic replans, as host state machines in numpy. They touch no device."""
