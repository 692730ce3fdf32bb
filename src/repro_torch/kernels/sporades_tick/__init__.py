"""The Sporades ordering tick as one CUDA kernel for Hopper (kernel.py +
csrc/sporades_tick.cu). Its plain version is the op chain of
``core/sporades.py``, which picks the route."""
