"""Fused commit of a protocol's packed channel ring: plain PyTorch version
(ref.py), CUDA kernel for Hopper (kernel.py + csrc/channel_ring.cu) and the
dispatch between them (ops.py)."""
