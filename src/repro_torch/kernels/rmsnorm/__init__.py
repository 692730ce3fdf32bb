"""Fused (residual +) RMSNorm: plain PyTorch version (ref.py), CUDA kernel
for Hopper (kernel.py + csrc/rmsnorm.cu) and the dispatch between them
(ops.py)."""
