"""Mamba selective scan: plain PyTorch version (ref.py), CUDA kernel for
Hopper (kernel.py + csrc/ssm_scan.cu) and the dispatch between them
(ops.py)."""
