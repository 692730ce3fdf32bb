"""The latency sketch's rank-bucket sums: plain PyTorch version (ref.py),
CUDA kernel for Hopper (kernel.py + csrc/sketch_buckets.cu) and the
dispatch between them (ops.py)."""
