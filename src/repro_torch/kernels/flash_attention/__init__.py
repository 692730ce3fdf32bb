"""Causal / non-causal GQA flash attention (forward): plain PyTorch version
(ref.py), CUDA kernel for Hopper (kernel.py + csrc/flash_attention.cu) and
the dispatch between them (ops.py)."""
