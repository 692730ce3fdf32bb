"""Flash-decoding (one query token over a KV cache): plain PyTorch version
(ref.py), CUDA kernel for Hopper (kernel.py + csrc/decode_attention.cu)
and the dispatch between them (ops.py)."""
