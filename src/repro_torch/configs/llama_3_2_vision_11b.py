"""llama-3.2-vision-11b — cross-attn image layers every 5th.  [hf:meta-llama/Llama-3.2-11B-Vision; unverified]

Modality frontend is a STUB: input_specs() supplies precomputed ViT patch
embeddings (1601 tokens x d_model) as the cross-attention memory.
"""
from repro_torch.configs.base import CrossAttnConfig, ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b", family="vlm",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab=128256,
    cross_attn=CrossAttnConfig(every=5, n_mem_tokens=1601),
    notes="text backbone + cross-attn to stubbed vision memory",
)
