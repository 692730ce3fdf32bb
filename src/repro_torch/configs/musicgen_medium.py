"""musicgen-medium — decoder-only over EnCodec tokens.  [arXiv:2306.05284; hf]

Audio frontend is a STUB: input_specs() supplies precomputed EnCodec frame
embeddings (batch, seq, d_model) in place of the 4-codebook delay-pattern
embedding sum; the head predicts over the 2048-entry codebook vocab.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium", family="audio",
    n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24, head_dim=64,
    d_ff=6144, vocab=2048, embed_inputs=False,
    notes="MHA (kv=24); frame-embedding inputs (stub frontend)",
)
