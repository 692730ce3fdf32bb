"""jamba-1.5-large-398b — Mamba+attn 1:7 interleave, MoE 16e top-2.  [arXiv:2403.19887; hf]"""
from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=24576, vocab=65536,
    attn_every=8,   # 1 attention layer per 8 (9 of 72), rest Mamba
    moe=MoEConfig(n_experts=16, top_k=2, d_ff_expert=24576, every=2),
    ssm=SSMConfig(kind="mamba", d_state=16, d_conv=4, expand=2, chunk=128),
    notes="hybrid SSM/attention with MoE every other layer",
)
