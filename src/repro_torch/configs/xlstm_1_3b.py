"""xlstm-1.3b — sLSTM + mLSTM blocks (7:1), no FFN.  [arXiv:2405.04517; unverified]"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4, head_dim=512,
    d_ff=0, vocab=50304,
    ssm=SSMConfig(kind="xlstm", slstm_every=8, chunk=128),
    notes="mLSTM matrix-memory linear attention; sLSTM every 8th layer; d_ff=0",
)
