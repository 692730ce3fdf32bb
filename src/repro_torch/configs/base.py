"""Model configs, input-shape configs and parameter counting (a copy of the
reference's jax-free ``repro.configs.base``).

Every assigned architecture has one ``configs/<id>.py`` exporting ``CONFIG``.
``reduced()`` derives a CPU-smoke-testable config of the same family.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    every: int = 1            # MoE MLP on layers where (layer_idx % every == every-1)
    dense_residual: bool = False   # arctic: dense FFN in parallel with MoE
    dense_d_ff: int = 0            # width of the parallel dense FFN
    capacity_factor: float = 1.25
    router_z_loss: float = 1e-3
    aux_loss: float = 1e-2


@dataclass(frozen=True)
class SSMConfig:
    kind: str = "mamba"       # "mamba" | "xlstm"
    d_state: int = 16         # mamba SSM state per channel
    d_conv: int = 4
    expand: int = 2
    # xlstm-only: sLSTM block every `slstm_every` layers (others are mLSTM)
    slstm_every: int = 8
    chunk: int = 128          # chunked-scan block length


@dataclass(frozen=True)
class CrossAttnConfig:
    every: int = 5            # cross-attn layer every k layers (vlm)
    n_mem_tokens: int = 1601  # precomputed vision-patch embeddings (stub frontend)


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str               # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 128
    qk_norm: bool = False
    qkv_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    cross_attn: Optional[CrossAttnConfig] = None
    # hybrid: one attention layer per `attn_every` layers, the rest SSM.
    # attn_every == 1 -> all attention; attn_every == 0 -> no attention (pure ssm)
    attn_every: int = 1
    # audio stub: inputs are precomputed frame embeddings, not token ids
    embed_inputs: bool = True
    notes: str = ""

    # ---- derived ----------------------------------------------------------
    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer mixer kind: attn | mamba | mlstm | slstm."""
        kinds = []
        for i in range(self.n_layers):
            if self.family == "ssm" and self.ssm is not None:
                if self.ssm.kind == "xlstm":
                    k = "slstm" if (i % self.ssm.slstm_every == self.ssm.slstm_every - 1) else "mlstm"
                else:
                    k = "mamba"
            elif self.family == "hybrid":
                # jamba-style 1:(attn_every-1) interleave; attention sits mid-period
                k = "attn" if (i % self.attn_every == self.attn_every // 2) else "mamba"
            else:
                k = "attn"
            kinds.append(k)
        return tuple(kinds)

    def layer_has_moe(self, i: int) -> bool:
        return self.moe is not None and (i % self.moe.every == self.moe.every - 1)

    def layer_has_cross_attn(self, i: int) -> bool:
        return (self.cross_attn is not None
                and i % self.cross_attn.every == self.cross_attn.every - 1)

    @property
    def block_period(self) -> int:
        """Smallest repeating super-block period (for scan-over-layers)."""
        p = 1
        if self.family == "ssm" and self.ssm is not None and self.ssm.kind == "xlstm":
            p = self.ssm.slstm_every
        if self.family == "hybrid":
            p = self.attn_every
        if self.moe is not None:
            p = _lcm(p, self.moe.every)
        if self.cross_attn is not None:
            p = _lcm(p, self.cross_attn.every)
        assert self.n_layers % p == 0, (self.name, self.n_layers, p)
        return p

    @property
    def sub_quadratic(self) -> bool:
        """Can serve 500k-token contexts (O(1)/O(s) state, not O(s) KV on every layer)."""
        return self.family in ("ssm", "hybrid")

    # ---- reduced smoke config --------------------------------------------
    def reduced(self) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests (one fwd/train step)."""
        period = self.block_period
        n_layers = max(period, 2) if self.n_layers % 2 == 0 else period
        # keep the super-block structure intact; shrink everything else
        moe = None
        if self.moe is not None:
            moe = dataclasses.replace(
                self.moe, n_experts=min(self.moe.n_experts, 4),
                top_k=min(self.moe.top_k, 2), d_ff_expert=64,
                dense_d_ff=32 if self.moe.dense_residual else 0)
        ssm = None
        if self.ssm is not None:
            ssm = dataclasses.replace(self.ssm, d_state=8, chunk=16)
        cross = None
        if self.cross_attn is not None:
            cross = dataclasses.replace(self.cross_attn, n_mem_tokens=7)
        n_kv = min(self.n_kv_heads, 2)
        n_h = max(2 * n_kv, 2)
        return dataclasses.replace(
            self, name=self.name + "-reduced", n_layers=n_layers,
            d_model=64, n_heads=n_h, n_kv_heads=n_kv, head_dim=16,
            d_ff=96 if self.d_ff else 0, vocab=256,
            moe=moe, ssm=ssm, cross_attn=cross)


def _lcm(a: int, b: int) -> int:
    import math
    return a * b // math.gcd(a, b)


# ---- input shapes ----------------------------------------------------------

@dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str                 # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k":    ShapeConfig("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    "decode_32k":  ShapeConfig("decode_32k", "decode", 32_768, 128),
    "long_500k":   ShapeConfig("long_500k", "decode", 524_288, 1),
}


def shape_supported(cfg: ModelConfig, shape: ShapeConfig) -> bool:
    """long_500k needs sub-quadratic attention (skip for pure full-attention)."""
    if shape.name == "long_500k":
        return cfg.sub_quadratic
    return True


# ---- parameter counting (for MODEL_FLOPS = 6·N·D roofline term) ------------

def param_count(cfg: ModelConfig, active_only: bool = False) -> int:
    """Exact parameter count from the config (embeddings + blocks + head)."""
    n = 0
    if cfg.embed_inputs:
        n += cfg.vocab * cfg.d_model
    if not cfg.tie_embeddings:
        n += cfg.vocab * cfg.d_model          # lm head
    kinds = cfg.layer_kinds()
    for i, kind in enumerate(kinds):
        n += cfg.d_model                      # norm1
        if kind == "attn":
            n += cfg.d_model * (cfg.q_dim + 2 * cfg.kv_dim)   # qkv
            if cfg.qkv_bias:
                n += cfg.q_dim + 2 * cfg.kv_dim
            if cfg.qk_norm:
                n += 2 * cfg.head_dim
            n += cfg.q_dim * cfg.d_model      # out proj
        elif kind == "mamba":
            s = cfg.ssm
            d_in = s.expand * cfg.d_model
            n += cfg.d_model * 2 * d_in           # in proj (x, z)
            n += d_in * s.d_conv + d_in           # conv w + b
            n += d_in * 2 * s.d_state             # w_bc
            n += d_in + d_in                      # w_dt [Di,1] + dt_bias
            n += d_in * s.d_state + d_in          # A_log, D
            n += d_in * cfg.d_model               # out proj
        elif kind == "mlstm":
            d_in = 2 * cfg.d_model
            n += cfg.d_model * 3 * d_in           # q,k,v (wide)
            n += 2 * (cfg.d_model * cfg.n_heads + cfg.n_heads)  # i,f gates
            n += cfg.d_model * d_in + d_in        # output gate
            n += d_in * cfg.d_model               # out proj
        elif kind == "slstm":
            d_in = 2 * cfg.d_model
            dh = d_in // cfg.n_heads
            n += 4 * (cfg.d_model * d_in + d_in)  # i,f,z,o projections
            n += 4 * cfg.n_heads * dh * dh        # recurrent head mixing
            n += d_in * cfg.d_model               # out proj
        if cfg.layer_has_cross_attn(i):
            n += cfg.d_model * (cfg.q_dim + 2 * cfg.kv_dim) + cfg.q_dim * cfg.d_model
            n += cfg.d_model                  # cross norm
        # mlp
        if cfg.layer_has_moe(i):
            m = cfg.moe
            n += cfg.d_model                  # norm2
            per_exp = 3 * cfg.d_model * m.d_ff_expert   # swiglu: gate, up, down
            n += m.n_experts * per_exp if not active_only else m.top_k * per_exp
            n += cfg.d_model * m.n_experts               # router
            if m.dense_residual:
                n += 3 * cfg.d_model * m.dense_d_ff
        elif cfg.d_ff:
            n += cfg.d_model                  # norm2
            n += 3 * cfg.d_model * cfg.d_ff
    n += cfg.d_model                          # final norm
    return n
