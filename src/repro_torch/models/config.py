"""Model configuration covering the full assigned architecture pool."""
from __future__ import annotations

import dataclasses
from typing import Any

__all__ = ["ModelConfig"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense|moe|vlm|audio|ssm|hybrid
    n_layers: int
    d_model: int
    n_heads: int                    # 0 for attention-free archs
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0                 # 0 -> d_model // n_heads

    # attention
    attn_kind: str = "gqa"          # gqa | mla
    qk_norm: bool = False
    window: int | None = None       # sliding-window attention (hybrid long ctx)
    rope_theta: float = 1e4

    # MLA (deepseek-v2)
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    rope_head_dim: int = 0
    nope_head_dim: int = 0

    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    n_dense_layers: int = 0         # dense prefix before MoE layers

    # token mixer
    mixer: str = "attn"             # attn | rwkv6 | hymba
    rwkv_head_size: int = 64
    ssm_state: int = 0
    ssm_heads: int = 0              # 0 -> n_heads

    # io / misc
    frontend: str | None = None     # None | vision | audio (stub embeddings)
    tie_embeddings: bool = False
    rms_eps: float = 1e-6
    param_dtype: str = "float32"    # master params
    compute_dtype: str = "bfloat16"

    def __post_init__(self):
        if self.n_heads and not self.d_head:
            object.__setattr__(self, "d_head", self.d_model // self.n_heads)
        if self.mixer == "rwkv6":
            assert self.d_model % self.rwkv_head_size == 0
        if self.ssm_state and self.mixer == "attn":
            object.__setattr__(self, "mixer", "hymba")
        if self.ssm_state and not self.ssm_heads:
            object.__setattr__(self, "ssm_heads", self.n_heads)

    # -- derived ----------------------------------------------------------------
    @property
    def padded_vocab_size(self) -> int:
        """Vocab padded to a TP-shardable multiple (Megatron-style, 256)."""
        return -(-self.vocab_size // 256) * 256

    @property
    def n_moe_layers(self) -> int:
        return (self.n_layers - self.n_dense_layers) if self.n_experts else 0

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def rwkv_heads(self) -> int:
        return self.d_model // self.rwkv_head_size

    def param_count(self) -> int:
        """Total parameters (analytic; used for 6ND roofline MODEL_FLOPS)."""
        return _count_params(self, active_only=False)

    def active_param_count(self) -> int:
        """Parameters active per token (MoE: top_k + shared experts only)."""
        return _count_params(self, active_only=True)

    def replace(self, **kw: Any) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


def _ffn_params(d_model: int, d_ff: int) -> int:
    return 3 * d_model * d_ff        # swiglu: gate, up, down


def _attn_params(cfg: ModelConfig) -> int:
    if cfg.mixer == "rwkv6":
        d, h = cfg.d_model, cfg.rwkv_head_size
        # r,k,v,g,o projections + decay lora (d->64->d) + per-channel params
        return 5 * d * d + d * 64 + 64 * d + 8 * d
    d, dh = cfg.d_model, cfg.d_head
    if cfg.attn_kind == "mla":
        qdim = cfg.nope_head_dim + cfg.rope_head_dim
        p = 0
        if cfg.q_lora_rank:
            p += d * cfg.q_lora_rank + cfg.q_lora_rank * cfg.n_heads * qdim
        else:
            p += d * cfg.n_heads * qdim
        p += d * (cfg.kv_lora_rank + cfg.rope_head_dim)
        p += cfg.kv_lora_rank * cfg.n_heads * (cfg.nope_head_dim + cfg.d_head)
        p += cfg.n_heads * cfg.d_head * d
        return p
    attn = d * cfg.n_heads * dh + 2 * d * cfg.n_kv_heads * dh \
        + cfg.n_heads * dh * d
    if cfg.mixer == "hymba":
        n, hh = cfg.ssm_state, cfg.ssm_heads
        di = hh * dh
        ssm = (d * di + 4 * di + 2 * d * n + d * hh + 3 * hh + di * d)
        return attn + ssm + 2 * d  # + the two combine norms
    return attn


def _count_params(cfg: ModelConfig, active_only: bool) -> int:
    d = cfg.d_model
    total = cfg.vocab_size * d                     # embed
    if not cfg.tie_embeddings:
        total += cfg.vocab_size * d                # lm head
    per_layer_attn = _attn_params(cfg) + 2 * d     # + 2 norms
    dense_layers = cfg.n_layers - cfg.n_moe_layers
    total += cfg.n_layers * per_layer_attn
    total += dense_layers * _ffn_params(d, cfg.d_ff)
    if cfg.is_moe:
        router = d * cfg.n_experts
        experts = cfg.n_experts * _ffn_params(d, cfg.moe_d_ff)
        shared = cfg.n_shared_experts * _ffn_params(d, cfg.moe_d_ff)
        if active_only:
            experts = cfg.top_k * _ffn_params(d, cfg.moe_d_ff)
        total += cfg.n_moe_layers * (router + experts + shared)
    return total
