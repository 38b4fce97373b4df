"""rwkv6-1.6b — Finch, attention-free, data-dependent decay
[arXiv:2404.05892; unverified tier].

Assignment row: 24L d_model=2048 (attn-free) d_ff=7168 vocab=65536.
head_size 64 -> 32 wkv heads.  Attention tile spec points are inapplicable;
the wkv chunk length is the analogous spec point.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b", family="ssm",
    n_layers=24, d_model=2048, n_heads=0, n_kv_heads=0,
    d_ff=7168, vocab_size=65536,
    mixer="rwkv6", rwkv_head_size=64,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(n_layers=2, d_model=64, d_ff=128, vocab_size=512,
                          rwkv_head_size=16)
