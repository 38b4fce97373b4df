"""kimi-k2-1t-a32b — trillion-param MoE, 384 experts top-8
[arXiv:2501.kimi2 (paper-table); unverified tier].

Assignment row: 61L d_model=7168 64H (GQA kv=8) d_ff=2048 vocab=163840,
MoE 384e top-8.  Blanks filled from the public K2 config: 1 shared expert,
1 dense prefix layer (ffn 18432), rope theta 5e4.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b", family="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8,
    d_ff=18432, vocab_size=163840, rope_theta=5e4,
    n_experts=384, n_shared_experts=1, top_k=8, moe_d_ff=2048,
    n_dense_layers=1,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(n_layers=3, d_model=64, n_heads=4, n_kv_heads=2,
                          d_head=16, d_ff=96, vocab_size=512, n_experts=8,
                          top_k=2, moe_d_ff=32, n_dense_layers=1)
