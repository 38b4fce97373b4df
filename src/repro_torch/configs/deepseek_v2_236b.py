"""deepseek-v2-236b — MLA kv_lora=512, 2 shared + 160 routed top-6
[arXiv:2405.04434; hf].

Assignment row: 60L d_model=5120 128H (kv=128) d_ff=1536 vocab=102400,
MoE 160e top-6.  MLA dims from the paper: q_lora 1536, kv_lora 512,
nope 128 / rope 64 per head, v head dim 128; first layer dense (ffn 12288).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b", family="moe",
    n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128,
    d_head=128, d_ff=12288, vocab_size=102400, rope_theta=1e4,
    attn_kind="mla", q_lora_rank=1536, kv_lora_rank=512,
    rope_head_dim=64, nope_head_dim=128,
    n_experts=160, n_shared_experts=2, top_k=6, moe_d_ff=1536,
    n_dense_layers=1,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(n_layers=3, d_model=64, n_heads=4, n_kv_heads=4,
                          d_head=16, d_ff=96, vocab_size=512,
                          q_lora_rank=32, kv_lora_rank=24, rope_head_dim=8,
                          nope_head_dim=16, n_experts=8, top_k=2,
                          moe_d_ff=32, n_dense_layers=1)
