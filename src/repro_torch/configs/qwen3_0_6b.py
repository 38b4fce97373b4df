"""qwen3-0.6b — qk_norm, GQA, tied embeddings [hf:Qwen/Qwen3-0.6B; hf].

Assignment row: 28L d_model=1024 16H (GQA kv=8) d_ff=3072 vocab=151936.
head_dim=128 (explicit in the hf config, != d_model/n_heads).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-0.6b", family="dense",
    n_layers=28, d_model=1024, n_heads=16, n_kv_heads=8, d_head=128,
    d_ff=3072, vocab_size=151936, rope_theta=1e6,
    qk_norm=True, tie_embeddings=True,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                          d_head=16, d_ff=128, vocab_size=512)
