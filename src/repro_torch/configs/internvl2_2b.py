"""internvl2-2b — InternViT + InternLM2-1.8B backbone [arXiv:2404.16821; hf].

Assignment row: 24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92553.
The ViT frontend is a stub, as in the reference: the prefill takes
precomputed patch embeddings ``embeds (B, S, d_model)``; decode and
serving take tokens.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b", family="vlm",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8,
    d_ff=8192, vocab_size=92553, rope_theta=1e6,
    frontend="vision",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                          d_head=16, d_ff=128, vocab_size=512)
