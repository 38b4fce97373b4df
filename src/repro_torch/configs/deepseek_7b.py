"""deepseek-7b — llama-arch MHA [arXiv:2401.02954; hf].

Assignment row: 30L d_model=4096 32H (kv=32, i.e. MHA) d_ff=11008
vocab=102400.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-7b", family="dense",
    n_layers=30, d_model=4096, n_heads=32, n_kv_heads=32,
    d_ff=11008, vocab_size=102400, rope_theta=1e4,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                          d_head=16, d_ff=128, vocab_size=512)
