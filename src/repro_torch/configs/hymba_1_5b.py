"""hymba-1.5b — parallel attention + mamba heads [arXiv:2411.13676; hf].

Assignment row: 32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001,
ssm_state=16.  Sliding window 1024 on the attention heads (the Hymba
global/local mix simplified to uniform SWA, as in the reference), which
bounds the decode state.  ``ssm_heads`` defaults to ``n_heads`` (25).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5,
    d_ff=5504, vocab_size=32001,
    ssm_state=16, window=1024,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                          d_head=16, d_ff=128, vocab_size=512, ssm_state=8,
                          ssm_heads=0, window=16)
