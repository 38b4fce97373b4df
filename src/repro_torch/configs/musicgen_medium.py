"""musicgen-medium — decoder-only over EnCodec tokens [arXiv:2306.05284; hf].

Assignment row: 48L d_model=1536 24H (kv=24, MHA) d_ff=6144 vocab=2048.
The EnCodec frontend is a stub, as in the reference: the prefill takes
precomputed frame embeddings ``embeds (B, S, d)``; decode and serving take
tokens.  (MusicGen uses sinusoidal positions; the reference uses rope.)
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium", family="audio",
    n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24,
    d_ff=6144, vocab_size=2048, rope_theta=1e4,
    frontend="audio",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                          d_head=16, d_ff=128, vocab_size=256)
