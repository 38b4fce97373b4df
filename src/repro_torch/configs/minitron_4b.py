"""minitron-4b — pruned nemotron [arXiv:2407.14679; hf].

Assignment row: 32L d_model=3072 24H (GQA kv=8) d_ff=9216 vocab=256000.
The 256k vocabulary makes the logits the largest activation of a
full-width prefill: (1, 4096, 256000) fp32 is 4.2 GB.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="minitron-4b", family="dense",
    n_layers=32, d_model=3072, n_heads=24, n_kv_heads=8,
    d_ff=9216, vocab_size=256000, rope_theta=1e4,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                          d_head=16, d_ff=128, vocab_size=1024)
