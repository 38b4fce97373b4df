"""Plain PyTorch chunked linear attention: the numerical oracle (reference
``ref.py``).  The chunked formulation lives in the leaf module
:mod:`.chunk_math` (itself checked against a per-step recurrence); this
wrapper takes the kernel's batched-head layout, the batch dimension written
out where the reference ``vmap``-s over it."""
from __future__ import annotations

import torch

from repro_torch.kernels.linear_attention.chunk_math import (
    chunked_linear_attention, naive_linear_attention)

__all__ = ["linear_attention", "chunked_linear_attention",
           "naive_linear_attention"]


def linear_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     log_w: torch.Tensor, *,
                     bonus: torch.Tensor | None = None,
                     inclusive: bool = False,
                     chunk: int = 64) -> torch.Tensor:
    """q/k (BH,T,dk), v (BH,T,dv), log_w (BH,T,dk), bonus (BH,dk) or None
    -> (BH,T,dv) in ``v.dtype``."""
    return chunked_linear_attention(q, k, v, log_w, bonus=bonus,
                                    inclusive=inclusive, chunk=chunk)
