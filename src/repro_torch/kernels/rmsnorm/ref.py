"""Plain PyTorch RMSNorm: the numerical oracle (reference ``ref.py``)."""
from __future__ import annotations

import torch

__all__ = ["rmsnorm"]


def rmsnorm(x: torch.Tensor, weight: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    # fp32 whatever x's dtype, or float64 for a float64 x
    acc = torch.promote_types(x.dtype, torch.float32)
    xf = x.to(acc)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * weight.to(acc)
    return out.to(x.dtype)
