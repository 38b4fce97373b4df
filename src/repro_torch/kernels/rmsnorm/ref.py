"""Plain PyTorch RMSNorm: the numerical oracle (reference ``ref.py``)."""
from __future__ import annotations

import torch

__all__ = ["rmsnorm"]


def rmsnorm(x: torch.Tensor, weight: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * weight.to(torch.float32)
    return out.to(x.dtype)
