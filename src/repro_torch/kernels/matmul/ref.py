"""Plain PyTorch version of the blocked matmul (the numerical oracle)."""
from __future__ import annotations

import torch

__all__ = ["matmul"]


def matmul(x: torch.Tensor, y: torch.Tensor,
           out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """``x @ y`` with an fp32 accumulator, cast to ``out_dtype`` (default
    ``x.dtype``): the reference's ``jnp.dot(..., preferred_element_type=
    float32)``.  Both operands are upcast to fp32 and multiplied in full
    fp32: TF32 is switched off for the product (it keeps about three
    decimal digits) and restored after."""
    out_dtype = out_dtype or x.dtype
    precision = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        acc = x.to(torch.float32) @ y.to(torch.float32)
    finally:
        torch.set_float32_matmul_precision(precision)
    return acc.to(out_dtype)
