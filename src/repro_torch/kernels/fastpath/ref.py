"""Plain PyTorch version of the fast-path hot-key matcher (the oracle)."""
from __future__ import annotations

import torch

__all__ = ["lookup"]


def lookup(x: torch.Tensor,        # (B, K) query keys
           keys: torch.Tensor,     # (N, K) hot keys (constants when baked)
           values: torch.Tensor,   # (N, V) precomputed outputs
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(out (B, V), hit (B,))``: ``out = onehot(match) @ values``,
    rows 0 where nothing matches and duplicate keys summed.

    Float values go through the product with an fp32 (float64: float64)
    accumulator, TF32 off, as the reference's oracle.  Integer values are never routed
    through a float product: the matching rows are added exactly in their
    own dtype (``index_add_``; integer addition wraps and does not depend
    on the order).
    """
    match = (x[:, None, :] == keys[None, :, :]).all(dim=-1)         # (B, N)
    hit = match.any(dim=-1)
    if values.dtype.is_floating_point:
        acc = torch.promote_types(values.dtype, torch.float32)
        precision = torch.get_float32_matmul_precision()
        torch.set_float32_matmul_precision("highest")
        try:
            out = (match.to(acc) @ values.to(acc)).to(values.dtype)
        finally:
            torch.set_float32_matmul_precision(precision)
        return out, hit
    rows, cols = match.nonzero(as_tuple=True)
    out = torch.zeros((x.shape[0], values.shape[1]), dtype=values.dtype,
                      device=values.device)
    out.index_add_(0, rows, values[cols])
    return out, hit
