"""Plain PyTorch versions of the fast-path hot-key matcher: :func:`lookup`
on the raw table (the oracle), and :func:`lookup_prepared`, which probes a
table's hashed form as the kernel's hashed body does (the CPU tests hold
the host-side table construction with it)."""
from __future__ import annotations

import torch

from repro_torch.kernels.fastpath.kernel import (PreparedTable,
                                                 canonical_queries,
                                                 hash_keys)

__all__ = ["lookup", "lookup_prepared"]


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


def lookup_prepared(x: torch.Tensor,    # (B, K) integer queries
                    table: PreparedTable,
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`lookup` through ``table``'s hashed form: each query, in its
    canonical form against the table's keys, starts at its hash's slot and
    probes linearly until it finds its key or an empty slot, then takes
    that key's pre-summed row (rounded once to the values' dtype)."""
    x = canonical_queries(x, table.kdtype)
    slots, hkeys = table.slots, table.hkeys
    vdtype = table.values.dtype
    b, v = x.shape[0], table.values.shape[1]
    mask = slots.shape[0] - 1
    if hkeys.shape[0] == 0:
        return (torch.zeros((b, v), dtype=vdtype, device=x.device),
                torch.zeros((b,), dtype=torch.bool, device=x.device))
    s = torch.as_tensor((hash_keys(x.cpu().numpy()) & mask).astype("int64"),
                        device=x.device)
    row = torch.full((b,), -1, dtype=torch.int64, device=x.device)
    active = torch.ones((b,), dtype=torch.bool, device=x.device)
    while bool(active.any()):
        k = slots[s].long()
        found = active & (k >= 0) & (hkeys[k.clamp(min=0)] == x).all(dim=-1)
        row = torch.where(found, k, row)
        active &= (k >= 0) & ~found
        s = (s + 1) & mask
    hit = row >= 0
    out = torch.where(hit[:, None], table.hvalues[row.clamp(min=0)],
                      torch.zeros((), dtype=table.hvalues.dtype,
                                  device=x.device))
    return out.to(vdtype), hit
