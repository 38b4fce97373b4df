"""Shared kernel plumbing: implementation-name resolution and tiling helpers.

Implementation selection lives in :mod:`repro_torch.kernels.registry`;
every kernel package's ``ops.py`` registers its named entries
(``torch_ref``, ``cuda``) there and dispatches through it.  This module
re-exports the registry's name helpers (``canonical_name`` maps the
reference's ``xla`` / ``pallas`` / ``interpret`` spellings, ``env_impl``
reads ``REPRO_KERNEL_IMPL``) and keeps the reference's tiling math.
No kernel of the port pads (each masks its ragged edge tiles), so
nothing in the package calls ``cdiv`` or ``pad_to_multiple`` yet.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import is_dtensor
from repro_torch.kernels.registry import canonical_name, env_impl

__all__ = ["canonical_name", "env_impl", "cdiv", "pad_to_multiple",
           "refuse_autograd"]


def refuse_autograd(name: str, *tensors: torch.Tensor | None) -> None:
    """Raise if a kernel wrapper is called under autograd on a tensor that
    requires grad, or on a DTensor.  No kernel of the port has a backward:
    it writes into a fresh tensor that carries no ``grad_fn``, so every
    gradient through the call would be cut without a word.  Nor does one
    take a DTensor: it would read only the local shard.  A differentiated
    or sharded step pins its implementations to ``torch_ref`` instead."""
    if any(is_dtensor(t) for t in tensors):
        raise RuntimeError(
            f"{name} takes plain tensors and was called on a DTensor; a "
            f"step under a mesh pins its implementation to torch_ref")
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} has no backward and was called on a tensor that "
            f"requires grad; run the step under torch.no_grad() or pin its "
            f"implementation to torch_ref")


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def pad_to_multiple(x: torch.Tensor, multiple: int, axis: int
                    ) -> tuple[torch.Tensor, int]:
    """Zero-pad ``axis`` of ``x`` up to the next multiple.  Returns
    ``(padded, n)`` with ``n`` the original length."""
    n = x.shape[axis]
    target = cdiv(n, multiple) * multiple
    if target == n:
        return x, n
    # F.pad lists (before, after) pairs from the last axis backwards.
    pads = [0, 0] * (x.ndim - 1 - axis % x.ndim) + [0, target - n]
    return F.pad(x, pads), n
