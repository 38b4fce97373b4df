"""Public fast-path lookup op, registry-dispatched.

Two entries: ``torch_ref`` (the plain version, :mod:`.ref`) and ``cuda``
(the hand-written kernel, :mod:`.kernel`).  The ``cuda`` guard is the
card and the reference's own precondition
(``src/repro/kernels/fastpath/ops.py:29-33``: 2-D tensors, one key width,
a value row a key, integer queries): any other call (a host tensor, float
queries) misses it and runs ``torch_ref``, counted in the registry's
``fallback_counts``.  The kernel takes what passes it: queries of any
integer dtype against keys of any integer dtype or fp32, bf16 or fp16
(compared as ``==`` compares them, in the promoted dtype; the kernel
converts each on load, so the entry passes them as they are), keys of
any width, fp32, bf16, fp16, int32 and int64 values and any positive
``block_b``.  A CUDA call it cannot take (a value dtype it lacks, 2^31
indices, a prepared table of another device) raises in the entry or the
wrapper (``kernel.unsupported``).  Where the reference pads the batch to
``block_b``, the kernel masks the ragged tail.

A table that stays fixed across calls (a specialized handler's) is
prepared once (:func:`prepare`) and passed as ``prepared=``: the ``cuda``
entry then runs on its hashed form, while ``torch_ref`` ignores it and
computes from the raw arrays, so the plain version stays the oracle.
"""
from __future__ import annotations

import torch

from repro_torch import compat
from repro_torch.kernels import registry
from repro_torch.kernels.fastpath import kernel, ref
from repro_torch.kernels.fastpath.kernel import (DEFAULT_BLOCK_B,
                                                 PreparedTable)

__all__ = ["lookup", "prepare"]

_INTEGER = (torch.int8, torch.int16, torch.int32, torch.int64, torch.uint8)


def _guard(x, keys, values, **_kw):
    # The card and the reference's precondition, by attribute reads only
    # (it runs before every router launch).
    return (x.device.type == "cuda" and x.ndim == 2 and keys.ndim == 2
            and values.ndim == 2 and x.shape[1] == keys.shape[1]
            and keys.shape[0] == values.shape[0]
            and x.dtype in _INTEGER)


@registry.register("fastpath", "torch_ref", priority=0,
                   description="vectorized compare, onehot gather "
                               "(the numerical oracle)")
def _lookup_torch_ref(x, keys, values, *, block_b=DEFAULT_BLOCK_B,
                      prepared=None, readback=None):
    del block_b, prepared, readback
    return ref.lookup(x, keys, values)


@registry.register("fastpath", "cuda", priority=20,
                   supports_grad=False, guard=_guard,
                   available=compat.has_hopper,
                   prepare=kernel.load_library,
                   description="hot-key matcher in CUDA C++ for sm_90a "
                               "(dense compare of a staged table, or a "
                               "prepared hash table, of canonical keys; "
                               "exact integer sums)")
def _lookup_cuda(x, keys, values, *, block_b=DEFAULT_BLOCK_B, prepared=None,
                 readback=None):
    if prepared is not None:
        if prepared.keys is not keys or prepared.values is not values:
            raise ValueError("the prepared table was built from other keys "
                             "or values than the call's")
        return kernel.fastpath_cuda_prepared(x.contiguous(), prepared,
                                             block_b=block_b,
                                             readback=readback)
    if x.dtype.is_floating_point:
        raise TypeError(f"the fast-path kernel takes integer queries, got "
                        f"{x.dtype} (the guard sends them to torch_ref)")
    args = (x.contiguous(), keys.contiguous(), values.contiguous())
    if readback is not None:
        return kernel.fastpath_cuda(*args, block_b=block_b,
                                    readback=readback)
    return kernel.fastpath_cuda(*args, block_b=block_b)


def lookup(x: torch.Tensor, keys: torch.Tensor, values: torch.Tensor, *,
           block_b: int = DEFAULT_BLOCK_B, impl: str | None = None,
           prepared: PreparedTable | None = None
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """``x (B, K)`` queries against ``keys (N, K)`` with ``values (N, V)``
    -> ``(out (B, V), hit (B,) bool)``.  ``prepared``: the table's
    :func:`prepare` form, which the ``cuda`` entry runs on."""
    return registry.dispatch("fastpath", impl, x, keys, values,
                             block_b=block_b, prepared=prepared)


def prepare(keys: torch.Tensor, values: torch.Tensor,
            impl: str | None = None) -> PreparedTable | None:
    """The table's prepared form (:func:`kernel.prepare_table`) for the
    entry ``impl`` resolves to, if that is ``cuda`` and the table is on a
    CUDA device; else None (counts no fallback: nothing is dispatched)."""
    entry, _ = registry.default_registry.pick("fastpath", impl)
    if entry.name != "cuda" or keys.device.type != "cuda":
        return None
    return kernel.prepare_table(keys, values)
