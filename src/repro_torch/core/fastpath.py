"""Fast-path specialization (paper §5): the generic re-implementation of
Morpheus' hot-key specialization, for the PyTorch port.

Two phases, as in the paper:

1. **Instrumentation phase** — sample invocations of the target function to
   find the most popular inputs along with their computed outputs (the
   handler's recorders, read by :func:`build_table`).
2. **Specialization phase** — regenerate the target with a fast path mapping
   the top-N inputs to their outputs, falling through to the generic
   computation on a miss (:func:`make_fastpath`).

The paper emits an if-else chain (one branch per hot key).  As in the
reference, the specialized function is a **vectorized matcher** instead:
it compares the batch against a constant ``(N, ...)`` key table, takes the
matching value rows, and skips the generic computation entirely when the
whole batch hits.  The matcher runs through the ``fastpath`` kernel family
(:mod:`repro_torch.kernels.fastpath`), so on the card it is the hand-written
CUDA matcher, on a table prepared once when the function is specialized.

One wait remains a call on the card: to skip the generic computation the
host has to know whether the whole batch hit, so the matcher writes its
miss count to a mapped host word and the call waits on the stream for it
(no copy, no reduction launch).  The reference decides in the graph
(``lax.cond``) and pays no such wait.  With
``skip_generic_when_all_hit=False`` the call launches and returns without
waiting.

Dtypes follow the reference as JAX computes it, with 64-bit types off: a
table or a requested dtype of int64 becomes int32, float64 float32 (values
wrap or round as ``jnp.asarray`` does), so the port's tables hold what the
reference's hold.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch import compat
from repro_torch.core import instrumentation as instr

__all__ = ["FastPathTable", "build_table", "canonical_dtype",
           "make_fastpath", "fastpath_generator"]

#: what JAX makes of a 64-bit dtype while 64-bit types are off
_X64_OFF = {torch.int64: torch.int32, torch.float64: torch.float32,
            torch.complex128: torch.complex64, torch.uint64: torch.uint32}


def canonical_dtype(dtype: Any) -> torch.dtype:
    """The torch dtype JAX (64-bit types off) gives an array asked to be
    ``dtype`` (a torch dtype, or anything ``numpy.dtype`` takes)."""
    if not isinstance(dtype, torch.dtype):
        dtype = torch.from_numpy(np.empty(0, dtype=np.dtype(dtype))).dtype
    return _X64_OFF.get(dtype, dtype)


def _as_tensor(arr: Any, dtype: Any = None,
               device: torch.device | str | None = None) -> torch.Tensor:
    """``jnp.asarray(arr, dtype)`` with 64-bit types off, as a tensor."""
    t = torch.as_tensor(np.asarray(arr))
    return t.to(device=device, dtype=canonical_dtype(
        t.dtype if dtype is None else dtype))


def _to_numpy(value: Any) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        value = value.detach().cpu()
        if value.dtype == torch.bfloat16:
            value = value.float()
        return value.numpy()
    return np.asarray(value)


@dataclasses.dataclass(frozen=True)
class FastPathTable:
    """Top-N hot inputs and their precomputed outputs."""

    keys: tuple          # hashable nested tuple rep of np.ndarray (N, *key_shape)
    values: tuple        # same for np.ndarray (N, *val_shape)

    @staticmethod
    def from_arrays(keys: Any, values: Any) -> "FastPathTable":
        def nest(x):
            return tuple(nest(v) for v in x) if isinstance(x, list) else x

        k = np.atleast_2d(_to_numpy(keys))
        v = _to_numpy(values)
        v = v.reshape(k.shape[0], -1)          # one value row per key
        return FastPathTable(keys=nest(k.tolist()), values=nest(v.tolist()))

    @property
    def n(self) -> int:
        return len(self.keys)

    def key_array(self, dtype: Any = None,
                  device: torch.device | str | None = None) -> torch.Tensor:
        return _as_tensor(np.array(self.keys), dtype, device)

    def value_array(self, dtype: Any = None,
                    device: torch.device | str | None = None
                    ) -> torch.Tensor:
        return _as_tensor(np.array(self.values), dtype, device)


def build_table(observed: dict, label: str, n: int,
                generic_fn: Callable[[torch.Tensor], Any],
                key_dtype: Any = np.int64,
                device: torch.device | str | None = None
                ) -> FastPathTable | None:
    """Specialization-phase table construction from instrumentation data.

    ``observed`` is ``handler.spec_space().observed``; the top-N keys are
    taken from the recorder for ``label`` and their outputs computed once
    with the generic function, which gets each key as a tensor on
    ``device`` (``cuda`` unless another is named).
    """
    top = instr.topk_from_counter(observed, label, n)
    if not top:
        return None
    dev = compat.resolve_device(device)
    keys = np.array([np.atleast_1d(np.asarray(k, dtype=key_dtype))
                     for k in top])
    values = np.stack([_to_numpy(generic_fn(_as_tensor(k, device=dev)))
                       for k in keys])
    return FastPathTable.from_arrays(keys, values)


def make_fastpath(
    generic_fn: Callable,
    table: FastPathTable,
    *,
    key_dtype: Any = torch.int32,
    value_dtype: Any = None,
    skip_generic_when_all_hit: bool = True,
    impl: str | None = None,
    device: torch.device | str | None = None,
) -> Callable:
    """Build the specialized function: vectorized top-N matcher + fall-through.

    ``generic_fn(batch_keys) -> batch_values`` is the generic computation
    (vectorized over the leading batch dim).  The returned function has the
    same signature and semantics for *all* inputs — hot inputs take the fast
    path, others fall through (the specialization guard).

    The matcher is the ``fastpath`` op under ``impl`` (the registry's
    choice when None), resolved once here, as the reference's ``jax.jit``
    traces it once; each call still checks the entry's device guard and
    counts a fallback on a miss.  Its table lives on ``device`` (``cuda``
    unless another is named), where the calls' inputs must lie.  The op
    sums the values of duplicate keys while the reference takes the first
    matching row, so repeated keys are dropped here, each key keeping its
    first row: the two agree on every input.  On the ``cuda`` entry the
    table is also prepared here, once (``ops.prepare``: the kernel's hashed
    form), the counterpart of the reference baking it in as a constant.

    With ``skip_generic_when_all_hit`` the function returns the table's rows
    without running ``generic_fn`` when every row hit, which the host must
    know: on the ``cuda`` entry the kernel writes the batch's miss count to
    a mapped host word and the call waits on the stream once (the
    reference's in-graph ``lax.cond`` pays no such wait); on ``torch_ref``
    it reads ``hit.all()``.  With ``skip_generic_when_all_hit=False`` a
    ``cuda`` call does not wait at all.
    """
    # The kernels import the core's spec points: import them here, not
    # when this module is imported.
    from repro_torch.kernels import registry
    from repro_torch.kernels.fastpath import kernel, ops

    dev = compat.resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    keys_c = table.key_array(key_dtype, dev)           # (N, *key_shape)
    vals_c = table.value_array(value_dtype, dev)       # (N, V)
    flat_k = keys_c.reshape(keys_c.shape[0], -1)
    # Keep each key's first row (the reference's argmax picks it).
    _, first = np.unique(flat_k.cpu().numpy(), axis=0, return_index=True)
    if len(first) < flat_k.shape[0]:
        keep = torch.as_tensor(np.sort(first), device=dev)
        flat_k, vals_c = flat_k[keep], vals_c[keep]
    flat_k = flat_k.contiguous()
    vals_flat = vals_c.reshape(vals_c.shape[0], -1).contiguous()
    select = registry.default_registry.bind("fastpath", impl)
    # builds the matcher's library too, off the dispatch path
    prepared = ops.prepare(flat_k, vals_flat, impl) \
        if dev.type == "cuda" else None
    readback = kernel.MissReadback() \
        if prepared is not None and skip_generic_when_all_hit else None
    dev_index = dev.index if dev.type == "cuda" else -1
    key_dtype_c = flat_k.dtype

    def specialized(x: torch.Tensor) -> torch.Tensor:
        if x.get_device() != dev_index:
            raise ValueError(f"the fast-path table is on {dev}, the input "
                             f"on {x.device}")
        batchless = x.ndim == keys_c.ndim - 1
        xb = x[None] if batchless else x           # (B, *key_shape)
        flat_x = xb if xb.ndim == 2 and xb.dtype is key_dtype_c \
            else xb.reshape(xb.shape[0], -1).to(key_dtype_c)
        # (B, V) rows of the matching key, 0 on a miss; hit (B,)
        entry = select(flat_x, flat_k, vals_flat)
        if entry.name == "cuda":
            fast, hit = entry.fn(flat_x, flat_k, vals_flat,
                                 prepared=prepared, readback=readback)
            all_hit = readback is not None and readback.misses == 0
        else:
            fast, hit = entry.fn(flat_x, flat_k, vals_flat)
            all_hit = skip_generic_when_all_hit and bool(hit.all())

        def backfill():
            slow = generic_fn(xb)
            hb = hit.reshape(hit.shape + (1,) * (slow.ndim - hit.ndim))
            return torch.where(hb, fast, slow)

        out = fast if all_hit else backfill()
        return out[0] if batchless else out

    return specialized


def fastpath_generator(payload: Any, generic_fn: Callable,
                       **kwargs: Any) -> Callable:
    """Custom-spec generator (register via ``add_custom_spec("fastpath", ...)``).

    The policy's config value (payload) for the custom point is either a
    :class:`FastPathTable` or ``(keys, values)`` arrays.
    """
    if isinstance(payload, FastPathTable):
        table = payload
    else:
        keys, values = payload
        table = FastPathTable.from_arrays(keys, values)
    return make_fastpath(generic_fn, table, **kwargs)
