"""Specialization guards (paper §4.4.3), for the PyTorch port.

The paper inserts a check at the specialized function's entry; on failure
it throws, and the JIT trampoline catches and re-routes to the generic
version.  Guards live at two levels here, as in the reference:

* **Host guards** — predicates over the (host-visible) arguments, evaluated
  by the trampoline *before* dispatch.  Used for workload-value and shape
  assumptions (``spec.generic("N", guard=...)``).  Cost: one Python-level
  predicate per call; the miss path costs one extra dispatch (handlers
  are pure, nothing to roll back).  Copied from the reference.
* **Data guards** — for data-dependent assumptions the host cannot see
  (e.g. "all keys hit the fast path").  The reference keeps them inside
  the compiled program (``lax.cond``, ``jnp.where``); PyTorch runs
  eagerly, so :func:`cond_guard` branches on the host, which reads the
  predicate from the device once (one synchronisation a call), and
  :func:`select_guard` is a ``torch.where``.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

__all__ = ["arg_equals", "shape_equals", "shape_multiple_of",
           "cond_guard", "select_guard"]


# --- host-side guard predicate factories --------------------------------------

def arg_equals(index: int | str) -> Callable:
    """Guard: positional/keyword argument equals the specialized value."""

    def g(args: tuple, kwargs: dict, value: Any) -> bool:
        actual = kwargs[index] if isinstance(index, str) else args[index]
        return actual == value

    return g


def shape_equals(index: int | str, dim: int) -> Callable:
    """Guard: ``args[index].shape[dim]`` equals the specialized value."""

    def g(args: tuple, kwargs: dict, value: Any) -> bool:
        actual = kwargs[index] if isinstance(index, str) else args[index]
        return actual.shape[dim] == value

    return g


def shape_multiple_of(index: int | str, dim: int) -> Callable:
    """Guard for assume-points: ``shape[dim] % value == 0`` (vacuous for a
    bool value, as in the reference)."""

    def g(args: tuple, kwargs: dict, value: Any) -> bool:
        if isinstance(value, bool):
            return True
        actual = kwargs[index] if isinstance(index, str) else args[index]
        return actual.shape[dim] % value == 0

    return g


# --- data guards ------------------------------------------------------------------

def cond_guard(pred: torch.Tensor,
               fast_fn: Callable,
               slow_fn: Callable,
               *operands: Any) -> tuple[Any, torch.Tensor]:
    """Batch-level data guard.

    Runs ``fast_fn`` when the scalar ``pred`` holds, otherwise ``slow_fn``
    (the generic code).  Returns ``(result, miss)`` where ``miss`` is a
    0/1 int32 host scalar the handler surfaces to the policy — overall metrics
    then "implicitly factor in any overheads" of guard failures (paper
    §3).  ``bool(pred)`` reads the predicate on the host: one
    synchronisation with the device a call, which the reference's
    in-graph ``lax.cond`` does not pay.
    """
    taken = bool(pred)
    result = fast_fn(*operands) if taken else slow_fn(*operands)
    miss = torch.as_tensor(int(not taken), dtype=torch.int32)
    return result, miss


def select_guard(hit: torch.Tensor,
                 fast_values: torch.Tensor,
                 slow_fn: Callable,
                 *operands: Any) -> torch.Tensor:
    """Element-level data guard: per-element select with generic backfill.

    The vectorized form of the paper's if-else fast path: compute the
    generic result for the whole batch and ``where``-select.  Only
    profitable when combined with a batch-level :func:`cond_guard` that
    skips the generic path entirely when every element hit — see
    ``fastpath.py``.
    """
    slow = slow_fn(*operands)
    hit_b = hit.reshape(hit.shape + (1,) * (fast_values.ndim - hit.ndim))
    return torch.where(hit_b, fast_values, slow)
