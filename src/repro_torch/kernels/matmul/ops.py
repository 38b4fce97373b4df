"""Public blocked-matmul op, dispatched through the kernel registry.

``assume_divisible=True`` is the kernel-level effect of the paper's
``spec_assume("N % B == 0")``: the CUDA kernel is instantiated without
its edge masking; the host guard at the handler level ensures the
assumption actually holds.

Two entries: ``torch_ref`` (the plain version, :mod:`.ref`) and ``cuda``
(the hand-written kernel, :mod:`.kernel`).  The ``cuda`` guard is the
card and the reference's own precondition
(``src/repro/kernels/matmul/ops.py:37-52``: 2-D float operands of one
inner dim): any other call (a host tensor, integer operands) misses it
and runs ``torch_ref``, counted in the registry's ``fallback_counts``.
The reference's guard also sends a call with ``assume_divisible=True``
whose shape is not a multiple of the tiles to its plain version; here
that call runs the kernel's edge-masked instantiation instead, which
takes any shape and gives the same product.  The kernel takes fp32, bf16
and fp16 operands (two dtypes widened to fp32, as ``jnp.dot`` promotes
them) into any of the three outputs.  A CUDA call it cannot take (fp64
operands, a tile triple it lacks) raises in the wrapper
(``kernel.unsupported``); it never silently runs the plain version.
Where the reference pads a ragged shape up to the tiles, the kernel masks
the edge.
"""
from __future__ import annotations

import torch

from repro_torch import compat
from repro_torch.kernels import registry
from repro_torch.kernels.matmul import kernel, ref
from repro_torch.kernels.matmul.kernel import DEFAULT_TILES

__all__ = ["matmul"]

_BM, _BN, _BK = DEFAULT_TILES


def _guard(x, y, **_kw):
    # The card and the reference's precondition without its divisibility
    # under assume_divisible (the entry runs the masked instantiation), by
    # attribute reads only.
    return (x.device.type == "cuda" and x.ndim == 2 and y.ndim == 2
            and x.shape[1] == y.shape[0] and x.dtype.is_floating_point
            and y.dtype.is_floating_point)


@registry.register("matmul", "torch_ref", priority=0,
                   description="fp32-accumulated torch matmul, TF32 off "
                               "(the numerical oracle)")
def _matmul_torch_ref(x, y, *, bm=_BM, bn=_BN, bk=_BK, out_dtype=None,
                      assume_divisible=False):
    del bm, bn, bk, assume_divisible          # no tiling in the generic path
    return ref.matmul(x, y, out_dtype=out_dtype or x.dtype)


@registry.register("matmul", "cuda", priority=20,
                   supports_grad=False, guard=_guard,
                   available=compat.has_hopper,
                   prepare=kernel.load_library,
                   description="blocked CUDA matmul for sm_90a (fp32 FMA "
                               "fed by cp.async, bf16 and fp16 on wgmma), "
                               "tiles as template arguments")
def _matmul_cuda(x, y, *, bm=_BM, bn=_BN, bk=_BK, out_dtype=None,
                 assume_divisible=False):
    # The unmasked instantiation only where the tiles divide the shape.
    divisible = (x.shape[0] % bm == 0 and y.shape[-1] % bn == 0
                 and x.shape[-1] % bk == 0)
    return kernel.matmul_cuda(x.contiguous(), y.contiguous(), bm=bm, bn=bn,
                              bk=bk, out_dtype=out_dtype or x.dtype,
                              assume_divisible=assume_divisible and divisible)


def matmul(x: torch.Tensor, y: torch.Tensor, *, bm: int = _BM,
           bn: int = _BN, bk: int = _BK,
           out_dtype: torch.dtype | None = None, impl: str | None = None,
           assume_divisible: bool = False) -> torch.Tensor:
    """``x (m, k) @ y (k, n)`` with an fp32 accumulator, tiles
    ``(bm, bn, bk)``; ``out_dtype`` defaults to ``x.dtype``."""
    return registry.dispatch(
        "matmul", impl, x, y, bm=bm, bn=bn, bk=bk, out_dtype=out_dtype,
        assume_divisible=assume_divisible)
