"""Public RMSNorm ops (any leading batch dims), registry-dispatched.

Two ops: ``rmsnorm`` (one tensor) and ``rmsnorm_pair`` (two tensors of one
width, such as a layer's q and k before attention: one kernel launch for
both).  Each has two entries: ``torch_ref`` (the plain version, :mod:`.ref`;
for the pair, two plain calls) and ``cuda`` (the hand-written kernel,
:mod:`.kernel`).  Both ops take their implementation from one choice (the
models pass ``rmsnorm_impl`` to each), so exploring that spec point covers
every norm.  The ``cuda`` guard is the card and the reference's own
precondition (``src/repro/kernels/rmsnorm/ops.py::_guard``: float rows of
the weight's width): any other call (a host tensor, integer rows, a
weight of another width) misses it and runs ``torch_ref``, counted in the
registry's ``fallback_counts``.  A call that passes it launches the kernel
or raises: a dtype the kernel lacks, such as fp64 rows, raises in the
wrapper (``kernel.unsupported``) and never runs the plain version.
"""
from __future__ import annotations

import torch

from repro_torch import compat
from repro_torch.kernels import registry
from repro_torch.kernels.rmsnorm import kernel, ref
from repro_torch.kernels.rmsnorm.kernel import DEFAULT_BLOCK_ROWS

__all__ = ["rmsnorm", "rmsnorm_pair"]


def _guard(x, weight, **_kw):
    # The card and the reference's precondition, by attribute reads only
    # (it runs before every launch).  A CUDA call the kernel cannot take
    # (fp64 rows) passes and raises in the wrapper.
    return (x.device.type == "cuda" and x.dtype.is_floating_point
            and weight.ndim == 1 and x.ndim >= 1
            and x.shape[-1] == weight.shape[0])


def _pair_guard(x0, w0, x1, w1, **_kw):
    return _guard(x0, w0) and _guard(x1, w1)


def _kernel_args(x, weight):
    """``x`` as the kernel takes it (rows dense; a copy only for other
    layouts) and the weight as fp32."""
    if not kernel.row_dense(x):
        x = x.contiguous()
    if weight.dtype is not torch.float32:
        weight = weight.to(torch.float32)
    return x, weight.contiguous()


@registry.register("rmsnorm", "torch_ref", priority=0,
                   description="plain PyTorch rmsnorm (the numerical oracle)")
def _rmsnorm_torch_ref(x, weight, *, eps=1e-6,
                       block_rows=DEFAULT_BLOCK_ROWS):
    del block_rows
    return ref.rmsnorm(x, weight, eps)


@registry.register("rmsnorm", "cuda", priority=20,
                   supports_grad=False, guard=_guard,
                   available=compat.has_hopper,
                   prepare=kernel.load_library,
                   description="one-read-per-row CUDA rmsnorm for sm_90a")
def _rmsnorm_cuda(x, weight, *, eps=1e-6, block_rows=DEFAULT_BLOCK_ROWS):
    x, weight = _kernel_args(x, weight)
    return kernel.rmsnorm_cuda(x, weight, eps=eps, block_rows=block_rows)


@registry.register("rmsnorm_pair", "torch_ref", priority=0,
                   description="two plain PyTorch rmsnorms")
def _rmsnorm_pair_torch_ref(x0, w0, x1, w1, *, eps=1e-6,
                            block_rows=DEFAULT_BLOCK_ROWS):
    del block_rows
    return ref.rmsnorm(x0, w0, eps), ref.rmsnorm(x1, w1, eps)


@registry.register("rmsnorm_pair", "cuda", priority=20,
                   supports_grad=False, guard=_pair_guard,
                   available=compat.has_hopper,
                   prepare=kernel.load_library,
                   description="two rmsnorms in one CUDA launch for sm_90a")
def _rmsnorm_pair_cuda(x0, w0, x1, w1, *, eps=1e-6,
                       block_rows=DEFAULT_BLOCK_ROWS):
    x0, w0 = _kernel_args(x0, w0)
    x1, w1 = _kernel_args(x1, w1)
    return kernel.rmsnorm_pair_cuda(x0, w0, x1, w1, eps=eps,
                                    block_rows=block_rows)


def rmsnorm(x: torch.Tensor, weight: torch.Tensor, *, eps: float = 1e-6,
            block_rows: int = DEFAULT_BLOCK_ROWS,
            impl: str | None = None) -> torch.Tensor:
    return registry.dispatch("rmsnorm", impl, x, weight, eps=eps,
                             block_rows=block_rows)


def rmsnorm_pair(x0: torch.Tensor, w0: torch.Tensor, x1: torch.Tensor,
                 w1: torch.Tensor, *, eps: float = 1e-6,
                 block_rows: int = DEFAULT_BLOCK_ROWS,
                 impl: str | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(rmsnorm(x0, w0), rmsnorm(x1, w1))``; with ``cuda``, one launch."""
    return registry.dispatch("rmsnorm_pair", impl, x0, w0, x1, w1, eps=eps,
                             block_rows=block_rows)
