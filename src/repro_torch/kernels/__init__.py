"""Hand-written Hopper kernels for the port's hot spots.

Each subpackage mirrors the reference's layout: ``ref.py`` (the plain
PyTorch version, the numerical oracle), ``kernel.py`` (the ``ctypes``
wrapper of a CUDA C++ kernel under ``csrc/``, compiled for ``sm_90a`` on
first use) and ``ops.py`` (the public op, which registers its named
entries — ``torch_ref`` and ``cuda`` — in :mod:`repro_torch.kernels.registry`
and dispatches through it).  :mod:`repro_torch.kernels.build` compiles the
CUDA sources.
"""
from repro_torch.kernels import registry
from repro_torch.kernels import (attention, fastpath, linear_attention, matmul,
                                 rmsnorm)
from repro_torch.kernels.registry import impl_point

__all__ = ["registry", "attention", "fastpath", "linear_attention", "matmul",
           "rmsnorm", "impl_point"]
