"""Chunked linear-attention recurrence (model-facing re-export).

The math lives in the leaf module
:mod:`repro_torch.kernels.linear_attention.chunk_math`, as in the
reference (``src/repro/models/chunk_scan.py``); model code imports it from
here.
"""
from repro_torch.kernels.linear_attention.chunk_math import (
    chunked_linear_attention,
    naive_linear_attention,
    step_linear_attention,
)

__all__ = ["chunked_linear_attention", "step_linear_attention",
           "naive_linear_attention"]
