"""Conversion of the reference's parameters (as numpy arrays) to tensors.

The test side flattens the reference's parameter pytree to numpy
(``jax.tree_util.tree_map(np.asarray, params)``); the port's parameter
layout is the same nested dict, leaf for leaf, so conversion is a copy of
each array to the device.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch import compat

__all__ = ["params_from_numpy"]


def params_from_numpy(tree: Any,
                      device: torch.device | str | None = None) -> Any:
    """A nested dict/list/tuple of numpy arrays -> the same structure of
    tensors on ``device`` (dtypes kept; default ``cuda``, see
    :func:`repro_torch.compat.resolve_device`)."""
    device = compat.resolve_device(device)
    return compat.tree_map(
        lambda a: torch.from_numpy(np.array(a, copy=True)).to(device), tree)
