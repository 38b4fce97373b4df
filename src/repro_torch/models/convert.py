"""Conversion of the reference's parameters and train state (as numpy
arrays) to tensors.

The test side flattens the reference's pytree to numpy
(``jax.tree_util.tree_map(np.asarray, tree)``); the port's parameter
layout is the same nested dict, leaf for leaf, and so is its train state
``{"params", "opt": {"m", "v", "count"[, "ef"]}}``
(:mod:`repro_torch.optim.adamw`), so conversion is a copy of each array to
the device.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch import compat

__all__ = ["params_from_numpy", "train_state_from_numpy"]


def params_from_numpy(tree: Any,
                      device: torch.device | str | None = None) -> Any:
    """A nested dict/list/tuple of numpy arrays -> the same structure of
    tensors on ``device`` (dtypes kept; default ``cuda``, see
    :func:`repro_torch.compat.resolve_device`)."""
    device = compat.resolve_device(device)
    return compat.tree_map(
        lambda a: torch.from_numpy(np.array(a, copy=True)).to(device), tree)


def train_state_from_numpy(tree: dict,
                           device: torch.device | str | None = None) -> dict:
    """The reference's train state ``{"params", "opt"}`` as numpy arrays ->
    the port's (:func:`params_from_numpy` leaf for leaf): the moments ``m``
    and ``v`` (and the error feedback ``ef``) fp32 trees of the parameters'
    structure, ``count`` an int32 0-d tensor.  Raises ``ValueError`` on an
    optimizer state of another layout."""
    opt = tree["opt"]
    keys = set(opt)
    if keys not in ({"m", "v", "count"}, {"m", "v", "count", "ef"}):
        raise ValueError(f"not an AdamW state: opt keys {sorted(keys)}")
    state = params_from_numpy(tree, device)
    state["opt"]["count"] = state["opt"]["count"].to(torch.int32).reshape(())
    return state
