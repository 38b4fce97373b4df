"""Device, toolchain and pytree helpers for the PyTorch/CUDA port.

The single place the port decides where it runs and whether its Hopper
kernels can be built:

* :func:`resolve_device` — entry points run on ``cuda`` unless the caller
  asks for the CPU; a missing CUDA device is an error, never a silent
  fall back to the host.
* probes — CUDA present, compute capability ``(9, 0)`` (Hopper, the
  ``sm_90a`` target the kernels are compiled for), ``nvcc`` available.
* :data:`BUILD_DIR` — where kernel libraries are compiled on first use
  (``build/kernels/`` at the root of the checkout; git-ignored).
* pytree helpers over dicts, lists and tuples (the port's stand-in for
  ``jax.tree_util``: parameters and caches are plain nested dicts).
"""
from __future__ import annotations

import functools
import os
import shutil
from pathlib import Path
from typing import Any, Callable

import torch

__all__ = ["BUILD_DIR", "resolve_device", "cuda_capability",
           "has_hopper", "nvcc_path", "tree_map",
           "tree_flatten", "tree_unflatten", "tree_leaves"]

#: compiled kernel libraries live here (``build/`` is git-ignored)
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"

#: the compute capability the hand-written kernels target (sm_90a)
HOPPER = (9, 0)


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless ``device`` names
    another.  Raises when CUDA is asked for (or defaulted to) and absent.

    Also pins float32 matrix products and convolutions to full float32:
    the reference computes the serve path in fp32, and TF32 keeps only
    about three decimal digits.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (CLI: "
            "--device cpu) to run on the host")
    # fp32 everywhere: no TF32 in matmuls (cuBLAS) or convolutions (cuDNN).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev


def cuda_capability() -> tuple[int, int] | None:
    """Compute capability of the current CUDA device, or None."""
    if not torch.cuda.is_available():
        return None
    return tuple(torch.cuda.get_device_capability())


@functools.lru_cache(maxsize=1)
def has_hopper() -> bool:
    """A CUDA device of capability >= (9, 0) is present (probed once: the
    kernel registry asks on every dispatch)."""
    cap = cuda_capability()
    return cap is not None and cap >= HOPPER


@functools.lru_cache(maxsize=1)
def nvcc_path() -> str | None:
    """The CUDA compiler: ``nvcc`` on the PATH, else under ``CUDA_HOME``
    or the toolkit's default prefix."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root:
            cand = Path(root) / "bin" / "nvcc"
            if cand.is_file():
                return str(cand)
    return None


# -- pytrees ---------------------------------------------------------------------
# Dict keys flatten in sorted order, as jax.tree_util does, so the leaf
# order of a port pytree matches the reference's for the same structure.

def tree_flatten(tree: Any, is_leaf: Callable[[Any], bool] | None = None
                 ) -> tuple[list, Any]:
    """Leaves and a structure token for :func:`tree_unflatten`."""
    leaves: list = []

    def walk(node):
        if is_leaf is not None and is_leaf(node):
            leaves.append(node)
            return None
        if isinstance(node, dict):
            keys = sorted(node)
            return ("d", keys, [walk(node[k]) for k in keys])
        if isinstance(node, (list, tuple)):
            return ("l" if isinstance(node, list) else "t",
                    None, [walk(v) for v in node])
        if node is None:
            return ("n", None, [])
        leaves.append(node)
        return None

    return leaves, walk(tree)


def tree_unflatten(treedef: Any, leaves: list) -> Any:
    it = iter(leaves)

    def build(td):
        if td is None:
            return next(it)
        kind, keys, children = td
        if kind == "n":
            return None
        vals = [build(c) for c in children]
        if kind == "d":
            return dict(zip(keys, vals))
        return vals if kind == "l" else tuple(vals)

    return build(treedef)


def tree_leaves(tree: Any, is_leaf: Callable[[Any], bool] | None = None
                ) -> list:
    return tree_flatten(tree, is_leaf)[0]


def tree_map(fn: Callable, tree: Any, *rest: Any,
             is_leaf: Callable[[Any], bool] | None = None) -> Any:
    leaves, td = tree_flatten(tree, is_leaf)
    others = [tree_flatten(r, is_leaf)[0] for r in rest]
    return tree_unflatten(td, [fn(*xs) for xs in zip(leaves, *others)])
