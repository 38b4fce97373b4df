"""Architecture registry of the port: the configs ported so far.

qwen3-0.6b (dense GQA with qk-norm and tied embeddings) and rwkv6-1.6b
(attention-free, chunked linear attention) run on the port today; asking
for another of the reference's architectures raises ``KeyError`` naming
the ROADMAP item that brings it (M7).
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

__all__ = ["ARCHS", "ARCH_IDS", "get_config", "get_reduced"]

ARCHS = ("qwen3_0_6b", "rwkv6_1_6b")

#: canonical CLI ids (the reference's spelling) -> module names
_ALIAS = {"qwen3-0.6b": "qwen3_0_6b", "rwkv6-1.6b": "rwkv6_1_6b"}

#: canonical arch ids
ARCH_IDS = tuple(_ALIAS)


def _module(name: str):
    mod = _ALIAS.get(name, name)
    if mod not in ARCHS:
        raise KeyError(f"arch {name!r} is not ported yet (ROADMAP M7); "
                       f"the port has {sorted(_ALIAS)}")
    return importlib.import_module(f"repro_torch.configs.{mod}")


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_reduced(name: str) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    return _module(name).reduced()
