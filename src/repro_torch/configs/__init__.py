"""Architecture registry of the port: the reference's ten configs.

MoE (kimi-k2-1t-a32b with GQA, deepseek-v2-236b with MLA), dense GQA/MHA
(qwen3-0.6b with qk-norm and tied embeddings, deepseek-7b, yi-6b,
minitron-4b), the stub-frontend families (internvl2-2b's vision and
musicgen-medium's audio frontends take precomputed embeddings), RWKV6
(rwkv6-1.6b) and the attention + SSM hybrid (hymba-1.5b).  An unknown name
raises ``KeyError``.
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

__all__ = ["ARCHS", "ARCH_IDS", "get_config", "get_reduced"]

ARCHS = ("kimi_k2_1t_a32b", "deepseek_v2_236b", "internvl2_2b", "yi_6b",
         "deepseek_7b", "minitron_4b", "qwen3_0_6b", "musicgen_medium",
         "rwkv6_1_6b", "hymba_1_5b")

#: canonical CLI ids (the reference's spelling) -> module names
_ALIAS = {"kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
          "deepseek-v2-236b": "deepseek_v2_236b",
          "internvl2-2b": "internvl2_2b", "yi-6b": "yi_6b",
          "deepseek-7b": "deepseek_7b", "minitron-4b": "minitron_4b",
          "qwen3-0.6b": "qwen3_0_6b", "musicgen-medium": "musicgen_medium",
          "rwkv6-1.6b": "rwkv6_1_6b", "hymba-1.5b": "hymba_1_5b"}

#: canonical arch ids
ARCH_IDS = tuple(_ALIAS)


def _module(name: str):
    mod = _ALIAS.get(name, name)
    if mod not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_ALIAS)}")
    return importlib.import_module(f"repro_torch.configs.{mod}")


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_reduced(name: str) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    return _module(name).reduced()
