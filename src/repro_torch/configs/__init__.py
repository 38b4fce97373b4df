"""Architecture registry of the port: the reference's ten configs.

MoE (kimi-k2-1t-a32b with GQA, deepseek-v2-236b with MLA), dense GQA/MHA
(qwen3-0.6b with qk-norm and tied embeddings, deepseek-7b, yi-6b,
minitron-4b), the stub-frontend families (internvl2-2b's vision and
musicgen-medium's audio frontends take precomputed embeddings), RWKV6
(rwkv6-1.6b) and the attention + SSM hybrid (hymba-1.5b).  An unknown name
raises ``KeyError``.

The shape registry (:class:`Shape`, :data:`SHAPES`) is the reference's:
the input shapes the dry run (:mod:`repro_torch.launch.dryrun`) takes
each architecture through.
"""
from __future__ import annotations

import dataclasses
import importlib

import torch

from repro_torch.models.config import ModelConfig

__all__ = ["ARCHS", "ARCH_IDS", "get_config", "get_reduced", "Shape",
           "SHAPES", "supported_shapes", "input_specs"]

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


@dataclasses.dataclass(frozen=True)
class Shape:
    name: str
    kind: str                  # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": Shape("train_4k", "train", 4_096, 256),
    "prefill_32k": Shape("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": Shape("decode_32k", "decode", 32_768, 128),
    "long_500k": Shape("long_500k", "decode", 524_288, 1),
}


def supported_shapes(cfg: ModelConfig) -> list[str]:
    """long_500k needs sub-quadratic attention; skip for pure full-attention
    archs."""
    out = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.mixer in ("rwkv6", "hymba"):
        out.append("long_500k")
    return out


def input_specs(cfg: ModelConfig, shape: Shape) -> dict:
    """Stand-ins for the step inputs of (cfg, shape): tensors on the
    ``meta`` device, of the reference's shapes and dtypes (int32 tokens and
    labels, fp32 embeds)."""
    b, s = shape.global_batch, shape.seq_len
    meta = lambda shp, dt: torch.empty(shp, dtype=dt, device="meta")
    if shape.kind in ("train", "prefill"):
        if cfg.frontend is not None:
            specs = {"embeds": meta((b, s, cfg.d_model), torch.float32)}
        else:
            specs = {"tokens": meta((b, s), torch.int32)}
        if shape.kind == "train":
            specs["labels"] = meta((b, s), torch.int32)
        return specs
    # decode: one new token against a seq_len cache
    return {"tokens": meta((b,), torch.int32),
            "pos": meta((), torch.int32)}
