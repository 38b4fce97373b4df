"""Model assembly for decode: embeddings -> GQA/SwiGLU layer stack -> LM head.

The port of the reference's dense decode path (``models/transformer.py``).
The model is plain functions over a dict of tensors, with the reference's
parameter layout: stacked ``dense_layers`` with a leading ``L`` axis,
``wq`` as ``(d, H, dh)`` and so on — so the reference's parameters convert
leaf for leaf (:mod:`repro_torch.models.convert`) and many specialized
variants share one copy of the weights.

Other mixers (MLA, RWKV6, Hymba) and MoE raise ``NotImplementedError``
(ROADMAP M7); the full-sequence ``apply`` waits for the flash-attention
kernel (ROADMAP K2).  Caches are updated in place (see
:mod:`repro_torch.models.attention`); every entry point still returns
``(logits, cache)``.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch import compat
from repro_torch.models import attention as attn_mod
from repro_torch.models.common import (KernelOptions, dense_init, embed_init,
                                       rms_norm, swiglu)
from repro_torch.models.config import ModelConfig

__all__ = ["RunOptions", "init_params", "param_axes", "init_cache",
           "cache_axes", "decode_step", "prefill_chunk", "lm_head_weight"]


@dataclasses.dataclass(frozen=True)
class RunOptions:
    """All step-level specialization choices, bundled.

    Populated from Iridescent spec points by the step builders; every field
    is a constant baked into the specialized variant.
    """

    kernels: KernelOptions = KernelOptions()
    window: int | None = None        # sliding-window override (long-context)
    decode_cache_dtype: str = "bfloat16"


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def _check_supported(cfg: ModelConfig) -> None:
    if cfg.mixer != "attn" or cfg.attn_kind != "gqa":
        raise NotImplementedError(
            f"{cfg.name}: mixer {cfg.mixer!r}/{cfg.attn_kind!r} is not "
            f"ported yet (ROADMAP M7); the port runs dense GQA models")
    if cfg.n_moe_layers:
        raise NotImplementedError(
            f"{cfg.name}: MoE layers are not ported yet (ROADMAP M7)")
    if cfg.frontend is not None:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.frontend} frontend is not ported yet "
            f"(ROADMAP M7)")


# -- params ------------------------------------------------------------------------

def _init_layer(gen: torch.Generator, cfg: ModelConfig) -> dict:
    d = cfg.d_model
    ones = lambda: torch.ones((d,), dtype=torch.float32, device=gen.device)
    return {"norm1": ones(),
            "mixer": attn_mod.init_gqa(gen, cfg),
            "norm2": ones(),
            "ffn": {"wg": dense_init(gen, (d, cfg.d_ff)),
                    "wu": dense_init(gen, (d, cfg.d_ff)),
                    "wd": dense_init(gen, (cfg.d_ff, d))}}


def _layer_axes(cfg: ModelConfig) -> dict:
    return {"norm1": (None,), "mixer": attn_mod.gqa_axes(cfg),
            "norm2": (None,),
            "ffn": {"wg": ("fsdp", "ffn"), "wu": ("fsdp", "ffn"),
                    "wd": ("ffn", "fsdp")}}


def _stack_axes(ax: dict) -> dict:
    """Prefix every leaf axes tuple with the stacked 'layers' dim."""
    return compat.tree_map(lambda t: ("layers",) + t, ax,
                           is_leaf=lambda x: isinstance(x, tuple))


def init_params(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """Random parameters on ``gen``'s device, drawn from ``gen``."""
    _check_supported(cfg)
    p: dict[str, Any] = {
        "embed": embed_init(gen, (cfg.padded_vocab_size, cfg.d_model)),
        "final_norm": torch.ones((cfg.d_model,), dtype=torch.float32,
                                 device=gen.device),
    }
    layers = [_init_layer(gen, cfg) for _ in range(cfg.n_layers)]
    p["dense_layers"] = compat.tree_map(lambda *ls: torch.stack(ls), *layers)
    del layers
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(gen, (cfg.d_model, cfg.padded_vocab_size))
    return p


def param_axes(cfg: ModelConfig) -> dict:
    _check_supported(cfg)
    ax: dict[str, Any] = {
        "embed": ("vocab", "embed"),
        "final_norm": (None,),
        "dense_layers": _stack_axes(_layer_axes(cfg)),
    }
    if not cfg.tie_embeddings:
        ax["lm_head"] = ("fsdp", "vocab")
    return ax


def lm_head_weight(params: dict, cfg: ModelConfig) -> torch.Tensor:
    cdt = _dtype(cfg.compute_dtype)
    return (params["embed"].T if cfg.tie_embeddings
            else params["lm_head"]).to(cdt)


# -- decode ------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               opts: RunOptions | None = None,
               device: torch.device | str = "cpu") -> dict:
    """Per-layer KV caches stacked on a leading ``L`` axis."""
    _check_supported(cfg)
    opts = opts or RunOptions()
    one = attn_mod.init_gqa_cache(cfg, batch, max_len, window=opts.window,
                                  dtype=_dtype(opts.decode_cache_dtype),
                                  device=device)
    return {k: v[None].repeat((cfg.n_layers,) + (1,) * v.ndim)
            for k, v in one.items()}


def cache_axes(cfg: ModelConfig) -> dict:
    _check_supported(cfg)
    return _stack_axes(attn_mod.gqa_cache_axes(cfg))


def _layer_decode(lp: dict, lc: dict, x: torch.Tensor, pos: torch.Tensor,
                  cfg: ModelConfig, opts: RunOptions):
    ko = opts.kernels
    xin = rms_norm(x, lp["norm1"], cfg.rms_eps, ko)
    h, lc = attn_mod.decode_gqa(lp["mixer"], lc, xin, pos, cfg, ko,
                                window=opts.window)
    x = x + h
    xin2 = rms_norm(x, lp["norm2"], cfg.rms_eps, ko)
    ff = lp["ffn"]
    f = swiglu(xin2, ff["wg"].to(xin2.dtype), ff["wu"].to(xin2.dtype),
               ff["wd"].to(xin2.dtype))
    return x + f, lc


def _layer(tree: dict, i: int) -> dict:
    """Layer ``i`` of a stacked pytree (views: in-place writes land in
    the stacked tensors)."""
    return compat.tree_map(lambda a: a[i], tree)


def decode_step(params: dict, cache: dict, tokens: torch.Tensor,
                pos: torch.Tensor, cfg: ModelConfig,
                opts: RunOptions) -> tuple[torch.Tensor, dict]:
    """One decode step. tokens (B,) int, pos scalar or (B,) ->
    (logits (B,V), cache).  ``cache`` is updated in place and returned."""
    _check_supported(cfg)
    cdt = _dtype(cfg.compute_dtype)
    x = params["embed"][tokens.long()].to(cdt)[:, None]     # (B,1,d)
    stacked = params["dense_layers"]
    for i in range(cfg.n_layers):
        x, _ = _layer_decode(_layer(stacked, i), _layer(cache, i), x, pos,
                             cfg, opts)
    xf = rms_norm(x, params["final_norm"], cfg.rms_eps, opts.kernels)
    head = lm_head_weight(params, cfg)
    logits = (xf[:, 0] @ head).to(torch.float32)
    return logits[:, : cfg.vocab_size], cache


def _select_rows(active: torch.Tensor, pos: torch.Tensor,
                 max_len: int) -> torch.Tensor:
    """Per-row write positions that leave inactive rows' caches as they
    were: an inactive row is sent past the cache (``max_len``), where the
    in-place attention write stores nothing.  The reference instead runs
    the step on every row and selects each cache leaf's rows afterwards;
    with in-place writes the selection happens at the write."""
    return torch.where(active, pos, torch.full_like(pos, max_len))


def prefill_chunk(params: dict, cache: dict, tokens: torch.Tensor,
                  pos: torch.Tensor, n_new: torch.Tensor, cfg: ModelConfig,
                  opts: RunOptions) -> tuple[torch.Tensor, dict]:
    """Chunked prefill: consume up to C prompt tokens per row.

    ``tokens (B,C)`` (pad with any valid id), ``pos (B,)`` per-row start
    positions, ``n_new (B,)`` valid token counts (<= C; rows may differ —
    a short row goes inactive once its tokens are consumed).  Returns
    ``(logits (B,V) at each row's last consumed token, cache)``; rows with
    ``n_new == 0`` get zero logits.

    A loop of single-token vector-pos decode steps with per-row masking,
    as the reference's ``lax.scan``.
    """
    b, c = tokens.shape
    max_len = cache["k"].shape[3]
    logits = torch.zeros((b, cfg.vocab_size), dtype=torch.float32,
                         device=tokens.device)
    for t in range(c):
        step_pos = _select_rows(t < n_new, pos + t, max_len)
        lg, cache = decode_step(params, cache, tokens[:, t], step_pos, cfg,
                                opts)
        logits = torch.where((n_new - 1 == t)[:, None], lg, logits)
    return logits, cache
