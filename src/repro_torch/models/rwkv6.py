"""RWKV6 "Finch" (arXiv:2404.05892): attention-free token mixer with
data-dependent decay, + squared-relu channel mix.

The port of the reference's ``models/rwkv6.py``, leaf for leaf in its
parameter layout.  Token-shift lerps for r/k/v/g/w, a LoRA producing the
per-step per-channel decay ``w_t``, per-head bonus ``u``, per-head output
norm (through the RMSNorm kernel), gated output.  As in the reference, the
r/k/v/g token-shift mix coefficients are static learned vectors and the
log-decay is clamped to ``[LOG_W_MIN, -1e-4]`` for fp32-safe chunked
evaluation (chunk <= 64).

The full-sequence forward runs the chunked linear-attention op (its CUDA
kernel under ``linear_attention_impl=cuda``); decode advances the
``(H, hs, hs)`` state directly.  The decode cache is updated in place, as
the port's attention caches are: the returned cache holds the tensors
passed in.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import compat
from repro_torch.distributed.sharding import (constrain, current_mesh,
                                              from_local, local_shard,
                                              logical_to_spec, write_local)
from repro_torch.kernels.linear_attention import linear_attention
from repro_torch.models.chunk_scan import step_linear_attention
from repro_torch.models.common import KernelOptions, dense_init, rms_norm
from repro_torch.models.config import ModelConfig

__all__ = ["init_rwkv6", "rwkv6_axes", "apply_rwkv6",
           "apply_rwkv6_channel_mix", "init_rwkv6_cache", "rwkv6_cache_axes",
           "decode_rwkv6", "LOG_W_MIN"]

LOG_W_MIN = -1.0        # per-step log-decay clamp (chunk-safety, see module doc)
_DECAY_LORA = 64


def init_rwkv6(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """Random parameters on ``gen``'s device, drawn from ``gen``."""
    d = cfg.d_model
    hs = cfg.rwkv_head_size
    h = cfg.rwkv_heads
    full = lambda value: torch.full((d,), value, dtype=torch.float32,
                                    device=gen.device)
    return {
        # token-shift mix coefficients (static lerp weights in [0,1])
        "mu_r": full(0.5), "mu_k": full(0.5), "mu_v": full(0.5),
        "mu_g": full(0.5), "mu_w": full(0.5),
        "wr": dense_init(gen, (d, d)),
        "wk": dense_init(gen, (d, d)),
        "wv": dense_init(gen, (d, d)),
        "wg": dense_init(gen, (d, d)),
        "wo": dense_init(gen, (d, d)),
        # data-dependent decay: w0 + tanh(x @ A) @ B   (Finch LoRA)
        "w0": full(-0.6),
        "w_lora_a": dense_init(gen, (d, _DECAY_LORA)),
        "w_lora_b": dense_init(gen, (_DECAY_LORA, d)) * 0.1,
        "u": dense_init(gen, (h, hs)) * 0.1,           # per-head bonus
        "ln_x": full(1.0),                             # output group norm
        # channel mix
        "cm_mu_k": full(0.5),
        "cm_wk": dense_init(gen, (d, cfg.d_ff)),
        "cm_wv": dense_init(gen, (cfg.d_ff, d)),
        "cm_wr": dense_init(gen, (d, d)),
    }


def rwkv6_axes(cfg: ModelConfig) -> dict:
    return {
        "mu_r": (None,), "mu_k": (None,), "mu_v": (None,), "mu_g": (None,),
        "mu_w": (None,),
        "wr": ("fsdp", "heads"), "wk": ("fsdp", "heads"),
        "wv": ("fsdp", "heads"), "wg": ("fsdp", "heads"),
        "wo": ("heads", "fsdp"),
        "w0": (None,), "w_lora_a": ("fsdp", None), "w_lora_b": (None, "fsdp"),
        "u": (None, None), "ln_x": (None,),
        "cm_mu_k": (None,),
        "cm_wk": ("fsdp", "ffn"), "cm_wv": ("ffn", "fsdp"),
        "cm_wr": ("fsdp", None),
    }


def _log_decay(p: dict, xw: torch.Tensor) -> torch.Tensor:
    """Finch data-dependent per-channel log decay, clamped for chunking
    (in fp32, or float64 for a float64 ``xw``)."""
    acc = torch.promote_types(xw.dtype, torch.float32)
    lora = torch.tanh(xw @ p["w_lora_a"].to(xw.dtype)) \
        @ p["w_lora_b"].to(xw.dtype)
    raw = -torch.exp(torch.clamp(p["w0"].to(acc) + lora.to(acc), -8.0, 1.0))
    return torch.clamp(raw, LOG_W_MIN, -1e-4)


def _mix(x: torch.Tensor, x_prev: torch.Tensor,
         mu: torch.Tensor) -> torch.Tensor:
    return x + (x_prev - x) * mu.to(x.dtype)


def _shift(x: torch.Tensor) -> torch.Tensor:
    """The previous token of each position (zeros before the first)."""
    return F.pad(x, (0, 0, 1, 0))[:, :-1]


def _time_mix_inputs(p: dict, x: torch.Tensor, x_prev: torch.Tensor):
    """Shared by the forward and decode: r/k/v/g and the decay from the
    shifted x."""
    cdt = x.dtype
    r = _mix(x, x_prev, p["mu_r"]) @ p["wr"].to(cdt)
    k = _mix(x, x_prev, p["mu_k"]) @ p["wk"].to(cdt)
    v = _mix(x, x_prev, p["mu_v"]) @ p["wv"].to(cdt)
    g = F.silu(_mix(x, x_prev, p["mu_g"]) @ p["wg"].to(cdt))
    lw = _log_decay(p, _mix(x, x_prev, p["mu_w"]))
    return r, k, v, g, lw


def _heads(x: torch.Tensor, h: int, hs: int) -> torch.Tensor:
    return x.reshape(x.shape[:-1] + (h, hs))


def _head_norm(o: torch.Tensor, cfg: ModelConfig,
               opts: KernelOptions) -> torch.Tensor:
    """The per-head output norm (unit weight), through the RMSNorm op."""
    ones = torch.ones((cfg.rwkv_head_size,), dtype=torch.float32,
                      device=o.device)
    return rms_norm(o, ones, cfg.rms_eps, opts)


def apply_rwkv6(p: dict, x: torch.Tensor, cfg: ModelConfig,
                opts: KernelOptions) -> torch.Tensor:
    """Time-mix over the full sequence. x (B,S,d) -> (B,S,d)."""
    b, s, d = x.shape
    h, hs = cfg.rwkv_heads, cfg.rwkv_head_size
    r, k, v, g, lw = _time_mix_inputs(p, x, _shift(x))
    # (B,S,d) -> (B,H,S,hs); under a mesh the scan runs on each rank's
    # batch rows and heads (DTensor cannot fold sharded (B, H) into rows)
    rh, kh, vh, wh = (constrain(_heads(t, h, hs).transpose(1, 2),
                                ("batch", "heads", "seq", None))
                      for t in (r, k, v, lw))
    u = p["u"].to(torch.float32)
    mesh = current_mesh()
    spec = logical_to_spec(("batch", "heads"), (b, h)) if mesh else ()
    if mesh is not None:
        batch = spec[0] if spec else None
        batch = (batch,) if isinstance(batch, str) else (batch or ())
        rh, kh, vh, wh = (local_shard(t, mesh, spec)
                          for t in (rh, kh, vh, wh))
        u = local_shard(u, mesh, spec[1:], {n: "partial" for n in batch})
    bl, hl = rh.shape[:2]
    o = linear_attention(
        *(t.reshape(bl * hl, s, hs) for t in (rh, kh, vh, wh)),
        bonus=u[None].expand(bl, hl, hs).reshape(bl * hl, hs),
        inclusive=False, chunk=min(opts.chunk_len, s),
        impl=opts.impl_for("linear_attention"))
    o = from_local(o.reshape(bl, hl, s, hs), mesh, spec)
    o = o.transpose(1, 2)                             # (B,S,H,hs)
    o = _head_norm(o, cfg, opts)
    o = o.reshape(b, s, d) * p["ln_x"].to(x.dtype) * g
    return constrain(o @ p["wo"].to(x.dtype), ("batch", "seq", None))


def apply_rwkv6_channel_mix(p: dict, x: torch.Tensor, cfg: ModelConfig,
                            x_prev: torch.Tensor | None = None
                            ) -> torch.Tensor:
    """Squared-relu channel mix (the rwkv 'ffn'). x (B,S,d) -> (B,S,d)."""
    if x_prev is None:
        x_prev = _shift(x)
    cdt = x.dtype
    xk = _mix(x, x_prev, p["cm_mu_k"])
    kk = torch.square(F.relu(xk @ p["cm_wk"].to(cdt)))
    kk = constrain(kk, ("batch", "seq", "ffn"))
    rr = torch.sigmoid(x @ p["cm_wr"].to(cdt))
    return rr * (kk @ p["cm_wv"].to(cdt))


# -- decode ---------------------------------------------------------------------

def init_rwkv6_cache(cfg: ModelConfig, batch: int, max_len: int = 0,
                     window: int | None = None,
                     dtype: torch.dtype = torch.float32,
                     device: torch.device | str | None = None) -> dict:
    """Recurrent row state: the fp32 wkv state and the two token shifts.
    O(1) in sequence length (``max_len`` and ``window`` are unused);
    ``device`` defaults to ``cuda`` (:func:`compat.resolve_device`)."""
    del max_len, window
    device = compat.resolve_device(device)
    h, hs, d = cfg.rwkv_heads, cfg.rwkv_head_size, cfg.d_model
    return {
        "state": torch.zeros((batch, h, hs, hs), dtype=torch.float32,
                             device=device),
        "x_tm": torch.zeros((batch, d), dtype=dtype, device=device),
        "x_cm": torch.zeros((batch, d), dtype=dtype, device=device),
    }


def rwkv6_cache_axes(cfg: ModelConfig) -> dict:
    return {"state": ("batch", "heads", None, None),
            "x_tm": ("batch", None), "x_cm": ("batch", None)}


def decode_rwkv6(p: dict, cache: dict, x: torch.Tensor, pos,
                 cfg: ModelConfig, opts: KernelOptions,
                 **_) -> tuple[torch.Tensor, dict]:
    """One step of time-mix. x (B,1,d) -> ((B,1,d), cache); ``state`` and
    ``x_tm`` are written in place (``pos`` is unused: the state is the
    whole history)."""
    b, _, d = x.shape
    h, hs = cfg.rwkv_heads, cfg.rwkv_head_size
    xt = x[:, 0]
    x_prev = cache["x_tm"].to(xt.dtype)
    r, k, v, g, lw = _time_mix_inputs(p, xt, x_prev)
    o, new_state = step_linear_attention(
        _heads(r, h, hs), _heads(k, h, hs), _heads(v, h, hs),
        _heads(lw, h, hs), cache["state"], bonus=p["u"])
    o = _head_norm(o, cfg, opts)
    o = o.reshape(b, d) * p["ln_x"].to(x.dtype) * g
    y = (o @ p["wo"].to(x.dtype))[:, None]
    # under a mesh each rank writes its own rows and heads of the state
    write_local(cache["state"], new_state)
    write_local(cache["x_tm"], xt)
    return y, cache
