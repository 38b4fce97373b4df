"""AdamW with global-norm clipping, a cosine schedule and optional int8
error-feedback gradient compression: the port of ``repro.optim.adamw``.

The optimizer state is a plain nested dict of tensors beside the
parameters: ``{"m": <params tree>, "v": <params tree>, "count": int32 0-d}``
(and ``"ef"`` under ``compress="int8_ef"``), all fp32 and on each
parameter's device, so the reference's state converts leaf for leaf
(:func:`repro_torch.models.convert.train_state_from_numpy`) and a
checkpoint written by either package restores into the other.

:func:`apply_updates` is functional, like the reference's: it returns new
parameter and state trees and leaves its inputs unchanged.  The
reference's CLI donates the input state to the jitted step; the port keeps
both copies for the length of the update instead (a second copy of params,
m and v: 7.2 GB at qwen3-0.6b in fp32), so a caller may keep the old state
(the checkpoint store's async writer, a test's before/after comparison)
without cloning it.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch import compat

__all__ = ["OptConfig", "init_opt_state", "opt_state_axes", "apply_updates",
           "cosine_lr"]


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    compress: str = "none"           # none | int8_ef  (spec point)


def cosine_lr(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup to ``cfg.lr``, then a cosine decay to 0 at
    ``total_steps``; ``step`` a float32 tensor, the result float32."""
    step = torch.as_tensor(step, dtype=torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    return cfg.lr * warm * 0.5 * (1 + torch.cos(math.pi * prog))


def init_opt_state(params: Any, cfg: OptConfig) -> dict:
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)
    leaf = compat.tree_leaves(params)[0]
    state = {
        "m": compat.tree_map(zeros, params),
        "v": compat.tree_map(zeros, params),
        "count": torch.zeros((), dtype=torch.int32, device=leaf.device),
    }
    if cfg.compress == "int8_ef":
        state["ef"] = compat.tree_map(zeros, params)  # error feedback
    return state


def opt_state_axes(param_axes: Any, cfg: OptConfig) -> dict:
    ax = {"m": param_axes, "v": param_axes, "count": ()}
    if cfg.compress == "int8_ef":
        ax["ef"] = param_axes
    return ax


def _global_norm(tree: Any) -> torch.Tensor:
    """The l2 norm over every leaf, in fp32."""
    leaves = [torch.sum(torch.square(x.to(torch.float32)))
              for x in compat.tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def _quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8: ``round(x / scale)`` (a true division,
    rounded half to even as the reference's ``jnp.round``), clipped to
    +-127."""
    scale = torch.clamp(torch.max(torch.abs(x)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _compress_ef(grads: Any, ef: Any) -> tuple[Any, Any]:
    """int8 quantization with error feedback: g' = deq(quant(g + ef)),
    ef' = (g + ef) - g'.  Unbiased-in-the-limit; the wire format (int8 +
    fp32 scale) is what a compressed all-reduce would ship."""
    g_leaves, treedef = compat.tree_flatten(grads)
    deq, new_ef = [], []
    for g, e in zip(g_leaves, compat.tree_leaves(ef)):
        gf = g.to(torch.float32) + e
        q, scale = _quantize_int8(gf)
        d = q.to(torch.float32) * scale
        deq.append(d)
        new_ef.append(gf - d)
    return (compat.tree_unflatten(treedef, deq),
            compat.tree_unflatten(treedef, new_ef))


@torch.no_grad()
def apply_updates(params: Any, grads: Any, state: dict,
                  cfg: OptConfig) -> tuple[Any, dict]:
    """One AdamW step: ``(new params, new state)``, out of place (the
    inputs are left unchanged; see the module docstring).

    The gradients are compressed first under ``int8_ef``, then clipped by
    their global norm (fp32, over every leaf); the bias corrections are
    ``1 - b ** count`` in fp32 with ``count`` the int32 step after this
    one.  Weight decay applies to leaves of two or more dims only, as in
    the reference: the stacked per-layer norm weights ``(L, d)`` are
    decayed, ``final_norm`` ``(d,)`` is not.
    """
    count = state["count"] + 1
    new_state = dict(state, count=count)

    if cfg.compress == "int8_ef":
        grads, new_ef = _compress_ef(grads, state["ef"])
        new_state["ef"] = new_ef

    gnorm = _global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-12),
                        max=1.0)

    cf = count.to(torch.float32)
    lr = cosine_lr(cfg, cf)
    b1c = 1 - cfg.b1 ** cf
    b2c = 1 - cfg.b2 ** cf

    p_leaves, treedef = compat.tree_flatten(params)
    new_p, new_m, new_v = [], [], []
    for p, g, m, v in zip(p_leaves, compat.tree_leaves(grads),
                          compat.tree_leaves(state["m"]),
                          compat.tree_leaves(state["v"])):
        g = g.to(torch.float32) * scale
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * torch.square(g)
        step = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        pf = p.to(torch.float32)
        if p.ndim >= 2:
            step = step + cfg.weight_decay * pf
        new_p.append((pf - lr * step).to(p.dtype))
        new_m.append(m)
        new_v.append(v)
    new_state["m"] = compat.tree_unflatten(treedef, new_m)
    new_state["v"] = compat.tree_unflatten(treedef, new_v)
    return compat.tree_unflatten(treedef, new_p), new_state
