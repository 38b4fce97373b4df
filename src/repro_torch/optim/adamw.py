"""AdamW with global-norm clipping, a cosine schedule and optional int8
error-feedback gradient compression: the port of ``repro.optim.adamw``.

The optimizer state is a plain nested dict of tensors beside the
parameters: ``{"m": <params tree>, "v": <params tree>, "count": int32 0-d}``
(and ``"ef"`` under ``compress="int8_ef"``), all fp32 and on each
parameter's device, so the reference's state converts leaf for leaf
(:func:`repro_torch.models.convert.train_state_from_numpy`) and a
checkpoint written by either package restores into the other.

Two entry points share one piece of arithmetic, the reference's:

* :func:`update_in_place` writes the new parameters, ``m``, ``v``,
  ``count`` (and ``ef``) into the tensors it is given, as XLA does with
  the state the reference's train step donates (``donate_argnums=0``).
  It walks each leaf in slices of its leading (layer) dim of at most
  :data:`SLICE_BYTES` of fp32, so no temporary is larger than one slice:
  at qwen3-0.6b in fp32 the update holds no second copy of params, m and
  v (7.2 GB) and no whole-leaf temporary.  The step builders call it for
  a handler registered with ``donate_argnums=0``.
* :func:`apply_updates` is functional, like the reference's: it clones
  the state (and, under ``int8_ef``, the gradients), runs
  :func:`update_in_place` on the clones and returns them, leaving its
  inputs unchanged (bit-equal to the in-place update by construction).
  An undonated step calls it, so a caller may keep the old state (a
  test's before/after comparison, a step replayed from one state).

Under a mesh each leaf is updated on this rank's shard (``to_local()``):
the gradient is placed as its parameter first, the state must be placed
as its parameter (:func:`opt_state_axes`), and the global norm and the
int8 scale are all-reduced over the mesh dims that split each leaf.  No
DTensor op strategy runs, so the update does not depend on a release's
op coverage.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch import compat
from repro_torch.distributed.sharding import (is_dtensor, local_like,
                                              local_view, reduce_over,
                                              shard_dims)

__all__ = ["OptConfig", "init_opt_state", "opt_state_axes", "apply_updates",
           "update_in_place", "cosine_lr", "SLICE_BYTES"]

#: the most fp32 bytes of a leaf that one slice of the in-place update
#: spans (its leading rows, at least one): each temporary is at most this
SLICE_BYTES = 64 << 20


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


def _quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8: ``round(x / scale)`` (a true division,
    rounded half to even as the reference's ``jnp.round``), clipped to
    +-127."""
    scale = torch.clamp(torch.max(torch.abs(x)), min=1e-12) / 127.0
    return _codes(x, scale), scale


def _codes(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)


def _rows(t: torch.Tensor):
    """Index slices of ``t``'s leading dim, each at most SLICE_BYTES of
    fp32 (at least one row); one ``...`` for a 0-d leaf."""
    if t.ndim == 0:
        yield ...
        return
    rows = max(1, SLICE_BYTES // max(4 * (t.numel() // max(t.shape[0], 1)),
                                     1))
    for i in range(0, t.shape[0], rows):
        yield slice(i, i + rows)


def _split_by(x: torch.Tensor) -> tuple[str, ...]:
    """The mesh dims that split ``x`` (none for a plain tensor)."""
    return tuple(n for d in shard_dims(x) for n in d)


def _reduce_leaves(values: list, like: list, op: str) -> list:
    """Each 0-d ``values[i]`` (a partial over this rank's shard of
    ``like[i]``) all-reduced with ``op`` over the mesh dims that split
    ``like[i]``: one collective per distinct set of dims."""
    groups: dict[tuple, list[int]] = {}
    for i, x in enumerate(like):
        dims = _split_by(x)
        if dims:
            groups.setdefault(dims, []).append(i)
    out = list(values)
    for dims, idx in groups.items():
        red = reduce_over(torch.stack([values[i] for i in idx]), op, dims,
                          like[idx[0]].device_mesh)
        for j, i in enumerate(idx):
            out[i] = red[j]
    return out


def _state_local(x: torch.Tensor, p: torch.Tensor, what: str
                 ) -> torch.Tensor:
    """This rank's shard of the state leaf ``x``, which must be placed as
    its parameter ``p`` is."""
    if is_dtensor(x) != is_dtensor(p) or (
            is_dtensor(p) and tuple(x.placements) != tuple(p.placements)):
        place = lambda t: tuple(t.placements) if is_dtensor(t) else "plain"
        raise ValueError(
            f"optimizer state {what!r} is placed as {place(x)}, its "
            f"parameter as {place(p)}: place the state by opt_state_axes")
    return local_view(x)


def _owned_fp32(g: torch.Tensor) -> torch.Tensor:
    """``g`` where it is a dense fp32 tensor the update may overwrite,
    else a dense fp32 copy."""
    if g.dtype == torch.float32 and g.is_contiguous():
        return g
    return g.to(torch.float32).contiguous()


@torch.no_grad()
def update_in_place(params: Any, grads: Any, state: dict,
                    cfg: OptConfig) -> tuple[Any, dict]:
    """One AdamW step written into ``params`` and ``state`` (``m``, ``v``,
    ``count``, and ``ef`` under ``int8_ef``); returns them, each leaf on
    its own storage.  Under ``int8_ef`` the gradients are consumed: each
    fp32 leaf is overwritten by its dequantized value.

    The reference's arithmetic: the gradients are compressed first under
    ``int8_ef`` (per-tensor scale), then clipped by their global norm
    (fp32, over every leaf); the bias corrections are ``1 - b ** count``
    in fp32 with ``count`` the int32 step after this one.  Weight decay
    applies to leaves of two or more dims only, as in the reference: the
    stacked per-layer norm weights ``(L, d)`` are decayed, ``final_norm``
    ``(d,)`` is not.  Every leaf is walked in slices of at most
    SLICE_BYTES (see the module docstring).
    """
    p_leaves = compat.tree_leaves(params)
    ps = [local_view(p) for p in p_leaves]
    gs = [local_like(g, p) for g, p in zip(compat.tree_leaves(grads),
                                           p_leaves)]
    ms = [_state_local(m, p, "m")
          for m, p in zip(compat.tree_leaves(state["m"]), p_leaves)]
    vs = [_state_local(v, p, "v")
          for v, p in zip(compat.tree_leaves(state["v"]), p_leaves)]
    count = local_view(state["count"])
    count.add_(1)
    zero = torch.zeros((), dtype=torch.float32, device=count.device)

    if cfg.compress == "int8_ef":
        # g' = deq(quant(g + ef)), ef' = (g + ef) - g', with the scale of
        # the whole leaf (its max over every rank's shard)
        es = [_state_local(e, p, "ef")
              for e, p in zip(compat.tree_leaves(state["ef"]), p_leaves)]
        gs = [_owned_fp32(g) for g in gs]
        amax = []
        for g, e in zip(gs, es):
            a = zero
            for sl in _rows(g):
                if g[sl].numel():
                    a = torch.maximum(a, torch.max(torch.abs(g[sl] + e[sl])))
            amax.append(a)
        amax = _reduce_leaves(amax, p_leaves, "max")
        for g, e, a in zip(gs, es, amax):
            scale = torch.clamp(a, min=1e-12) / 127.0
            for sl in _rows(g):
                gf = g[sl] + e[sl]
                d = _codes(gf, scale).to(torch.float32) * scale
                e[sl].copy_(gf - d)
                g[sl].copy_(d)

    sq = []
    for g in gs:
        s = zero
        for sl in _rows(g):
            s = s + torch.sum(torch.square(g[sl].to(torch.float32)))
        sq.append(s)
    gnorm = torch.sqrt(torch.sum(torch.stack(
        _reduce_leaves(sq, p_leaves, "sum"))))
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-12),
                        max=1.0)

    cf = count.to(torch.float32)
    lr = cosine_lr(cfg, cf)
    b1c = 1 - cfg.b1 ** cf
    b2c = 1 - cfg.b2 ** cf
    for p, g, m, v in zip(ps, gs, ms, vs):
        for sl in _rows(p):
            gi = g[sl].to(torch.float32) * scale
            mi = cfg.b1 * m[sl] + (1 - cfg.b1) * gi
            vi = cfg.b2 * v[sl] + (1 - cfg.b2) * torch.square(gi)
            step = (mi / b1c) / (torch.sqrt(vi / b2c) + cfg.eps)
            pf = p[sl].to(torch.float32)
            if p.ndim >= 2:
                step = step + cfg.weight_decay * pf
            p[sl].copy_(pf - lr * step)
            m[sl].copy_(mi)
            v[sl].copy_(vi)
    return params, state


def _clone(x: Any) -> Any:
    """A copy of a tensor leaf on storage of its own (a DTensor's shard
    cloned and placed as before)."""
    if not isinstance(x, torch.Tensor):
        return x
    if not is_dtensor(x):
        return x.clone()
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(x.to_local().clone(), x.device_mesh,
                              x.placements, run_check=False, shape=x.shape,
                              stride=x.stride())


@torch.no_grad()
def apply_updates(params: Any, grads: Any, state: dict,
                  cfg: OptConfig) -> tuple[Any, dict]:
    """One AdamW step: ``(new params, new state)``, out of place (the
    inputs are left unchanged): :func:`update_in_place` on clones."""
    params, state = compat.tree_map(_clone, (params, state))
    if cfg.compress == "int8_ef":
        grads = compat.tree_map(_clone, grads)
    return update_in_place(params, grads, state, cfg)
