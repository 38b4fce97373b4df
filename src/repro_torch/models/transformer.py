"""Model assembly: embeddings -> mixer/FFN layer stack -> LM head.

The port of the reference's ``models/transformer.py`` for every mixer
and FFN it has.  Mixers: GQA/MHA (qwen3, deepseek-7b, yi-6b, minitron-4b,
kimi-k2, and the stub-frontend internvl2-2b and musicgen-medium, whose
``apply`` takes precomputed ``embeds``), MLA (deepseek-v2), RWKV6 (time
mix through the chunked linear attention, channel mix in place of the
FFN) and Hymba (sliding-window attention and SSM heads side by side, each
output normalised, averaged).  FFNs: SwiGLU, or, after a dense prefix of
``n_layers - n_moe_layers`` layers, MoE (kimi-k2, deepseek-v2).
It holds the full-sequence forward ``apply`` (prefill; its attention runs
the flash attention kernel, its RWKV6 time mix and SSM heads the
linear-attention kernel) and the cached ``decode_step``/``prefill_chunk``
of the serve step.  The model is
plain functions over a dict of tensors, with the reference's parameter
layout: stacked ``dense_layers`` and ``moe_layers`` with a leading ``L``
axis, ``wq`` as ``(d, H, dh)`` and so on — so the reference's parameters
convert leaf for leaf (:mod:`repro_torch.models.convert`) and many
specialized variants share one copy of the weights.

The layer stack is a Python loop (the reference's ``lax.scan`` over
layers has no counterpart: eager PyTorch pays nothing per layer to
compile).  Activation checkpointing of each layer is a spec point
(``RunOptions.remat`` in {none, dots, full}, :func:`_remat_wrap`); it
changes the memory a differentiated step holds, never its result.
Caches are updated in place
(see :mod:`repro_torch.models.attention`, :mod:`repro_torch.models.mla`
and :mod:`repro_torch.models.rwkv6`); the decode entry points still
return ``(logits, cache)``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable

import torch
import torch.utils.checkpoint as torch_checkpoint

from repro_torch import compat
from repro_torch.distributed.sharding import (PartitionSpec, constrain,
                                              current_mesh, entry_dims,
                                              from_local, is_dtensor,
                                              local_shard,
                                              local_start, local_view,
                                              logical_to_spec, mesh_shape,
                                              shard_dims, spec_of_dims,
                                              write_local)
from repro_torch.models import attention as attn_mod
from repro_torch.models import mla as mla_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import rwkv6 as rwkv_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import (KernelOptions, dense_init, embed_init,
                                       rms_norm, swiglu)
from repro_torch.models.config import ModelConfig
from repro_torch.models.moe import MoEOptions

__all__ = ["RunOptions", "check_supported", "init_params", "param_axes",
           "apply", "init_cache",
           "cache_axes", "decode_step", "prefill_chunk", "lm_head_weight",
           "head_logits"]


@dataclasses.dataclass(frozen=True)
class RunOptions:
    """All step-level specialization choices, bundled.

    Populated from Iridescent spec points by the step builders; every field
    is a constant baked into the specialized variant.
    """

    kernels: KernelOptions = KernelOptions()
    moe: MoEOptions = MoEOptions()
    remat: str = "none"              # none | dots | full
    window: int | None = None        # sliding-window override (long-context)
    logits_dtype: str = "float32"
    decode_cache_dtype: str = "bfloat16"


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for a mixer the port does not have."""
    if cfg.mixer not in ("attn", "rwkv6", "hymba") or \
            cfg.attn_kind not in ("gqa", "mla"):
        raise NotImplementedError(
            f"{cfg.name}: no mixer {cfg.mixer!r}/{cfg.attn_kind!r}; the "
            f"port has attn (gqa, mla), rwkv6 and hymba")


# -- params ------------------------------------------------------------------------

def _init_mixer(gen: torch.Generator, cfg: ModelConfig) -> dict:
    if cfg.mixer == "hymba":
        ones = lambda: torch.ones((cfg.d_model,), dtype=torch.float32,
                                  device=gen.device)
        return {"attn": attn_mod.init_gqa(gen, cfg),
                "ssm": ssm_mod.init_ssm(gen, cfg),
                "norm_a": ones(), "norm_s": ones()}
    if cfg.attn_kind == "mla":
        return mla_mod.init_mla(gen, cfg)
    return attn_mod.init_gqa(gen, cfg)


def _mixer_axes(cfg: ModelConfig) -> dict:
    if cfg.mixer == "rwkv6":
        return rwkv_mod.rwkv6_axes(cfg)
    if cfg.mixer == "hymba":
        return {"attn": attn_mod.gqa_axes(cfg), "ssm": ssm_mod.ssm_axes(cfg),
                "norm_a": (None,), "norm_s": (None,)}
    if cfg.attn_kind == "mla":
        return mla_mod.mla_axes(cfg)
    return attn_mod.gqa_axes(cfg)


def _init_layer(gen: torch.Generator, cfg: ModelConfig, moe: bool) -> dict:
    d = cfg.d_model
    ones = lambda: torch.ones((d,), dtype=torch.float32, device=gen.device)
    if cfg.mixer == "rwkv6":
        # the channel mix's parameters live inside the mixer dict
        return {"norm1": ones(), "mixer": rwkv_mod.init_rwkv6(gen, cfg),
                "norm2": ones()}
    p = {"norm1": ones(), "mixer": _init_mixer(gen, cfg), "norm2": ones()}
    if moe:
        p["moe"] = moe_mod.init_moe(gen, cfg)
    else:
        p["ffn"] = {"wg": dense_init(gen, (d, cfg.d_ff)),
                    "wu": dense_init(gen, (d, cfg.d_ff)),
                    "wd": dense_init(gen, (cfg.d_ff, d))}
    return p


def _layer_axes(cfg: ModelConfig, moe: bool) -> dict:
    ax = {"norm1": (None,), "mixer": _mixer_axes(cfg), "norm2": (None,)}
    if cfg.mixer == "rwkv6":
        pass
    elif moe:
        ax["moe"] = moe_mod.moe_axes(cfg)
    else:
        ax["ffn"] = {"wg": ("fsdp", "ffn"), "wu": ("fsdp", "ffn"),
                     "wd": ("ffn", "fsdp")}
    return ax


def _stack_axes(ax: dict) -> dict:
    """Prefix every leaf axes tuple with the stacked 'layers' dim."""
    return compat.tree_map(lambda t: ("layers",) + t, ax,
                           is_leaf=lambda x: isinstance(x, tuple))


class _StackDraw:
    """Stands in for the generator while a layer initializer runs:
    ``dense_init`` asks it for each normal draw in turn (:meth:`normal`).

    The shape pass (``slots=None``) draws nothing: its tensors are on the
    meta device, and ``draws`` keeps them in draw order, so that the
    leaves that are a draw as it came (no arithmetic after it) can be told
    apart.  A drawing pass fills ``slots[j]``, the layer's slice of the
    stacked leaf that draw ``j`` is, in place from ``gen``; a draw without
    a slot (None) is made fresh.
    """

    def __init__(self, gen: torch.Generator, slots: list | None = None):
        self.gen = gen
        self.slots = slots
        self.device = gen.device if slots is not None else \
            torch.device("meta")
        self.draws: list[torch.Tensor] = []

    def normal(self, shape: tuple) -> torch.Tensor:
        if self.slots is None:
            out = torch.empty(shape, dtype=torch.float32, device="meta")
        else:
            out = self.slots[len(self.draws)]
            if out is None:
                out = torch.empty(shape, dtype=torch.float32,
                                  device=self.device)
            out.normal_(generator=self.gen)
        self.draws.append(out)
        return out


def _init_stack(gen: torch.Generator, n: int,
                init: Callable[[Any], dict]) -> dict:
    """``n`` layers of ``init`` stacked on a leading axis, each stacked
    leaf allocated once and every layer drawn into its slice, from ``gen``
    in the order ``n`` calls of ``init(gen)`` would draw them (a list of
    layers and a ``torch.stack`` would hold two copies of the stack)."""
    shape = _StackDraw(gen)
    tree = init(shape)
    leaves, treedef = compat.tree_flatten(tree)
    stacked = [torch.empty((n,) + tuple(leaf.shape), dtype=leaf.dtype,
                           device=gen.device) for leaf in leaves]
    # which draw, if any, each leaf is as it came
    drawn = {id(t): j for j, t in enumerate(shape.draws)}
    as_drawn = {drawn[id(leaf)]: i for i, leaf in enumerate(leaves)
                if id(leaf) in drawn}
    for layer in range(n):
        draw = _StackDraw(gen, [
            stacked[as_drawn[j]][layer] if j in as_drawn else None
            for j in range(len(shape.draws))])
        for i, leaf in enumerate(compat.tree_leaves(init(draw))):
            dest = stacked[i][layer]
            if leaf.data_ptr() != dest.data_ptr():
                dest.copy_(leaf)
    return compat.tree_unflatten(treedef, stacked)


def init_params(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """Random parameters on ``gen``'s device, drawn from ``gen``: the
    embedding, the ``n_layers - n_moe_layers`` dense layers, the MoE
    layers, then the untied LM head."""
    check_supported(cfg)
    n_moe = cfg.n_moe_layers
    n_dense = cfg.n_layers - n_moe
    p: dict[str, Any] = {
        "embed": embed_init(gen, (cfg.padded_vocab_size, cfg.d_model)),
        "final_norm": torch.ones((cfg.d_model,), dtype=torch.float32,
                                 device=gen.device),
    }
    if n_dense:
        p["dense_layers"] = _init_stack(
            gen, n_dense, lambda g: _init_layer(g, cfg, moe=False))
    if n_moe:
        p["moe_layers"] = _init_stack(
            gen, n_moe, lambda g: _init_layer(g, cfg, moe=True))
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(gen, (cfg.d_model, cfg.padded_vocab_size))
    return p


def param_axes(cfg: ModelConfig) -> dict:
    check_supported(cfg)
    n_moe = cfg.n_moe_layers
    ax: dict[str, Any] = {
        "embed": ("vocab", "embed"),
        "final_norm": (None,),
    }
    if cfg.n_layers - n_moe:
        ax["dense_layers"] = _stack_axes(_layer_axes(cfg, moe=False))
    if n_moe:
        ax["moe_layers"] = _stack_axes(_layer_axes(cfg, moe=True))
    if not cfg.tie_embeddings:
        ax["lm_head"] = ("fsdp", "vocab")
    return ax


# -- forward ----------------------------------------------------------------------

def _window(cfg: ModelConfig, opts: RunOptions) -> int | None:
    """The attention window: the override, else (Hymba) the config's."""
    if cfg.mixer == "hymba" and opts.window is None:
        return cfg.window
    return opts.window


def _hymba_combine(lp: dict, a: torch.Tensor, s: torch.Tensor,
                   cfg: ModelConfig, ko: KernelOptions) -> torch.Tensor:
    """Each branch normalised by its own weight, then averaged."""
    a = rms_norm(a, lp["norm_a"], cfg.rms_eps, ko)
    s = rms_norm(s, lp["norm_s"], cfg.rms_eps, ko)
    return 0.5 * (a + s)


def _apply_mixer(lp: dict, x: torch.Tensor, cfg: ModelConfig,
                 opts: RunOptions) -> torch.Tensor:
    ko = opts.kernels
    if cfg.mixer == "rwkv6":
        return rwkv_mod.apply_rwkv6(lp, x, cfg, ko)
    if cfg.mixer == "hymba":
        a = attn_mod.apply_gqa(lp["attn"], x, cfg, ko,
                               window=_window(cfg, opts))
        s = ssm_mod.apply_ssm(lp["ssm"], x, cfg, ko)
        return _hymba_combine(lp, a, s, cfg, ko)
    if cfg.attn_kind == "mla":
        return mla_mod.apply_mla(lp, x, cfg, ko, window=opts.window)
    return attn_mod.apply_gqa(lp, x, cfg, ko, window=opts.window)


def _apply_ffn(lp: dict, x: torch.Tensor, cfg: ModelConfig, opts: RunOptions,
               moe: bool) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The layer's FFN and its MoE aux loss (None for a dense FFN)."""
    if cfg.mixer == "rwkv6":
        return rwkv_mod.apply_rwkv6_channel_mix(lp["mixer"], x, cfg), None
    if moe:
        return moe_mod.apply_moe(lp["moe"], x, cfg, opts.moe)
    f = lp["ffn"]
    cdt = x.dtype
    return swiglu(x, f["wg"].to(cdt), f["wu"].to(cdt), f["wd"].to(cdt)), None


def _layer_fwd(lp: dict, x: torch.Tensor, cfg: ModelConfig,
               opts: RunOptions, moe: bool):
    ko = opts.kernels
    x = x + _apply_mixer(lp["mixer"], rms_norm(x, lp["norm1"], cfg.rms_eps,
                                               ko), cfg, opts)
    f, aux = _apply_ffn(lp, rms_norm(x, lp["norm2"], cfg.rms_eps, ko), cfg,
                        opts, moe)
    return x + f, aux


#: the matrix products ``dots`` saves: 2-D products with no batch dims,
#: as the reference's ``checkpoint_dots_with_no_batch_dims`` (``x @ w``
#: over (B, S, d) folds to ``mm``; ``bmm``, the attention's and the
#: experts' batched products, is recomputed)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    policy = torch_checkpoint.CheckpointPolicy
    return policy.MUST_SAVE if op in _DOTS else policy.PREFER_RECOMPUTE


def _remat_wrap(fn: Callable, remat: str) -> Callable:
    """``fn`` under the activation checkpointing policy ``remat``:
    ``none`` keeps every activation for the backward; ``full`` keeps only
    the layer's inputs and recomputes the rest; ``dots`` keeps the outputs
    of the 2-D matrix products (:data:`_DOTS`) and recomputes the rest.
    Outside autograd (no input requires grad) each runs ``fn`` once.

    On this port ``dots`` trades speed for nothing at qwen3-0.6b's width
    (fp32, (8, 512), an H100; ``tools/remat_profile.py``): it spares the
    device ~29 ms a step of the products ``full`` recomputes, but its
    policy runs as a Python dispatch mode over every op of the forward
    and of the recompute, which costs the host ~150 ms a step more than
    ``full``; the backward waits on that recompute, so the step is slower
    than under ``full`` (650 against 638 ms) and holds ~3.3 GB more.  It
    stays a candidate, as in the reference, so tuned configs replay; the
    Controller measures it like the others."""
    if remat == "none":
        return fn
    if remat == "full":
        return functools.partial(torch_checkpoint.checkpoint, fn,
                                 use_reentrant=False)
    if remat == "dots":
        return functools.partial(
            torch_checkpoint.checkpoint, fn, use_reentrant=False,
            context_fn=functools.partial(
                torch_checkpoint.create_selective_checkpoint_contexts,
                _save_dots))
    raise ValueError(f"unknown remat policy {remat!r}")


def _run_stack(stacked: dict, x: torch.Tensor, cfg: ModelConfig,
               opts: RunOptions, moe: bool, aux: torch.Tensor):
    """The stack's layers in turn, each under the ``remat`` policy;
    ``aux`` plus their MoE aux losses."""
    body = _remat_wrap(functools.partial(_layer_fwd, cfg=cfg, opts=opts,
                                         moe=moe), opts.remat)
    leaves, treedef = compat.tree_flatten(stacked)
    # one unbind a leaf: its backward stacks the layers' gradients once,
    # where indexing each layer's slice would build a zero-filled gradient
    # of the whole stack per layer and add them (quadratic in depth)
    per_layer = [leaf.unbind(0) for leaf in leaves]
    for i in range(leaves[0].shape[0]):
        lp = compat.tree_unflatten(treedef, [u[i] for u in per_layer])
        x, layer_aux = body(lp, x)
        if layer_aux is not None:
            aux = aux + layer_aux
    return x, aux


def apply(params: dict, cfg: ModelConfig, opts: RunOptions,
          tokens: torch.Tensor | None = None,
          embeds: torch.Tensor | None = None,
          return_hidden: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward.  Returns (logits (B,S,V) in
    ``opts.logits_dtype``, aux) — or (hidden (B,S,d), aux) with
    ``return_hidden``.  ``V`` is the padded vocab, as in the reference;
    ``aux`` is the float32 sum of the MoE layers' auxiliary losses (zero
    for dense models)."""
    check_supported(cfg)
    cdt = _dtype(cfg.compute_dtype)
    if embeds is None:
        if tokens is None:
            raise ValueError("apply needs tokens or embeds")
        x = _embed(params, tokens).to(cdt)
    else:
        x = embeds.to(cdt)
    x = constrain(x, ("batch", "seq", None))
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if "dense_layers" in params:
        x, aux = _run_stack(params["dense_layers"], x, cfg, opts, False, aux)
    if "moe_layers" in params:
        x, aux = _run_stack(params["moe_layers"], x, cfg, opts, True, aux)
    x = rms_norm(x, params["final_norm"], cfg.rms_eps, opts.kernels)
    if return_hidden:
        return x, aux
    logits = head_logits(x, lm_head_weight(params, cfg))
    return logits.to(_dtype(opts.logits_dtype)), aux


def head_logits(x: torch.Tensor, head: torch.Tensor) -> torch.Tensor:
    """``x (B, S, d) @ head (d, V)``, placed ``(batch, seq, vocab)``.  Under
    a mesh on each rank's own rows and vocab shard, as GSPMD partitions
    it: the head's ``fsdp`` rows gathered, never its vocab, so no rank
    holds its rows' logits over the whole vocab.  The gradient of ``x``
    is a partial sum over the vocab's mesh dims, that of ``head`` over
    the rows'."""
    mesh = current_mesh()
    if mesh is None:
        return x @ head
    spec = logical_to_spec(("batch", "seq", "vocab"),
                           tuple(x.shape[:2]) + tuple(head.shape[1:]))
    spec = tuple(spec) + (None,) * (3 - len(spec))
    rows = entry_dims(spec[0]) + entry_dims(spec[1])
    xl = local_shard(x, mesh, PartitionSpec(*spec[:2]),
                     {n: "partial" for n in entry_dims(spec[2])})
    hl = local_shard(head, mesh, PartitionSpec(None, spec[2]),
                     {n: "partial" for n in rows})
    return from_local(xl @ hl, mesh, PartitionSpec(*spec))


def _embed(params: dict, tokens: torch.Tensor) -> torch.Tensor:
    """The embedding rows of ``tokens``.  Under a mesh each rank looks its
    token rows up in its own shard of the vocab-sharded table (a row it
    does not hold is 0), and the parts are a ``Partial`` sum over the
    vocab's mesh dims: the whole table is never gathered (indexing a
    DTensor table gathers it, 622 MB a rank at qwen3-0.6b)."""
    emb = params["embed"]
    if not is_dtensor(emb):
        return emb[tokens.long()]
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = emb.device_mesh
    vdims, ddims = shard_dims(emb)
    tdims = shard_dims(tokens)[0] if is_dtensor(tokens) else ()
    # a rank's table shard; its gradient is a partial sum over the dims
    # that split the tokens (each rank sees only its rows)
    table = local_shard(emb, mesh, spec_of_dims((vdims, ddims)),
                        {n: "partial" for n in tdims})
    ids = local_view(tokens).long() - local_start(emb, 0)
    own = (ids >= 0) & (ids < table.shape[0])
    rows = table[ids.clamp(0, table.shape[0] - 1)] * own[..., None]
    place = [Shard(0) if n in tdims else Partial() if n in vdims
             else Shard(rows.ndim - 1) if n in ddims else Replicate()
             for n in mesh_shape(mesh)]
    return DTensor.from_local(rows, mesh, place, run_check=False)


def lm_head_weight(params: dict, cfg: ModelConfig) -> torch.Tensor:
    cdt = _dtype(cfg.compute_dtype)
    return (params["embed"].T if cfg.tie_embeddings
            else params["lm_head"]).to(cdt)


# -- decode ------------------------------------------------------------------------

def _init_hymba_cache(cfg: ModelConfig, batch: int, max_len: int,
                      window: int | None = None,
                      dtype: torch.dtype = torch.bfloat16,
                      device: torch.device | str | None = None) -> dict:
    """The attention ring bounded by the window (the override, else the
    config's) beside the SSM row state."""
    return {"attn": attn_mod.init_gqa_cache(cfg, batch, max_len,
                                            window=window or cfg.window,
                                            dtype=dtype, device=device),
            "ssm": ssm_mod.init_ssm_cache(cfg, batch, dtype=dtype,
                                          device=device)}


def _hymba_cache_axes(cfg: ModelConfig) -> dict:
    return {"attn": attn_mod.gqa_cache_axes(cfg),
            "ssm": ssm_mod.ssm_cache_axes(cfg)}


def _cache_fns(cfg: ModelConfig):
    if cfg.mixer == "rwkv6":
        return rwkv_mod.init_rwkv6_cache, rwkv_mod.rwkv6_cache_axes
    if cfg.mixer == "hymba":
        return _init_hymba_cache, _hymba_cache_axes
    if cfg.attn_kind == "mla":
        return mla_mod.init_mla_cache, mla_mod.mla_cache_axes
    return attn_mod.init_gqa_cache, attn_mod.gqa_cache_axes


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               opts: RunOptions | None = None,
               device: torch.device | str | None = None) -> dict:
    """Per-layer caches (KV rings, MLA's latent rings, RWKV6 row state, or
    Hymba's window ring and SSM state) stacked on a
    leading ``L`` axis, on ``device`` (default ``cuda``, see
    :func:`repro_torch.compat.resolve_device`)."""
    check_supported(cfg)
    opts = opts or RunOptions()
    init, _ = _cache_fns(cfg)
    one = init(cfg, batch, max_len, window=opts.window,
               dtype=_dtype(opts.decode_cache_dtype),
               device=compat.resolve_device(device))
    return compat.tree_map(
        lambda v: v[None].repeat((cfg.n_layers,) + (1,) * v.ndim), one)


def cache_axes(cfg: ModelConfig) -> dict:
    check_supported(cfg)
    _, axes = _cache_fns(cfg)
    return _stack_axes(axes(cfg))


def _layer_decode(lp: dict, lc: dict, x: torch.Tensor, pos: torch.Tensor,
                  cfg: ModelConfig, opts: RunOptions, moe: bool):
    ko = opts.kernels
    xin = rms_norm(x, lp["norm1"], cfg.rms_eps, ko)
    if cfg.mixer == "rwkv6":
        h, lc = rwkv_mod.decode_rwkv6(lp["mixer"], lc, xin, pos, cfg, ko)
    elif cfg.mixer == "hymba":
        mp = lp["mixer"]
        ha, _ = attn_mod.decode_gqa(mp["attn"], lc["attn"], xin, pos, cfg,
                                    ko, window=_window(cfg, opts))
        hs, _ = ssm_mod.decode_ssm(mp["ssm"], lc["ssm"], xin, pos, cfg, ko)
        h = _hymba_combine(mp, ha, hs, cfg, ko)
    elif cfg.attn_kind == "mla":
        h, lc = mla_mod.decode_mla(lp["mixer"], lc, xin, pos, cfg, ko,
                                   window=opts.window)
    else:
        h, lc = attn_mod.decode_gqa(lp["mixer"], lc, xin, pos, cfg, ko,
                                    window=opts.window)
    x = x + h
    xin2 = rms_norm(x, lp["norm2"], cfg.rms_eps, ko)
    if cfg.mixer == "rwkv6":
        x_prev = lc["x_cm"][:, None].to(xin2.dtype)
        f = rwkv_mod.apply_rwkv6_channel_mix(lp["mixer"], xin2, cfg,
                                             x_prev=x_prev)
        write_local(lc["x_cm"], xin2[:, 0])     # its own rows under a mesh
    elif moe:
        f, _ = moe_mod.apply_moe(lp["moe"], xin2, cfg, opts.moe)
    else:
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
    (logits (B,V), cache).  ``cache`` is updated in place and returned;
    its first ``n_layers - n_moe_layers`` layers go with ``dense_layers``,
    the rest with ``moe_layers``."""
    check_supported(cfg)
    cdt = _dtype(cfg.compute_dtype)
    x = _embed(params, tokens).to(cdt)[:, None]              # (B,1,d)
    x = constrain(x, ("batch", None, None))
    n_dense = cfg.n_layers - cfg.n_moe_layers
    for i in range(cfg.n_layers):
        moe = i >= n_dense
        lp = _layer(params["moe_layers"], i - n_dense) if moe else \
            _layer(params["dense_layers"], i)
        x, _ = _layer_decode(lp, _layer(cache, i), x, pos, cfg, opts, moe)
    xf = rms_norm(x, params["final_norm"], cfg.rms_eps, opts.kernels)
    head = lm_head_weight(params, cfg)
    logits = (xf[:, 0] @ head).to(torch.float32)
    return logits[:, : cfg.vocab_size], cache


def _cache_leaves(cfg: ModelConfig, cache: dict):
    """``(max_len, rows)`` of a cache, its leaves located through
    ``cache_axes`` (generic across mixers): the seq capacity of its paged
    leaves (``seq_kv``: attention KV; None without), and its row-state
    leaves (``batch`` without ``seq_kv``: the RWKV6 state and token
    shifts, the SSM state and conv inputs) with their batch axis."""
    pairs = list(zip(compat.tree_leaves(cache), compat.tree_leaves(
        cache_axes(cfg), is_leaf=lambda a: isinstance(a, tuple))))
    max_len = next((leaf.shape[ax.index("seq_kv")] for leaf, ax in pairs
                    if "seq_kv" in ax), None)
    rows = [(leaf, ax.index("batch")) for leaf, ax in pairs
            if "batch" in ax and "seq_kv" not in ax]
    return max_len, rows


def _save_rows(rows: list, idle: list[int]) -> list:
    """The ``idle`` rows of each in-place row-state leaf, before a
    chunked-prefill step (nothing when every row is active): under a mesh
    the rows of each rank's own shard of the leaf."""
    saved = []
    if not idle:
        return saved
    for leaf, bi in rows:
        loc, b0 = local_view(leaf), local_start(leaf, bi)
        mine = [i - b0 for i in idle if b0 <= i < b0 + loc.shape[bi]]
        if mine:
            idx = torch.tensor(mine, device=loc.device)
            saved.append((loc, bi, idx, loc.index_select(bi, idx)))
    return saved


def _select_rows(saved: list) -> None:
    """The reference's per-row select after a chunked-prefill step, for
    in-place row state: an idle row's leaves get back the values saved
    before the step.  (Paged leaves need no select: an idle row's write is
    sent past the cache, where it stores nothing.)"""
    for loc, bi, idx, old in saved:
        loc.index_copy_(bi, idx, old)


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
    as the reference's ``lax.scan``: attention writes land at per-row
    positions, and recurrent state only advances while a row is active
    (:func:`_select_rows`; the counts are read on the host once, so a step
    whose rows are all active saves nothing).  The cache is updated in
    place and returned.
    """
    b, c = tokens.shape
    max_len, rows = _cache_leaves(cfg, cache)
    counts = n_new.tolist() if rows else []
    logits = torch.zeros((b, cfg.vocab_size), dtype=torch.float32,
                         device=tokens.device)
    for t in range(c):
        active = t < n_new
        step_pos = pos + t
        if max_len is not None:
            step_pos = torch.where(active, step_pos,
                                   torch.full_like(pos, max_len))
        saved = _save_rows(rows, [i for i, n in enumerate(counts) if t >= n])
        lg, cache = decode_step(params, cache, tokens[:, t], step_pos, cfg,
                                opts)
        _select_rows(saved)
        logits = torch.where((n_new - 1 == t)[:, None], lg, logits)
    return logits, cache
