"""Step builders: where the framework's Iridescent spec points live.

Each builder is *handler code* in the paper's sense: it declares
specialization points through the :class:`SpecCtx` it receives and returns
the step function.  Re-building under a different configuration bakes
different constants (kernel implementation, tile sizes, rows per block,
cache and logits dtypes) into the closure the runtime dispatches to.

The port has the serving builders: the phase-disaggregated serve step,
the full-sequence prefill step (the path of the flash attention kernel,
and of the linear-attention kernel for rwkv6 and hymba's SSM heads) and
the single-token decode step.  They declare every spec label the
reference's builders declare.  Two candidate sets differ from the
reference's, because they are tile sizes of the Hopper kernels rather than
of the TPU's VMEM:

* ``block_q`` in (64, 128) and ``block_kv`` in (32, 64): the query and kv
  tile rows of the flash attention kernel, which stages them in fp32 in
  shared memory.  A thread block has at most 227 KB there; at d = 128 the
  (128, 64) pair takes 170 KB, while the reference's 128-1024 rows (up to
  2 MB for a (1024, 1024) pair) do not fit.
* ``norm_block_rows`` in (4,): the rows per thread block of the RMSNorm
  kernel, the one size the library instantiates until a measurement on
  the card picks others.

The train builder (:func:`make_train_builder`) declares the reference's
training points on top: ``remat`` (activation checkpointing per layer),
``microbatch`` (gradient accumulation), ``logits_layout``, ``loss_chunk``
(the chunked cross-entropy) and ``sharding_profile``; its ``*_impl``
points are pinned to gradient-safe entries (``torch_ref``): no
hand-written kernel of the port has a backward, as no Pallas kernel of the
reference has one.

Every builder takes the reference's ``mesh`` (a ``DeviceMesh`` with named
dims, :mod:`repro_torch.launch.mesh`).  Under a mesh the step runs in
:func:`~repro_torch.distributed.sharding.mesh_context` with the rules of
its ``sharding_profile`` (:data:`SHARDING_PROFILES`): parameters (and
gradients, new parameters and caches) are placed as DTensors by their
logical axes, the models' ``constrain`` points place the activations, and
DTensor inserts the collectives, as GSPMD does for the reference.  Under a
mesh every ``*_impl`` point (and the step-wide choice) is pinned to
``torch_ref``: the CUDA wrappers take plain tensors and raise on a
DTensor, and the reference's own mesh path lowers its plain versions too
(its dry run builds with ``kernel_impl="xla"``).  With no mesh every step
runs exactly as before, on one device.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Callable

import torch

from repro_torch import compat
from repro_torch.core.specializer import SpecCtx
from repro_torch.distributed.sharding import (DEFAULT_RULES, ShardingRules,
                                              constrain, from_local,
                                              is_dtensor, local_shard,
                                              local_start, mesh_context,
                                              reduce_over, replicate,
                                              shard_dims, spec_of_dims)
from repro_torch.kernels import registry as kernel_registry
from repro_torch.kernels.attention.kernel import (BLOCK_KV, BLOCK_Q,
                                                  DEFAULT_BLOCK_KV,
                                                  DEFAULT_BLOCK_Q)
from repro_torch.kernels.linear_attention.kernel import CHUNKS
from repro_torch.kernels.rmsnorm.kernel import BLOCK_ROWS, DEFAULT_BLOCK_ROWS
from repro_torch.models import transformer as model
from repro_torch.models.common import KernelOptions
from repro_torch.models.config import ModelConfig
from repro_torch.models.moe import MoEOptions
from repro_torch.models.transformer import RunOptions
from repro_torch.optim import (OptConfig, apply_updates, opt_state_axes,
                               update_in_place)

__all__ = ["SHARDING_PROFILES", "make_train_builder", "make_prefill_builder",
           "make_decode_builder", "make_serve_builder", "phase_context_fn",
           "run_options_from_spec", "cross_entropy", "chunked_cross_entropy"]

# -- sharding profiles (layout specialization points) ---------------------------

def _profile_dp(base: ShardingRules) -> ShardingRules:
    """Pure DP: params replicated (generic; only fits small models)."""
    return base.replace(fsdp=None, expert_fsdp=None, ffn="model",
                        heads="model", vocab="model", experts="model")


def _profile_fsdp(base: ShardingRules) -> ShardingRules:
    """ZeRO-3 over the data dim + TP over the model dim (the default)."""
    return base


def _profile_fsdp_pods(base: ShardingRules) -> ShardingRules:
    """ZeRO-3 over the data AND pod dims (max memory savings, gathers
    across pods)."""
    return base.replace(fsdp=("pod", "data"))


def _profile_seq(base: ShardingRules) -> ShardingRules:
    """Sequence parallelism: long-context activations sharded over
    model."""
    return base.replace(seq="model")


def _profile_fsdp_noexp(base: ShardingRules) -> ShardingRules:
    """FSDP for dense params; expert weights sharded over experts (model)
    only: no per-layer expert-weight all-gathers, at the cost of E/|model|
    experts resident per device."""
    return base.replace(expert_fsdp=None)


def _profile_serve_ep(base: ShardingRules) -> ShardingRules:
    """Inference layout: no FSDP (nothing re-gathered per token); dense
    params TP over model; experts sharded experts->data x inner-dim->model,
    so decode dispatch moves activations instead of weights."""
    return base.replace(fsdp=None, experts=("pod", "data"),
                        expert_fsdp="model", expert_cap=None,
                        moe_groups=None)


#: the reference's layout profiles: each maps the default rules to its own
SHARDING_PROFILES: dict[str, Callable[[ShardingRules], ShardingRules]] = {
    "dp": _profile_dp,
    "fsdp": _profile_fsdp,
    "fsdp_pods": _profile_fsdp_pods,
    "fsdp_noexp": _profile_fsdp_noexp,
    "seq": _profile_seq,
    "serve_ep": _profile_serve_ep,
}


def run_options_from_spec(spec: SpecCtx, cfg: ModelConfig, *,
                          kernel_impl: str | None = None,
                          window: int | None = None,
                          for_decode: bool = False,
                          differentiable: bool = False,
                          sharded: bool = False) -> RunOptions:
    """Declare the model-level spec points and bundle the chosen constants.

    The implementation choice per kernel family the step exercises
    (``rmsnorm_impl``; ``attention_impl`` for attention mixers,
    ``linear_attention_impl`` for rwkv6/hymba) has as candidates the
    registry entries *available on this host*; a choice that guard-misses
    at dispatch (a host tensor asking for ``cuda``) degrades to torch_ref
    inside the registry (paper §4.4.3).  ``block_q``/``block_kv`` are the
    flash attention kernel's tiles (see the module docstring for why their
    candidates are not the reference's); ``chunk_len`` (rwkv6/hymba) the
    linear attention's chunk, in the reference's (16, 32, 64), which the
    kernel instantiates as they are; ``swa_impl`` is declared for a
    sliding-window model or ``window`` override only.  A MoE model
    declares the reference's dispatch points with its labels, candidates
    and defaults: ``moe_impl`` (einsum, gather, shard — ``shard`` is the
    explicit expert parallelism over a mesh's ``model`` dim and runs
    ``gather`` without one), ``capacity_factor``, ``moe_group`` and
    ``moe_ranking``.
    ``logits_dtype`` sets the full-sequence forward's logits (decode logits
    are always fp32, as in the reference).  ``remat`` (none, dots, full)
    is declared unless ``for_decode`` (every builder but the train
    builder passes it, as in the reference).  With ``differentiable``
    every ``*_impl`` point is pinned to a gradient-safe entry
    (``registry.impl_point(require_grad=True)``), and so is the step-wide
    ``KernelOptions.impl`` (``torch_ref``, overriding ``kernel_impl``),
    which a family without a point of its own falls through to: the step
    runs under autograd, which the registry's dispatch cannot see.
    ``sharded`` (a step under a mesh) pins them the same way: the CUDA
    wrappers take no DTensor.
    """
    model.check_supported(cfg)
    uses_attention = cfg.mixer in ("attn", "hymba")
    uses_linear_attention = cfg.mixer in ("rwkv6", "hymba")
    differentiable = differentiable or sharded
    if differentiable:
        # the step-wide choice reaches every family the step routes without
        # a point of its own (MLA's attention): pin it to the entry every
        # family registers as gradient-safe, declaring no point for it
        kernel_impl = kernel_registry.FALLBACK_IMPL
    ko = KernelOptions(
        impl=kernel_impl,
        rmsnorm_impl=kernel_registry.impl_point(spec, "rmsnorm",
                                                default=kernel_impl,
                                                require_grad=differentiable),
        attention_impl=(kernel_registry.impl_point(spec, "attention",
                                                   default=kernel_impl,
                                                   require_grad=differentiable)
                        if uses_attention else None),
        linear_attention_impl=(
            kernel_registry.impl_point(spec, "linear_attention",
                                       default=kernel_impl,
                                       require_grad=differentiable)
            if uses_linear_attention else None),
        block_q=spec.enum("block_q", DEFAULT_BLOCK_Q, BLOCK_Q,
                          guarded=False),
        block_kv=spec.enum("block_kv", DEFAULT_BLOCK_KV, BLOCK_KV,
                           guarded=False),
        norm_block_rows=spec.enum("norm_block_rows", DEFAULT_BLOCK_ROWS,
                                  BLOCK_ROWS, guarded=False),
        chunk_len=(spec.enum("chunk_len", 64, CHUNKS, guarded=False)
                   if uses_linear_attention else 64),
        swa_impl=(spec.enum("swa_impl", "full", ("full", "banded"),
                            guarded=False)
                  if (cfg.window or window) else "full"),
    )
    moe = MoEOptions()
    if cfg.is_moe:
        moe = MoEOptions(
            impl=spec.enum("moe_impl", "einsum",
                           ("einsum", "gather", "shard"), guarded=False),
            capacity_factor=spec.enum("capacity_factor", 1.25,
                                      (1.0, 1.25, 1.5, 2.0), guarded=False),
            group_size=spec.enum("moe_group", 0, (0, 1024, 4096),
                                 guarded=False),
            ranking=spec.enum("moe_ranking", "cumsum", ("cumsum", "sort"),
                              guarded=False),
        )
    # what each remat policy costs on the card: models.transformer._remat_wrap
    remat = (spec.enum("remat", "none", ("none", "dots", "full"),
                       guarded=False) if not for_decode else "none")
    return RunOptions(
        kernels=ko, moe=moe, remat=remat, window=window,
        logits_dtype=spec.enum("logits_dtype", "float32",
                               ("float32", "bfloat16"), guarded=False))


def _rules_from_spec(spec: SpecCtx, default: str = "fsdp") -> ShardingRules:
    """The ``sharding_profile`` point and the rules it selects (with no
    mesh the rules place nothing)."""
    profile = spec.enum("sharding_profile", default,
                        tuple(SHARDING_PROFILES), guarded=False)
    return SHARDING_PROFILES[profile](DEFAULT_RULES)


def _constrain_tree(tree: Any, axes_tree: Any) -> Any:
    """Each leaf of ``tree`` constrained by its logical axes (a no-op
    without a mesh)."""
    return compat.tree_map(lambda x, a: x if x is None else constrain(x, a),
                           tree, axes_tree, is_leaf=_is_axes)


def _is_axes(x: Any) -> bool:
    return isinstance(x, tuple) and not isinstance(x, torch.Tensor)


def _with_cache_points(spec: SpecCtx, opts: RunOptions
                       ) -> tuple[RunOptions, ShardingRules]:
    """The cached steps' points: the KV cache dtype, the sharding profile
    and the cache layout: ``seq`` shards the cache's sequence dim over the
    model dim (kv head counts rarely divide a wide model dim), as in the
    reference."""
    opts = dataclasses.replace(opts, decode_cache_dtype=spec.enum(
        "cache_dtype", "bfloat16", ("bfloat16", "float32"), guarded=False))
    rules = _rules_from_spec(spec)
    if spec.enum("cache_layout", "seq", ("seq", "batch"),
                 guarded=False) == "seq":
        rules = rules.replace(seq_kv="model")
    return opts, rules


def _cached_step(step: Callable, params: dict, cache: dict,
                 cfg: ModelConfig, mesh: Any, *args) -> tuple[Any, dict]:
    """``step(params, cache, *args)`` (a decode step or chunked prefill,
    which write the cache in place).  Under a mesh (already in its
    context) the parameters and the cache are placed by their axes (a
    leaf already so placed is taken as it is), and the step writes into
    each cache leaf's local shard, in place: nothing of the cache is
    gathered.  The logits come back as a plain tensor, the same on every
    rank, and the cache as the placed tree (the caller's own leaves where
    they came placed)."""
    if mesh is None:
        return step(params, cache, *args)
    params = _constrain_tree(params, model.param_axes(cfg))
    logits, cache = step(params,
                         _constrain_tree(cache, model.cache_axes(cfg)), *args)
    return replicate(logits), cache


def make_prefill_builder(cfg: ModelConfig, mesh: Any = None, *,
                         kernel_impl: str | None = None,
                         window: int | None = None
                         ) -> Callable[[SpecCtx], Callable]:
    """Handler builder for ``prefill_step(params, batch) -> logits``.

    ``batch`` holds ``tokens (B, S)`` (or ``embeds (B, S, d)``, the stub
    frontends' input); the step runs the full-sequence forward
    (:func:`repro_torch.models.transformer.apply`), whose attention is the
    flash attention kernel under ``attention_impl=cuda`` (an rwkv6 time
    mix and hymba's SSM heads: the linear-attention kernel under
    ``linear_attention_impl=cuda``),
    and returns the logits ``(B, S, V)`` in ``logits_dtype``.  Under
    ``mesh`` the parameters are placed by their axes and the logits come
    back as a DTensor (vocab-sharded by the rules).
    """

    def builder(spec: SpecCtx) -> Callable:
        opts = run_options_from_spec(spec, cfg, kernel_impl=kernel_impl,
                                     window=window, for_decode=True,
                                     sharded=mesh is not None)
        rules = _rules_from_spec(spec)

        def prefill_step(params, batch):
            with mesh_context(mesh, rules):
                params = _constrain_tree(params, model.param_axes(cfg))
                logits, _ = model.apply(params, cfg, opts,
                                        tokens=batch.get("tokens"),
                                        embeds=batch.get("embeds"))
            return logits

        return prefill_step

    return builder


def make_decode_builder(cfg: ModelConfig, mesh: Any = None, *,
                        kernel_impl: str | None = None,
                        window: int | None = None
                        ) -> Callable[[SpecCtx], Callable]:
    """Handler builder for ``serve_step(params, cache, tokens, pos)``: one
    new token for the whole batch against the KV cache
    (:func:`repro_torch.models.transformer.decode_step`; the cache is
    updated in place).  Returns ``(logits (B, V), cache)``.  Under
    ``mesh`` the returned cache is a new tree of DTensors placed by the
    cache's axes, the reference's ``seq_kv="model"`` under
    ``cache_layout="seq"`` (:func:`_cached_step`)."""

    def builder(spec: SpecCtx) -> Callable:
        opts, rules = _with_cache_points(spec, run_options_from_spec(
            spec, cfg, kernel_impl=kernel_impl, window=window,
            for_decode=True, sharded=mesh is not None))

        def serve_step(params, cache, tokens, pos):
            with mesh_context(mesh, rules):
                return _cached_step(
                    lambda p, c: model.decode_step(p, c, tokens, pos, cfg,
                                                   opts),
                    params, cache, cfg, mesh)

        return serve_step

    return builder


def phase_context_fn(args, kwargs) -> tuple[str, int]:
    """Context key for the phase-disaggregated serve handler:
    ``(phase, bucket)``.  The phase is read off the token rank at dispatch
    time — ``(B, C)`` is a chunked-prefill step, ``(B,)`` a decode step —
    so prefill and decode traffic land in *separate* specialization
    contexts of the same handler, each with its own dispatch snapshot and
    its own Controller search."""
    tokens = args[2]
    phase = "prefill" if getattr(tokens, "ndim", 1) == 2 else "decode"
    return (phase, int(tokens.shape[0]))


def make_serve_builder(cfg: ModelConfig, mesh: Any = None, *,
                       kernel_impl: str | None = None
                       ) -> Callable[[SpecCtx], Callable]:
    """Handler builder for the phase-disaggregated
    ``serve_step(params, cache, tokens, pos, n_new)``.

    One registered handler serves both phases, branching on the token
    rank: ``tokens (B,)`` runs one vector-pos decode step, ``tokens (B, C)``
    runs a chunked prefill
    (:func:`repro_torch.models.transformer.prefill_chunk`).  Register it
    with ``context_fn=phase_context_fn`` and the two phases become separate
    ``(phase, bucket)`` specialization contexts.

    ``pos (B,)`` is each row's write position; ``n_new (B,)`` the valid
    token count per row (prefill only).  Returns ``(logits (B, V), cache)``;
    the cache is updated in place (under ``mesh``: returned as a new tree
    of DTensors, as :func:`make_decode_builder`'s).
    """

    def builder(spec: SpecCtx) -> Callable:
        opts, rules = _with_cache_points(spec, run_options_from_spec(
            spec, cfg, kernel_impl=kernel_impl, for_decode=True,
            sharded=mesh is not None))

        def step(params, cache, tokens, pos, n_new):
            if tokens.ndim == 2:
                return model.prefill_chunk(params, cache, tokens, pos,
                                           n_new, cfg, opts)
            return model.decode_step(params, cache, tokens, pos, cfg, opts)

        def serve_step(params, cache, tokens, pos, n_new):
            with mesh_context(mesh, rules):
                return _cached_step(
                    lambda p, c: step(p, c, tokens, pos, n_new), params,
                    cache, cfg, mesh)

        return serve_step

    return builder


# -- loss --------------------------------------------------------------------------

class _VocabParallelNLL(torch.autograd.Function):
    """The token NLL of each rank's local logits ``(..., V_loc)``, the
    vocab split over the mesh dims ``vdims`` and the rows over ``rdims``:
    the max, the sum of exponentials and the label's logit (0 on a rank
    whose vocab range does not hold it) all-reduced over ``vdims``, the
    NLL and the count of valid (label >= 0) rows summed, then all-reduced
    over ``rdims``.  Returns the two sums, the same on every rank.  The
    gradient is ``softmax - onehot`` of the valid rows on the local shard;
    the sums' gradient reaches every rank whole, so nothing of it is
    reduced backward."""

    @staticmethod
    def forward(ctx, lg, labels, v0, vdims, rdims, mesh):
        m = reduce_over(lg.amax(-1), "max", vdims, mesh)
        z = reduce_over(torch.exp(lg - m[..., None]).sum(-1), "sum", vdims,
                        mesh)
        lse = m + torch.log(z)
        ids = labels.long() - v0
        own = (ids >= 0) & (ids < lg.shape[-1])
        ids = ids.clamp(0, lg.shape[-1] - 1)
        picked = torch.gather(lg, -1, ids[..., None])[..., 0] * own
        picked = reduce_over(picked, "sum", vdims, mesh)
        mask = (labels >= 0).to(torch.float32)
        total = reduce_over(torch.sum((lse - picked) * mask), "sum", rdims,
                            mesh)
        count = reduce_over(mask.sum(), "sum", rdims, mesh)
        ctx.save_for_backward(lg, lse, ids, own, mask)
        return total, count

    @staticmethod
    def backward(ctx, g_total, g_count):
        lg, lse, ids, own, mask = ctx.saved_tensors
        grad = torch.exp(lg - lse[..., None]) * mask[..., None]
        grad.scatter_add_(-1, ids[..., None], -(own * mask)[..., None])
        return grad * g_total, None, None, None, None, None


def _token_nll(logits: torch.Tensor, labels: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """The fp32 token NLL summed over valid (label >= 0) positions, and
    their count.  Under a mesh (``logits`` a DTensor) each rank works on
    its own shard of the logits (:class:`_VocabParallelNLL`): no rank
    holds the whole ``(B, S, V)`` tensor or a vocab-replicated copy of
    it, and the two sums come back replicated."""
    if not is_dtensor(logits):
        lg = logits.to(torch.float32)
        lse = torch.logsumexp(lg, dim=-1)
        ll = torch.gather(lg, -1,
                          labels.clamp_min(0)[..., None].long())[..., 0]
        mask = (labels >= 0).to(torch.float32)
        return torch.sum((lse - ll) * mask), mask.sum()
    mesh = logits.device_mesh
    dims = shard_dims(logits)
    rdims = tuple(n for d in dims[:-1] for n in d)
    lg = local_shard(logits, mesh, spec_of_dims(dims)).to(torch.float32)
    lab = local_shard(labels, mesh, spec_of_dims(dims[:-1]))
    total, count = _VocabParallelNLL.apply(
        lg, lab, local_start(logits, lg.ndim - 1), dims[-1], rdims, mesh)
    # the sums re-enter the mesh's tensors as replicated DTensors (their
    # gradient then comes back plain)
    return from_local(total, mesh, ()), from_local(count, mesh, ())


def chunked_cross_entropy(hidden: torch.Tensor, head: torch.Tensor,
                          labels: torch.Tensor, chunk: int) -> torch.Tensor:
    """Token CE without materializing the full (B,S,V) fp32 logits.

    The LM head product and the fp32 log-sum-exp run per sequence chunk,
    so peak logits memory is (B, chunk, V).  The same math as
    :func:`cross_entropy`; ``chunk`` must divide S.
    """
    s = hidden.shape[1]
    if s % chunk:
        raise ValueError(f"loss_chunk {chunk} does not divide S = {s}")
    total, count = 0.0, 0.0
    for i in range(0, s, chunk):
        lg = model.head_logits(hidden[:, i:i + chunk], head)
        t, c = _token_nll(lg, labels[:, i:i + chunk])
        total, count = total + t, count + c
    return total / torch.clamp(count, min=1.0)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  gather_logits: bool = False) -> torch.Tensor:
    """Token CE in fp32, mean over valid (label >= 0) positions.

    ``gather_logits`` (the ``logits_layout`` point) replicates the logits'
    vocab dim first; otherwise they stay vocab-sharded through the loss
    under a mesh (:func:`_token_nll`: the max and log-sum-exp reductions
    are small all-reduces instead of an all-gather of the whole (B,S,V)
    tensor).
    """
    if gather_logits:
        logits = constrain(logits, ("batch", "seq", None))
    total, count = _token_nll(logits, labels)
    return total / torch.clamp(count, min=1.0)


# -- train ------------------------------------------------------------------------

def _microbatch(v: torch.Tensor, i: int, micro: int) -> torch.Tensor:
    """Rows ``[i * B / micro, (i + 1) * B / micro)`` of a batch leaf (the
    reference's ``reshape((micro, -1))[i]``).  Under a mesh the leaf is
    gathered whole first (token ids and labels: a few MB at production
    sizes) and the slice placed by its batch axes: DTensor cannot split a
    dim sharded over more ranks than the micro count."""
    n = v.shape[0] // micro
    if not is_dtensor(v):
        return v[i * n:(i + 1) * n]
    return constrain(replicate(v)[i * n:(i + 1) * n],
                     ("batch", "seq", None)[:v.ndim])


def _value_and_grad(loss_fn: Callable, params: Any, batch: dict
                    ) -> tuple[torch.Tensor, list]:
    """``loss_fn(params, batch)`` and its fp32 gradient per leaf of
    ``params`` (flattened order; zeros for a leaf the loss does not use,
    as ``jax.grad`` gives)."""
    leaves, treedef = compat.tree_flatten(params)
    live = [p.detach().requires_grad_() for p in leaves]
    with torch.enable_grad():
        loss = loss_fn(compat.tree_unflatten(treedef, live), batch)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
    return loss.detach(), [
        torch.zeros_like(p, dtype=torch.float32) if g is None
        else g.to(torch.float32) for p, g in zip(leaves, grads)]


def make_train_builder(cfg: ModelConfig, opt_cfg: OptConfig, mesh: Any = None
                       ) -> Callable[[SpecCtx], Callable]:
    """Returns the handler builder for ``train_step(state, batch)``.

    ``state = {"params": ..., "opt": ...}`` (the optimizer state of
    :func:`repro_torch.optim.init_opt_state`); ``batch`` holds ``labels``
    and ``tokens`` (or ``embeds``), each with the batch on its leading
    axis.  Returns ``(new state, {"loss": fp32 0-d tensor})``.  The loss
    stays on the device: reading it is the caller's synchronisation.

    Which state comes back depends on the registration, as in the
    reference (``jax.jit(..., donate_argnums=0)``):

    * undonated (the default): the step is functional.  The input state
      is left unchanged and new trees come back
      (:func:`repro_torch.optim.apply_updates`), so a caller may call it
      twice on one state and compare.
    * donated (``register(..., donate_argnums=0)``, ``spec.donated(0)``):
      the AdamW update writes params, ``m``, ``v``, ``count`` (and ``ef``)
      into the state's own tensors
      (:func:`repro_torch.optim.update_in_place`) and the step returns the
      dict it was given.  The state is written only after the loss and
      the gradients exist, so an exception before then leaves it whole;
      the runtime's guards run before the variant, so a guard miss hands
      the generic variant an untouched state.  Under a mesh a leaf not
      yet placed by its axes (a plain tensor on the first step) is
      replaced in the dict by its placed DTensor, which later steps then
      update in place.

    The reference's points, labels, candidates and defaults (all internal
    tuning parameters, so none carries a guard): those of
    :func:`run_options_from_spec` with ``remat`` and every implementation
    pinned to a gradient-safe entry (the step-wide one too, so no family
    reaches a kernel); ``microbatch`` (1, 2, 4: the batch's
    leading axis split as ``(micro, -1)``, the gradients summed, then
    divided by ``micro``); ``logits_layout`` (``gathered`` replicates the
    logits' vocab dim before the loss; one placement without a mesh);
    ``loss_chunk`` (0 = the full logits, else :func:`chunked_cross_entropy`
    over chunks of that many positions, which must divide S) and
    ``sharding_profile``.

    Under ``mesh`` the step runs in the profile's rules and places the
    parameters, the gradients and the optimizer state
    (:func:`~repro_torch.optim.opt_state_axes`: ``m``, ``v`` and ``ef`` by
    the parameters' axes) by their logical axes (DTensors, as the
    reference's ``_constrain_tree``); the update runs on each rank's
    shards, and the loss comes back as a plain tensor, the same on every
    rank.
    """

    def builder(spec: SpecCtx) -> Callable:
        donate = spec.donated(0)
        opts = run_options_from_spec(spec, cfg, differentiable=True)
        micro = spec.enum("microbatch", 1, (1, 2, 4), guarded=False)
        gather_logits = spec.enum("logits_layout", "sharded",
                                  ("sharded", "gathered"),
                                  guarded=False) == "gathered"
        loss_chunk = spec.enum("loss_chunk", 0, (0, 16, 256, 512, 1024),
                               guarded=False)   # 0 = unchunked (generic)
        rules = _rules_from_spec(spec)
        if opts.remat != "none":
            # a non-reentrant checkpoint's first call imports torch._dynamo
            # (seconds): import it while the variant builds, off the
            # critical path, not inside the first step
            importlib.import_module("torch._dynamo")

        def loss_fn(params, batch):
            if loss_chunk:
                hidden, aux = model.apply(
                    params, cfg, opts, tokens=batch.get("tokens"),
                    embeds=batch.get("embeds"), return_hidden=True)
                head = model.lm_head_weight(params, cfg)
                return chunked_cross_entropy(
                    hidden, head, batch["labels"], loss_chunk) + aux
            logits, aux = model.apply(
                params, cfg, opts, tokens=batch.get("tokens"),
                embeds=batch.get("embeds"))
            return cross_entropy(logits, batch["labels"],
                                 gather_logits) + aux

        def train_step(state, batch):
            with mesh_context(mesh, rules):
                return _train_step(state, batch)

        def _train_step(state, batch):
            ax = model.param_axes(cfg)
            params = _constrain_tree(state["params"], ax)
            opt = _constrain_tree(state["opt"], opt_state_axes(ax, opt_cfg))
            grads, loss_total = None, None
            for i in range(micro):
                mb = batch if micro == 1 else {
                    k: _microbatch(v, i, micro) for k, v in batch.items()}
                li, gi = _value_and_grad(loss_fn, params, mb)
                grads = gi if grads is None else [
                    a + b for a, b in zip(grads, gi)]
                loss_total = li if loss_total is None else loss_total + li
            if micro > 1:
                grads = [g / micro for g in grads]
            _, treedef = compat.tree_flatten(params)
            grads = _constrain_tree(compat.tree_unflatten(treedef, grads),
                                    ax)
            metrics = {"loss": replicate(loss_total / micro)}
            if not donate:
                new_params, new_opt = apply_updates(params, grads, opt,
                                                    opt_cfg)
                return {"params": new_params, "opt": new_opt}, metrics
            update_in_place(params, grads, opt, opt_cfg)
            state["params"] = params
            state["opt"] = opt
            return state, metrics

        return train_step

    return builder
