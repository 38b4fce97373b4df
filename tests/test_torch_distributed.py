"""The port's distributed layer on 4 gloo ranks of the CPU, a
(data=2, model=2) mesh, held to one process: a sharding never changes the
numbers (GSPMD's contract, which the reference relies on).

One module-scoped run spawns the ranks (a script in a subprocess, with a
``file://`` rendezvous under ``tmp_path``, never a fixed port) and every
rank records each check; the tests read the records:

* ``compressed_psum``: int8 in the gathered buffer, and within int8 error
  of the plain sum (relative error < 0.02 against 2 x);
* the ``shard`` MoE against the reference's ``dense`` on the same numpy
  weights (2e-5), its aux loss against the data shards' mean, and its
  gradients against the single-process ``gather``'s (1e-5 relative);
* the full-sequence attention on each rank's own heads
  (:func:`repro_torch.models.attention.sharded_attention`) against the
  plain attention on all of them, with kv heads split and replicated,
  and its gradients;
* the ``shard`` MoE refusing tokens that do not divide over ``data``;
* sharded train steps, from the reference's initial state, against the
  reference's jitted one-process step and the port's one-process step
  (loss within 1e-5; the gradient, as the new first moment, and every
  parameter within 1e-5 relative, at the default schedule: AdamW's
  first step is about ``sign(g)``, so at a larger learning rate a
  gradient near zero would turn a different order of the sums into a
  visible update; under ``int8_ef`` the first moment at most one int8
  step away in < 0.1 % of the elements): reduced qwen3 under ``dp``,
  ``fsdp`` and ``seq``, reduced deepseek-v2 under ``fsdp`` and
  ``fsdp_noexp``, each with ``compress`` none and ``int8_ef``, and
  reduced kimi-k2 under ``fsdp`` with the ``gather`` and ``einsum`` MoE
  at a binding capacity and with ``microbatch`` 2; the attention of each
  step ran on the rank's own batch rows and heads;
* the vocab-parallel token NLL under both ``logits_layout``s (value and
  gradient, masked labels, labels in each vocab shard) against one
  process and the reference's ``cross_entropy``;
* ``apply_moe`` on each rank's own tokens (two groups a data rank, and
  one group at a binding capacity) against one process, with gradients;
* a reduced hymba whose 3 heads do not divide ``model``: the prefill
  against one process, each rank attending with its uneven share;
* a reduced deepseek-v2 decode step under ``serve_ep`` against the
  reference's jitted step (logits and cache, 1e-5) and the port's one
  process;
* ``restore(axes=...)`` onto the mesh.

The reference's steps run in the test process while the ranks run.
"""
import json
import os
import pickle
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro import optim as ref_optim  # noqa: E402
from repro.core.specializer import specialize_builder as ref_specialize  # noqa: E402
from repro.models import moe as ref_moe  # noqa: E402
from repro.models import transformer as ref_model  # noqa: E402
from repro.models.config import ModelConfig as RefModelConfig  # noqa: E402
from repro.training import steps as ref_steps  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs import tuned  # noqa: E402

#: the moe layer of the reference's test_distributed_small.py
MOE_CFG = dict(name="m", family="moe", n_layers=1, d_model=32, n_heads=4,
               n_kv_heads=2, d_ff=64, vocab_size=128, n_experts=8, top_k=2,
               moe_d_ff=48, n_shared_experts=1)
#: (arch, sharding profile, compress, the other spec points of the step)
TRAIN_CASES = [("qwen3-0.6b", p, c, {}) for p in ("dp", "fsdp", "seq")
               for c in ("none", "int8_ef")] + \
              [("deepseek-v2-236b", p, c, {}) for p in ("fsdp", "fsdp_noexp")
               for c in ("none", "int8_ef")] + \
              [("kimi-k2-1t-a32b", "fsdp", "none", spec) for spec in (
                  {"moe_impl": "gather", "capacity_factor": 1.0},
                  {"moe_impl": "einsum", "capacity_factor": 1.0},
                  {"moe_impl": "gather", "microbatch": 2})] + \
              [("qwen3-0.6b", "fsdp", "int8_ef", {"donate": 0}),
               ("deepseek-v2-236b", "fsdp_noexp", "none", {"donate": 0})]
#: a case's spec entry ``donate`` is no spec point: the sharded step is
#: built with ``donate_argnums=(donate,)`` (the one-process step and the
#: reference's are not) and runs on a clone of the state
DONATE = "donate"


def _train_id(case):
    arch, profile, compress, spec = case
    return "-".join([arch, profile, compress]
                    + [f"{k}={v}" for k, v in spec.items()])


TRAIN_IDS = [_train_id(c) for c in TRAIN_CASES]
#: apply_moe on the mesh: 2 groups a data rank, and one group whose
#: capacity binds (positions continue across the data ranks)
MOE_GROUP_CASES = [{"impl": i, "group_size": 16} for i in ("gather", "einsum")] \
    + [{"impl": i, "capacity_factor": 1.0} for i in ("gather", "einsum")]
#: the NLL's inputs: (B, S, V) logits, labels in both vocab halves, some -1
NLL_SHAPE = (4, 8, 64)
WORLD = 4
TIMEOUT = 300
B, S = 4, 16
DECODE_STEPS = 3
DECODE_CONFIG = {"sharding_profile": "serve_ep", "cache_dtype": "float32"}
#: the cached steps on the mesh: (name, arch, kind, cache_layout, kv
#: heads).  Reduced qwen3's 2 kv heads divide over model=2, so both
#: layouts split the heads; with 1 kv head ``seq`` splits the slots (the
#: split softmax) and ``batch`` keeps the heads replicated
CACHED_CASES = [
    ("qwen3_seq", "qwen3-0.6b", "decode", "seq", None),
    ("qwen3_batch", "qwen3-0.6b", "decode", "batch", None),
    ("qwen3_kv1_seq", "qwen3-0.6b", "decode", "seq", 1),
    ("qwen3_kv1_batch", "qwen3-0.6b", "decode", "batch", 1),
    ("qwen3_kv1_serve", "qwen3-0.6b", "serve", "seq", 1),
    ("mla_serve", "deepseek-v2-236b", "serve", "seq", None),
    ("rwkv6_serve", "rwkv6-1.6b", "serve", "seq", None),
    ("hymba_serve", "hymba-1.5b", "serve", "seq", 1),
]
#: the allocation guard's decode steps: (name, arch, cache_layout, kv heads)
GUARD_CASES = [
    ("qwen3_kv1_seq", "qwen3-0.6b", "seq", 1),
    ("qwen3_batch", "qwen3-0.6b", "batch", None),
    ("mla_seq", "deepseek-v2-236b", "seq", None),
]

_RANKS = r'''
import json, os, pickle, sys, traceback
import numpy as np
import torch
import torch.distributed as dist
import torch.utils._python_dispatch

from repro_torch import compat, configs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core.specializer import specialize_builder
from repro_torch.distributed import compression, sharding as sh
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe, transformer as model
from repro_torch.models import train_state_from_numpy
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import RunOptions
from repro_torch.optim import OptConfig, init_opt_state
from repro_torch.training import steps

TRAIN_CASES = json.loads(sys.argv[3])
MOE_CFG = json.loads(sys.argv[4])
CACHED_CASES = json.loads(sys.argv[5])
GUARD_CASES = json.loads(sys.argv[6])
TRAIN_IDS = json.loads(sys.argv[7])
MOE_GROUP_CASES = json.loads(sys.argv[8])
GUARD_LEN = 4096
PREFILL_ARCHS = ["rwkv6-1.6b", "hymba-1.5b"]
B, S, DECODE_STEPS = 4, 16, 3
DECODE_CONFIG = {"sharding_profile": "serve_ep", "cache_dtype": "float32"}


def full(x):
    return sh.replicate(x)


def rel(a, b):
    """max |a - b| over max |b|"""
    a, b = full(a).double(), full(b).double()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def quanta(a, b):
    """(max |a - b| in int8 steps of b's per-tensor scale, share of the
    elements that differ by more than 1e-5 relative)"""
    a, b = full(a).double(), full(b).double()
    d = (a - b).abs()
    big = b.abs().max().clamp_min(1e-30)
    return (float(d.max() / (big / 127)),
            float((d > 1e-5 * big).double().mean()))


def absdiff(a, b):
    return float((full(a).double() - full(b).double()).abs().max())


def check_psum(mesh):
    x = torch.randn(64, 32, generator=torch.Generator().manual_seed(3))
    wire = []
    orig = dist.all_gather_into_tensor

    def spy(out, inp, *a, **k):
        wire.append(str(out.dtype))
        return orig(out, inp, *a, **k)

    dist.all_gather_into_tensor = spy
    try:
        y = compression.compressed_psum(x, "data", mesh)
        tree = compression.compressed_psum_tree({"a": x, "b": [x[:4]]},
                                                "model", mesh)
    finally:
        dist.all_gather_into_tensor = orig
    return {"wire": wire, "rel": rel(y, 2 * x), "dtype": str(y.dtype),
            "tree_rel": max(rel(tree["a"], 2 * x),
                            rel(tree["b"][0], 2 * x[:4]))}


def check_shard_moe(mesh, data):
    cfg = ModelConfig(**MOE_CFG)
    names = ["router", "wg", "wu", "wd"]
    p = {n: torch.from_numpy(data[n]) for n in names}
    p["shared"] = {n: torch.from_numpy(data["shared_" + n])
                   for n in ("wg", "wu", "wd")}
    x = torch.from_numpy(data["x"])
    opts = moe.MoEOptions(impl="shard", capacity_factor=8.0)
    moe.reset_degrades()

    def leaves(tree):
        return [t.detach().requires_grad_() for t in compat.tree_leaves(tree)]

    _, td = compat.tree_flatten(p)
    lp, lx = leaves(p), x.detach().requires_grad_()
    with sh.mesh_context(mesh, sh.DEFAULT_RULES):
        out, aux = moe.apply_moe(compat.tree_unflatten(td, lp), lx, cfg,
                                 opts)
        loss = full(torch.sum(out ** 2) + aux)
        grads = torch.autograd.grad(loss, lp + [lx])
        out_full, aux_full = full(out), full(aux)
    deg = moe.degrades
    # 3 tokens do not divide over data=2: refused, as the reference's
    # shard_map in_spec refuses them (not a counted degrade)
    try:
        with sh.mesh_context(mesh, sh.DEFAULT_RULES):
            moe.apply_moe(p, x[:1, :3], cfg, opts)
        indivisible = "ran"
    except ValueError as e:
        indivisible = str(e)
    # the oracle: gather on all tokens in one process; the aux loss is the
    # mean of the two data shards' (the tokens of batch rows 0-1 and 2-3)
    gopts = moe.MoEOptions(impl="gather", capacity_factor=8.0)
    rp, rx = leaves(p), x.detach().requires_grad_()
    pp = compat.tree_unflatten(td, rp)
    o_ref, _ = moe.apply_moe(pp, rx, cfg, gopts)
    aux_ref = 0.5 * (moe.apply_moe(pp, rx[:2], cfg, gopts)[1]
                     + moe.apply_moe(pp, rx[2:], cfg, gopts)[1])
    ref_grads = torch.autograd.grad(torch.sum(o_ref ** 2) + aux_ref,
                                    rp + [rx])
    return {"dense_err": absdiff(out_full, torch.from_numpy(data["dense"])),
            "aux_err": abs(float(aux_full) - float(aux_ref)),
            "grad_finite": all(bool(torch.isfinite(g).all()) for g in grads),
            "grad_rel": max(rel(g, r) for g, r in zip(grads, ref_grads)),
            "degrades": deg, "out_type": type(out).__name__,
            "indivisible": indivisible, "degrades_after": moe.degrades}


def load_state(workdir, arch, compress):
    """The reference's initial train state, as the test process wrote it."""
    with open(os.path.join(workdir, f"state_{arch}_{compress}.pkl"),
              "rb") as f:
        return train_state_from_numpy(pickle.load(f), "cpu")


def train_setup(workdir, arch, compress):
    cfg = configs.get_reduced(arch).replace(compute_dtype="float32")
    opt = OptConfig(compress=compress)     # the default schedule
    rs = np.random.RandomState(7)
    toks = torch.from_numpy(rs.randint(0, cfg.vocab_size, (B, S + 1))
                            .astype(np.int32))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    return cfg, opt, load_state(workdir, arch, compress), batch


def attention_spy(seen):
    """``attn_mod.attn_op`` that records the (q, k) shapes it is given."""
    op = attn_mod.attn_op

    def spy(q, k, v, **kw):
        seen.append([list(q.shape), list(k.shape)])
        return op(q, k, v, **kw)
    return op, spy


def local_storages(tree):
    return [sh.local_view(t).untyped_storage().data_ptr()
            for t in compat.tree_leaves(tree)]


def check_train(mesh, workdir, rank, case_id, arch, profile, compress, spec):
    cfg, opt, state, batch = train_setup(workdir, arch, compress)
    spec = dict(spec)
    donate = spec.pop("donate", None)
    config = {"sharding_profile": profile, **spec}
    plain = specialize_builder(steps.make_train_builder(cfg, opt),
                               config).fn
    sharded = specialize_builder(
        steps.make_train_builder(cfg, opt, mesh), config,
        donate_argnums=() if donate is None else (donate,)).fn
    given = compat.tree_map(torch.clone, state)
    ref_state, ref_m = plain(state, batch)
    seen, rows = [], []
    op, attn_mod.attn_op = attention_spy(seen)
    route = moe._route
    moe._route = lambda lg, k: (rows.append(lg.shape[0]), route(lg, k))[1]
    try:
        new_state, m = sharded(given, batch)
    finally:
        attn_mod.attn_op = op
        moe._route = route
    leaves = compat.tree_leaves(new_state["params"])
    moments = compat.tree_leaves(new_state["opt"]["m"])
    np.savez(os.path.join(workdir, f"train_{case_id}_{rank}.npz"),
             loss=np.float32(m["loss"]),
             **{f"p{i}": full(x).numpy() for i, x in enumerate(leaves)},
             **{f"m{i}": full(x).numpy() for i, x in enumerate(moments)})
    placed = [tuple(repr(p) for p in x.placements) for x in leaves
              if sh.is_dtensor(x)]
    rec = {"loss_err": abs(float(m["loss"]) - float(ref_m["loss"])),
           "loss_type": type(m["loss"]).__name__,
           "param_rel": max(rel(a, b) for a, b in zip(
               leaves, compat.tree_leaves(ref_state["params"]))),
           "opt_rel": max(rel(a, b) for a, b in zip(
               compat.tree_leaves(new_state["opt"]["m"]),
               compat.tree_leaves(ref_state["opt"]["m"]))),
           "opt_quanta": max(quanta(a, b) for a, b in zip(
               compat.tree_leaves(new_state["opt"]["m"]),
               compat.tree_leaves(ref_state["opt"]["m"]))),
           "n_dtensor": len(placed), "n_leaves": len(leaves),
           "sharded_leaves": sum(any("Shard" in p for p in pl)
                                 for pl in placed),
           "attn_shapes": sorted({json.dumps(x) for x in seen}),
           "route_rows": sorted(set(rows)), "donated": {}}
    if donate is not None:
        # the state comes back as the dict it was given; a second step
        # writes every leaf's local shard in place, placements unchanged
        ptrs = local_storages(new_state)
        place = [tuple(x.placements) if sh.is_dtensor(x) else None
                 for x in compat.tree_leaves(new_state)]
        again, m2 = sharded(new_state, batch)
        rec["donated"] = {
            "returns_its_state": new_state is given and again is given,
            "keeps_storage": local_storages(again) == ptrs,
            "keeps_placement": place == [
                tuple(x.placements) if sh.is_dtensor(x) else None
                for x in compat.tree_leaves(again)],
            "count": int(full(again["opt"]["count"])),
            "second_loss_finite": bool(torch.isfinite(full(m2["loss"])))}
    return rec, \
        (cfg, new_state)


def check_local_attention(mesh):
    """sharded_attention on (data=2, model=2) against the plain attention
    on all heads, with 2 kv heads (split over model) and 1 (replicated:
    each rank takes its q heads' kv head); gradients of q, k and v."""
    from repro_torch.kernels.attention import attention
    gen = torch.Generator().manual_seed(4)
    out = {}
    for hk in (2, 1):
        q, k, v = (torch.randn(4, h, 8, 16, generator=gen)
                   for h in (4, hk, hk))
        w = torch.randn(4, 4, 8, 16, generator=gen)
        ins = [t.clone().requires_grad_() for t in (q, k, v)]
        seen = []
        op, attn_mod.attn_op = attention_spy(seen)
        try:
            with sh.mesh_context(mesh, sh.DEFAULT_RULES):
                y = attn_mod.sharded_attention(*ins, causal=True,
                                               impl="torch_ref")
                placed = repr(tuple(y.placements))
                y = full(y)
                grads = torch.autograd.grad((y * w).sum(), ins)
        finally:
            attn_mod.attn_op = op
        ref_ins = [t.clone().requires_grad_() for t in (q, k, v)]
        ref = attention(*ref_ins, causal=True, impl="torch_ref")
        ref_grads = torch.autograd.grad((ref * w).sum(), ref_ins)
        out[f"hk{hk}"] = {
            "err": absdiff(y, ref), "placements": placed, "seen": seen,
            "grad_rel": max(rel(g, r) for g, r in zip(grads, ref_grads))}
    return out


def check_nll(mesh, workdir, rank):
    """cross_entropy on logits placed (batch over data, vocab over model),
    built from each rank's own shard, under both logits layouts: the loss
    and the gradient of the rank's shard against one process, and the
    largest tensor the sharded layout's loss and backward make."""
    from torch.distributed.tensor import DTensor
    with np.load(os.path.join(workdir, "nll.npz")) as data:
        logits, labels = data["logits"], torch.from_numpy(data["labels"])
    ref = torch.from_numpy(logits).requires_grad_()
    out = {}
    for gather in (False, True):
        one = steps.cross_entropy(ref, labels, gather)
        g_one, = torch.autograd.grad(one, [ref])
        with sh.mesh_context(mesh, sh.DEFAULT_RULES):
            spec = sh.logical_to_spec(("batch", "seq", "vocab"), ref.shape)
            place = sh.placements(spec, mesh)
            b0 = mesh.get_local_rank("data") * logits.shape[0] // 2
            v0 = mesh.get_local_rank("model") * logits.shape[2] // 2
            local = torch.from_numpy(np.ascontiguousarray(logits[
                b0:b0 + logits.shape[0] // 2, :,
                v0:v0 + logits.shape[2] // 2])).requires_grad_()
            dt = DTensor.from_local(local, mesh, place, run_check=False)
            with Biggest() as big:
                loss = steps.cross_entropy(dt, labels, gather)
                g, = torch.autograd.grad(loss, [local])
        name = "gathered" if gather else "sharded"
        loss = full(loss).detach()
        out[name] = {
            "loss_err": abs(float(loss) - float(one)),
            "grad_err": absdiff(g, g_one[b0:b0 + logits.shape[0] // 2, :,
                                         v0:v0 + logits.shape[2] // 2]),
            "biggest": list(big.biggest), "local": local.nbytes,
            "placements": repr(place)}
        np.savez(os.path.join(workdir, f"nll_{name}_{rank}.npz"),
                 loss=np.float32(loss), grad=g.numpy(), b0=b0, v0=v0)
    return out


def check_grouped_moe(mesh, data):
    """apply_moe on each rank's own tokens (x (4, 16, d): 32 tokens a data
    rank) against one process, output and gradients: the routing ran on
    the rank's rows."""
    cfg = ModelConfig(**MOE_CFG)
    p = {n: torch.from_numpy(data[n]) for n in ["router", "wg", "wu", "wd"]}
    p["shared"] = {n: torch.from_numpy(data["shared_" + n])
                   for n in ("wg", "wu", "wd")}
    _, td = compat.tree_flatten(p)
    x = torch.from_numpy(data["x"])
    out = {}
    for case in MOE_GROUP_CASES:
        opts = moe.MoEOptions(**case)

        def run(mesh_):
            lp = [t.detach().requires_grad_() for t in compat.tree_leaves(p)]
            lx = x.detach().requires_grad_()
            with sh.mesh_context(mesh_, sh.DEFAULT_RULES):
                o, aux = moe.apply_moe(compat.tree_unflatten(td, lp), lx, cfg,
                                       opts)
                loss = full(torch.sum(o ** 2) + aux)
                grads = torch.autograd.grad(loss, lp + [lx])
                return full(o), full(aux), grads

        rows = []
        route = moe._route
        moe._route = lambda lg, k: (rows.append(lg.shape[0]), route(lg, k))[1]
        try:
            o, aux, grads = run(mesh)
        finally:
            moe._route = route
        o1, aux1, grads1 = run(None)
        out[json.dumps(case, sort_keys=True)] = {
            "out_err": absdiff(o, o1), "aux_err": absdiff(aux, aux1),
            "grad_rel": max(rel(g, r) for g, r in zip(grads, grads1)),
            "route_rows": rows}
    return out


def check_decode(mesh, workdir, rank):
    cfg = configs.get_reduced("deepseek-v2-236b").replace(
        compute_dtype="float32")
    params = load_state(workdir, "deepseek-v2-236b", "none")["params"]
    plain = specialize_builder(steps.make_decode_builder(cfg),
                               DECODE_CONFIG).fn
    sharded = specialize_builder(steps.make_decode_builder(cfg, mesh),
                                 DECODE_CONFIG).fn
    opts = RunOptions(decode_cache_dtype="float32")
    c_plain = model.init_cache(cfg, B, 8, opts, device="cpu")
    c_mesh = model.init_cache(cfg, B, 8, opts, device="cpu")
    toks = torch.from_numpy(np.random.RandomState(5).randint(
        0, cfg.vocab_size, (DECODE_STEPS, B)).astype(np.int32))
    logit_err, cache_err, logits = 0.0, 0.0, []
    for t in range(DECODE_STEPS):
        pos = torch.tensor(t, dtype=torch.int32)
        lg_p, c_plain = plain(params, c_plain, toks[t], pos)
        lg_m, c_mesh = sharded(params, c_mesh, toks[t], pos)
        logits.append(full(lg_m).numpy())
        logit_err = max(logit_err, absdiff(lg_m, lg_p))
        cache_err = max(cache_err, max(absdiff(a, b) for a, b in zip(
            compat.tree_leaves(c_mesh), compat.tree_leaves(c_plain))))
    placed = sorted({repr(tuple(x.placements))
                     for x in compat.tree_leaves(c_mesh)})
    np.savez(os.path.join(workdir, f"decode_{rank}.npz"),
             logits=np.stack(logits),
             **{f"c{i}": full(x).numpy()
                for i, x in enumerate(compat.tree_leaves(c_mesh))})
    return {"logit_err": logit_err, "cache_err": cache_err,
            "cache_placements": placed}


class Biggest(torch.utils._python_dispatch.TorchDispatchMode):
    """The largest tensor any op makes (a DTensor's local shard; an
    output that shares an input's storage, a view or an in-place write,
    makes nothing)."""

    def __init__(self):
        super().__init__()
        self.biggest = (0, "", [])

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.utils._python_dispatch import \
            is_traceable_wrapper_subclass
        out = func(*args, **(kwargs or {}))

        def loc(t):
            # a wrapper (DTensor, a collective's pending result): its data
            while is_traceable_wrapper_subclass(t):
                t = getattr(t, t.__tensor_flatten__()[0][0])
            return t

        tensors = lambda tree: [loc(t) for t in compat.tree_leaves(tree)
                                if isinstance(t, torch.Tensor)]
        ins = {t.untyped_storage().data_ptr()
               for t in tensors((args, kwargs or {}))}
        for t in tensors(out):
            if t.untyped_storage().data_ptr() not in ins:
                self.biggest = max(self.biggest,
                                   (t.nbytes, str(func), list(t.shape)))
        return out


def cached_cfg(arch, kv_heads):
    cfg = configs.get_reduced(arch).replace(compute_dtype="float32")
    return cfg if kv_heads is None else cfg.replace(n_kv_heads=kv_heads)


def cached_params(workdir, arch, cfg, kv_heads):
    if arch == "qwen3-0.6b" and kv_heads is None:
        # the reference's weights: one case is held to its jitted step
        return load_state(workdir, arch, "none")["params"]
    return model.init_params(torch.Generator().manual_seed(0), cfg)


def check_cached(mesh, workdir, rank, name, arch, kind, layout, kv_heads):
    """A cached step on the mesh against one process from the same
    weights and an empty fp32 cache: a scalar-pos decode chain
    (``kind`` decode), or the serve step's ragged chunked prefill (idle
    rows included) then vector-pos decode (``kind`` serve); the logits
    of every step and the last cache, and the cache's placements."""
    cfg = cached_cfg(arch, kv_heads)
    params = cached_params(workdir, arch, cfg, kv_heads)
    config = {"cache_layout": layout, "cache_dtype": "float32"}
    make = (steps.make_decode_builder if kind == "decode"
            else steps.make_serve_builder)
    plain = specialize_builder(make(cfg), config).fn
    sharded = specialize_builder(make(cfg, mesh), config).fn
    opts = RunOptions(decode_cache_dtype="float32")
    max_len = 16 if kind == "serve" else 8
    c_plain = model.init_cache(cfg, B, max_len, opts, device="cpu")
    c_mesh = model.init_cache(cfg, B, max_len, opts, device="cpu")
    rs = np.random.RandomState(9)
    toks = lambda *s: torch.from_numpy(rs.randint(
        0, cfg.vocab_size, s).astype(np.int32))
    i32 = lambda v: torch.tensor(v, dtype=torch.int32)
    if kind == "decode":
        calls = [(toks(B), i32(t)) for t in range(DECODE_STEPS)]
    else:
        # chunks of 4 with ragged counts (row 3 idle in the first), then
        # vector-pos decode steps from each row's own position
        n1, n2 = [4, 2, 3, 0], [2, 4, 1, 3]
        calls = [(toks(B, 4), i32([0] * B), i32(n1)),
                 (toks(B, 4), i32(n1), i32(n2))]
        pos = [a + b for a, b in zip(n1, n2)]
        calls += [(toks(B), i32([p + t for p in pos]), i32([1] * B))
                  for t in range(2)]
    logit_err, logits = 0.0, []
    for args in calls:
        lg_p, c_plain = plain(params, c_plain, *args)
        lg_m, c_mesh = sharded(params, c_mesh, *args)
        logits.append(full(lg_m).numpy())
        logit_err = max(logit_err, absdiff(lg_m, lg_p))
    cache_err = max(absdiff(a, b) for a, b in zip(
        compat.tree_leaves(c_mesh), compat.tree_leaves(c_plain)))
    np.savez(os.path.join(workdir, f"cached_{name}_{rank}.npz"),
             logits=np.stack(logits))
    return {"logit_err": logit_err, "cache_err": cache_err,
            "logit_type": type(lg_m).__name__,
            "cache_placements": {
                "/".join(map(str, path)): repr(tuple(x.placements))
                for path, x in zip(_paths(c_mesh), compat.tree_leaves(c_mesh))}}


def _paths(tree, pre=()):
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _paths(tree[k], pre + (k,))]
    return [pre]


def check_guard(mesh, workdir, name, arch, layout, kv_heads):
    """The largest tensor any op makes in a placed cached step, on each
    rank, against the whole of the largest cache leaf: a cache long
    enough (GUARD_LEN slots) that a whole leaf is at least 8 x any tensor
    the one-process step makes."""
    cfg = cached_cfg(arch, kv_heads)
    params = cached_params(workdir, arch, cfg, kv_heads)
    config = {"cache_layout": layout, "cache_dtype": "float32"}
    plain = specialize_builder(steps.make_decode_builder(cfg), config).fn
    sharded = specialize_builder(steps.make_decode_builder(cfg, mesh),
                                 config).fn
    opts = RunOptions(decode_cache_dtype="float32")
    cache = model.init_cache(cfg, B, GUARD_LEN, opts, device="cpu")
    leaf = max(t.nbytes for t in compat.tree_leaves(cache))
    tok = torch.zeros(B, dtype=torch.int32)
    with Biggest() as one:
        plain(params, cache, tok, torch.tensor(0, dtype=torch.int32))
    # the first mesh step places the cache; the guarded one takes it placed
    _, placed = sharded(params, cache, tok, torch.tensor(0, dtype=torch.int32))
    with Biggest() as guard:
        sharded(params, placed, tok, torch.tensor(1, dtype=torch.int32))
    return {"leaf": leaf, "one_process": list(one.biggest),
            "biggest": list(guard.biggest)}


def check_prefill(mesh, arch, heads=None):
    """The prefill step on the mesh against one process: rwkv6's time mix
    and hymba's SSM scan run on each rank's batch rows (and rwkv6's
    heads); ``heads`` (q, kv) overrides the config's, and the attention's
    (q, k) shapes on the rank are recorded."""
    cfg = configs.get_reduced(arch).replace(compute_dtype="float32")
    if heads is not None:
        cfg = cfg.replace(n_heads=heads[0], n_kv_heads=heads[1])
    params = model.init_params(torch.Generator().manual_seed(0), cfg)
    plain = specialize_builder(steps.make_prefill_builder(cfg), {}).fn
    sharded = specialize_builder(steps.make_prefill_builder(cfg, mesh),
                                 {}).fn
    toks = torch.from_numpy(np.random.RandomState(3).randint(
        0, cfg.vocab_size, (B, S)).astype(np.int32))
    batch = {"tokens": toks}
    seen = []
    op, attn_mod.attn_op = attention_spy(seen)
    try:
        got = sharded(params, batch)
    finally:
        attn_mod.attn_op = op
    return {"rel": rel(got, plain(params, batch)), "attn_shapes": seen,
            "model_rank": mesh.get_local_rank("model")}


def check_restore(mesh, rank, workdir, cfg, state):
    mgr = CheckpointManager(os.path.join(workdir, f"ckpt_{rank}"),
                            async_save=False)
    mgr.save(1, state["params"])
    template = compat.tree_map(torch.zeros_like,
                               model.init_params(
                                   torch.Generator().manual_seed(1), cfg))
    ax = model.param_axes(cfg)
    rules = steps.SHARDING_PROFILES["fsdp"](sh.DEFAULT_RULES)
    with sh.mesh_context(mesh, rules):
        restored, meta = mgr.restore(template, axes=ax)
        want = sh.spec_for_axes(ax, template)
    got = compat.tree_leaves(restored)
    wants = compat.tree_leaves(want, is_leaf=lambda x: isinstance(x, tuple))
    return {"step": meta["step"],
            "placed": all(tuple(g.placements) == w[1]
                          for g, w in zip(got, wants)),
            "err": max(absdiff(g, s) for g, s in zip(
                got, compat.tree_leaves(state["params"])))}


def check_refuse(mesh):
    """Every CUDA wrapper refuses a DTensor before it looks at devices."""
    from repro_torch.kernels.attention import kernel as attn
    from repro_torch.kernels.fastpath import kernel as fp
    from repro_torch.kernels.linear_attention import kernel as la
    from repro_torch.kernels.matmul import kernel as mm
    from repro_torch.kernels.rmsnorm import kernel as rms

    with sh.mesh_context(mesh, sh.DEFAULT_RULES):
        d2 = sh.constrain(torch.ones(8, 16), ("batch", "ffn"))
        d3 = sh.constrain(torch.ones(4, 8, 16), ("batch", None, None))
        d4 = sh.constrain(torch.ones(2, 4, 8, 16),
                          ("batch", "heads", None, None))
    w = torch.ones(16)
    calls = {
        "rmsnorm_cuda": lambda: rms.rmsnorm_cuda(d2, w),
        "rmsnorm_pair_cuda": lambda: rms.rmsnorm_pair_cuda(d2, w, d2, w),
        "flash_attention_cuda": lambda: attn.flash_attention_cuda(
            d4, d4, d4),
        "linear_attention_cuda": lambda: la.linear_attention_cuda(
            d3, d3, d3, d3),
        "matmul_cuda": lambda: mm.matmul_cuda(d2, d2),
        "fastpath_cuda": lambda: fp.fastpath_cuda(
            torch.ones(8, 1, dtype=torch.int32),
            torch.ones(16, 1, dtype=torch.int32), d2),
    }
    out = {}
    for name, call in calls.items():
        try:
            call()
            out[name] = "ran"
        except Exception as e:
            out[name] = f"{type(e).__name__}: {e}"
    return out


def main(rank, world, init, workdir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    mesh = make_local_mesh(2, 2, device="cpu")
    out = {}

    def record(name, fn, *args):
        try:
            out[name] = fn(*args)
        except Exception:
            out[name] = {"error": traceback.format_exc()}
        return out[name]

    record("psum", check_psum, mesh)
    record("refuse", check_refuse, mesh)
    record("attention", check_local_attention, mesh)
    with np.load(os.path.join(workdir, "moe.npz")) as data:
        record("shard_moe", check_shard_moe, mesh, dict(data))
    record("nll", check_nll, mesh, workdir, rank)
    with np.load(os.path.join(workdir, "moe.npz")) as data:
        record("grouped_moe", check_grouped_moe, mesh, dict(data))
    kept = None
    for case_id, (arch, profile, compress, spec) in zip(TRAIN_IDS,
                                                        TRAIN_CASES):
        name = f"train:{case_id}"
        try:
            out[name], res = check_train(mesh, workdir, rank, case_id, arch,
                                         profile, compress, spec)
            if case_id == "qwen3-0.6b-fsdp-none":
                kept = res
        except Exception:
            out[name] = {"error": traceback.format_exc()}
    record("decode", check_decode, mesh, workdir, rank)
    for case in CACHED_CASES:
        record("cached:" + case[0], check_cached, mesh, workdir, rank, *case)
    for case in GUARD_CASES:
        record("guard:" + case[0], check_guard, mesh, workdir, *case)
    for arch in PREFILL_ARCHS:
        record("prefill:" + arch, check_prefill, mesh, arch)
    record("prefill:hymba_uneven", check_prefill, mesh, "hymba-1.5b", (3, 1))
    if kept is not None:
        record("restore", check_restore, mesh, rank, workdir, *kept)
    with open(os.path.join(workdir, f"rank_{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    workdir = sys.argv[1]
    init = "file://" + os.path.join(workdir, "rendezvous")
    torch.multiprocessing.spawn(main, args=(int(sys.argv[2]), init, workdir),
                                nprocs=int(sys.argv[2]))
'''


def _moe_inputs(path):
    """Numpy weights and input for the shard MoE case, and the reference's
    ``dense`` output on them (ample capacity: no token dropped)."""
    cfg = RefModelConfig(**MOE_CFG)
    rs = np.random.RandomState(11)
    d, e, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    w = lambda *s: (rs.randn(*s) * s[-2] ** -0.5).astype(np.float32)
    data = {"router": w(d, e), "wg": w(e, d, f), "wu": w(e, d, f),
            "wd": w(e, f, d), "shared_wg": w(d, f), "shared_wu": w(d, f),
            "shared_wd": w(f, d),
            "x": rs.randn(4, 16, d).astype(np.float32)}
    p = {n: jnp.asarray(data[n]) for n in ("router", "wg", "wu", "wd")}
    p["shared"] = {n: jnp.asarray(data["shared_" + n])
                   for n in ("wg", "wu", "wd")}
    out, _ = ref_moe.apply_moe(p, jnp.asarray(data["x"]), cfg,
                               ref_moe.MoEOptions(impl="dense",
                                                  capacity_factor=8.0))
    data["dense"] = np.asarray(out)
    np.savez(path, **data)


def _nll_inputs(path):
    """Logits and labels for the NLL case (labels in both vocab halves of
    every row of the batch, some masked), and the reference's
    ``cross_entropy`` and its gradient on them."""
    rs = np.random.RandomState(13)
    logits = (rs.randn(*NLL_SHAPE) * 3).astype(np.float32)
    labels = rs.randint(0, NLL_SHAPE[2], NLL_SHAPE[:2]).astype(np.int32)
    labels[:, 0] = 5                                  # the first vocab half
    labels[:, 1] = NLL_SHAPE[2] - 3                   # the second
    labels[0, 2:5] = -1
    labels[3, -1] = -1
    np.savez(path, logits=logits, labels=labels)
    loss, grad = jax.value_and_grad(ref_steps.cross_entropy)(
        jnp.asarray(logits), jnp.asarray(labels))
    return float(loss), np.asarray(grad)


def _ref_cfg(arch):
    return ref_configs.get_reduced(arch).replace(compute_dtype="float32")


def _reference_states(work):
    """The reference's initial train state of each (arch, compress) of
    TRAIN_CASES, as numpy, pickled for the ranks."""
    states = {}
    for arch, compress in sorted({(a, c) for a, _, c, _ in TRAIN_CASES}):
        opt = ref_optim.OptConfig(compress=compress)
        params = ref_model.init_params(jax.random.PRNGKey(0), _ref_cfg(arch))
        states[arch, compress] = jax.tree_util.tree_map(np.asarray, {
            "params": params, "opt": ref_optim.init_opt_state(params, opt)})
        with open(work / f"state_{arch}_{compress}.pkl", "wb") as f:
            pickle.dump(states[arch, compress], f)
    return states


def _reference_train(states):
    """The reference's jitted one-process train step of each case's state
    and spec points (the sharding profile aside) on the ranks' batch:
    (loss, new params, new first moment), leaves, by case id."""
    out, done = {}, {}
    for case_id, (arch, _, compress, spec) in zip(TRAIN_IDS, TRAIN_CASES):
        spec = {k: v for k, v in spec.items() if k != DONATE}
        key = (arch, compress, json.dumps(spec, sort_keys=True))
        if key in done:
            out[case_id] = done[key]
            continue
        state = states[arch, compress]
        cfg = _ref_cfg(arch)
        step = jax.jit(ref_specialize(ref_steps.make_train_builder(
            cfg, ref_optim.OptConfig(compress=compress), kernel_impl="xla"),
            spec).fn)
        toks = np.random.RandomState(7).randint(
            0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
        new, m = step(state, {"tokens": toks[:, :-1],
                              "labels": toks[:, 1:]})
        leaves = lambda t: [np.asarray(x) for x in jax.tree_util.tree_leaves(t)]
        out[case_id] = done[key] = (float(m["loss"]), leaves(new["params"]),
                                    leaves(new["opt"]["m"]))
    return out


def _reference_decode(states):
    """The reference's jitted decode step of reduced deepseek-v2 under
    DECODE_CONFIG, DECODE_STEPS tokens from an empty cache: the logits of
    each step and the last cache's leaves."""
    cfg = _ref_cfg("deepseek-v2-236b")
    step = jax.jit(ref_specialize(ref_steps.make_decode_builder(
        cfg, kernel_impl="xla"), DECODE_CONFIG).fn)
    cache = ref_model.init_cache(cfg, B, 8, ref_model.RunOptions(
        decode_cache_dtype="float32"))
    params = states["deepseek-v2-236b", "none"]["params"]
    toks = np.random.RandomState(5).randint(
        0, cfg.vocab_size, (DECODE_STEPS, B)).astype(np.int32)
    logits = []
    for t in range(DECODE_STEPS):
        lg, cache = step(params, cache, jnp.asarray(toks[t]), jnp.int32(t))
        logits.append(np.asarray(lg))
    return np.stack(logits), [np.asarray(x)
                              for x in jax.tree_util.tree_leaves(cache)]


def _reference_qwen3_decode(states):
    """The reference's jitted decode steps of reduced qwen3 under
    ``cache_layout=seq`` from an empty fp32 cache, on the tokens the
    ranks' ``qwen3_seq`` case draws: the logits of each step."""
    cfg = _ref_cfg("qwen3-0.6b")
    step = jax.jit(ref_specialize(ref_steps.make_decode_builder(
        cfg, kernel_impl="xla"), {"cache_layout": "seq",
                                  "cache_dtype": "float32"}).fn)
    cache = ref_model.init_cache(cfg, B, 8, ref_model.RunOptions(
        decode_cache_dtype="float32"))
    params = states["qwen3-0.6b", "none"]["params"]
    rs = np.random.RandomState(9)
    logits = []
    for t in range(DECODE_STEPS):
        tok = rs.randint(0, cfg.vocab_size, (B,)).astype(np.int32)
        lg, cache = step(params, cache, jnp.asarray(tok), jnp.int32(t))
        logits.append(np.asarray(lg))
    return np.stack(logits)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The ranks' records, the reference's results (computed here while
    the ranks run) and the directory of the ranks' outputs."""
    work = tmp_path_factory.mktemp("gloo")
    _moe_inputs(work / "moe.npz")
    nll = _nll_inputs(work / "nll.npz")
    states = _reference_states(work)
    script = work / "ranks.py"
    script.write_text(_RANKS)
    src = os.path.join(os.path.dirname(__file__), os.pardir, "src")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(src),
               OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, str(script), str(work), str(WORLD),
         json.dumps(TRAIN_CASES), json.dumps(MOE_CFG),
         json.dumps(CACHED_CASES), json.dumps(GUARD_CASES),
         json.dumps(TRAIN_IDS), json.dumps(MOE_GROUP_CASES)],
        env=env, stdin=subprocess.DEVNULL, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        ref = {"train": _reference_train(states),
               "decode": _reference_decode(states),
               "qwen3_decode": _reference_qwen3_decode(states), "nll": nll}
        _, err = proc.communicate(timeout=TIMEOUT)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-4000:]
    recs = [json.loads((work / f"rank_{r}.json").read_text())
            for r in range(WORLD)]
    return {"ranks": recs, "ref": ref, "work": work}


@pytest.fixture(scope="module")
def ranks(run):
    return run["ranks"]


def _per_rank(ranks, name):
    recs = [r[name] for r in ranks]
    for rec in recs:
        assert "error" not in rec, rec["error"]
    return recs


def test_compressed_psum_int8_on_the_wire(ranks):
    for rec in _per_rank(ranks, "psum"):
        assert rec["wire"][0] == "torch.int8"        # the payload
        assert rec["wire"][1] == "torch.float32"     # the scales
        assert rec["dtype"] == "torch.float32"
        assert rec["rel"] < 0.02 and rec["tree_rel"] < 0.02


def test_shard_moe_matches_reference_dense(ranks):
    for rec in _per_rank(ranks, "shard_moe"):
        assert rec["out_type"] == "DTensor"
        assert rec["degrades"] == 0
        assert rec["dense_err"] < 2e-5
        assert rec["aux_err"] < 1e-6


def test_shard_moe_refuses_tokens_that_do_not_divide_over_data(ranks):
    for rec in _per_rank(ranks, "shard_moe"):
        assert "do not divide over the data dims" in rec["indivisible"]
        assert rec["degrades_after"] == 0


def test_shard_moe_gradients_match_single_process_gather(ranks):
    for rec in _per_rank(ranks, "shard_moe"):
        assert rec["grad_finite"]
        assert rec["grad_rel"] < 1e-5


@pytest.mark.parametrize("arch,profile,compress,spec", TRAIN_CASES,
                         ids=TRAIN_IDS)
def test_sharded_train_step_matches_one_process(ranks, arch, profile,
                                                compress, spec):
    micro = spec.get("microbatch", 1)
    for rec in _per_rank(ranks, "train:" + _train_id(
            (arch, profile, compress, spec))):
        assert rec["loss_type"] == "Tensor"
        assert rec["loss_err"] < 1e-5
        assert rec["param_rel"] < 1e-5
        if compress == "none":
            assert rec["opt_rel"] < 1e-5
        else:
            # the compressed gradient is quantized with the global
            # per-tensor scale, as on one device: an element whose value
            # the order of the sums moves across a rounding boundary
            # differs by one int8 step; a per-shard scale would move most
            steps_, share = rec["opt_quanta"]
            assert steps_ <= 1.001 and share < 1e-3
        # every parameter comes back as a DTensor, some of them sharded
        # (under dp too: heads, ffn and vocab over model)
        assert rec["n_dtensor"] == rec["n_leaves"]
        assert rec["sharded_leaves"] > 0
        # the attention ran on the rank's half of the (micro)batch rows
        # and its half of the heads, the whole sequence
        heads = configs.get_reduced(arch).n_heads
        assert rec["attn_shapes"]
        for shapes in rec["attn_shapes"]:
            q, _ = json.loads(shapes)
            assert q[:3] == [B // micro // 2, heads // 2, S], q
        # an MoE layer routed the rank's own tokens: its half of the
        # (micro)batch rows
        if configs.get_reduced(arch).is_moe:
            assert rec["route_rows"] == [B // micro // 2 * S], rec
        if DONATE in spec:
            assert rec["donated"] == {
                "returns_its_state": True, "keeps_storage": True,
                "keeps_placement": True, "count": 2,
                "second_loss_finite": True}
        else:
            assert rec["donated"] == {}


def _rel(got, want):
    """max |got - want| over max |want|"""
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


def _quanta(got, want):
    """(max |got - want| in int8 steps of want's per-tensor scale, share of
    the elements that differ by more than 1e-5 of want's largest)"""
    big = max(float(np.abs(want).max()), 1e-30)
    d = np.abs(got.astype(np.float64) - want)
    return float(d.max()) / (big / 127), float((d > 1e-5 * big).mean())


@pytest.mark.parametrize("arch,profile,compress,spec", TRAIN_CASES,
                         ids=TRAIN_IDS)
def test_sharded_train_step_matches_reference(run, arch, profile, compress,
                                              spec):
    """Every rank's sharded step against the reference's jitted
    one-process step from the same state and batch."""
    case_id = _train_id((arch, profile, compress, spec))
    loss, params, moments = run["ref"]["train"][case_id]
    for r in range(WORLD):
        with np.load(run["work"] / f"train_{case_id}_{r}.npz") as got:
            assert abs(float(got["loss"]) - loss) < 1e-5
            assert len(got.files) == 1 + len(params) + len(moments)
            p_err = max(_rel(got[f"p{i}"], w) for i, w in enumerate(params))
            m_got = [got[f"m{i}"] for i in range(len(moments))]
        assert p_err < 1e-5
        if compress == "none":
            assert max(_rel(g, w) for g, w in zip(m_got, moments)) < 1e-5
        else:
            # the gradients agree within 1e-5 before the int8
            # quantization: an element that close to a rounding boundary
            # lands one int8 step (of the per-tensor scale) away
            steps_, share = max(_quanta(g, w) for g, w in zip(m_got, moments))
            assert steps_ <= 1.001 and share < 1e-3, (steps_, share)


def test_cuda_wrappers_refuse_a_dtensor(ranks):
    for rec in _per_rank(ranks, "refuse"):
        assert len(rec) == 6
        for name, what in rec.items():
            assert what.startswith("RuntimeError") and "DTensor" in what, \
                (name, what)


def test_sharded_attention_runs_on_local_heads(ranks):
    """Each rank attends with its 2 of 4 batch rows and 2 of 4 q heads:
    with kv heads split (one of 2 each) and replicated (the one kv head
    taken once per q head)."""
    for rec in _per_rank(ranks, "attention"):
        for name, kv_heads in (("hk2", 1), ("hk1", 2)):
            r = rec[name]
            assert r["err"] < 1e-6 and r["grad_rel"] < 1e-6, r
            assert r["placements"] == "(Shard(dim=0), Shard(dim=1))"
            assert r["seen"] == [[[2, 2, 8, 16], [2, kv_heads, 8, 16]]]


def test_serve_ep_decode_step_matches_reference(run):
    """Every rank's serve_ep decode steps against the reference's jitted
    steps: the logits of each and the last cache, leaf by leaf."""
    logits, cache = run["ref"]["decode"]
    for r in range(WORLD):
        with np.load(run["work"] / f"decode_{r}.npz") as got:
            np.testing.assert_allclose(got["logits"], logits, rtol=1e-5,
                                       atol=1e-5)
            assert len(got.files) == 1 + len(cache)
            for i, want in enumerate(cache):
                np.testing.assert_allclose(got[f"c{i}"], want, rtol=1e-5,
                                           atol=1e-5)


def test_serve_ep_decode_step_matches_one_process(ranks):
    for rec in _per_rank(ranks, "decode"):
        assert rec["logit_err"] < 1e-5 and rec["cache_err"] < 1e-5
        # cache_layout=seq: the latent cache's sequence dim over model
        assert any("Shard(dim=2)" in p for p in rec["cache_placements"])


@pytest.mark.parametrize("case", CACHED_CASES, ids=lambda c: c[0])
def test_cached_step_on_local_shards_matches_one_process(ranks, case):
    """Each rank writes and attends on its own shard of the cache: the
    logits of every step and the last cache within 1e-5 of one process,
    the cache still placed by its axes."""
    name, arch, kind, layout, kv_heads = case
    for rec in _per_rank(ranks, "cached:" + name):
        assert rec["logit_type"] == "Tensor"
        assert rec["logit_err"] < 1e-5 and rec["cache_err"] < 1e-5, rec
        placed = rec["cache_placements"]
        if arch == "qwen3-0.6b":
            # (layers, batch, kv heads, slots, head dim): batch over data;
            # the kv heads over model where they divide, else the slots
            # under seq, else nothing
            want = ("Shard(dim=2)" if kv_heads is None else
                    "Shard(dim=3)" if layout == "seq" else "Replicate()")
            for leaf in ("k", "v"):
                assert placed[leaf] == f"(Shard(dim=1), {want})", placed
        if arch == "deepseek-v2-236b":
            assert placed["ckv"] == "(Shard(dim=1), Shard(dim=2))", placed
        if arch == "rwkv6-1.6b":
            assert placed["state"] == "(Shard(dim=1), Shard(dim=2))", placed


def test_cached_step_on_local_shards_matches_reference(run):
    """Reduced qwen3's seq-layout decode steps on every rank against the
    reference's jitted steps on the same weights and tokens."""
    for r in range(WORLD):
        with np.load(run["work"] / f"cached_qwen3_seq_{r}.npz") as got:
            np.testing.assert_allclose(got["logits"],
                                       run["ref"]["qwen3_decode"],
                                       rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", GUARD_CASES, ids=lambda c: c[0])
def test_cached_step_makes_no_whole_cache_copy(ranks, case):
    """No op of a placed cached step makes a tensor of half a whole cache
    leaf or more, on any rank: the cache is long enough that a whole leaf
    is at least 8 x the largest tensor of the one-process step."""
    for rec in _per_rank(ranks, "guard:" + case[0]):
        assert 8 * rec["one_process"][0] <= rec["leaf"], rec
        assert rec["biggest"][0] < rec["leaf"] / 2, rec


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "hymba-1.5b"])
def test_prefill_scans_on_local_rows_match_one_process(ranks, arch):
    """The logits within 1e-5 of the one-process step's largest."""
    for rec in _per_rank(ranks, "prefill:" + arch):
        assert rec["rel"] < 1e-5, rec


def test_prefill_splits_uneven_heads(ranks):
    """Reduced hymba with 3 heads and 1 kv head on model = 2: the logits
    within 1e-5 of one process, and each rank attends with its share of
    the heads as GSPMD pads them (chunks of 2: model rank 0 holds heads
    0-1, rank 1 head 2) on its 2 batch rows, with the kv head of each
    (the rank's heads split the group of 3: one kv head a q head)."""
    for rec in _per_rank(ranks, "prefill:hymba_uneven"):
        assert rec["rel"] < 1e-5, rec
        share = 2 if rec["model_rank"] == 0 else 1
        assert rec["attn_shapes"], rec
        for q, k in rec["attn_shapes"]:
            assert q[:3] == [B // 2, share, S] and k[:2] == [B // 2, share], \
                rec


@pytest.mark.parametrize("layout", ["sharded", "gathered"])
def test_vocab_parallel_nll_matches_one_process_and_reference(run, ranks,
                                                              layout):
    """The token NLL of logits placed (batch over data, vocab over model),
    masked labels among them: the loss and each rank's gradient shard
    within 1e-6 of one process and of the reference's cross_entropy and
    its gradient; under ``sharded`` no op makes a tensor as large as the
    rank's rows over the whole vocab."""
    loss, grad = run["ref"]["nll"]
    for r, rec in enumerate(_per_rank(ranks, "nll")):
        got = rec[layout]
        assert got["loss_err"] < 1e-6 and got["grad_err"] < 1e-6, got
        assert got["placements"] == "(Shard(dim=0), Shard(dim=2))"
        with np.load(run["work"] / f"nll_{layout}_{r}.npz") as out:
            assert abs(float(out["loss"]) - loss) < 1e-6
            b0, v0 = int(out["b0"]), int(out["v0"])
            want = grad[b0:b0 + NLL_SHAPE[0] // 2, :,
                        v0:v0 + NLL_SHAPE[2] // 2]
            np.testing.assert_allclose(out["grad"], want, rtol=0,
                                       atol=1e-6)
        if layout == "sharded":
            assert got["biggest"][0] < 2 * got["local"], got


@pytest.mark.parametrize("case", MOE_GROUP_CASES,
                         ids=lambda c: "-".join(f"{k}={v}"
                                                for k, v in c.items()))
def test_moe_on_local_tokens_matches_one_process(ranks, case):
    """apply_moe under the mesh routes each rank's 32 of the 64 tokens
    (two groups of 16 a data rank, or one group whose binding capacity
    continues the positions across the ranks): output, aux loss and
    every gradient within 1e-5 of one process."""
    for rec in _per_rank(ranks, "grouped_moe"):
        got = rec[json.dumps(case, sort_keys=True)]
        assert got["out_err"] < 1e-5 and got["aux_err"] < 1e-6, got
        assert got["grad_rel"] < 1e-5, got
        assert got["route_rows"] == [32], got


def test_restore_reshards_onto_the_mesh(ranks):
    for rec in _per_rank(ranks, "restore"):
        assert rec["step"] == 1 and rec["placed"]
        assert rec["err"] == 0.0


def test_tuned_table_holds_a_chain_step_per_cell():
    """The table starts from nothing of the reference's: each entry is the
    spec of a step of the port's hillclimb chain for its cell, and
    ``best_spec`` hands out a copy (the generic config for any other
    key)."""
    from repro_torch.launch.hillclimb import CHAINS
    for key, spec in tuned.TUNED.items():
        assert spec in [s for _, s in CHAINS[key]], key
    assert tuned.best_spec("qwen3-0.6b", "train_4k") == {}
    for arch, shape in tuned.TUNED:
        spec = tuned.best_spec(arch, shape)
        assert spec == tuned.TUNED[arch, shape]
        spec["moe_impl"] = "shard"             # a copy, not the table's
        assert tuned.best_spec(arch, shape) == tuned.TUNED[arch, shape]
        assert json.loads(tuned.spec_json(arch, shape)) == \
            tuned.TUNED[arch, shape]
