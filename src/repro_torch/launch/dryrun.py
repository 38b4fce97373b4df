"""Multi-pod dry run of the port: prove the distribution config is coherent.

For every (architecture x input-shape x mesh) cell, one step of the port
runs once on the production mesh (single pod: (data=16, model=16), 256
ranks; multi-pod: (pod=2, data=16, model=16), 512 ranks) in one host
process, and the run records per rank:

1. the memory (``memory``): the local shards of the arguments, the
   outputs, and the peak of live local storage during the step less the
   arguments, with the five largest tensors alive at that peak;
2. the FLOPs and the bytes the rank's ops move (``flops``, ``bytes``);
3. the bytes of every collective the step issues, per kind
   (``collectives``);
4. a roofline of those numbers on an H100 (``roofline``).

How it runs without the devices: :func:`main` opens a process group of
256 or 512 ranks on the ``fake`` backend (one process plays rank 0; a
collective moves nothing) and builds the mesh with
:func:`repro_torch.launch.mesh.make_production_mesh`.  The parameters,
optimizer state, batch and cache are DTensors placed by their logical
axes under the cell's rules (:func:`_rules_for`), whose local shards are
fake tensors (shapes and dtypes, no memory); the step is
``specialize_builder(builder, spec_cfg).fn`` of the mesh-aware builders
(the train step with its state donated, ``donate_argnums=(0,)``, as the
reference lowers it: the state it returns aliases its arguments) and
runs under :class:`_Counter`, a ``FakeTensorMode`` that sees every op
DTensor runs on the local shards.  Every ``*_impl`` point is pinned to
``torch_ref`` under a mesh (the CUDA wrappers take no DTensor), as the
reference's dry run lowers ``xla``.

Counting: FLOPs come from ``torch.utils.flop_counter``'s formulas applied
to the local shapes of each op (a sharded product counts its shard; a
product that runs replicated counts in full on every rank: that
redundancy is what ``useful_flops_ratio`` shows).  A count over DTensors
would see the global shapes; it is never divided by the world size.  The
bytes an op moves are its inputs read and its outputs written (eager
PyTorch fuses nothing); an indexed write counts the values it writes, an
indexed read the rows it reads, a view nothing.  A collective counts its
result bytes, under the reference's kind names.

Depth: the port's layer stack is a Python loop, not a scan, so the
full-depth run counts every layer and gives ``roofline_input``.  The
reference's depth-1 and depth-2 surrogates still run (unless
``--no-surrogate``) and are recorded under ``surrogate``: the affine
extrapolation of their FLOPs and collective bytes to the full depth must
equal the full count, a test of the counters rather than a correction.
(The bytes moved hold DTensor's local layout copies, which differ at the
first and the last layer, so they are not exactly affine.)

Results land in ``artifacts/dryrun/<mesh>/<arch>__<shape>[__tag].json``
(a failed cell: ``<cell>.error.txt``); as the reference's, :func:`main`
exits 0 when a cell failed, and lists the failed cells last.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-0.6b \\
        --shape decode_32k --mesh single --spec '{"sharding_profile": "serve_ep"}'
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import heapq
import json
import os
import sys
import time
import traceback
import warnings
import weakref
from typing import Any

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch import compat, configs
from repro_torch.configs import SHAPES, Shape, input_specs, supported_shapes
from repro_torch.core.specializer import specialize_builder
from repro_torch.distributed.sharding import (DEFAULT_RULES, is_dtensor,
                                              spec_for_axes)
from repro_torch.models import transformer as model
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import RunOptions
from repro_torch.optim import OptConfig, init_opt_state, opt_state_axes
from repro_torch.training.steps import (SHARDING_PROFILES, make_decode_builder,
                                        make_prefill_builder,
                                        make_train_builder)

# The roofline's card: NVIDIA H100 SXM5 80GB at 700 W (NVIDIA's H100
# datasheet; the values chip_smoke.py uses).  Dense peaks by the cell's
# compute dtype (bf16 is the configs' default; fp32 without TF32).
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
HBM_BW = 3.35e12              # bytes/s per GPU
# A collective's bytes go over the slowest link its group spans.  An
# 8-GPU node joins its GPUs by NVLink 4 (450e9 bytes/s each way); nodes
# are joined by 400 Gb/s InfiniBand NDR, one ConnectX-7 per GPU (50e9).
# make_production_mesh lays the ranks out row-major, so a node holds 8
# consecutive ranks: the model dim's 16 consecutive ranks span two nodes,
# and the data and pod dims (strides 16 and 256) span 16 and 2 nodes.
NVLINK_BW = 450e9
IB_BW = 50e9
NODE_GPUS = 8

#: collective ops (functional and c10d) by name, and their kind (the
#: reference's names)
_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce", "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
    "broadcast": "broadcast", "broadcast_": "broadcast",
}
#: in-place indexed writes: they move the values they write (read, write)
_WRITES = {"index_copy_", "index_put_", "index_add_", "scatter_",
           "scatter_add_", "scatter_reduce_", "masked_scatter_", "copy_",
           "_index_put_impl_"}
#: indexed reads: they move the rows they read and write (and the index)
_GATHERS = {"index_select", "index", "gather", "embedding"}


def parse_collectives(events: list) -> dict:
    """Sum result bytes per collective kind from the step's collective
    events ``(kind, nbytes, seconds)``; also ``total`` (bytes),
    ``counts`` per kind and ``seconds`` (each at its group's link)."""
    out: dict[str, Any] = {}
    count: dict[str, int] = {}
    seconds = 0.0
    for kind, nbytes, secs in events:
        out[kind] = out.get(kind, 0.0) + nbytes
        count[kind] = count.get(kind, 0) + 1
        seconds += secs
    out["total"] = sum(out.values())
    out["counts"] = count
    out["seconds"] = seconds
    return out


def _tensors(tree: Any) -> list:
    return [t for t in compat.tree_leaves(tree)
            if isinstance(t, torch.Tensor)]


def _link_bw(ranks: list) -> float:
    """The slowest link a group of ranks spans (inf for one rank: the
    collective moves nothing)."""
    if len(ranks) <= 1:
        return float("inf")
    return NVLINK_BW if len({r // NODE_GPUS for r in ranks}) == 1 else IB_BW


def _group_ranks(func, args: tuple) -> list:
    """The ranks of the group a collective op runs over (its group name
    for a functional collective, its process group for a c10d one)."""
    import torch.distributed as dist
    from torch.distributed import distributed_c10d as c10d
    for a in args:
        if isinstance(a, str) and func.namespace == "_c10d_functional":
            try:
                return dist.get_process_group_ranks(
                    c10d._resolve_process_group(a))
            except (KeyError, ValueError, RuntimeError):
                continue
        if isinstance(a, dist.ProcessGroup):
            return dist.get_process_group_ranks(a)
    return []


class _Counter(FakeTensorMode):
    """A ``FakeTensorMode`` that counts what one rank does.

    A DTensor op comes to the mode with DTensor types: it is passed on to
    DTensor's dispatch inside the handler (the mode is off the stack
    there, so DTensor's sharding propagation runs its global-shape meta
    calls under a mode of its own), and the ops DTensor then runs on the
    local fake shards come back here, each counted: its FLOPs, the bytes
    it moves, a collective's result bytes, and the storages it makes
    (live bytes over the step, the peak, and the tensors alive at it).
    ``counting`` is off while the arguments are built."""

    def __init__(self):
        super().__init__(allow_non_fake_inputs=True)
        from torch.utils.flop_counter import flop_registry
        self.flop_registry = flop_registry
        self.counting = False
        self.flops = 0.0
        self.bytes = 0.0
        self.collectives: list = []
        self.args: set[int] = set()
        self.live: dict[int, tuple] = {}
        self.cur = self.peak = 0
        self.rising = False
        self.top: list = []

    def start(self, args: Any) -> None:
        """Count from here; the storages of ``args`` are the arguments'."""
        self.args = {id(t.untyped_storage()) for t in _local_tensors(args)}
        self._keep = [t.untyped_storage() for t in _local_tensors(args)]
        self.counting = True

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, torch.Tensor) and t.__name__ == "DTensor"
               for t in types):
            return func(*args, **kwargs)
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if self.counting:
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        name = func._schema.name.split("::")[-1]
        kind = _COLLECTIVES.get(name) if func.namespace in (
            "_c10d_functional", "c10d") else None
        if kind is not None:
            res = out if func.namespace == "_c10d_functional" else args[0]
            nbytes = sum(t.nbytes for t in _tensors(res))
            self.collectives.append(
                (kind, nbytes, nbytes / _link_bw(_group_ranks(func, args))))
        else:
            fn = self.flop_registry.get(func._overloadpacket)
            if fn is not None:
                self.flops += fn(*args, **kwargs, out_val=out)
            # a view moves nothing, nor does a metadata query (``prim``:
            # the ``device`` that indexing a fake tensor asks for)
            if not func.is_view and func.namespace != "prim":
                self.bytes += self._moved(name, args, kwargs, out)
        for t in _tensors(out):
            self._track(t, str(func._overloadpacket))

    def _moved(self, name: str, args, kwargs, out) -> int:
        ins = _tensors((args, kwargs))
        if name in _WRITES:
            return 2 * sum(t.nbytes for t in ins[1:])
        outs = sum(t.nbytes for t in _tensors(out))
        if name in _GATHERS:
            return 2 * outs + sum(t.nbytes for t in ins[1:])
        return sum(t.nbytes for t in ins) + outs

    def _track(self, t: torch.Tensor, op: str) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self.args or key in self.live:
            return
        self.live[key] = (st.nbytes(), list(t.shape), str(t.dtype), op)
        self.cur += st.nbytes()
        weakref.finalize(st, self._free, key)
        if self.cur > self.peak:
            self.peak, self.rising = self.cur, True

    def _free(self, key: int) -> None:
        if self.rising:
            # the first free after a new peak: the live set is the peak's
            self.top = heapq.nlargest(5, self.live.values())
            self.rising = False
        self.cur -= self.live.pop(key)[0]

    def peak_tensors(self) -> list:
        top = heapq.nlargest(5, self.live.values()) if self.rising \
            else self.top
        return [{"bytes": b, "shape": s, "dtype": d, "op": o}
                for b, s, d, o in top]


#: the products whose DTensor strategy the dry run takes from the
#: enumerated einsum rules (see _enumerated_products)
_PRODUCTS = ("mm.default", "addmm.default", "bmm.default",
             "baddbmm.default")


@contextlib.contextmanager
def _enumerated_products():
    """DTensor's enumerated einsum strategies for the matrix products,
    where a release registers both those and a per-mesh-dim strategy whose
    search over placements costs seconds a call on a 3-D mesh (a
    miniature train step of deepseek-v2 on (2, 2, 2): 70 s of bmm
    against 2.5 s).  Both are DTensor's own rules; nothing changes where
    a release has only one."""
    from torch.distributed.tensor import DTensor
    prop = DTensor._op_dispatcher.sharding_propagator
    single = getattr(prop, "op_single_dim_strategy_funcs", {})
    stash = {op: single.pop(op) for op in list(single)
             if str(op).removeprefix("aten.") in _PRODUCTS
             and op in prop.op_strategy_funcs}
    try:
        yield
    finally:
        single.update(stash)


def _local_tensors(tree: Any) -> list:
    return [t.to_local() if is_dtensor(t) else t for t in _tensors(tree)]


def _nbytes(tree: Any) -> int:
    """Bytes of the distinct local storages of ``tree``'s tensors."""
    seen: dict[int, int] = {}
    for t in _local_tensors(tree):
        st = t.untyped_storage()
        seen[id(st)] = st.nbytes()
    return sum(seen.values())


def _attach(tree: Any, axes_tree: Any, mesh, rules) -> Any:
    """Each (fake, global) leaf of ``tree`` as a DTensor placed by its
    logical axes: its local shard a new fake tensor of the shard's shape."""
    from torch.distributed.tensor import DTensor, Shard
    shardings = spec_for_axes(axes_tree, tree, mesh, rules)
    sizes = mesh.mesh.shape

    def one(t, sh):
        _, place = sh
        shape = list(t.shape)
        for size, pl in zip(sizes, place):
            if isinstance(pl, Shard):
                shape[pl.dim] //= int(size)
        local = torch.empty(shape, dtype=t.dtype)
        return DTensor.from_local(local, mesh, place, run_check=False,
                                  shape=t.shape, stride=t.stride())

    is_sh = lambda x: isinstance(x, tuple) and len(x) == 2 and \
        not isinstance(x[0], (str, type(None), tuple))
    leaves, treedef = compat.tree_flatten(tree)
    shs = compat.tree_leaves(shardings, is_leaf=is_sh)
    return compat.tree_unflatten(treedef, [one(t, s)
                                           for t, s in zip(leaves, shs)])


def _rules_for(spec_cfg: dict, kind: str):
    prof = spec_cfg.get("sharding_profile", "fsdp")
    rules = SHARDING_PROFILES[prof](DEFAULT_RULES)
    if kind == "decode" and spec_cfg.get("cache_layout", "seq") == "seq":
        rules = rules.replace(seq_kv="model")
    return rules


def _depth_variant(cfg: ModelConfig, n: int) -> ModelConfig:
    """Reduced-depth config for affine FLOP extrapolation (n = layers in the
    varying stack; the dense prefix of MoE archs stays at its full size)."""
    if cfg.is_moe:
        return cfg.replace(n_layers=cfg.n_dense_layers + n)
    return cfg.replace(n_layers=n)


def _n_varying(cfg: ModelConfig) -> int:
    return cfg.n_moe_layers if cfg.is_moe else cfg.n_layers


@dataclasses.dataclass
class CellSpec:
    arch: str
    shape: Shape
    spec_cfg: dict
    opt: OptConfig


def build_lowerable(cfg: ModelConfig, shape: Shape, mesh, spec_cfg: dict,
                    opt_cfg: OptConfig):
    """Returns ``(step_fn, example_args)``: the specialized step of the
    mesh-aware builder, and its arguments as DTensors placed by their
    axes under the cell's rules.  Call it inside a ``FakeTensorMode``
    (the arguments' shards are fake)."""
    kind = shape.kind
    rules = _rules_for(spec_cfg, kind)
    kw = dict(kernel_impl="torch_ref")
    params = _attach(model.init_params(torch.Generator(), cfg),
                     model.param_axes(cfg), mesh, rules)

    def batch_of(specs: dict) -> dict:
        out = {}
        for k, s in specs.items():
            axes = ("batch", "seq", None)[: s.ndim]
            out[k] = _attach(torch.empty(s.shape, dtype=s.dtype), axes,
                             mesh, rules)
        return out

    if kind == "train":
        # the state is donated, as the reference lowers the train step
        step = specialize_builder(make_train_builder(cfg, opt_cfg, mesh),
                                  spec_cfg, donate_argnums=(0,)).fn
        opt = _attach(init_opt_state(params, opt_cfg),
                      opt_state_axes(model.param_axes(cfg), opt_cfg), mesh,
                      rules)
        return step, ({"params": params, "opt": opt},
                      batch_of(input_specs(cfg, shape)))

    if kind == "prefill":
        step = specialize_builder(make_prefill_builder(cfg, mesh, **kw),
                                  spec_cfg).fn
        return step, (params, batch_of(input_specs(cfg, shape)))

    # decode
    step = specialize_builder(make_decode_builder(cfg, mesh, **kw),
                              spec_cfg).fn
    ropts = RunOptions(
        decode_cache_dtype=spec_cfg.get("cache_dtype", "bfloat16"))
    cache = _attach(model.init_cache(cfg, shape.global_batch, shape.seq_len,
                                     ropts, device="cpu"),
                    model.cache_axes(cfg), mesh, rules)
    toks = _attach(torch.empty((shape.global_batch,), dtype=torch.int32),
                   ("batch",), mesh, rules)
    pos = torch.zeros((), dtype=torch.int32)
    return step, (params, cache, toks, pos)


def analyze(cfg: ModelConfig, shape: Shape, mesh, spec_cfg: dict,
            opt_cfg: OptConfig) -> dict:
    """One step of the cell under :class:`_Counter`: its per-rank FLOPs,
    bytes moved, collectives and memory."""
    counter = _Counter()
    t0 = time.perf_counter()
    with _enumerated_products(), counter, warnings.catch_warnings():
        # init_params compares data pointers, which fake tensors lack
        warnings.filterwarnings("ignore", "Accessing the data pointer")
        step, args = build_lowerable(cfg, shape, mesh, spec_cfg, opt_cfg)
        t_build = time.perf_counter() - t0
        counter.start(args)
        t0 = time.perf_counter()
        out = step(*args)
        t_run = time.perf_counter() - t0
        counter.counting = False
        arg_bytes = _nbytes(args)
        # outputs that are arguments (the cache a decode step writes in
        # place) alias them
        out_ids = {id(t.untyped_storage()): t.untyped_storage().nbytes()
                   for t in _local_tensors(out)}
        alias = sum(n for k, n in out_ids.items() if k in counter.args)
        memory = {
            "argument_size_in_bytes": arg_bytes,
            "output_size_in_bytes": sum(out_ids.values()) - alias,
            "alias_size_in_bytes": alias,
            "temp_size_in_bytes": counter.peak,
            "peak_tensors": counter.peak_tensors(),
            "params_size_in_bytes": _nbytes(
                args[0]["params"] if shape.kind == "train" else args[0]),
        }
        if shape.kind == "decode":
            cache = args[1]
            memory["cache_placed_bytes"] = _nbytes(cache)
            memory["cache_whole_bytes"] = sum(
                t.numel() * t.element_size() for t in _tensors(cache))
        del out, args, step
    return {
        "flops": counter.flops,
        "bytes": counter.bytes,
        "collectives": parse_collectives(counter.collectives),
        "memory": memory,
        "build_s": t_build,
        "run_s": t_run,
    }


def roofline(cfg: ModelConfig, shape: Shape, ri: dict, n_chips: int) -> dict:
    """The roofline terms of ``roofline_input`` on the H100 constants:
    the counts are per rank, so each term divides by a per-GPU peak;
    the model FLOPs are global, so they divide by the ranks."""
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    n_active = cfg.active_param_count()
    model_flops = 6 * n_active * tokens if shape.kind == "train" else \
        2 * n_active * tokens
    compute_t = ri["flops"] / PEAK_FLOPS[cfg.compute_dtype]
    memory_t = ri["bytes"] / HBM_BW
    collective_t = ri["collective_s"]
    dominant = max(("compute", compute_t), ("memory", memory_t),
                   ("collective", collective_t), key=lambda kv: kv[1])[0]
    return {
        "compute_s": compute_t,
        "memory_s": memory_t,
        "collective_s": collective_t,
        "dominant": dominant,
        "model_flops": model_flops,
        "model_flops_per_chip": model_flops / n_chips,
        "useful_flops_ratio": (model_flops / n_chips) / max(ri["flops"], 1.0),
        "tokens": tokens,
        "peak_flops": PEAK_FLOPS[cfg.compute_dtype],
        "hbm_bw": HBM_BW,
    }


def _roofline_input(a: dict) -> dict:
    return {"flops": a["flops"], "bytes": a["bytes"],
            "collective_bytes": a["collectives"]["total"],
            "collective_s": a["collectives"]["seconds"]}


def run_cell(arch: str, shape_name: str, mesh_name: str, mesh, spec_cfg: dict,
             opt_cfg: OptConfig, surrogate: bool = True,
             cfg: ModelConfig | None = None,
             shape: Shape | None = None) -> dict:
    """One cell: the full-depth step (``full``, which gives
    ``roofline_input``), the depth-1/2 surrogates and their extrapolation
    (``surrogate``), and the roofline.  ``cfg`` and ``shape`` override the
    registry's (a reduced config, a small shape)."""
    cfg = cfg or configs.get_config(arch)
    shape = shape or SHAPES[shape_name]
    n_chips = mesh.size()
    result: dict = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "chips": int(n_chips), "spec": {k: str(v) for k, v in spec_cfg.items()},
        "model_params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
        "torch": torch.__version__,
    }
    full = analyze(cfg, shape, mesh, spec_cfg, opt_cfg)
    result["full"] = full
    result["roofline_input"] = _roofline_input(full)
    if surrogate:
        a1 = _roofline_input(analyze(_depth_variant(cfg, 1), shape, mesh,
                                     spec_cfg, opt_cfg))
        a2 = _roofline_input(analyze(_depth_variant(cfg, 2), shape, mesh,
                                     spec_cfg, opt_cfg))
        n = _n_varying(cfg)
        result["surrogate"] = {
            "d1": a1, "d2": a2,
            "extrapolated": {k: a1[k] + (n - 1) * (a2[k] - a1[k])
                             for k in a1}}
    result["roofline"] = roofline(cfg, shape, result["roofline_input"],
                                  n_chips)
    return result


def open_fake_world(world: int) -> None:
    """A process group of ``world`` ranks on the ``fake`` backend, this
    process rank 0 (a collective moves nothing)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all",
                    help="arch id or 'all' (see repro_torch.configs.ARCH_IDS)")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=("single", "multi", "both"))
    ap.add_argument("--spec", default="{}", help="JSON spec-point config")
    ap.add_argument("--tag", default="", help="suffix for output filenames")
    ap.add_argument("--out", default="artifacts/dryrun")
    ap.add_argument("--no-surrogate", action="store_true")
    ap.add_argument("--compress", default="none",
                    choices=("none", "int8_ef"))
    args = ap.parse_args(argv)

    import torch.distributed as dist

    from repro_torch.launch.mesh import PRODUCTION, make_production_mesh

    spec_cfg = json.loads(args.spec)
    opt_cfg = OptConfig(compress=args.compress)
    archs = list(configs.ARCH_IDS) if args.arch == "all" else [args.arch]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    failed = []
    for multi in meshes:
        world = 1
        for n in PRODUCTION[multi][0]:
            world *= n
        open_fake_world(world)
        try:
            mesh = make_production_mesh(multi_pod=multi)
            mesh_name = "multi" if multi else "single"
            outdir = os.path.join(args.out, mesh_name)
            os.makedirs(outdir, exist_ok=True)
            for arch in archs:
                cfg = configs.get_config(arch)
                shapes = (supported_shapes(cfg) if args.shape == "all"
                          else [args.shape])
                for shape_name in shapes:
                    tag = f"__{args.tag}" if args.tag else ""
                    fn = os.path.join(outdir,
                                      f"{arch}__{shape_name}{tag}.json")
                    print(f"=== {mesh_name} {arch} {shape_name} ===",
                          flush=True)
                    try:
                        t0 = time.perf_counter()
                        res = run_cell(arch, shape_name, mesh_name, mesh,
                                       spec_cfg, opt_cfg,
                                       surrogate=not args.no_surrogate)
                        res["wall_s"] = time.perf_counter() - t0
                        with open(fn, "w") as f:
                            json.dump(res, f, indent=1)
                        rf = res["roofline"]
                        mem = res["full"]["memory"]
                        print(f"  ok in {res['wall_s']:.1f}s: "
                              f"compute={rf['compute_s']:.4f}s "
                              f"memory={rf['memory_s']:.4f}s "
                              f"collective={rf['collective_s']:.4f}s "
                              f"dominant={rf['dominant']} "
                              f"useful={rf['useful_flops_ratio']:.3f} "
                              f"args={mem['argument_size_in_bytes']/2**30:.2f}GiB "
                              f"temp={mem['temp_size_in_bytes']/2**30:.2f}GiB",
                              flush=True)
                    except Exception as e:
                        print(f"  FAILED: {e}", flush=True)
                        traceback.print_exc()
                        failed.append(f"{mesh_name} {arch} {shape_name}")
                        with open(fn.replace(".json", ".error.txt"),
                                  "w") as f:
                            f.write(traceback.format_exc())
        finally:
            dist.destroy_process_group()
    # As the reference's: a failed cell leaves its .error.txt beside the
    # artifacts and the run still exits 0; the failed cells are listed.
    for cell in failed:
        print(f"FAILED cell: {cell}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
