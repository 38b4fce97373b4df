"""The port's dry run (``repro_torch.launch.dryrun``), its hillclimb
(``repro_torch.launch.hillclimb``) and the shape registry, held to the
reference's.

The port's cells run in this process on the ``fake`` backend (a group
opened and destroyed around each use).  The reference's dry run compiles
the same miniature cells in a subprocess with 8 XLA host devices on an
``AxisType.Auto`` mesh (its own test's ``jax.make_mesh`` makes
``Explicit`` axes, under which its sharding constraints raise), and runs
its hillclimb on a stubbed cell; the subprocess runs while the
port's cells run here.  The reference's modules set ``XLA_FLAGS`` when
imported; this process imports them with the variable restored after, so
its own JAX keeps the one host device.
"""
import contextlib
import dataclasses
import importlib
import json
import os
import subprocess
import sys
import traceback
from unittest import mock

import pytest

torch = pytest.importorskip("torch")

from repro import configs as ref_configs  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch import dryrun, hillclimb  # noqa: E402
from repro_torch.optim import OptConfig, adamw  # noqa: E402
from repro_torch.training.steps import SHARDING_PROFILES  # noqa: E402

MINI_ARCHS = ["yi-6b", "deepseek-v2-236b", "rwkv6-1.6b", "hymba-1.5b"]
MINI_SHAPES = [configs.Shape("t", "train", 64, 8),
               configs.Shape("d", "decode", 64, 8)]
#: the per-rank temp table: reduced configs, train (B 16, S 64), on the
#: (pod, data, model) meshes below, each against XLA's compiled temp.
#: The port's cells run on the (data, model) mesh of the same ranks: a
#: pod dim of size 1 shards nothing, and DTensor's strategy search on a
#: 3-D mesh takes three times as long
TABLE = [("kimi-k2-1t-a32b", {"moe_impl": "gather"}),
         ("kimi-k2-1t-a32b", {"moe_impl": "einsum"}),
         ("qwen3-0.6b", {}),
         ("hymba-1.5b", {"swa_impl": "banded"})]
TABLE_MESHES = [(1, 2, 2), (1, 8, 2)]
TABLE_SHAPE = (64, 16)
#: the hillclimb's a5_micro and a6_group steps in miniature, on (2, 2, 2):
#: (tag, spec, (seq, batch)); a6's groups of 1024 span two ranks' 512
#: tokens
CHAIN_CELLS = [("a5_micro", {"moe_impl": "gather", "microbatch": 4}, (64, 8)),
               ("a6_group", {"moe_impl": "gather", "moe_group": 1024},
                (256, 8))]
#: the production train cells' fsdp_noexp profile in miniature: (arch,
#: spec, mesh, (seq, batch)).  A batch this small leaves the optimizer's
#: working set beside the activations, where the optimizer's stacks led
#: the peak of a4/a5/a8/a9 before the donated step
NOEXP_CELL = ("kimi-k2-1t-a32b",
              {"moe_impl": "gather", "sharding_profile": "fsdp_noexp"},
              (1, 2, 2), (16, 4))
#: the ops of the AdamW update's arithmetic
OPT_OPS = {"aten.sub", "aten.add", "aten.mul", "aten.div", "aten.sqrt",
           "aten.square", "aten.pow", "aten.clone", "aten._to_copy",
           "aten.round", "aten.clamp", "aten.abs"}
TIMEOUT = 600

#: a deterministic stand-in for a dry-run cell, the same in both drivers
_STUB = r'''
import json as _json


def stub_metric(spec):
    text = _json.dumps(spec, sort_keys=True)
    return 1.0 + sum(ord(c) * (i + 1) for i, c in enumerate(text)) % 97


def stub_run_cell(arch, shape, mesh_name, mesh, spec, opt_cfg,
                  surrogate=True):
    return {"roofline": {"compute_s": stub_metric(spec), "memory_s": 0.5,
                         "collective_s": 0.25, "dominant": "compute",
                         "useful_flops_ratio": 0.5},
            "full": {"memory": {"temp_size_in_bytes": 0}}}
'''

_ORACLE = r'''
import os
os.environ["JAX_PLATFORMS"] = "cpu"
import contextlib, io, json, sys
from repro.launch import dryrun as dr     # sets XLA_FLAGS (host devices)
from repro.launch import hillclimb as hc
import jax
import numpy as np
from jax.sharding import AxisType, Mesh
from repro import configs
from repro.configs import Shape
from repro.optim import OptConfig

def compiled(cfg, shape, mesh_shape, spec):
    n = int(np.prod(mesh_shape))
    mesh = Mesh(np.array(jax.devices()[:n]).reshape(mesh_shape),
                ("pod", "data", "model"), axis_types=(AxisType.Auto,) * 3)
    step, args, kw = dr.build_lowerable(cfg, shape, mesh, spec, OptConfig(),
                                        scan_layers=True)
    return jax.jit(step, **kw).lower(*args).compile().memory_analysis()


out = {"args": {}, "temp": {}, "chain_args": {}}
for arch in json.loads(sys.argv[1]):
    cfg = configs.get_reduced(arch)
    for shape in (Shape("t", "train", 64, 8), Shape("d", "decode", 64, 8)):
        mem = compiled(cfg, shape, (2, 2, 2), {})
        out["args"][f"{arch}:{shape.kind}"] = int(mem.argument_size_in_bytes)
table = json.loads(sys.argv[4])
for mesh_shape in table["meshes"]:
    for arch, spec in table["cells"]:
        mem = compiled(configs.get_reduced(arch),
                       Shape("t", "train", *table["shape"]), tuple(mesh_shape),
                       spec)
        out["temp"][f"{arch}:{json.dumps(spec)}:{mesh_shape}"] = [
            int(mem.argument_size_in_bytes), int(mem.temp_size_in_bytes)]
arch, spec, mesh_shape, shape = table["noexp"]
mem = compiled(configs.get_reduced(arch), Shape("t", "train", *shape),
               tuple(mesh_shape), spec)
out["noexp"] = [int(mem.argument_size_in_bytes), int(mem.temp_size_in_bytes)]
for tag, spec, shape in table["chain"]:
    mem = compiled(configs.get_reduced("kimi-k2-1t-a32b"),
                   Shape("t", "train", *shape), (2, 2, 2), spec)
    out["chain_args"][tag] = int(mem.argument_size_in_bytes)
exec(sys.argv[3])
hc.run_cell = stub_run_cell
hc.make_production_mesh = lambda multi_pod=False: None
sys.argv = ["hillclimb", "--out", sys.argv[2]]
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    hc.main()
out["hillclimb"] = buf.getvalue()
print(json.dumps(out))
'''


def _ref_module(name):
    """A reference module that sets ``XLA_FLAGS`` when imported, imported
    with the variable restored after."""
    old = os.environ.get("XLA_FLAGS")
    try:
        return importlib.import_module(name)
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old


@contextlib.contextmanager
def _mesh(shape, names):
    """A ``DeviceMesh`` of ``shape`` on the ``fake`` backend."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    world = 1
    for n in shape:
        world *= n
    dryrun.open_fake_world(world)
    try:
        yield DeviceMesh("cpu", torch.arange(world).reshape(shape),
                         mesh_dim_names=names)
    finally:
        dist.destroy_process_group()


def _best_tags(text):
    """``{(arch, shape): tag}`` from a hillclimb's output."""
    out = {}
    for line in text.splitlines():
        if line.startswith("--- "):
            cell, rest = line[4:].split(": best step [")
            arch, shape = cell.split()
            out[arch, shape] = rest.split("]")[0]
    return out


def _seed_artifact(outdir):
    """An existing artifact for kimi decode's b2 step, better than any the
    stub makes: both drivers must read it back and pick it."""
    os.makedirs(outdir / "single", exist_ok=True)
    fn = outdir / "single" / "kimi-k2-1t-a32b__decode_32k__b2_moegather.json"
    fn.write_text(json.dumps({"roofline": {"compute_s": 0.01,
                                           "memory_s": 0.0,
                                           "collective_s": 0.0}}))


def _cell(arch, mesh, spec, cfg, shape):
    """A miniature cell's result, or ``{"error": traceback}``: a cell that
    fails fails only the tests that read it."""
    try:
        return dryrun.run_cell(arch, shape.name, "mini", mesh, spec,
                               OptConfig(), surrogate=False, cfg=cfg,
                               shape=shape)
    except Exception:
        return {"error": traceback.format_exc()}


def _ok(res):
    assert "error" not in res, res["error"]
    return res


@pytest.fixture(scope="module")
def mini(tmp_path_factory):
    """The port's miniature cells (run here) and the reference's oracle
    (its argument bytes and its hillclimb's choices, from the
    subprocess)."""
    work = tmp_path_factory.mktemp("dryrun")
    _seed_artifact(work / "ref")
    src = os.path.join(os.path.dirname(__file__), os.pardir, "src")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(src))
    env.pop("XLA_FLAGS", None)
    table = {"meshes": TABLE_MESHES, "cells": TABLE, "shape": TABLE_SHAPE,
             "chain": CHAIN_CELLS, "noexp": NOEXP_CELL}
    proc = subprocess.Popen(
        [sys.executable, "-c", _ORACLE, json.dumps(MINI_ARCHS),
         str(work / "ref"), _STUB, json.dumps(table)],
        env=env, stdin=subprocess.DEVNULL, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    port, temp, chain, noexp = {}, {}, {}, None
    kimi = configs.get_reduced("kimi-k2-1t-a32b")
    try:
        with _mesh((2, 2, 2), ("pod", "data", "model")) as mesh:
            for arch in MINI_ARCHS:
                cfg = configs.get_reduced(arch)
                for shape in MINI_SHAPES:
                    port[f"{arch}:{shape.kind}"] = dryrun.run_cell(
                        arch, shape.name, "mini", mesh, {}, OptConfig(),
                        surrogate=False, cfg=cfg, shape=shape)
            for tag, spec, (s, b) in CHAIN_CELLS:
                chain[tag] = _cell(
                    "kimi-k2-1t-a32b", mesh, spec, kimi,
                    configs.Shape("t", "train", s, b))
        for mesh_shape in TABLE_MESHES:
            assert mesh_shape[0] == 1
            with _mesh(mesh_shape[1:], ("data", "model")) as mesh:
                for arch, spec in TABLE:
                    temp[f"{arch}:{json.dumps(spec)}:{list(mesh_shape)}"] = \
                        _cell(arch, mesh, spec, configs.get_reduced(arch),
                              configs.Shape("t", "train", *TABLE_SHAPE))
        arch, spec, mesh_shape, shape = NOEXP_CELL
        # one layer a slice of the in-place update, as the production
        # cells' layers (1.41 GB of an expert stack) are each larger than
        # the bound; the miniature's leaves are all smaller
        with _mesh(mesh_shape[1:], ("data", "model")) as mesh, \
                mock.patch.object(adamw, "SLICE_BYTES", 0):
            noexp = _cell(arch, mesh, spec, configs.get_reduced(arch),
                          configs.Shape("t", "train", *shape))
        out, err = proc.communicate(timeout=TIMEOUT)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-4000:]
    return {"port": port, "ref": json.loads(out.splitlines()[-1]),
            "work": work, "temp": temp, "chain": chain, "noexp": noexp}


def test_shape_registry_matches_reference():
    assert set(configs.SHAPES) == set(ref_configs.SHAPES)
    for name, shape in configs.SHAPES.items():
        assert dataclasses.astuple(shape) == dataclasses.astuple(
            ref_configs.SHAPES[name])
    for arch in configs.ARCH_IDS:
        cfg, ref = configs.get_config(arch), ref_configs.get_config(arch)
        assert configs.supported_shapes(cfg) == \
            ref_configs.supported_shapes(ref)
        for name in configs.SHAPES:
            got = configs.input_specs(cfg, configs.SHAPES[name])
            want = ref_configs.input_specs(ref, ref_configs.SHAPES[name])
            assert list(got) == list(want)
            for k, t in got.items():
                assert t.device.type == "meta"
                assert tuple(t.shape) == tuple(want[k].shape)
                assert str(t.dtype).removeprefix("torch.") == \
                    str(want[k].dtype)


def test_rules_and_depth_helpers_match_reference():
    ref = _ref_module("repro.launch.dryrun")
    for profile in SHARDING_PROFILES:
        for layout in ("seq", "batch"):
            for kind in ("train", "prefill", "decode"):
                spec = {"sharding_profile": profile, "cache_layout": layout}
                assert dryrun._rules_for(spec, kind).rules == \
                    ref._rules_for(spec, kind).rules
    assert dryrun._rules_for({}, "decode").rules == \
        ref._rules_for({}, "decode").rules
    for arch in configs.ARCH_IDS:
        cfg, rcfg = configs.get_config(arch), ref_configs.get_config(arch)
        assert dryrun._n_varying(cfg) == ref._n_varying(rcfg)
        for n in (1, 2):
            assert dataclasses.asdict(dryrun._depth_variant(cfg, n)) == \
                dataclasses.asdict(ref._depth_variant(rcfg, n))


def test_counters_count_local_work():
    """On a fake (2, 2) mesh: a sharded product counts its local shard, a
    replicated one counts in full, an all-gather its result bytes."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    with _mesh((2, 2), ("data", "model")) as mesh:
        counter = dryrun._Counter()
        with counter:
            dt = lambda shape, pl: DTensor.from_local(
                torch.empty(shape), mesh, pl, run_check=False)
            a = dt((8, 16), [Shard(0), Replicate()])      # (16, 16)
            b = dt((16, 4), [Replicate(), Shard(1)])      # (16, 8)
            ra = dt((16, 16), [Replicate(), Replicate()])
            rb = dt((16, 8), [Replicate(), Replicate()])
            counter.start(())
            c = a @ b
            sharded = counter.flops
            ra @ rb
            replicated = counter.flops - sharded
            c.redistribute(mesh, [Replicate(), Replicate()])
    assert sharded == 2 * 8 * 16 * 4
    assert replicated == 2 * 16 * 16 * 8
    coll = dryrun.parse_collectives(counter.collectives)
    # (8, 4) gathered over data to (16, 4), then over model to (16, 8)
    assert coll["counts"] == {"all-gather": 2}
    assert coll["all-gather"] == coll["total"] == (16 * 4 + 16 * 8) * 4


def test_slices_of_a_leaf_count_their_own_bytes():
    """Indexing a tensor in slices (the in-place optimizer walks each leaf
    so) counts each slice's elementwise op, not the whole tensor a slice:
    the ``device`` query that indexing dispatches moves no bytes."""
    counter = dryrun._Counter()
    with counter:
        x = torch.empty(60, 1000)
        counter.start(())
        for i in range(60):
            x[i:i + 1] * 2.0
    assert counter.bytes == 60 * 2 * 1000 * 4


def test_miniature_dry_run_completes(mini):
    for arch in MINI_ARCHS:
        for shape in MINI_SHAPES:
            res = mini["port"][f"{arch}:{shape.kind}"]
            assert res["full"]["flops"] > 0, (arch, shape)
            assert res["chips"] == 8
            assert res["roofline"]["compute_s"] > 0


def test_miniature_argument_bytes_match_reference(mini):
    """The local shards of the arguments against XLA's per-device
    argument size for the same cell (1 %)."""
    for key, want in mini["ref"]["args"].items():
        got = mini["port"][key]["full"]["memory"]["argument_size_in_bytes"]
        assert abs(got - want) <= 0.01 * want, (key, got, want)


def test_miniature_temp_within_reference(mini):
    """Per rank, the port's peak temporary bytes at most 1.25 x XLA's
    compiled temp for the same cell, and its argument bytes within 1 %:
    no rank holds a whole copy of what the reference's layout shards (the
    copies grow with the data dim: (1, 8, 2) shows them where (1, 2, 2)
    may not)."""
    assert len(mini["temp"]) == len(TABLE) * len(TABLE_MESHES)
    over = []
    for key, (args, want) in mini["ref"]["temp"].items():
        mem = _ok(mini["temp"][key])["full"]["memory"]
        got = mem["temp_size_in_bytes"]
        # the table PERF.md quotes (pytest -s shows it)
        print(f"temp {key}: port {got} XLA {want} ratio {got / want:.3f}")
        if got > 1.25 * want:
            over.append((key, got, want, mem["peak_tensors"]))
        got = mem["argument_size_in_bytes"]
        assert abs(got - args) <= 0.01 * args, (key, got, args)
    assert not over, over


@pytest.mark.parametrize("arch,spec", TABLE,
                         ids=lambda v: v if isinstance(v, str) else
                         "-".join(f"{k}={x}" for k, x in v.items()) or "default")
def test_peak_holds_no_global_batch_or_token_dim(mini, arch, spec):
    """On the fake (1, 8, 2) mesh no storage among a train cell's five
    largest at the peak has the global batch as its leading dim, or the
    global token or slot count as any dim: the loss, the routing and the
    dispatch run on each rank's own rows."""
    s, b = TABLE_SHAPE
    cfg = configs.get_reduced(arch)
    tokens = {b * s, b * s * cfg.top_k} if cfg.is_moe else {b * s}
    res = _ok(mini["temp"][f"{arch}:{json.dumps(spec)}:{[1, 8, 2]}"])
    top = res["full"]["memory"]["peak_tensors"]
    assert len(top) == 5
    for t in top:
        assert t["shape"][0] != b and not tokens & set(t["shape"]), top


def test_donated_noexp_cell_holds_no_optimizer_stack(mini):
    """The train cell of the production profile ``fsdp_noexp`` in
    miniature (reduced kimi-k2, the gather MoE): the step is donated, so
    the new state aliases the arguments; its temp is at most 1.25 x XLA's
    for the reference's donated step, its arguments within 1 %, and no
    tensor among the five largest at the peak is a whole stacked leaf
    made by the update's arithmetic (the gradients' stacks may lead)."""
    arch, spec, mesh_shape, (s, b) = NOEXP_CELL
    mem = _ok(mini["noexp"])["full"]["memory"]
    args, want = mini["ref"]["noexp"]
    got = mem["temp_size_in_bytes"]
    print(f"temp noexp {spec} {list(mesh_shape)}: port {got} XLA {want} "
          f"ratio {got / want:.3f}")
    assert got <= 1.25 * want, (got, want, mem["peak_tensors"])
    assert abs(mem["argument_size_in_bytes"] - args) <= 0.01 * args
    assert mem["alias_size_in_bytes"] >= 0.99 * mem["argument_size_in_bytes"]
    cfg = configs.get_reduced(arch)
    layers = {cfg.n_layers, cfg.n_moe_layers, cfg.n_dense_layers} - {1}
    top = mem["peak_tensors"]
    assert len(top) == 5
    for t in top:
        assert not (t["op"] in OPT_OPS and len(t["shape"]) >= 2
                    and t["shape"][0] in layers), top


@pytest.mark.parametrize("tag", [c[0] for c in CHAIN_CELLS])
def test_chain_steps_a5_a6_complete_in_miniature(mini, tag):
    """The hillclimb's a5_micro (microbatch 4 with the gather MoE: a
    microbatch's 2 rows do not divide the 4 batch shards) and a6_group
    (moe_group 1024 over ranks of 512 tokens) run on (2, 2, 2), with the
    reference's argument bytes (1 %)."""
    res = _ok(mini["chain"][tag])
    assert res["full"]["flops"] > 0
    want = mini["ref"]["chain_args"][tag]
    got = res["full"]["memory"]["argument_size_in_bytes"]
    assert abs(got - want) <= 0.01 * want, (tag, got, want)


def test_depth_extrapolation_equals_full_count():
    """d1/d2 extrapolated to 4 layers against the 4-layer count: the
    FLOPs and the collective bytes of the loop are affine in the depth.
    (The bytes moved are not exactly: they hold DTensor's local layout
    copies, which differ at the first and the last layer.)"""
    cfg = configs.get_reduced("qwen3-0.6b").replace(n_layers=4)
    shape = configs.Shape("t", "train", 32, 4)
    with _mesh((2, 2), ("data", "model")) as mesh:
        res = dryrun.run_cell("qwen3-0.6b", "t", "mini", mesh, {},
                              OptConfig(), surrogate=True, cfg=cfg,
                              shape=shape)
    ext, full = res["surrogate"]["extrapolated"], res["roofline_input"]
    for k in ("flops", "collective_bytes"):
        assert full[k] > 0
        assert abs(ext[k] - full[k]) <= 1e-9 * full[k], (k, ext[k], full[k])


class _StubMesh:
    def size(self):
        return 256


def test_roofline_uses_the_h100_constants(monkeypatch):
    flops, nbytes, cbytes, csecs = 3.0e13, 2.0e12, 5.0e9, 0.125
    monkeypatch.setattr(dryrun, "analyze", lambda *a, **k: {
        "flops": flops, "bytes": nbytes,
        "collectives": {"total": cbytes, "seconds": csecs, "counts": {}},
        "memory": {}})
    shape = configs.SHAPES["train_4k"]
    cfg = configs.get_config("qwen3-0.6b")
    res = dryrun.run_cell("qwen3-0.6b", "train_4k", "single", _StubMesh(),
                          {}, OptConfig(), surrogate=False)
    rf = res["roofline"]
    assert cfg.compute_dtype == "bfloat16"
    assert rf["compute_s"] == flops / 989e12
    assert rf["memory_s"] == nbytes / 3.35e12
    assert rf["collective_s"] == csecs
    assert rf["dominant"] == "memory"           # 0.597 s against 0.030
    tokens = shape.global_batch * shape.seq_len
    assert rf["tokens"] == tokens
    assert rf["model_flops"] == 6 * cfg.active_param_count() * tokens
    assert rf["model_flops_per_chip"] == rf["model_flops"] / 256
    assert rf["useful_flops_ratio"] == rf["model_flops_per_chip"] / flops
    fp32 = dryrun.roofline(cfg.replace(compute_dtype="float32"), shape,
                           res["roofline_input"], 256)
    assert fp32["compute_s"] == flops / 67e12
    # a collective's seconds are its bytes over the slowest link spanned
    assert dryrun._link_bw(list(range(8))) == 450e9
    assert dryrun._link_bw(list(range(16))) == 50e9
    assert dryrun._link_bw(list(range(0, 256, 16))) == 50e9


def test_decode_cell_holds_no_whole_cache_copy():
    """A decode cell whose slots split over model (1 kv head, seq
    layout): the cache placed a quarter a rank, and the step's temporary
    storage under half the whole cache."""
    cfg = configs.get_reduced("qwen3-0.6b").replace(n_kv_heads=1)
    shape = configs.Shape("d", "decode", 8192, 8)
    with _mesh((2, 2), ("data", "model")) as mesh:
        res = dryrun.run_cell("qwen3-0.6b", "d", "mini", mesh,
                              {"cache_layout": "seq"}, OptConfig(),
                              surrogate=False, cfg=cfg, shape=shape)
    mem = res["full"]["memory"]
    whole = mem["cache_whole_bytes"]
    kv = 2 * cfg.n_layers * 8 * 8192 * cfg.d_head * 2     # bf16 k and v
    slot_pos = cfg.n_layers * 8192 * 4                     # replicated
    assert whole == kv + slot_pos
    assert mem["cache_placed_bytes"] == kv / 4 + slot_pos
    assert mem["alias_size_in_bytes"] == mem["cache_placed_bytes"]
    assert mem["temp_size_in_bytes"] < whole / 2, mem["peak_tensors"]


def test_hillclimb_chains_and_metric_match_reference():
    ref = _ref_module("repro.launch.hillclimb")
    assert hillclimb.CHAINS == ref.CHAINS
    for res in ({"roofline": {"compute_s": 0.5, "memory_s": 0.25,
                              "collective_s": 0.25}},
                {"roofline": {"compute_s": 0.0}}, {}):
        assert hillclimb._metric(res) == ref._metric(res)


def test_hillclimb_picks_the_references_best(mini, monkeypatch,
                                                    capsys):
    """The port's hillclimb on the stubbed cell chooses the step the
    reference's hillclimb chooses on the same stub, and reads an existing
    artifact back instead of running its cell."""
    scope: dict = {}
    exec(_STUB, scope)
    ran = []

    def run_cell(arch, shape, mesh_name, mesh, spec, opt_cfg,
                 surrogate=True):
        ran.append((arch, shape, json.dumps(spec, sort_keys=True)))
        return scope["stub_run_cell"](arch, shape, mesh_name, mesh, spec,
                                      opt_cfg, surrogate)

    monkeypatch.setattr(dryrun, "run_cell", run_cell)
    out = mini["work"] / "port"
    _seed_artifact(out)
    assert hillclimb.main(["--out", str(out)]) == 0
    got = _best_tags(capsys.readouterr().out)
    want = _best_tags(mini["ref"]["hillclimb"])
    assert got == want and len(got) == len(hillclimb.CHAINS)
    assert got["kimi-k2-1t-a32b", "decode_32k"] == "b2_moegather"
    b2 = dict(hillclimb.CHAINS["kimi-k2-1t-a32b", "decode_32k"])[
        "b2_moegather"]
    assert ("kimi-k2-1t-a32b", "decode_32k",
            json.dumps(b2, sort_keys=True)) not in ran
    assert len(ran) == sum(len(c) for c in hillclimb.CHAINS.values()) - 1
    # every step it ran left its tagged artifact
    assert len(list((out / "single").glob("*.json"))) == len(ran) + 1


def test_failed_cell_leaves_its_error_and_exits_zero(tmp_path, capsys):
    """As the reference's CLI: a cell that raises leaves
    ``<cell>.error.txt`` and no artifact, the run lists it last and exits
    0 (the caller reads the error files)."""
    def broken(*_a, **_kw):
        raise RuntimeError("no such cell here")

    with mock.patch.object(dryrun, "run_cell", broken):
        code = dryrun.main(["--arch", "qwen3-0.6b", "--shape", "decode_32k",
                            "--mesh", "single", "--out", str(tmp_path)])
    assert code == 0
    err = tmp_path / "single" / "qwen3-0.6b__decode_32k.error.txt"
    assert "no such cell here" in err.read_text()
    assert not (tmp_path / "single" / "qwen3-0.6b__decode_32k.json").exists()
    out = capsys.readouterr().out
    assert out.rstrip().splitlines()[-1] == \
        "FAILED cell: single qwen3-0.6b decode_32k"
