"""The port's logical-axis sharding rules against the reference's: the
seven cases of tests/test_sharding.py on the port, then parity of
``logical_to_spec`` and ``spec_for_axes`` with the reference's on (2, 2)
and (2, 2, 2) meshes for every leaf of the ten reduced configs'
``param_axes`` under every sharding profile and of their optimizer
state, and the mesh constructors.  Every mesh is a ``DeviceMesh`` on the
``fake`` backend (one process plays every rank): the (2, 2) and
(2, 2, 2) ones in this process, each in a group made and destroyed
around its use, the production meshes in a subprocess."""
import contextlib
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from jax.sharding import PartitionSpec as P  # noqa: E402

from repro import compat as ref_compat  # noqa: E402
from repro import configs as ref_configs  # noqa: E402
from repro.distributed import sharding as ref_sh  # noqa: E402
from repro.models import transformer as ref_model  # noqa: E402
from repro.training import steps as ref_steps  # noqa: E402
from repro_torch import compat, configs  # noqa: E402
from repro_torch.distributed import (DEFAULT_RULES, ShardingRules,  # noqa: E402
                                     logical_to_spec, spec_for_axes)
from repro_torch.distributed import sharding as sh  # noqa: E402
from repro_torch.models import transformer as model  # noqa: E402
from repro_torch.training.steps import SHARDING_PROFILES  # noqa: E402

MESHES = [((2, 2), ("data", "model")),
          ((2, 2, 2), ("pod", "data", "model"))]


@contextlib.contextmanager
def _mesh(shape=(2, 2), axes=("data", "model")):
    """A ``DeviceMesh`` of ``shape`` on the ``fake`` backend, its process
    group destroyed on exit."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    world = 1
    for n in shape:
        world *= n
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield DeviceMesh("cpu", torch.arange(world).reshape(shape),
                         mesh_dim_names=axes)
    finally:
        dist.destroy_process_group()


def test_rules_make_and_replace():
    r = ShardingRules.make({"a": "x", "b": ("x", "y"), "c": None})
    assert r.get("a") == ("x",)
    assert r.get("b") == ("x", "y")
    assert r.get("c") is None
    r2 = r.replace(a=None, c="y")
    assert r2.get("a") is None and r2.get("c") == ("y",)
    with pytest.raises(KeyError):
        r.get("missing")


def test_logical_to_spec_basic():
    with _mesh() as m:
        spec = logical_to_spec(("batch", None, "ffn"), (8, 3, 4), m,
                               DEFAULT_RULES)
    assert spec == sh.PartitionSpec("data", None, "model")
    assert tuple(spec) == tuple(P("data", None, "model"))


def test_divisibility_degrades_to_replicated():
    # dim 3 not divisible by the model dim (2) -> replicated
    with _mesh() as m:
        spec = logical_to_spec(("batch", "ffn"), (8, 3), m, DEFAULT_RULES)
    assert spec == sh.PartitionSpec("data")


def test_missing_mesh_axis_is_dropped():
    with _mesh() as m:
        spec = logical_to_spec(("batch",), (8,), m, DEFAULT_RULES)
    assert spec == sh.PartitionSpec("data")   # ('pod','data') -> ('data',)


def test_multi_axis_mapping():
    with _mesh((2, 2, 2), ("pod", "data", "model")) as m:
        spec = logical_to_spec(("batch", "ffn"), (8, 8), m, DEFAULT_RULES)
    assert spec == sh.PartitionSpec(("pod", "data"), "model")


def test_profiles_are_distinct():
    specs = {}
    for name, fn in SHARDING_PROFILES.items():
        rules = fn(DEFAULT_RULES)
        specs[name] = (rules.get("fsdp"), rules.get("seq"))
    assert specs["dp"][0] is None
    assert specs["fsdp"][0] == ("data",)
    assert specs["fsdp_pods"][0] == ("pod", "data")
    assert specs["seq"][1] == ("model",)


def test_trailing_nones_trimmed():
    with _mesh() as m:
        spec = logical_to_spec(("batch", None, None), (8, 2, 2), m,
                               DEFAULT_RULES)
    assert spec == sh.PartitionSpec("data")


def test_rules_and_profiles_equal_the_reference():
    assert DEFAULT_RULES.rules == ref_sh.DEFAULT_RULES.rules
    assert tuple(SHARDING_PROFILES) == tuple(ref_steps.SHARDING_PROFILES)
    for name, fn in SHARDING_PROFILES.items():
        assert fn(DEFAULT_RULES).rules == \
            ref_steps.SHARDING_PROFILES[name](ref_sh.DEFAULT_RULES).rules


def test_placements_of_a_spec():
    from torch.distributed.tensor import Replicate, Shard
    with _mesh((2, 2, 2), ("pod", "data", "model")) as m:
        assert sh.placements(sh.PartitionSpec(("pod", "data"), "model"),
                             m) == (Shard(0), Shard(0), Shard(1))
        assert sh.placements(sh.PartitionSpec(None, "data"), m) == \
            (Replicate(), Shard(1), Replicate())
        with pytest.raises(ValueError, match="dim order"):
            sh.placements(sh.PartitionSpec(("data", "pod")), m)
    assert sh.named_sharding(("batch",), (8,), None) is None   # no mesh


def test_constrain_without_a_mesh_is_the_identity():
    x = torch.ones(4, 2)
    assert sh.constrain(x, ("batch", "ffn")) is x
    assert sh.replicate(x) is x


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
@pytest.mark.parametrize("shape,names", MESHES)
def test_param_specs_equal_the_reference(arch, shape, names):
    """Every leaf of ``param_axes`` under every profile: the port's spec
    equals the reference's as a tuple, and ``spec_for_axes`` places the
    leaf as that spec says."""
    cfg = configs.get_reduced(arch)
    ref_cfg = ref_configs.get_reduced(arch)
    params = model.init_params(torch.Generator().manual_seed(0), cfg)
    is_axes = lambda x: isinstance(x, tuple)
    axes = compat.tree_leaves(model.param_axes(cfg), is_leaf=is_axes)
    ref_axes = compat.tree_leaves(ref_model.param_axes(ref_cfg),
                                  is_leaf=is_axes)
    assert axes == ref_axes
    shapes = [tuple(p.shape) for p in compat.tree_leaves(params)]
    ref_mesh = ref_compat.abstract_mesh(shape, names)
    with _mesh(shape, names) as mesh:
        for name, fn in SHARDING_PROFILES.items():
            rules = fn(DEFAULT_RULES)
            ref_rules = ref_steps.SHARDING_PROFILES[name](
                ref_sh.DEFAULT_RULES)
            placed = compat.tree_leaves(
                spec_for_axes(model.param_axes(cfg), params, mesh, rules),
                is_leaf=is_axes)
            for ax, s, (_, place) in zip(axes, shapes, placed):
                spec = logical_to_spec(ax, s, mesh, rules)
                ref_spec = ref_sh.logical_to_spec(ax, s, ref_mesh, ref_rules)
                assert tuple(spec) == tuple(ref_spec), (name, ax, s)
                assert place == sh.placements(tuple(ref_spec), mesh)


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_opt_state_specs_equal_the_reference(arch):
    """The optimizer state's axes (m, v, int8 error feedback, the step
    count) placed on (pod, data, model) as the reference places them."""
    from repro.optim import adamw as ref_adamw
    from repro_torch.optim import OptConfig, adamw, init_opt_state
    cfg = configs.get_reduced(arch)
    opt_cfg = OptConfig(compress="int8_ef")
    params = model.init_params(torch.Generator().manual_seed(0), cfg)
    state = init_opt_state(params, opt_cfg)
    axes = adamw.opt_state_axes(model.param_axes(cfg), opt_cfg)
    ref_axes = ref_adamw.opt_state_axes(
        ref_model.param_axes(ref_configs.get_reduced(arch)),
        ref_adamw.OptConfig(compress="int8_ef"))
    is_axes = lambda x: isinstance(x, tuple)
    assert compat.tree_leaves(axes, is_leaf=is_axes) == \
        compat.tree_leaves(ref_axes, is_leaf=is_axes)
    ref_mesh = ref_compat.abstract_mesh((2, 2, 2), ("pod", "data", "model"))
    leaves = compat.tree_leaves(state)
    with _mesh((2, 2, 2), ("pod", "data", "model")) as mesh:
        placed = compat.tree_leaves(spec_for_axes(axes, state, mesh),
                                    is_leaf=is_axes)
        assert len(placed) == len(leaves)
        for ax, leaf, (_, place) in zip(
                compat.tree_leaves(axes, is_leaf=is_axes), leaves, placed):
            ref_spec = ref_sh.logical_to_spec(ax, tuple(leaf.shape),
                                              ref_mesh, ref_sh.DEFAULT_RULES)
            assert place == sh.placements(tuple(ref_spec), mesh)


_FAKE = r"""
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.distributed.sharding import mesh_shape
from repro_torch.launch import mesh
for world, multi in ((256, False), (512, True)):
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    m = mesh.make_production_mesh(multi_pod=multi)
    print(world, mesh_shape(m), m.device_type)
    try:
        mesh.make_production_mesh(multi_pod=not multi)
    except ValueError as e:
        print("refused", "needs a world of" in str(e))
    dist.destroy_process_group()
"""


def test_production_meshes_on_the_fake_backend():
    """The reference's (16, 16) and (2, 16, 16) meshes over a fake world
    of 256 or 512 ranks in one process; any other world size raises."""
    src = os.path.join(os.path.dirname(__file__), os.pardir, "src")
    out = subprocess.run([sys.executable, "-c", _FAKE], capture_output=True,
                         text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=src))
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.splitlines()
    assert lines == [
        "256 {'data': 16, 'model': 16} cpu", "refused True",
        "512 {'pod': 2, 'data': 16, 'model': 16} cpu", "refused True"]


def test_local_mesh_needs_a_group_and_the_card_by_default():
    from repro_torch.launch import mesh
    with pytest.raises(RuntimeError, match="process group"):
        mesh.make_local_mesh(1, 1, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mesh.make_local_mesh(1, 1)
