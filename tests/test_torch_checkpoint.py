"""The port's checkpoint store against the JAX reference: spec_state files
and parameter checkpoints written by either package restore into the
other, and the store's own behaviour (round trip, keep-k, async, atomic).
"""
import json
import os
import time

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import checkpoint as ref_ckpt  # noqa: E402
from repro import configs as ref_configs  # noqa: E402
from repro.core import IridescentRuntime as RefRuntime  # noqa: E402
from repro.core.points import DISABLED as REF_DISABLED  # noqa: E402
from repro.core.runtime import encode_context_key as ref_encode  # noqa: E402
from repro.kernels import registry as ref_registry  # noqa: E402
from repro.models import KernelOptions as RefKernelOptions  # noqa: E402
from repro.models import transformer as ref_model  # noqa: E402
from repro_torch import checkpoint, compat, configs  # noqa: E402
from repro_torch.core import DISABLED, IridescentRuntime  # noqa: E402
from repro_torch.core import encode_context_key  # noqa: E402
from repro_torch.kernels import registry  # noqa: E402
from repro_torch.models import KernelOptions, params_from_numpy  # noqa: E402
from repro_torch.models import transformer as model  # noqa: E402

#: the forward's tolerance of tests/test_torch_model.py (fp32, summation
#: order differs between the frameworks)
TOL = 1e-4
#: context -> config each package specializes before saving; DISABLED
#: rides the codec, tuple keys round-trip
CONFIGS = {("decode", 4): {"tile": 16, "mode": "b"},
           ("prefill", 8): {"tile": 4, "mode": None}}
SAFETY = {"last_known_good": {("decode", 4): {"tile": 8, "mode": "a"}},
          "quarantined": {("prefill", 8): [{"tile": 16, "mode": "b"}]}}


def _builder(spec):
    spec.enum("tile", 8, (4, 8, 16))
    spec.enum("mode", "a", ("a", "b"))
    return lambda x: x


def _ctx(args, kwargs):
    return args[0]


def _disabled(package):
    return REF_DISABLED if package == "ref" else DISABLED


def _save(package, path):
    """Specialize CONFIGS (mode None -> DISABLED) in ``package``'s runtime
    and save its spec_state with the SAFETY payload."""
    rt = (RefRuntime if package == "ref" else IridescentRuntime)(
        async_compile=False)
    h = rt.register("h", _builder, context_fn=_ctx)
    for key, cfg in CONFIGS.items():
        cfg = {k: (_disabled(package) if v is None else v)
               for k, v in cfg.items()}
        h.specialize(cfg, wait=True, context=key)
    enc = ref_encode if package == "ref" else encode_context_key
    safety = {"h": {
        "last_known_good": {enc(k): v for k, v in
                            SAFETY["last_known_good"].items()},
        "quarantined": {enc(k): v for k, v in
                        SAFETY["quarantined"].items()}}}
    save = (ref_ckpt.save_spec_state if package == "ref"
            else checkpoint.save_spec_state)
    save(path, rt, safety=safety)
    rt.shutdown()


def _restore(package, path):
    """(seeded configs by context, safety state) after ``package``
    restores ``path``; DISABLED mapped to None."""
    rt = (RefRuntime if package == "ref" else IridescentRuntime)(
        async_compile=False)
    h = rt.register("h", _builder, context_fn=_ctx)
    restore = (ref_ckpt.restore_spec_state if package == "ref"
               else checkpoint.restore_spec_state)
    load_safety = (ref_ckpt.load_safety_state if package == "ref"
                   else checkpoint.load_safety_state)
    assert restore(path, rt, wait=True)
    dis = _disabled(package)
    plain = lambda cfg: {k: (None if v is dis else v)  # noqa: E731
                         for k, v in cfg.items()}
    seeded = {key: plain(h.seeded_config(key)) for key in CONFIGS}
    safety = load_safety(path)["h"]
    safety = {part: {k: ([plain(c) for c in v] if isinstance(v, list)
                         else plain(v)) for k, v in safety[part].items()}
              for part in safety}
    rt.shutdown()
    return seeded, safety


@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")])
def test_spec_state_cross_read(tmp_path, writer, reader):
    path = str(tmp_path / "spec_state.json")
    _save(writer, path)
    with open(path) as f:
        assert json.load(f)["version"] == 3
    got = _restore(reader, path)
    assert got == _restore(writer, path)
    seeded, safety = got
    assert seeded == CONFIGS
    assert safety == {
        "last_known_good": {encode_context_key(k): v for k, v in
                            SAFETY["last_known_good"].items()},
        "quarantined": {encode_context_key(k): v for k, v in
                        SAFETY["quarantined"].items()}}


def _impl_builder(reg):
    def builder(spec):
        reg.impl_point(spec, "rmsnorm")
        return lambda x: x
    return builder


def _restore_impl(package, path):
    rt = (RefRuntime if package == "ref" else IridescentRuntime)(
        async_compile=False)
    reg = ref_registry if package == "ref" else registry
    h = rt.register("h", _impl_builder(reg))
    restore = (ref_ckpt.restore_spec_state if package == "ref"
               else checkpoint.restore_spec_state)
    applied = restore(path, rt, wait=True)
    impl = h.active_config().get("rmsnorm_impl")
    rt.shutdown()
    return applied, impl


def _impl_file(path, impl):
    with open(path, "w") as f:
        json.dump({"version": 3, "handlers": {"h": {"contexts": {
            encode_context_key("default"): {"rmsnorm_impl": impl}}}}}, f)


def test_spec_state_kernel_impl_outside_the_space(tmp_path):
    """A kernel-impl name the reading package lacks (the port's ``cuda``
    read by the reference) is handled as the reference handles a value
    outside its space: the context stays generic.  The reference's names
    are aliases in the port, so its files replay there."""
    path = str(tmp_path / "spec_state.json")
    _impl_file(path, "cuda")
    unknown = str(tmp_path / "unknown.json")
    _impl_file(unknown, "no_such_impl")
    assert _restore_impl("ref", path) == _restore_impl("ref", unknown)
    assert _restore_impl("ref", path)[0] is False
    assert _restore_impl("port", unknown)[0] is False
    _impl_file(path, "pallas_tpu")
    assert _restore_impl("ref", path) == (True, "pallas_tpu")
    assert _restore_impl("port", path) == (True, "pallas_tpu")


@pytest.fixture(scope="module")
def qwen3():
    ref_cfg = ref_configs.get_reduced("qwen3-0.6b").replace(
        compute_dtype="float32")
    cfg = configs.get_reduced("qwen3-0.6b").replace(compute_dtype="float32")
    ref_params = ref_model.init_params(jax.random.PRNGKey(0), ref_cfg)
    np_params = jax.tree_util.tree_map(np.asarray, ref_params)
    tokens = np.random.RandomState(3).randint(
        0, cfg.vocab_size, (2, 12)).astype(np.int32)
    return dict(ref_cfg=ref_cfg, cfg=cfg, ref_params=ref_params,
                np_params=np_params, tokens=tokens)


def _zeros_like_port(np_params):
    return params_from_numpy(jax.tree_util.tree_map(np.zeros_like,
                                                    np_params), "cpu")


def test_checkpoint_reference_to_port(tmp_path, qwen3):
    ref_ckpt.CheckpointManager(str(tmp_path), async_save=False).save(
        7, qwen3["ref_params"], extra_meta={"loss": 2.5})
    template = _zeros_like_port(qwen3["np_params"])
    params, meta = checkpoint.CheckpointManager(str(tmp_path)).restore(
        template)
    assert meta == {"step": 7, "loss": 2.5}
    ref_leaves = jax.tree_util.tree_leaves(qwen3["np_params"])
    leaves = compat.tree_leaves(params)
    assert len(leaves) == len(ref_leaves)
    for a, b in zip(ref_leaves, leaves):
        assert b.numpy().dtype == a.dtype
        np.testing.assert_array_equal(b.numpy(), a)      # bit-equal
    ref_logits, _ = ref_model.apply(
        qwen3["ref_params"], qwen3["ref_cfg"],
        ref_model.RunOptions(kernels=RefKernelOptions(impl="xla")),
        tokens=jnp.asarray(qwen3["tokens"]))
    logits, _ = model.apply(
        params, qwen3["cfg"],
        model.RunOptions(kernels=KernelOptions(impl="torch_ref")),
        tokens=torch.from_numpy(qwen3["tokens"]))
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits),
                               rtol=TOL, atol=TOL)


def test_checkpoint_port_to_reference(tmp_path, qwen3):
    params = params_from_numpy(qwen3["np_params"], "cpu")
    checkpoint.CheckpointManager(str(tmp_path), async_save=False).save(
        3, params)
    restored, meta = ref_ckpt.CheckpointManager(str(tmp_path)).restore(
        qwen3["ref_params"])
    assert meta == {"step": 3}
    for a, b in zip(jax.tree_util.tree_leaves(qwen3["np_params"]),
                    jax.tree_util.tree_leaves(restored)):
        assert np.asarray(b).dtype == a.dtype
        np.testing.assert_array_equal(np.asarray(b), a)  # bit-equal


# -- the store's own behaviour (test_checkpoint_data.py's cases) ---------------

def _tree():
    return {"params": {"w": torch.arange(12.0).reshape(3, 4),
                       "b": torch.ones(4)},
            "opt": {"count": torch.tensor(7, dtype=torch.int32)},
            "layers": [torch.zeros(2), torch.full((2,), 3.0)]}


def test_roundtrip(tmp_path):
    mgr = checkpoint.CheckpointManager(str(tmp_path), keep=3)
    t = _tree()
    mgr.save(5, t, extra_meta={"loss": 1.5}, block=True)
    restored, meta = mgr.restore(t)
    for a, b in zip(compat.tree_leaves(t), compat.tree_leaves(restored)):
        assert b.dtype == a.dtype
        torch.testing.assert_close(b, a, rtol=0, atol=0)
    assert meta["step"] == 5 and meta["loss"] == 1.5


def test_keep_k_gc(tmp_path):
    mgr = checkpoint.CheckpointManager(str(tmp_path), keep=2)
    for s in range(5):
        mgr.save(s, _tree(), block=True)
    assert mgr.all_steps() == [3, 4]


def test_async_save_off_critical_path(tmp_path):
    mgr = checkpoint.CheckpointManager(str(tmp_path), keep=2,
                                       async_save=True)
    t0 = time.perf_counter()
    mgr.save(1, _tree())
    submit_time = time.perf_counter() - t0
    mgr.wait()
    assert mgr.all_steps() == [1]
    assert submit_time < 5.0


def test_atomic_no_partial_dirs(tmp_path):
    mgr = checkpoint.CheckpointManager(str(tmp_path), keep=3)
    mgr.save(1, _tree(), block=True)
    entries = [e for e in os.listdir(tmp_path) if e.startswith(".tmp_")]
    assert entries == []


def test_restore_latest_and_specific(tmp_path):
    mgr = checkpoint.CheckpointManager(str(tmp_path), keep=5)
    t = _tree()
    for s in (1, 2, 3):
        t = compat.tree_map(lambda x: x + 1, t)
        mgr.save(s, t, block=True)
    _, meta = mgr.restore(t)
    assert meta["step"] == 3
    r1, meta1 = mgr.restore(t, step=1)
    assert meta1["step"] == 1
    torch.testing.assert_close(r1["params"]["b"], torch.full((4,), 2.0))


def test_restore_casts_to_template_and_refuses_axes(tmp_path):
    """bf16 is written widened to fp32 (numpy has none) and cast back to
    the template's dtype; with no mesh active, ``axes`` re-shards nothing
    and the leaves land as without it (re-sharding onto a mesh:
    tests/test_torch_distributed.py)."""
    mgr = checkpoint.CheckpointManager(str(tmp_path), async_save=False)
    x = torch.tensor([1.5, -2.25, 3.0], dtype=torch.bfloat16)
    mgr.save(1, {"x": x})
    with np.load(tmp_path / "step_00000001" / "shard_0.npz") as data:
        assert data["x"].dtype == np.float32
    restored, _ = mgr.restore({"x": torch.zeros(3, dtype=torch.bfloat16)})
    assert restored["x"].dtype == torch.bfloat16
    torch.testing.assert_close(restored["x"], x, rtol=0, atol=0)
    placed, _ = mgr.restore({"x": torch.zeros(3, dtype=torch.bfloat16)},
                            axes={"x": ("embed",)})
    assert type(placed["x"]) is torch.Tensor
    torch.testing.assert_close(placed["x"], x, rtol=0, atol=0)
    with pytest.raises(FileNotFoundError):
        checkpoint.CheckpointManager(str(tmp_path / "empty")).restore({})
