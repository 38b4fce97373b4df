"""The donated train step: ``register(..., donate_argnums=0)`` and the
in-place AdamW update, against the reference and the functional path.

The in-place update (:func:`repro_torch.optim.update_in_place`) is held to
the reference's ``apply_updates`` on identical gradients (within 1e-6,
compress none and int8_ef, clipped and unclipped) with every leaf walked
in several slices; the functional ``apply_updates`` is bit-equal to a
clone followed by the in-place update, and the in-place update keeps
every leaf's storage.  A handler registered with ``donate_argnums=0``
equals an undonated one run from a clone of the state, takes a guard miss
on an intact state, keeps the live state out of a shadow pair, and the
runtime rejects any other jit keyword.  An asynchronous checkpoint save
of host tensors writes the values from before a later in-place update.
"""
import threading

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import optim as ref_optim  # noqa: E402
from repro_torch import compat, configs  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.core import IridescentRuntime  # noqa: E402
from repro_torch.core.specializer import specialize_builder  # noqa: E402
from repro_torch.models import transformer as model  # noqa: E402
from repro_torch.optim import (OptConfig, adamw, apply_updates,  # noqa: E402
                               init_opt_state, update_in_place)
from repro_torch.serve.shadow import ShadowEvaluator  # noqa: E402
from repro_torch.training import make_train_builder  # noqa: E402

OPT_TOL = 1e-6
CFG = configs.get_reduced("qwen3-0.6b").replace(compute_dtype="float32")
OPT = OptConfig(lr=1e-2, warmup_steps=1, total_steps=100)
#: a slice of 64 fp32 bytes: every leaf of _tree below spans several
SMALL_SLICE = 64


def _tree(rs, scale=1.0):
    """A params-shaped tree: a stacked (L, d) norm, a 3-D stack, a matrix
    and a 1-D final norm."""
    return {"final_norm": (rs.randn(24) * scale).astype(np.float32),
            "layers": {"norm1": (rs.randn(4, 8) * scale).astype(np.float32),
                       "wq": (rs.randn(4, 8, 4) * scale).astype(np.float32)},
            "lm_head": (rs.randn(24, 16) * scale).astype(np.float32)}


def _to_port(tree):
    return compat.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _clone(tree):
    return compat.tree_map(torch.clone, tree)


def _storages(tree):
    return [t.untyped_storage().data_ptr() for t in compat.tree_leaves(tree)]


@pytest.mark.parametrize("compress", ["none", "int8_ef"])
@pytest.mark.parametrize("clip_norm", [1.0, 1e3])
def test_update_in_place_matches_reference(compress, clip_norm, monkeypatch):
    """Three in-place steps on the same gradients (clipped and unclipped,
    through the warmup into the decay), each leaf in several slices:
    params, m, v, count and ef agree with the reference's."""
    monkeypatch.setattr(adamw, "SLICE_BYTES", SMALL_SLICE)
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=6, clip_norm=clip_norm,
              compress=compress)
    cfg, ref_cfg = OptConfig(**kw), ref_optim.OptConfig(**kw)
    rs = np.random.RandomState(0)
    params = _tree(rs)
    ref_p, p = jax.tree_util.tree_map(jnp.asarray, params), _to_port(params)
    ref_st = ref_optim.init_opt_state(ref_p, ref_cfg)
    st = init_opt_state(p, cfg)
    assert all(len(list(adamw._rows(t))) > 1
               for t in compat.tree_leaves(p))
    for _ in range(3):
        g = _tree(rs, scale=0.1)
        ref_p, ref_st = ref_optim.apply_updates(
            ref_p, jax.tree_util.tree_map(jnp.asarray, g), ref_st, ref_cfg)
        p, st = update_in_place(p, _to_port(g), st, cfg)
    assert st["count"].dtype == torch.int32 and int(st["count"]) == 3
    for want, got in zip(jax.tree_util.tree_leaves((ref_p, ref_st)),
                         compat.tree_leaves((p, st))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=OPT_TOL, atol=OPT_TOL)


@pytest.mark.parametrize("compress", ["none", "int8_ef"])
@pytest.mark.parametrize("slice_bytes", [SMALL_SLICE, adamw.SLICE_BYTES])
def test_functional_equals_clone_then_in_place(compress, slice_bytes,
                                               monkeypatch):
    """apply_updates is bit-equal to clones updated in place, and leaves
    its inputs (gradients too) unchanged."""
    monkeypatch.setattr(adamw, "SLICE_BYTES", slice_bytes)
    cfg = OptConfig(lr=1e-2, warmup_steps=1, total_steps=10,
                    compress=compress)
    rs = np.random.RandomState(1)
    params = _to_port(_tree(rs))
    state = init_opt_state(params, cfg)
    for _ in range(2):
        grads = _to_port(_tree(rs, scale=0.1))
        before = _clone((params, grads, state))
        fp, fs = apply_updates(params, grads, state, cfg)
        for a, b in zip(compat.tree_leaves(before),
                        compat.tree_leaves((params, grads, state))):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        ip, ist = update_in_place(*_clone((params, grads, state)), cfg)
        for a, b in zip(compat.tree_leaves((fp, fs)),
                        compat.tree_leaves((ip, ist))):
            assert torch.equal(a, b)
        params, state = fp, fs


@pytest.mark.parametrize("compress", ["none", "int8_ef"])
def test_update_in_place_keeps_every_storage(compress):
    cfg = OptConfig(compress=compress)
    rs = np.random.RandomState(2)
    params = _to_port(_tree(rs))
    state = init_opt_state(params, cfg)
    before = _clone((params, state))
    ptrs = _storages((params, state))
    p2, st2 = update_in_place(params, _to_port(_tree(rs)), state, cfg)
    assert p2 is params and st2 is state
    assert _storages((p2, st2)) == ptrs
    # and every leaf was written (count, m, v, params; ef under int8_ef)
    changed = [not torch.equal(a, b) for a, b in zip(
        compat.tree_leaves(before), compat.tree_leaves((p2, st2)))]
    assert all(changed), changed


# -- the donated handler -------------------------------------------------------------

def _state_and_batch(b=4, s=16, seed=7):
    params = model.init_params(torch.Generator().manual_seed(0), CFG)
    state = {"params": params, "opt": init_opt_state(params, OPT)}
    rs = np.random.RandomState(seed)
    toks = torch.from_numpy(
        rs.randint(0, CFG.vocab_size, (b, s + 1)).astype(np.int32))
    return state, {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _assert_trees_equal(a, b):
    la, lb = compat.tree_leaves(a), compat.tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert torch.equal(x, y)


def test_donated_handler_equals_undonated_from_a_clone():
    """Two steps of the donated handler against the undonated one from a
    clone of the same state: losses and states bit-equal; the donated one
    returns the dict it was given, every leaf on its own storage, and the
    undonated one leaves its input unchanged."""
    rt = IridescentRuntime(async_compile=False)
    donated = rt.register("donated", make_train_builder(CFG, OPT),
                          donate_argnums=0)
    plain = rt.register("plain", make_train_builder(CFG, OPT))
    assert donated.donate_argnums == (0,) and plain.donate_argnums == ()
    state, batch = _state_and_batch()
    ref = _clone(state)
    ptrs = _storages(state)
    for _ in range(2):
        kept = _clone(ref)
        ref_new, ref_m = plain(ref, batch)
        _assert_trees_equal(ref, kept)             # undonated: unchanged
        new, m = donated(state, batch)
        assert new is state and _storages(new) == ptrs
        assert torch.equal(m["loss"], ref_m["loss"])
        _assert_trees_equal(new, ref_new)
        ref = ref_new
    assert int(state["opt"]["count"]) == 2


def test_donated_handler_takes_a_guard_miss_on_an_intact_state():
    """A specialized variant whose guard misses: the trampoline hands the
    generic (donated) variant the state untouched, so the step equals the
    undonated generic step from a clone."""
    train = make_train_builder(CFG, OPT)

    def builder(spec):
        spec.assume("two_rows", guard=lambda a, k, v:
                    a[1]["tokens"].shape[0] == 2)
        return train(spec)

    rt = IridescentRuntime(async_compile=False)
    h = rt.register("train", builder, donate_argnums=(0,))
    h.specialize({"two_rows": True, "microbatch": 2}, wait=True)
    state, batch = _state_and_batch(b=4)
    ref_new, ref_m = specialize_builder(train, {}).fn(_clone(state), batch)
    new, m = h(state, batch)
    assert h.guard_misses == 1
    assert torch.equal(m["loss"], ref_m["loss"])
    _assert_trees_equal(new, ref_new)


def test_donated_handler_keeps_live_state_out_of_a_shadow_pair():
    """A shadow evaluator on a donated handler clones the donated state at
    capture and before each shadow call, even when asked to share it: the
    pairs run, and the live state is what the live steps made of it."""
    rt = IridescentRuntime(async_compile=False)
    h = rt.register("train", make_train_builder(CFG, OPT), donate_argnums=0)
    ev = ShadowEvaluator(h, sample_frac=1.0, k=2, shared_args=(0,))
    assert ev.shared_args == frozenset()
    state, batch = _state_and_batch()
    plain = specialize_builder(make_train_builder(CFG, OPT), {}).fn
    ref = _clone(state)
    state, _ = h(state, batch)                     # captured, then stepped
    ref, _ = plain(ref, batch)
    live = _clone(state)
    ptrs = _storages(state)
    view = h.context()
    view.build({"microbatch": 2}, wait=True)
    ev.begin(view.key, {"microbatch": 2}, {})
    assert ev.step(budget=2) == 2 and ev.calls == 4
    assert ev.verdict(view.key)["measured"]
    _assert_trees_equal(state, live)
    assert _storages(state) == ptrs
    state, _ = h(state, batch)
    ref, _ = plain(ref, batch)
    _assert_trees_equal(state, ref)
    ev.close()


def test_register_rejects_an_unknown_jit_kwarg():
    rt = IridescentRuntime(async_compile=False)
    with pytest.raises(TypeError, match="static_argnums"):
        rt.register("train", make_train_builder(CFG, OPT),
                    static_argnums=1)
    assert "train" not in rt.handlers
    h = rt.register("train", make_train_builder(CFG, OPT), donate_argnums=0)
    assert h.jit_kwargs == {"donate_argnums": 0}


# -- the checkpoint store ---------------------------------------------------------

def test_async_save_of_host_tensors_writes_the_values_before_an_update(
        tmp_path):
    """The writer thread is held on an event while the state is updated in
    place; the checkpoint then holds the state as it was at ``save``."""
    cfg = OptConfig(compress="int8_ef")
    rs = np.random.RandomState(3)
    params = _to_port(_tree(rs))
    state = {"params": params, "opt": init_opt_state(params, cfg)}
    before = _clone(state)
    mgr = CheckpointManager(str(tmp_path), keep=1)
    gate, write = threading.Event(), mgr._write

    def held(*args):
        assert gate.wait(60)
        return write(*args)

    mgr._write = held
    mgr.save(1, state)
    update_in_place(state["params"], _to_port(_tree(rs)), state["opt"], cfg)
    assert not torch.equal(state["params"]["lm_head"],
                           before["params"]["lm_head"])
    gate.set()
    mgr.wait()
    restored, meta = mgr.restore(before)
    assert meta["step"] == 1
    _assert_trees_equal(restored, before)
