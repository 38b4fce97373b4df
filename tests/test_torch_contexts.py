"""The reference's scenarios of ``tests/test_contexts.py``, held against the
port: each test keeps its name there.  A call's output is held to the
reference's handler function (``_mm_builder``'s body under JAX) on the
same numpy inputs, within 1e-6.  ``test_per_context_arg_specs_no_cross_demotion``
checks what the reference's checks through its AOT executables
(``_aot_failures``, JAX only): each context keeps its own built variant and
its own recorded argument specs.

Workload-contextual specialization: per-context dispatch snapshots.

One handler + a context_fn: each workload class (e.g. batch-shape) keeps
its own active variant, stats, guard-miss counters, and argument specs;
the legacy context-less API keeps targeting the default context.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro_torch.checkpoint import restore_spec_state, save_spec_state  # noqa: E402
from repro_torch.core import (DEFAULT_CONTEXT, IridescentRuntime,  # noqa: E402
                              encode_context_key, guards)


def _mm_builder(spec):
    B = spec.enum("B", 8, (4, 8, 16))

    def matmul(L, R):
        return (L @ R) * 1.0

    return matmul


def _reference(x, n):
    """The reference's ``_mm_builder`` body on ``x @ eye(n)``, in JAX, from
    the same numpy input the port's call gets."""
    return np.asarray((jnp.asarray(np.asarray(x)) @ jnp.eye(n)) * 1.0)


def _batch_ctx(args, kwargs):
    return int(args[0].shape[0])


def make_rt(**kw):
    return IridescentRuntime(async_compile=False, **kw)


def test_contexts_materialize_on_dispatch():
    rt = make_rt()
    h = rt.register("m", _mm_builder, context_fn=_batch_ctx)
    assert h.contexts() == [DEFAULT_CONTEXT]
    h(torch.ones((4, 4)), torch.eye(4))
    h(torch.ones((8, 8)), torch.eye(8))
    assert set(h.contexts()) == {DEFAULT_CONTEXT, 4, 8}
    rt.shutdown()


def test_per_context_active_variants():
    """Each batch-shape class dispatches to its own active variant."""
    rt = make_rt()
    h = rt.register("m", _mm_builder, context_fn=_batch_ctx)
    h(torch.ones((4, 4)), torch.eye(4))
    h(torch.ones((8, 8)), torch.eye(8))
    h.specialize({"B": 4}, context=4, wait=True)
    h.specialize({"B": 16}, context=8, wait=True)
    assert h.active_config(context=4) == {"B": 4}
    assert h.active_config(context=8) == {"B": 16}
    # dispatch stays correct in both contexts after the split
    np.testing.assert_allclose(h(torch.ones((4, 4)), torch.eye(4)),
                               _reference(np.ones((4, 4)), 4), rtol=1e-6)
    np.testing.assert_allclose(h(torch.ones((8, 8)), torch.eye(8)),
                               _reference(np.ones((8, 8)), 8), rtol=1e-6)
    rt.shutdown()


def test_specializing_one_context_leaves_others_alone():
    rt = make_rt()
    h = rt.register("m", _mm_builder, context_fn=_batch_ctx)
    h(torch.ones((4, 4)), torch.eye(4))
    h(torch.ones((8, 8)), torch.eye(8))
    h.specialize({"B": 16}, context=4, wait=True)
    assert h.active_config(context=4) == {"B": 16}
    assert h.active_config(context=8) == {}          # still generic
    rt.shutdown()


def test_default_context_backcompat():
    """The legacy context-less API (rt.specialize, handler.specialize)
    targets the default context and behaves exactly as before."""
    rt = make_rt()
    h = rt.register("m", _mm_builder)                # no context_fn
    h(torch.ones((4, 4)), torch.eye(4))
    rt.specialize({"B": 4}, wait=True)
    assert h.active_config() == {"B": 4}
    assert h.contexts() == [DEFAULT_CONTEXT]
    assert h.active_config(context=DEFAULT_CONTEXT) == {"B": 4}
    rt.shutdown()


def test_per_context_guard_miss_counters():
    def b(spec):
        N = spec.generic("N", None, guard=guards.shape_equals(0, 0))
        return lambda L, R: (L @ R) * 1.0

    rt = make_rt()
    h = rt.register("m", b, context_fn=_batch_ctx)
    h(torch.ones((4, 4)), torch.eye(4))
    h(torch.ones((8, 8)), torch.eye(8))
    # context 4 gets an assumption that never holds there
    h.specialize({"N": 999}, context=4, wait=True)
    for _ in range(3):
        out = h(torch.ones((4, 4)), torch.eye(4))        # miss -> generic
        np.testing.assert_allclose(out, _reference(np.ones((4, 4)), 4),
                                   rtol=1e-6)
        h(torch.ones((8, 8)), torch.eye(8))              # other context: clean
    assert h.context(4).guard_misses == 3
    assert h.context(8).guard_misses == 0
    assert h.guard_misses == 3                        # handler aggregates
    rt.shutdown()


def test_per_context_arg_specs_no_cross_demotion():
    """Contexts with different shapes AOT-compile independently: calls in
    one context never poison (demote) another context's AOT path."""
    rt = make_rt()
    h = rt.register("m", _mm_builder, context_fn=_batch_ctx)
    for _ in range(5):
        h(torch.ones((4, 4)), torch.eye(4))
        h(torch.ones((8, 8)), torch.eye(8))
    for key in (4, 8):
        ctx = h._ctx_map[key]
        variant = ctx.variants[ctx.active_key]
        assert variant.compiled, f"context {key} lost its build"
        args, _ = ctx.arg_specs
        assert [a[0] for a in args] == [(key, key)] * 2
    rt.shutdown()


def test_per_context_stats_and_counters():
    rt = make_rt()
    h = rt.register("m", _mm_builder, context_fn=_batch_ctx)
    for _ in range(3):
        h(torch.ones((4, 4)), torch.eye(4))
    h(torch.ones((8, 8)), torch.eye(8))
    stats = h.stats()
    per_ctx = stats["contexts"]
    assert per_ctx[encode_context_key(4)]["calls"] == 3
    assert per_ctx[encode_context_key(8)]["calls"] == 1
    # handler-level tput aggregates across contexts
    assert h.tput.total() == 4
    assert h.context(4).calls() == 3
    rt.shutdown()


def test_despecialize_single_context_and_all():
    rt = make_rt()
    h = rt.register("m", _mm_builder, context_fn=_batch_ctx)
    h(torch.ones((4, 4)), torch.eye(4))
    h(torch.ones((8, 8)), torch.eye(8))
    h.specialize({"B": 4}, context=4, wait=True)
    h.specialize({"B": 16}, context=8, wait=True)
    h.despecialize(context=4)
    assert h.active_config(context=4) == {}
    assert h.active_config(context=8) == {"B": 16}    # untouched
    h.despecialize()                                  # all contexts
    assert h.active_config(context=8) == {}
    rt.shutdown()


def test_unhashable_context_key_rejected():
    rt = make_rt()
    h = rt.register("m", _mm_builder,
                    context_fn=lambda a, k: list(a[0].shape))
    with pytest.raises(TypeError, match="hashable"):
        h(torch.ones((4, 4)), torch.eye(4))
    rt.shutdown()


def test_context_view_surface():
    rt = make_rt()
    h = rt.register("m", _mm_builder, context_fn=_batch_ctx)
    h(torch.ones((4, 4)), torch.eye(4))
    view = h.context(4)
    view.specialize({"B": 16}, wait=True)
    assert view.active_config() == {"B": 16}
    assert view.has_variant({"B": 16})
    assert not view.has_variant({"B": 4})
    assert view.calls() == 1
    view.despecialize()
    assert view.active_config() == {}
    rt.shutdown()


# --- persistence: per-context spec_state.json (v2) + legacy loader ------------

def test_spec_state_roundtrip_per_context(tmp_path):
    path = str(tmp_path / "spec_state.json")
    rt = make_rt()
    h = rt.register("m", _mm_builder, context_fn=_batch_ctx)
    h(torch.ones((4, 4)), torch.eye(4))
    h(torch.ones((8, 8)), torch.eye(8))
    h.specialize({"B": 4}, context=4, wait=True)
    h.specialize({"B": 16}, context=8, wait=True)
    save_spec_state(path, rt)
    rt.shutdown()

    with open(path) as f:
        raw = json.load(f)
    assert raw["version"] == 3
    assert encode_context_key(4) in raw["handlers"]["m"]["contexts"]

    # fresh process: restore seeds the non-default contexts; the moment
    # traffic materializes each context, its tuned config is re-applied.
    rt2 = make_rt()
    h2 = rt2.register("m", _mm_builder, context_fn=_batch_ctx)
    assert restore_spec_state(path, rt2, wait=True)
    assert h2.seeded_config(4) == {"B": 4}
    h2(torch.ones((4, 4)), torch.eye(4))                  # materializes ctx 4
    h2(torch.ones((8, 8)), torch.eye(8))
    rt2.compile_service.drain(timeout=30)
    assert h2.active_config(context=4) == {"B": 4}
    assert h2.active_config(context=8) == {"B": 16}
    rt2.shutdown()


def test_spec_state_legacy_flat_format_loads(tmp_path):
    """The old flat {handler: config} format still loads — it targets the
    default context."""
    path = str(tmp_path / "spec_state.json")
    with open(path, "w") as f:
        json.dump({"m": {"B": 4}}, f)
    rt = make_rt()
    h = rt.register("m", _mm_builder)
    h(torch.ones((4, 4)), torch.eye(4))
    assert restore_spec_state(path, rt, wait=True)
    assert h.active_config() == {"B": 4}
    rt.shutdown()


def test_spec_state_stale_config_degrades_to_generic(tmp_path):
    path = str(tmp_path / "spec_state.json")
    with open(path, "w") as f:
        json.dump({"version": 2, "handlers": {
            "m": {"contexts": {encode_context_key(DEFAULT_CONTEXT):
                               {"no_such_point": 1}}}}}, f)
    rt = make_rt()
    h = rt.register("m", _mm_builder)
    restore_spec_state(path, rt, wait=True)           # must not raise
    out = h(torch.ones((4, 4)), torch.eye(4))
    np.testing.assert_allclose(out, _reference(np.ones((4, 4)), 4),
                               rtol=1e-6)
    assert h.active_config() == {}
    rt.shutdown()


def test_spec_state_malformed_v2_degrades_to_generic(tmp_path):
    """A truncated / hand-edited v2 file must never crash startup."""
    path = str(tmp_path / "spec_state.json")
    with open(path, "w") as f:
        json.dump({"version": 2, "handlers": {
            "m": {"contexts": {encode_context_key(DEFAULT_CONTEXT): None}},
            "n": {"contexts": "garbage"}}}, f)
    rt = make_rt()
    h = rt.register("m", _mm_builder)
    restore_spec_state(path, rt, wait=True)           # must not raise
    out = h(torch.ones((4, 4)), torch.eye(4))
    np.testing.assert_allclose(out, _reference(np.ones((4, 4)), 4),
                               rtol=1e-6)
    assert h.active_config() == {}
    rt.shutdown()


def test_save_preserves_unmaterialized_seeded_contexts(tmp_path):
    """Run 2 sees traffic for only one of run 1's tuned contexts; saving
    must not drop the other context's paid-for config."""
    path = str(tmp_path / "spec_state.json")
    rt = make_rt()
    h = rt.register("m", _mm_builder, context_fn=_batch_ctx)
    h(torch.ones((4, 4)), torch.eye(4))
    h(torch.ones((8, 8)), torch.eye(8))
    h.specialize({"B": 4}, context=4, wait=True)
    h.specialize({"B": 16}, context=8, wait=True)
    save_spec_state(path, rt)
    rt.shutdown()

    rt2 = make_rt()
    h2 = rt2.register("m", _mm_builder, context_fn=_batch_ctx)
    restore_spec_state(path, rt2, wait=True)
    h2(torch.ones((4, 4)), torch.eye(4))                  # only ctx 4 traffic
    rt2.compile_service.drain(timeout=30)
    save_spec_state(path, rt2)                        # must keep ctx 8
    rt2.shutdown()

    rt3 = make_rt()
    h3 = rt3.register("m", _mm_builder, context_fn=_batch_ctx)
    restore_spec_state(path, rt3, wait=True)
    h3(torch.ones((8, 8)), torch.eye(8))
    rt3.compile_service.drain(timeout=30)
    assert h3.active_config(context=8) == {"B": 16}
    rt3.shutdown()


def test_compile_cost_estimates_surfaced_per_config():
    rt = make_rt()
    h = rt.register("m", _mm_builder)
    h(torch.ones((4, 4)), torch.eye(4))
    h.specialize({"B": 4}, wait=True)
    svc = rt.compile_service
    est = svc.estimate_compile_s("m", config={"B": 4})
    assert est is not None and est > 0
    per_cfg = svc.cost_estimates("m")
    assert any(v["mean_compile_s"] for v in per_cfg.values())
    rt.shutdown()


def test_seeded_config_applied_when_context_appears_late():
    rt = make_rt()
    h = rt.register("m", _mm_builder, context_fn=_batch_ctx)
    h.seed_spec_state(encode_context_key(4), {"B": 16})
    h(torch.ones((8, 8)), torch.eye(8))                   # a different context
    assert h.active_config(context=8) == {}
    h(torch.ones((4, 4)), torch.eye(4))                   # ctx 4 materializes
    rt.compile_service.drain(timeout=30)
    assert h.active_config(context=4) == {"B": 16}
    rt.shutdown()


def test_property_context_routing_stays_correct():
    """For any mix of shapes and per-context configs, every call's output
    equals the generic function's (the paper's correctness guarantee,
    per context)."""
    rt = make_rt()
    h = rt.register("m", _mm_builder, context_fn=_batch_ctx)
    shapes = [2, 4, 6, 8]
    for n in shapes:
        x = torch.arange(n * n, dtype=torch.float32).reshape(n, n)
        np.testing.assert_allclose(h(x, torch.eye(n)), _reference(x, n),
                                   rtol=1e-6)
    for n, b in zip(shapes, (4, 8, 16, 4)):
        h.specialize({"B": b}, context=n, wait=True)
    for n in shapes:
        x = torch.arange(n * n, dtype=torch.float32).reshape(n, n)
        np.testing.assert_allclose(h(x, torch.eye(n)), _reference(x, n),
                                   rtol=1e-6)
    rt.shutdown()


# -- per-context instrumentation (ROADMAP: enable_instrumentation used to
# -- target the default context only) ------------------------------------------

def test_enable_instrumentation_per_context():
    """Instrumenting one workload class samples only that class's calls;
    every other context keeps its uninstrumented lock-free fast path."""
    rt = make_rt()
    h = rt.register("m", _mm_builder, context_fn=_batch_ctx)
    h(torch.ones((4, 4)), torch.eye(4))
    h(torch.ones((8, 8)), torch.eye(8))
    h.context(4).enable_instrumentation(
        rate=1.0, collectors={"rows": lambda a, k: int(a[0].shape[0])})
    for _ in range(3):
        h(torch.ones((4, 4)), torch.eye(4))
        h(torch.ones((8, 8)), torch.eye(8))
    observed = h.spec_space().observed["rows"]
    # only context 4's calls were sampled
    assert observed["samples"] == 3
    assert dict(observed["top"]) == {4: 3}
    # context 4 is on the instrumented slow path, context 8 untouched
    assert h._ctx_map[4].snapshot.variant.specialized.instrumented
    assert h._ctx_map[8].snapshot.fast is not None
    assert not h._ctx_map[8].snapshot.variant.specialized.instrumented
    rt.shutdown()


def test_disable_instrumentation_per_context_restores_fast_path():
    rt = make_rt()
    h = rt.register("m", _mm_builder, context_fn=_batch_ctx)
    h(torch.ones((4, 4)), torch.eye(4))
    view = h.context(4)
    view.enable_instrumentation(rate=1.0)
    assert h._ctx_map[4].snapshot.fast is None        # sampling forces slow
    view.disable_instrumentation()
    h(torch.ones((4, 4)), torch.eye(4))
    snap = h._ctx_map[4].snapshot
    assert not snap.variant.specialized.instrumented
    assert snap.fast is not None                      # fast path restored
    rt.shutdown()


def test_contextless_instrumentation_unchanged():
    """The legacy context-less call still targets the default context."""
    rt = make_rt()
    h = rt.register("m", _mm_builder)
    h(torch.ones((4, 4)), torch.eye(4))
    h.enable_instrumentation(rate=1.0,
                             collectors={"n": lambda a, k: a[0].shape[0]})
    h(torch.ones((4, 4)), torch.eye(4))
    assert h.spec_space().observed["n"]["samples"] == 1
    assert h._snapshot.variant.specialized.instrumented
    h.disable_instrumentation()
    assert not h._snapshot.variant.specialized.instrumented
    rt.shutdown()
