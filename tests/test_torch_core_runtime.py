"""The reference's scenarios of ``tests/test_core_runtime.py``, held against the
port: each test keeps its name there.  A call's output is held to the
reference's handler function (``_mm_builder``'s body, or the custom
generator's, under JAX) on the same numpy inputs, within 1e-6.

Runtime: trampoline dispatch, guards + fallback, async compile,
instrumentation.  Core invariant (paper §4.4.3): for every input, the
handler's observable behaviour equals the generic function's."""
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro_torch.core import IridescentRuntime, guards  # noqa: E402


def _mm_builder(spec):
    B = spec.enum("B", 8, (4, 8, 16))
    N = spec.generic("N", None, guard=guards.shape_equals(0, 0))

    def matmul(L, R):
        return (L @ R) * 1.0  # B/N only affect codegen, not semantics

    return matmul


def _reference(x, y):
    """The reference's ``_mm_builder`` body in JAX on the same numpy
    inputs."""
    return np.asarray((jnp.asarray(np.asarray(x)) @ jnp.asarray(
        np.asarray(y))) * 1.0)


def make_rt(**kw):
    return IridescentRuntime(async_compile=False, **kw)


def test_generic_available_immediately():
    rt = make_rt()
    h = rt.register("m", _mm_builder)
    out = h(torch.ones((4, 4)), torch.eye(4))
    assert out.shape == (4, 4)
    assert h.active_config() == {}


def test_specialize_and_guard_fallback():
    rt = make_rt()
    h = rt.register("m", _mm_builder)
    h(torch.ones((8, 8)), torch.eye(8))
    h.specialize({"B": 4, "N": 8}, wait=True)
    h(torch.ones((8, 8)), torch.eye(8))
    assert h.guard_misses == 0
    # guard miss -> generic fallback, still correct
    out = h(torch.ones((4, 4)), torch.eye(4))
    assert h.guard_misses == 1
    np.testing.assert_allclose(out, _reference(np.ones((4, 4)), np.eye(4)),
                               rtol=1e-6)


def test_variant_cache_reuse():
    rt = make_rt()
    h = rt.register("m", _mm_builder)
    h(torch.ones((4, 4)), torch.eye(4))
    h.specialize({"B": 4}, wait=True)
    h.specialize({"B": 16}, wait=True)
    n = len(h.variants())
    h.specialize({"B": 4}, wait=True)   # cached
    assert len(h.variants()) == n


def test_async_compile_off_critical_path():
    rt = IridescentRuntime(async_compile=True)
    try:
        h = rt.register("m", _mm_builder)
        h(torch.ones((4, 4)), torch.eye(4))
        h.specialize({"B": 16}, wait=False)
        # trampoline keeps serving (old variant) while compiling
        out = h(torch.ones((4, 4)), torch.eye(4))
        assert out.shape == (4, 4)
        deadline = time.time() + 20
        while h.active_config().get("B") != 16 and time.time() < deadline:
            time.sleep(0.05)
            h(torch.ones((4, 4)), torch.eye(4))
        assert h.active_config().get("B") == 16
    finally:
        rt.shutdown()


def test_compile_times_recorded():
    rt = make_rt()
    h = rt.register("m", _mm_builder)
    h(torch.ones((4, 4)), torch.eye(4))
    h.specialize({"B": 4}, wait=True)
    stats = h.stats()
    assert stats["variants"] >= 2
    assert any(v is not None for v in stats["compile_times_s"].values())


def test_host_instrumentation_collects_topk():
    rt = make_rt()
    h = rt.register("m", _mm_builder)
    h(torch.ones((4, 4)), torch.eye(4))
    h.enable_instrumentation(
        rate=1.0, collectors={"N": lambda a, k: a[0].shape[0]})
    for n in (4, 4, 4, 8):
        h(torch.ones((n, n)), torch.eye(n))
    obs = h.spec_space().observed
    assert obs["N"]["top"][0][0] == 4
    h.disable_instrumentation()


def test_custom_spec_generator():
    rt = make_rt()
    rt.add_custom_spec("scaler", lambda payload: float(payload) * 2)

    def b(spec):
        s = spec.custom("s", "scaler")
        return lambda x: x * (s if s is not None else 1.0)

    h = rt.register("h", b)
    assert float(h(torch.tensor(3))) == 3.0
    h.specialize({"s": 2}, wait=True)
    assert float(h(torch.tensor(3))) == 12.0


def test_runtime_routes_config_subsets():
    rt = make_rt()
    rt.register("m", _mm_builder)

    def b2(spec):
        k = spec.enum("K", 1, (1, 2))
        return lambda x: x * k

    rt.register("other", b2)
    rt.specialize({"B": 4, "K": 2}, wait=True)
    assert rt.handler("m").active_config().get("B") == 4
    assert rt.handler("other").active_config().get("K") == 2


@settings(max_examples=20, deadline=None)
@given(st.integers(2, 6), st.sampled_from([4, 8, 16]),
       st.booleans())
def test_property_specialized_equals_generic(n, b_choice, specialize):
    """For ANY input and ANY configuration, handler output == generic
    output (the paper's correctness guarantee)."""
    rt = make_rt()
    h = rt.register("m", _mm_builder)
    x = torch.arange(n * n, dtype=torch.float32).reshape(n, n)
    generic = _reference(x, np.eye(n, dtype=np.float32))
    if specialize:
        h.specialize({"B": b_choice, "N": 8}, wait=True)  # guard vs n!=8
    out = h(x, torch.eye(n))
    np.testing.assert_allclose(out, generic, rtol=1e-6)
