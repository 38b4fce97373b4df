"""The fast path of the PyTorch port against the JAX reference: the
matcher op's plain version (``torch_ref``) against the reference's oracle
and its Pallas kernel in interpret mode (``tests/test_kernels.py:136-145``);
integer sums that a float product would round; ``make_fastpath`` against
the reference's on hits, misses and duplicate keys (a port of
``tests/test_fastpath.py``'s property test, both ``skip`` settings); the
64-bit dtypes as JAX computes them with 64-bit types off; ``build_table``
from a runtime's observed counter; the guards; ports of
``tests/test_system.py``'s guarded fast-path serving and full-loop tests;
and the quickstart's guard miss at N = 64.

Tolerances: exact for integer values, 1e-6 for float values (the
reference's).
"""
import importlib.util
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro import compat as ref_compat  # noqa: E402
from repro.core import ChangeDetector as RefChangeDetector  # noqa: E402
from repro.core import ExhaustiveSweep as RefSweep  # noqa: E402
from repro.core import Explorer as RefExplorer  # noqa: E402
from repro.core import IridescentRuntime as RefRuntime  # noqa: E402
from repro.core import fastpath as ref_fp  # noqa: E402
from repro.core import guards as ref_guards  # noqa: E402
from repro.kernels import fastpath as ref_lookup_op  # noqa: E402
from repro.kernels import registry as ref_registry  # noqa: E402
from repro.kernels.fastpath import ref as ref_oracle  # noqa: E402
from repro_torch import compat  # noqa: E402
from repro_torch.core import (ChangeDetector, ExhaustiveSweep,  # noqa: E402
                              Explorer, IridescentRuntime, guards)
from repro_torch.core import fastpath as fp  # noqa: E402
from repro_torch.core.instrumentation import HostRecorder  # noqa: E402
from repro_torch.data import RequestGenerator  # noqa: E402
from repro_torch.kernels import registry  # noqa: E402
from repro_torch.kernels.fastpath import kernel, lookup, ops  # noqa: E402
from repro_torch.kernels.fastpath import ref  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CPU = "cpu"

#: (B, N, K, V) of tests/test_kernels.py:136-137
CASES = [(64, 8, 3, 16), (100, 4, 1, 8), (256, 32, 2, 4)]


def _lookup_inputs(b, n, kk, v, seed):
    rs = np.random.RandomState(seed)
    x = rs.randint(0, 10, (b, kk)).astype(np.int32)
    keys = rs.randint(0, 10, (n, kk)).astype(np.int32)
    vals = rs.randn(n, v).astype(np.float32)
    return x, keys, vals


def _ref_interpret(x, keys, vals, **kw):
    if not ref_compat.has_pallas():
        pytest.skip("the reference's Pallas module is not importable")
    key = ("fastpath", "pallas_interpret")
    before = ref_registry.default_registry.fallback_counts.get(key, 0)
    out = ref_lookup_op.lookup(x, keys, vals, impl="interpret", **kw)
    assert ref_registry.default_registry.fallback_counts.get(key, 0) \
        == before, "the interpret entry fell back"
    return out


@pytest.mark.parametrize("b,n,kk,v", CASES)
def test_lookup_matches_reference(b, n, kk, v):
    """Duplicate keys occur here (keys drawn from 0..9) and sum."""
    x, keys, vals = _lookup_inputs(b, n, kk, v, seed=b)
    out, hit = lookup(*map(torch.from_numpy, (x, keys, vals)),
                      impl="torch_ref")
    assert out.shape == (b, v) and out.dtype == torch.float32
    assert hit.dtype == torch.bool and hit.shape == (b,)
    for o_ref, h_ref in (
            ref_oracle.lookup(*map(jnp.asarray, (x, keys, vals))),
            _ref_interpret(*map(jnp.asarray, (x, keys, vals)), block_b=32)):
        np.testing.assert_allclose(out.numpy(), np.asarray(o_ref),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(hit.numpy(), np.asarray(h_ref))


@pytest.mark.parametrize("vdtype", ["int32", "bfloat16", "float32"])
def test_lookup_value_dtypes_match_reference_oracle(vdtype):
    x, keys, vals = _lookup_inputs(100, 16, 2, 5, seed=3)
    vals = (vals * 1000).astype(np.int32) if vdtype == "int32" else vals
    xt, kt = torch.from_numpy(x), torch.from_numpy(keys)
    vt = torch.from_numpy(vals).to(getattr(torch, vdtype))
    out, hit = lookup(xt, kt, vt, impl="torch_ref")
    o_ref, h_ref = ref_oracle.lookup(
        jnp.asarray(x), jnp.asarray(keys),
        jnp.asarray(vals).astype(getattr(jnp, vdtype)))
    assert out.dtype == vt.dtype
    if vdtype == "int32":
        np.testing.assert_array_equal(out.numpy(), np.asarray(o_ref))
    else:
        np.testing.assert_allclose(out.float().numpy(),
                                   np.asarray(o_ref, np.float32),
                                   rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(hit.numpy(), np.asarray(h_ref))


def test_integer_values_sum_exactly():
    """2^25 + 1 is not an fp32 number: the reference's oracle adds integer
    values exactly and so does the port.  (The reference's Pallas kernel
    in interpret mode returns 2^25 here: its one-hot product runs in fp32,
    ``src/repro/kernels/fastpath/kernel.py:38-40``; the port follows the
    oracle.)"""
    x = np.array([[1], [2], [5]], np.int32)
    keys = np.array([[1], [2]], np.int32)
    vals = np.array([[7], [2 ** 25 + 1]], np.int32)
    out, hit = lookup(*map(torch.from_numpy, (x, keys, vals)),
                      impl="torch_ref")
    o_ref, h_ref = ref_oracle.lookup(*map(jnp.asarray, (x, keys, vals)))
    np.testing.assert_array_equal(out.numpy(), np.asarray(o_ref))
    np.testing.assert_array_equal(out.numpy(), [[7], [2 ** 25 + 1], [0]])
    np.testing.assert_array_equal(hit.numpy(), np.asarray(h_ref))
    # int64 values keep all 64 bits, and duplicate keys sum exactly
    big = torch.tensor([[2 ** 40 + 1], [2 ** 40 + 3]], dtype=torch.int64)
    out, _ = lookup(torch.tensor([[4]]), torch.tensor([[4], [4]]), big,
                    impl="torch_ref")
    assert out.item() == 2 ** 41 + 4


def test_empty_table_misses_every_row():
    x = torch.tensor([[1], [2]], dtype=torch.int32)
    out, hit = lookup(x, torch.zeros((0, 1), dtype=torch.int32),
                      torch.zeros((0, 3)), impl="torch_ref")
    assert out.shape == (2, 3) and not out.any() and not hit.any()


def test_guard_decides_by_device_and_integer_queries():
    """The guard is the card and the reference's precondition: 2-D
    tensors of one key width, a value row a key, integer queries.  Float
    queries miss it, as they miss the reference's guard, and so does a
    host tensor; a miss runs ``torch_ref``.  The kernel takes float keys,
    fp16 values and any positive ``block_b``; a CUDA call it cannot take
    (fp64 values, which no reference array holds with 64-bit types off)
    passes the guard and raises in the wrapper (below)."""
    from test_torch_matmul import _OnCard

    xi, xf = torch.zeros(4, 1, dtype=torch.int32), torch.zeros(4, 1)
    k, v = torch.zeros(2, 1, dtype=torch.int32), torch.zeros(2, 3)
    card = lambda *ts: tuple(map(_OnCard, ts))            # noqa: E731
    assert ops._guard(*card(xi, k, v))
    assert ops._guard(*card(xi.long(), k, v))
    assert ops._guard(*card(xi, k.float(), v))            # float keys
    assert ops._guard(*card(xi, k, v.half()), block_b=64)
    assert not ops._guard(*card(xf, k, v))                # float queries
    assert not ops._guard(*card(xi, torch.zeros(2, 2, dtype=torch.int32),
                                v))
    assert not ops._guard(xi, k, v)                       # a host tensor
    assert not ref_lookup_op.ops._guard(jnp.zeros((4, 1)), jnp.zeros((2, 1)),
                                        jnp.zeros((2, 3)))
    assert ref_lookup_op.ops._guard(jnp.zeros((4, 1), jnp.int32),
                                    jnp.zeros((2, 1)), jnp.zeros((2, 3)))
    assert kernel.unsupported(xi, k, v.half()) is None
    assert kernel.unsupported(xi, k, v, block_b=64) is None
    assert kernel.unsupported(xi, k.float(), v) is None
    assert isinstance(kernel.unsupported(xi, k, v.double()), TypeError)
    assert isinstance(kernel.unsupported(xi, k, v, block_b=0), ValueError)
    assert kernel.unsupported(xi, k, v) is None


def test_cuda_entry_raises_on_float_queries(monkeypatch):
    """Float queries that reach the ``cuda`` entry raise a TypeError
    before the kernel is called; integer ones reach it with keys of any
    dtype the kernel takes, float keys included, both as they are (the
    kernel converts them on load)."""
    calls = []
    monkeypatch.setattr(ops.kernel, "fastpath_cuda",
                        lambda x, k, v, block_b: calls.append(
                            (x.dtype, k.dtype)))
    xi, k = torch.zeros(4, 1, dtype=torch.int32), torch.zeros(2, 1).int()
    v = torch.zeros(2, 3)
    with pytest.raises(TypeError, match="integer"):
        ops._lookup_cuda(xi.float(), k, v)
    assert calls == []
    ops._lookup_cuda(xi, k.float(), v)
    ops._lookup_cuda(xi, k.long(), v)
    ops._lookup_cuda(xi.to(torch.int8), k.to(torch.uint8), v)
    assert calls == [(torch.int32, torch.float32), (torch.int32, torch.int64),
                     (torch.int8, torch.uint8)]


def test_unavailable_cuda_on_host_degrades_like_reference():
    if compat.has_hopper() or ref_compat.on_tpu():
        pytest.skip("the kernel entries are available here")
    x, keys, vals = _lookup_inputs(64, 8, 3, 16, seed=9)
    port_key, ref_key = ("fastpath", "cuda"), ("fastpath", "pallas_tpu")
    port_before = registry.default_registry.fallback_counts.get(port_key, 0)
    ref_before = ref_registry.default_registry.fallback_counts.get(ref_key, 0)
    out, hit = lookup(*map(torch.from_numpy, (x, keys, vals)), impl="cuda")
    o_ref, h_ref = ref_lookup_op.lookup(*map(jnp.asarray, (x, keys, vals)),
                                        impl="pallas_tpu")
    np.testing.assert_allclose(out.numpy(), np.asarray(o_ref), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(hit.numpy(), np.asarray(h_ref))
    assert registry.default_registry.fallback_counts[port_key] \
        == port_before + 1
    assert ref_registry.default_registry.fallback_counts[ref_key] \
        == ref_before + 1


def test_kernel_wrapper_refuses_host_tensors():
    x = torch.zeros(4, 1, dtype=torch.int32)
    before = kernel.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernel.fastpath_cuda(x, x, torch.zeros(4, 2))
    assert kernel.launches == before
    assert kernel.DEFAULT_BLOCK_B == 256
    for block_b in (1, 7, 32, 100, 1024):
        assert kernel.unsupported(x, x, torch.zeros(4, 2),
                                  block_b=block_b) is None


def test_cuda_choices_follow_the_host():
    assert ("cuda" in registry.choices("fastpath")) == compat.has_hopper()
    assert registry.choices("fastpath")[-1] == "torch_ref"
    assert not registry.get("fastpath", "cuda").supports_grad


# -- make_fastpath (tests/test_fastpath.py) -----------------------------------------

def _generic_t(xb):
    xb = torch.atleast_2d(xb)
    return (xb.to(torch.float32) ** 2).sum(-1, keepdim=True) + 1.0


def _generic_j(xb):
    xb = jnp.atleast_2d(xb)
    return (xb.astype(jnp.float32) ** 2).sum(-1, keepdims=True) + 1.0


@settings(max_examples=30, deadline=None)
@given(
    st.lists(st.tuples(st.integers(0, 50), st.integers(0, 50)),
             min_size=1, max_size=8),
    st.lists(st.tuples(st.integers(0, 50), st.integers(0, 50)),
             min_size=1, max_size=16),
    st.booleans(),
)
def test_property_fastpath_matches_reference(table_keys, queries, skip):
    """fastpath(x) == the reference's fastpath(x) == generic(x) for all x,
    hits and misses; table keys may repeat."""
    keys = np.asarray(table_keys, np.int32)
    vals = np.asarray(_generic_j(jnp.asarray(keys)))
    q = np.asarray(queries, np.int32)
    port = fp.make_fastpath(_generic_t, fp.FastPathTable.from_arrays(
        keys, vals), skip_generic_when_all_hit=skip, device=CPU)
    ref = ref_fp.make_fastpath(_generic_j, ref_fp.FastPathTable.from_arrays(
        keys, vals), skip_generic_when_all_hit=skip)
    out = port(torch.from_numpy(q))
    expect = np.asarray(ref(jnp.asarray(q)))
    np.testing.assert_allclose(out.numpy(), expect, rtol=1e-6)
    np.testing.assert_allclose(out.numpy(),
                               _generic_t(torch.from_numpy(q)).numpy(),
                               rtol=1e-6)


@pytest.mark.parametrize("skip", [True, False])
def test_duplicate_keys_take_the_first_row_like_reference(skip):
    """A table whose keys repeat with different values: the reference
    gathers the first matching row (argmax); the port drops the repeats
    when it builds the table, so the matcher's sum is that row."""
    keys = np.array([[3], [5], [3], [5], [5]], np.int32)
    vals = np.array([[10.], [20.], [30.], [40.], [50.]], np.float32)
    q = np.array([[5], [3], [7], [5]], np.int32)

    def generic_t(xb):
        return xb.to(torch.float32) * -1.0

    def generic_j(xb):
        return xb.astype(jnp.float32) * -1.0

    port = fp.make_fastpath(generic_t, fp.FastPathTable.from_arrays(
        keys, vals), skip_generic_when_all_hit=skip, device=CPU)
    ref = ref_fp.make_fastpath(generic_j, ref_fp.FastPathTable.from_arrays(
        keys, vals), skip_generic_when_all_hit=skip)
    for batch in (q, q[[0, 1, 3]]):                    # mixed, then all hit
        out = port(torch.from_numpy(batch))
        expect = np.asarray(ref(jnp.asarray(batch)))
        np.testing.assert_array_equal(out.numpy(), expect)
    np.testing.assert_array_equal(port(torch.from_numpy(q)).numpy(),
                                  [[20.], [10.], [-7.], [20.]])


def test_scalar_input_shape():
    keys = np.array([[1, 2]], np.int32)
    vals = _generic_t(torch.from_numpy(keys)).numpy()
    f = fp.make_fastpath(_generic_t, fp.FastPathTable.from_arrays(keys, vals),
                         device=CPU)
    out = f(torch.tensor([1, 2], dtype=torch.int32))
    assert out.shape == (1,)
    ref = ref_fp.make_fastpath(_generic_j, ref_fp.FastPathTable.from_arrays(
        keys, vals))
    np.testing.assert_array_equal(
        out.numpy(), np.asarray(ref(jnp.array([1, 2], jnp.int32))))


def test_64bit_dtypes_canonicalise_as_jax_does():
    """With 64-bit types off JAX makes int64 int32 (wrapping) and float64
    float32; the port's tables do the same."""
    keys = np.array([[2 ** 40 + 5], [7]], np.int64)
    vals = np.array([[1.5], [2 ** 30 + 0.1]], np.float64)
    pt, rt = (fp.FastPathTable.from_arrays(keys, vals),
              ref_fp.FastPathTable.from_arrays(keys, vals))
    with pytest.warns(UserWarning):           # JAX warns as it truncates
        rk = rt.key_array(jnp.int64)
    for pk, rk in ((pt.key_array(torch.int64), rk),
                   (pt.key_array(), rt.key_array()),
                   (pt.key_array(np.int64), rt.key_array(jnp.int32))):
        assert pk.dtype == torch.int32 and str(rk.dtype) == "int32"
        np.testing.assert_array_equal(pk.numpy(), np.asarray(rk))
    for pv, rv in ((pt.value_array(), rt.value_array()),
                   (pt.value_array(np.float64), rt.value_array(jnp.float32))):
        assert pv.dtype == torch.float32 and str(rv.dtype) == "float32"
        np.testing.assert_array_equal(pv.numpy(), np.asarray(rv))
    assert fp.canonical_dtype(np.int64) == torch.int32
    assert fp.canonical_dtype(torch.float64) == torch.float32
    assert fp.canonical_dtype(torch.bfloat16) == torch.bfloat16
    # a fast path built with int64 keys and values (as the reference's
    # fig4 benchmark asks) holds int32 ones, and answers as the reference's
    f = fp.make_fastpath(lambda xb: xb * 3, pt, key_dtype=torch.int64,
                         value_dtype=torch.int64, device=CPU)
    ref_f = ref_fp.make_fastpath(lambda xb: xb * 3, rt, key_dtype=jnp.int64,
                                 value_dtype=jnp.int64)
    q = np.array([[5], [7], [9]], np.int32)
    out = f(torch.from_numpy(q))
    expect = np.asarray(ref_f(jnp.asarray(q)))
    assert out.dtype == torch.int32 and str(expect.dtype) == "int32"
    np.testing.assert_array_equal(out.numpy(), expect)


def test_build_table_from_instrumentation():
    rec = HostRecorder("key", lambda a, k: int(a[0]), rate=1.0)
    for v in [5, 5, 5, 3, 3, 9]:
        rec.maybe_record((v,), {})
    observed = {"key": rec.summary()}

    def gen(k):
        assert k.dtype == torch.int32              # int64 keys, x64 off
        return k.numpy().astype(np.float64) * 2.0

    table = fp.build_table(observed, "key", n=2, generic_fn=gen, device=CPU)
    assert table.n == 2
    assert {int(np.asarray(k)[0]) for k in table.keys} == {5, 3}
    assert fp.build_table({}, "key", 4, lambda k: k, device=CPU) is None


def test_build_table_from_runtime_observed_counter_like_reference():
    """The handler's host recorder (instrumented variant) feeds
    ``build_table``; both runtimes build the same table."""
    def generic_t(xb):
        return (xb.to(torch.float32) * 2 + 1).sum(-1, keepdim=True)

    def generic_j(xb):
        return (xb.astype(jnp.float32) * 2 + 1).sum(-1, keepdims=True)

    tables = []
    for runtime, generic, as_input, first in (
            (IridescentRuntime, generic_t, torch.from_numpy,
             lambda a, k: int(a[0][0, 0].item())),
            (RefRuntime, generic_j, jnp.asarray,
             lambda a, k: int(np.asarray(a[0])[0, 0]))):
        rt = runtime(async_compile=False)
        h = rt.register("lookup", lambda spec, g=generic: g)
        h.enable_instrumentation(rate=1.0, collectors={"hot": first})
        for v in (4, 4, 4, 8, 8, 1):
            h(as_input(np.array([[v]], np.int32)))
        kw = {"device": CPU} if runtime is IridescentRuntime else {}
        tables.append(fp.build_table(h.spec_space().observed, "hot", n=2,
                                     generic_fn=generic, **kw)
                      if runtime is IridescentRuntime else
                      ref_fp.build_table(h.spec_space().observed, "hot", n=2,
                                         generic_fn=generic))
        rt.shutdown()
    port, ref = tables
    assert port.keys == ref.keys == ((4,), (8,))
    assert port.values == ref.values


# -- guards ---------------------------------------------------------------------------

def test_host_guards_match_reference():
    x = np.zeros((6, 4), np.float32)
    args_t, args_j = (torch.from_numpy(x), 3), (jnp.asarray(x), 3)
    for name, make, value in (("arg_equals", lambda m: m(1), 3),
                              ("arg_equals", lambda m: m(1), 4),
                              ("shape_equals", lambda m: m(0, 0), 6),
                              ("shape_equals", lambda m: m(0, 1), 6),
                              ("shape_multiple_of", lambda m: m(0, 0), 3),
                              ("shape_multiple_of", lambda m: m(0, 1), 3),
                              ("shape_multiple_of", lambda m: m(0, 1), True)):
        port = make(getattr(guards, name))(args_t, {}, value)
        ref = make(getattr(ref_guards, name))(args_j, {}, value)
        assert bool(port) == bool(ref), (name, value)


@pytest.mark.parametrize("all_hit", [True, False])
def test_data_guards_match_reference(all_hit):
    hit = np.array([True, all_hit, True])
    fast = np.array([[1.0], [2.0], [3.0]], np.float32)
    xs = np.array([[10.0], [20.0], [30.0]], np.float32)

    def slow(x):
        return x * 2

    out, miss = guards.cond_guard(torch.from_numpy(hit).all(),
                                  lambda x: x + 1, slow, torch.from_numpy(xs))
    r_out, r_miss = ref_guards.cond_guard(jnp.asarray(hit).all(),
                                          lambda x: x + 1, slow,
                                          jnp.asarray(xs))
    np.testing.assert_array_equal(out.numpy(), np.asarray(r_out))
    assert int(miss) == int(r_miss) == int(not all_hit)
    sel = guards.select_guard(torch.from_numpy(hit), torch.from_numpy(fast),
                              slow, torch.from_numpy(xs))
    r_sel = ref_guards.select_guard(jnp.asarray(hit), jnp.asarray(fast),
                                    slow, jnp.asarray(xs))
    np.testing.assert_array_equal(sel.numpy(), np.asarray(r_sel))


# -- the core loop (tests/test_system.py) ----------------------------------------------

def test_guarded_specialization_serving():
    """Fast-path-specialized lookup handler stays correct on misses and the
    policy can read the instrumentation statistics (paper §5 two phases);
    the port's handler answers as the reference's."""
    def generic(xb):
        xb = torch.atleast_2d(xb)
        return (xb.to(torch.float32) * 2 + 1).sum(-1, keepdim=True)

    def generic_j(xb):
        xb = jnp.atleast_2d(xb)
        return (xb.astype(jnp.float32) * 2 + 1).sum(-1, keepdims=True)

    rt = IridescentRuntime(async_compile=False)
    rt.add_custom_spec("fastpath", lambda payload: fp.make_fastpath(
        generic, payload, skip_generic_when_all_hit=True, device=CPU))

    def build(spec):
        f = spec.custom("hot", "fastpath")
        return f if f is not None else generic

    h = rt.register("lookup", build)
    # the reference's int64 input is int32 in JAX (64-bit types off)
    xs = np.array([[3], [9], [40]], np.int32)
    x = torch.from_numpy(xs)
    expect = np.asarray(generic_j(jnp.asarray(xs)))
    np.testing.assert_allclose(h(x).numpy(), expect)

    h.enable_instrumentation(rate=1.0, collectors={
        "hot": lambda a, k: int(a[0][0, 0].item())})
    for _ in range(5):
        h(x)
    tbl = fp.build_table(h.spec_space().observed, "hot", n=2,
                         generic_fn=generic, device=CPU)
    assert tbl is not None
    h.disable_instrumentation()
    h.specialize({"hot": tbl}, wait=True)
    np.testing.assert_allclose(h(x).numpy(), expect)   # hits + misses right
    rt.shutdown()


def test_full_loop_converges_and_adapts():
    """The paper's Fig 2/7 scenario in miniature, in both runtimes: the
    explorer finds the optimum, then re-explores after a workload
    change."""
    results = []
    for runtime, sweep, explorer, detector, ones in (
            (IridescentRuntime, ExhaustiveSweep, Explorer, ChangeDetector,
             lambda: torch.ones(8)),
            (RefRuntime, RefSweep, RefExplorer, RefChangeDetector,
             lambda: jnp.ones(8))):
        rt = runtime(async_compile=False)

        def build(spec):
            b = spec.enum("B", 1, (1, 4))

            def handler(x):
                return (x * b).sum()

            return handler

        h = rt.register("h", build)
        h(ones())
        phase = {"v": 0}

        def metric(h=h, phase=phase):
            b = h.active_config().get("B", 1)
            speed = {0: {1: 1.0, 4: 3.0}, 1: {1: 5.0, 4: 0.5}}
            return speed[phase["v"]].get(b if b else 1, 1.0)

        ex = explorer(h, sweep.from_space(h.spec_space(), ["B"]), dwell=3,
                      metric_fn=metric,
                      change_detector=detector(0.25, warmup=0))
        for _ in range(40):
            h(ones())
            ex.step()
        first = (ex.phase.value, h.active_config()["B"])
        assert float(h(ones())) == 32.0
        phase["v"] = 1
        for _ in range(80):
            h(ones())
            ex.step()
        results.append((first, ex.explorations >= 1,
                        h.active_config()["B"]))
        rt.shutdown()
    port, ref = results
    assert port == ref == (("exploit", 4), True, 1)


def test_request_generator_matches_reference():
    from repro.data import RequestGenerator as RefGenerator

    port, ref = RequestGenerator(seed=2), RefGenerator(seed=2)
    for _ in range(2):
        np.testing.assert_array_equal(port.keys(64), ref.keys(64))
        np.testing.assert_array_equal(port.batch_lengths(16),
                                      ref.batch_lengths(16))
        port.shift()
        ref.shift()


def _load_example(name):
    spec = importlib.util.spec_from_file_location(
        f"_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_guard_miss_at_64_like_reference():
    """The quickstart's handler, specialized for N = 64 and called with a
    32 x 32 input, misses its guard and answers through the generic
    variant; every block size answers as the reference's handler."""
    port_mod, ref_mod = _load_example("quickstart_torch"), \
        _load_example("quickstart")
    rs = np.random.RandomState(0)
    x, y = (rs.randn(64, 64).astype(np.float32) for _ in range(2))
    rt, rrt = IridescentRuntime(async_compile=False), \
        RefRuntime(async_compile=False)
    h = rt.register("matmul", port_mod.build_matmul)
    rh = rrt.register("matmul", ref_mod.build_matmul)
    for b in (4, 8, 16, 32, 64):
        h.specialize({"B": b}, wait=True)
        rh.specialize({"B": b}, wait=True)
        np.testing.assert_allclose(
            h(torch.from_numpy(x), torch.from_numpy(y)).numpy(),
            np.asarray(rh(jnp.asarray(x), jnp.asarray(y))),
            rtol=1e-4, atol=1e-4)
    x2 = np.ones((32, 32), np.float32)
    eye = np.eye(32, dtype=np.float32)
    h.specialize({"B": 16, "N": 64}, wait=True)
    rh.specialize({"B": 16, "N": 64}, wait=True)
    out = h(torch.from_numpy(x2), torch.from_numpy(eye))
    r_out = rh(jnp.asarray(x2), jnp.asarray(eye))
    assert h.guard_misses == rh.guard_misses == 1
    np.testing.assert_allclose(out.numpy(), x2, rtol=1e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(r_out), rtol=1e-5)
    rt.shutdown()
    rrt.shutdown()


def test_quickstart_main_runs_on_cpu():
    mod = _load_example("quickstart_torch")
    result = mod.main(["--device", "cpu"])
    assert result["settled"] and result["guard_misses"] == 1
    assert result["selected"]["B"] in (4, 8, 16, 32, 64)


# -- the prepared (hashed) table ------------------------------------------------------

def _colliding(n):
    """2n int32 keys (K = 1) whose hashes share one slot of the table
    ``prepare_table`` builds for n keys."""
    size = 2
    while size < 2 * n:
        size *= 2
    cand = np.arange(8 * n * size, dtype=np.int64)[:, None]
    slot = kernel.hash_keys(cand) & np.uint64(size - 1)
    same = cand[slot == np.bincount(slot.astype(np.int64)).argmax()]
    assert len(same) >= 2 * n
    return same[:2 * n].astype(np.int32)


#: (B, N, K, V, key dtype, value dtype, keys from 0..range or "chain")
PREPARED_CASES = [
    (64, 8, 3, 16, "int32", "float32", 10),
    (100, 0, 1, 4, "int32", "float32", 10),
    (100, 1, 1, 3, "int64", "int32", 10),
    (256, 32, 2, 4, "int64", "bfloat16", 10),
    (200, 40, 32, 5, "int32", "int64", 3),
    (300, 64, 1, 2, "int32", "float32", "chain"),
    (128, 500, 1, 1, "int32", "int32", 200),
]


def _prepared_inputs(b, n, kk, v, kdt, vdt, keys_from, seed):
    rs = np.random.RandomState(seed)
    if keys_from == "chain":
        same = _colliding(n)
        keys, absent = same[:n], same[n:]
        x = np.where((np.arange(b) % 2 == 0)[:, None],
                     keys[rs.randint(0, n, b)], absent[rs.randint(0, n, b)])
    else:
        keys = rs.randint(0, keys_from, (n, kk))
        x = rs.randint(0, keys_from + 2, (b, kk))
        if n:
            pick = rs.rand(b) < 0.6
            x[pick] = keys[rs.randint(0, n, pick.sum())]
    if vdt in ("int32", "int64"):
        vals = rs.randint(-2 ** 20, 2 ** 20, (n, v))
    else:
        vals = rs.randn(n, v)
    return (x.astype(kdt), keys.astype(kdt),
            vals.astype("float32" if vdt == "bfloat16" else vdt))


@pytest.mark.parametrize("case", PREPARED_CASES,
                         ids=[f"{c[1]}x{c[2]}-{c[4]}-{c[5]}-{c[6]}"
                              for c in PREPARED_CASES])
def test_lookup_prepared_matches_reference(case):
    """The hashed form built on the host, probed by the plain
    ``ref.lookup_prepared``, against ``ref.lookup``, the reference's
    oracle and its Pallas kernel in interpret mode: duplicate keys (keys
    from a small range), N = 0 and 1, K up to 32, int32 and int64 keys,
    every value dtype, and a table whose keys share one probe chain
    (queried with absent keys of the same slot too).  Integer values stay
    under 2^24 in every sum, where the interpret kernel's fp32 product is
    exact, and keys fit int32, as JAX holds them."""
    b, n, kk, v, kdt, vdt, keys_from = case
    x, keys, vals = _prepared_inputs(b, n, kk, v, kdt, vdt, keys_from,
                                     seed=n + kk)
    tvals = torch.from_numpy(vals).to(getattr(torch, vdt))
    xt, kt = torch.from_numpy(x), torch.from_numpy(keys)
    table = kernel.prepare_table(kt, tvals)
    assert table.keys is kt and table.values is tvals
    mask = table.slots.shape[0] - 1
    assert mask & (mask + 1) == 0 and mask + 1 >= max(2, 2 * n)
    out, hit = ref.lookup_prepared(xt, table)
    o_port, h_port = ref.lookup(xt, kt, tvals)
    assert out.dtype == tvals.dtype and out.shape == (b, v)
    assert torch.equal(hit, h_port)
    jvals = jnp.asarray(vals).astype(getattr(jnp, vdt))
    jx = jnp.asarray(x.astype(np.int32))
    jk = jnp.asarray(keys.astype(np.int32))
    oracles = [(o_port, h_port), ref_oracle.lookup(jx, jk, jvals)]
    if n:      # a zero-row table has no block for the Pallas kernel
        oracles.append(_ref_interpret(jx, jk, jvals, block_b=32))
    for o_ref, h_ref in oracles:
        np.testing.assert_array_equal(hit.numpy(), np.asarray(h_ref))
        if vdt in ("int32", "int64"):
            np.testing.assert_array_equal(out.numpy(), np.asarray(o_ref))
        else:
            o_ref = o_ref.float() if isinstance(o_ref, torch.Tensor) \
                else np.asarray(o_ref.astype(jnp.float32))
            np.testing.assert_allclose(out.float().numpy(), np.asarray(o_ref),
                                       rtol=1e-6, atol=1e-6)


def test_prepared_table_sums_duplicates_and_wraps():
    """Duplicate keys' values are pre-summed once: integers wrap in their
    own type, bf16 values sum in fp32 and round once."""
    keys = torch.tensor([[7], [3], [7], [7]], dtype=torch.int32)
    i32 = torch.tensor([[2 ** 31 - 1], [5], [1], [2]], dtype=torch.int32)
    table = kernel.prepare_table(keys, i32)
    assert table.hkeys[:, 0].tolist() == [7, 3]
    assert table.hvalues[:, 0].tolist() == [-2 ** 31 + 2, 5]
    x = torch.tensor([[7], [3], [9]], dtype=torch.int32)
    out, hit = ref.lookup_prepared(x, table)
    assert torch.equal(out, ref.lookup(x, keys, i32)[0])
    assert hit.tolist() == [True, True, False]
    bf = torch.tensor([[1.0], [5.0], [2 ** -8], [2 ** -8]],
                      dtype=torch.bfloat16)
    table = kernel.prepare_table(keys, bf)
    assert table.hvalues.dtype == torch.float32
    assert table.hvalues[0, 0].item() == 1.0 + 2 ** -7
    out, _ = ref.lookup_prepared(x, table)
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, ref.lookup(x, keys, bf)[0])


#: a fixed key vector and its hashes, pinned: the card test
#: (tests/test_torch_fastpath_cuda.py) checks the kernel library's hash on
#: the same vector
HASH_KEYS = [[0], [1], [-1], [2 ** 31 - 1], [-2 ** 31], [2 ** 40 + 12345]]
HASH_PINNED = [16294208416658607535, 16490336266968443936,
               15999695513772384452, 13807218343701425311,
               547167690438560762, 1117476736002829374]


def test_hash_is_pinned_and_matches_the_source():
    """Python's hash gives the pinned outputs (the first is splitmix64's
    first output from seed 0), and its constants are the .cu's: the one
    function written twice."""
    got = kernel.hash_keys(np.array(HASH_KEYS, np.int64))
    assert got.dtype == np.uint64 and got.tolist() == HASH_PINNED
    # the same in Python integers, mod 2^64
    def mix(z):
        m = 2 ** 64 - 1
        z ^= z >> 30
        z = z * kernel._MIX1 & m
        z ^= z >> 27
        z = z * kernel._MIX2 & m
        return z ^ z >> 31
    assert [mix(kernel._HASH_SEED ^ (k % 2 ** 64)) for (k,) in HASH_KEYS] \
        == HASH_PINNED
    # int32 keys hash as their sign-extended int64 value
    assert kernel.hash_keys(np.array(HASH_KEYS[:5], np.int32)).tolist() \
        == HASH_PINNED[:5]
    # K > 1 chains the integers
    two = kernel.hash_keys(np.array([[0, 1]], np.int64))[0]
    assert two not in HASH_PINNED
    src = kernel.SOURCE.read_text()
    for name, value in (("kHashSeed", kernel._HASH_SEED),
                        ("kMix1", kernel._MIX1), ("kMix2", kernel._MIX2)):
        assert f"{name} = {value:#X}ull".replace("0X", "0x") in src, name
    for shift in (30, 27, 31):
        assert f"z ^= z >> {shift};" in src


def test_lookup_with_prepared_on_cpu_runs_the_oracle():
    """On the CPU ``lookup(..., prepared=)`` runs ``torch_ref`` on the raw
    arrays, and ``ops.prepare`` gives no table (nothing is dispatched)."""
    x, keys, vals = map(torch.from_numpy, _lookup_inputs(64, 8, 3, 16, 4))
    table = kernel.prepare_table(keys, vals)
    expect = lookup(x, keys, vals, impl="torch_ref")
    got = lookup(x, keys, vals, impl="torch_ref", prepared=table)
    assert all(torch.equal(a, b) for a, b in zip(got, expect))
    assert ops.prepare(keys, vals, "cuda") is None
    assert ops.prepare(keys, vals, "torch_ref") is None


def test_cuda_entry_sends_a_prepared_table_to_its_wrapper(monkeypatch):
    calls = []
    monkeypatch.setattr(ops.kernel, "fastpath_cuda_prepared",
                        lambda x, t, block_b, readback: calls.append(t))
    x, keys, vals = map(torch.from_numpy, _lookup_inputs(8, 4, 1, 2, 5))
    table = kernel.prepare_table(keys, vals)
    ops._lookup_cuda(x, keys, vals, prepared=table)
    assert calls == [table]
    with pytest.raises(ValueError, match="other keys"):
        ops._lookup_cuda(x, keys.clone(), vals, prepared=table)


def test_prepared_wrapper_refuses_host_tensors():
    x, keys, vals = map(torch.from_numpy, _lookup_inputs(8, 4, 1, 2, 6))
    table = kernel.prepare_table(keys, vals)
    before = kernel.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernel.fastpath_cuda_prepared(x, table)
    with pytest.raises(ValueError, match="body"):
        kernel.fastpath_cuda_prepared(x, table, body="sorted")
    with pytest.raises(TypeError, match="keys must be"):
        kernel.prepare_table(keys.double(), vals)
    assert kernel.prepare_table(keys.float(), vals).hkeys.dtype \
        == torch.int32
    assert kernel.launches == before


@pytest.mark.parametrize("skip", [True, False])
def test_make_fastpath_on_cpu_counts_its_fallback_as_before(skip):
    """Asked for ``cuda`` with a host table, the specialized function runs
    ``torch_ref`` and counts one fallback a call, as ``dispatch`` does; the
    entry is resolved once, when the function is built."""
    keys = np.array([[3, 1], [5, 2], [9, 9]], np.int32)
    vals = _generic_t(torch.from_numpy(keys)).numpy()
    f = fp.make_fastpath(_generic_t, fp.FastPathTable.from_arrays(keys, vals),
                         skip_generic_when_all_hit=skip, impl="cuda",
                         device=CPU)
    counts = registry.default_registry.fallback_counts
    before = counts.get(("fastpath", "cuda"), 0)
    q = torch.from_numpy(np.array([[3, 1], [9, 9], [4, 4]], np.int32))
    for batch in (q, q[:2]):                            # mixed, then all hit
        np.testing.assert_array_equal(f(batch).numpy(),
                                      _generic_t(batch).numpy())
    assert counts[("fastpath", "cuda")] == before + 2
    auto = fp.make_fastpath(_generic_t, fp.FastPathTable.from_arrays(
        keys, vals), skip_generic_when_all_hit=skip, device=CPU)
    before = dict(counts)
    if not compat.has_hopper():
        auto(q)
        assert dict(counts) == before          # torch_ref chosen, no miss


def test_registry_bind_resolves_once():
    reg = registry.KernelRegistry()
    reg.register("fam", "torch_ref")(lambda x: ("ref", x))
    reg.register("fam", "fast", priority=5,
                 guard=lambda x: x > 0)(lambda x: ("fast", x))
    select = reg.bind("fam", None)
    assert select(3).name == "fast"
    assert select(-1).name == "torch_ref"
    assert reg.fallback_counts == {("fam", "fast"): 1}
    assert reg.pick("fam", "fast") == (reg.get("fam", "fast"), None)
