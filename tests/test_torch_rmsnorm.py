"""RMSNorm of the PyTorch port against the JAX reference, and the port's
kernel registry (aliases, availability and guard fallbacks)."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import compat as ref_compat  # noqa: E402
from repro.kernels import registry as ref_registry  # noqa: E402
from repro.kernels import rmsnorm as ref_rmsnorm  # noqa: E402
from repro_torch import compat  # noqa: E402
from repro_torch.kernels import registry  # noqa: E402
from repro_torch.kernels.rmsnorm import kernel, ops  # noqa: E402
from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_pair  # noqa: E402

# The shapes and tolerances of tests/test_kernels.py's rmsnorm sweep.
SHAPES = [(32, 128), (100, 64), (256, 256), (2, 17, 64)]
TOL = {"float32": 1e-5, "bfloat16": 3e-2}


def _inputs(shape, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(*shape).astype(np.float32)
    w = rs.randn(shape[-1]).astype(np.float32)
    return x, w


def _port(x, dtype):
    return torch.from_numpy(x).to(getattr(torch, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("ref_impl", ["xla", "interpret"])
def test_torch_ref_matches_reference(shape, dtype, ref_impl):
    if ref_impl == "interpret" and not ref_compat.has_pallas_tpu():
        pytest.skip("Pallas TPU module not importable: the reference's "
                    "interpret entry would fall back to xla_ref")
    x, w = _inputs(shape)
    ref = ref_rmsnorm.rmsnorm(jnp.asarray(x).astype(getattr(jnp, dtype)),
                              jnp.asarray(w), impl=ref_impl, block_rows=16)
    out = rmsnorm(_port(x, dtype), torch.from_numpy(w), impl="torch_ref")
    assert out.dtype == getattr(torch, dtype) and out.shape == shape
    tol = TOL[dtype]
    np.testing.assert_allclose(np.asarray(ref, np.float32),
                               out.to(torch.float32).numpy(),
                               rtol=tol, atol=tol)


def test_torch_ref_computes_float64_in_float64():
    """A float64 input is normalised in float64 (the witness the full-width
    parity check uses), to float64 rounding of numpy's float64 result."""
    x, w = (a.astype(np.float64) for a in _inputs((100, 64)))
    want = x / np.sqrt(np.mean(x * x, -1, keepdims=True) + 1e-6) * w
    out = rmsnorm(torch.from_numpy(x), torch.from_numpy(w), eps=1e-6,
                  impl="torch_ref")
    assert out.dtype == torch.float64
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-12, atol=1e-12)


def test_legacy_aliases_resolve():
    assert registry.FALLBACK_IMPL == "torch_ref"
    for name in ("xla", "xla_ref", "ref"):
        assert registry.canonical_name(name) == "torch_ref"
    for name in ("pallas", "pallas_tpu", "pallas_gpu"):
        assert registry.canonical_name(name) == "cuda"
    assert registry.get("rmsnorm", "pallas_tpu").name == "cuda"
    assert registry.get("rmsnorm", "xla").name == "torch_ref"
    point = registry.ImplPoint("rmsnorm_impl", None, None, False,
                               choices=("torch_ref",), family="rmsnorm")
    for name in ("xla_ref", "pallas_tpu", "cuda", "torch_ref"):
        assert point.validate(name)
    assert not point.validate("no_such_impl")
    with pytest.raises(KeyError, match="torch_ref"):
        registry.get("rmsnorm", "no_such_impl")


def test_cuda_on_cpu_tensor_degrades_like_reference():
    """Asking for the kernel with a host tensor runs the plain version and
    counts one fallback, as the reference registry does for pallas_tpu."""
    if ref_compat.on_tpu():
        pytest.skip("the reference's pallas_tpu entry is available here")
    x, w = _inputs((8, 64))
    port_key, ref_key = ("rmsnorm", "cuda"), ("rmsnorm", "pallas_tpu")
    port_before = registry.default_registry.fallback_counts.get(port_key, 0)
    ref_before = ref_registry.default_registry.fallback_counts.get(ref_key, 0)
    out = registry.dispatch("rmsnorm", "cuda", torch.from_numpy(x),
                            torch.from_numpy(w), eps=1e-6, block_rows=4)
    ref = ref_registry.dispatch("rmsnorm", "pallas_tpu", jnp.asarray(x),
                                jnp.asarray(w), eps=1e-6, block_rows=8)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)
    assert registry.default_registry.fallback_counts[port_key] \
        == port_before + 1
    assert ref_registry.default_registry.fallback_counts[ref_key] \
        == ref_before + 1


def test_guard_miss_routes_to_torch_ref():
    """An available kernel entry whose guard refuses a host tensor: the
    registry runs torch_ref and counts the miss under the entry's name."""
    reg = registry.KernelRegistry()
    reg.register("fam", "torch_ref")(
        lambda x, w, **kw: ops._rmsnorm_torch_ref(x, w, **kw))

    def never(*_a, **_k):
        raise AssertionError("the guarded entry must not run")

    reg.register("fam", "cuda", guard=ops._guard, available=lambda: True,
                 supports_grad=False)(never)
    x, w = _inputs((4, 32))
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    assert not ops._guard(xt, wt)
    out = reg.dispatch("fam", "cuda", xt, wt, eps=1e-6)
    torch.testing.assert_close(out, ops.ref.rmsnorm(xt, wt, 1e-6))
    assert reg.fallback_counts == {("fam", "cuda"): 1}


def test_guard_sends_every_cuda_tensor_to_the_kernel():
    """The guard is the card and the reference's precondition: every CUDA
    float tensor of the weight's width reaches the kernel entry, in any
    dtype or layout.  The kernel takes fp32, bf16 and fp16 rows (fp16 as
    the reference's kernel does); one it cannot take (here fp64 rows)
    raises there, and no fallback is counted.  Integer rows miss the
    guard, as they miss the reference's, and run ``torch_ref`` with one
    fallback counted."""
    from test_torch_matmul import _OnCard

    reg = registry.KernelRegistry()
    reg.register("fam", "torch_ref")(
        lambda x, w, **kw: ops._rmsnorm_torch_ref(x._t, w, **kw))
    launched = []

    def entry(x, w, **_kw):
        err = kernel.unsupported(x, w)
        if err is not None:
            raise err
        launched.append(x)

    reg.register("fam", "cuda", guard=ops._guard, available=lambda: True,
                 supports_grad=False)(entry)
    w = torch.ones(32)
    for x in (torch.ones(4, 32), torch.ones(4, 32).bfloat16(),
              torch.ones(32, 4).t(), torch.ones(4, 32).half()):
        assert ops._guard(_OnCard(x), w)
    assert ref_rmsnorm.ops._guard(jnp.ones((4, 32), jnp.float16),
                                  jnp.ones(32))
    for x in (torch.ones(4, 32), torch.ones(4, 32).bfloat16(),
              torch.ones(4, 32).half()):
        reg.dispatch("fam", "cuda", _OnCard(x), w, eps=1e-6)
    assert len(launched) == 3 and reg.fallback_counts == {}
    assert ops._guard(_OnCard(torch.ones(4, 32).double()), w)
    with pytest.raises(TypeError, match="float64"):
        reg.dispatch("fam", "cuda", _OnCard(torch.ones(4, 32).double()), w,
                     eps=1e-6)
    assert len(launched) == 3 and reg.fallback_counts == {}
    xi = torch.from_numpy((10 * _inputs((4, 32))[0]).astype(np.int32))
    assert not ref_rmsnorm.ops._guard(jnp.asarray(xi.numpy()), jnp.ones(32))
    out = reg.dispatch("fam", "cuda", _OnCard(xi), w, eps=1e-6)
    torch.testing.assert_close(out, ops._rmsnorm_torch_ref(xi, w))
    assert len(launched) == 3 and reg.fallback_counts == {("fam", "cuda"): 1}
    assert not ops._guard(torch.ones(4, 32), w)          # a host tensor


def test_kernel_wrapper_refuses_host_tensors():
    x, w = _inputs((4, 32))
    before = kernel.launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernel.rmsnorm_cuda(torch.from_numpy(x), torch.from_numpy(w))
    assert kernel.launches == before


def test_cuda_choices_follow_the_host():
    assert ("cuda" in registry.choices("rmsnorm")) == compat.has_hopper()
    assert registry.choices("rmsnorm")[-1] == "torch_ref"
    assert not registry.get("rmsnorm", "cuda").supports_grad
    assert registry.choices("rmsnorm", require_grad=True) == ("torch_ref",)


#: qwen3's q and k before attention, reduced: (B, heads, S, head dim) with
#: 2:1 query to kv heads, as the model's qk-norm gives them
PAIR_SHAPES = [((2, 4, 8, 32), (2, 2, 8, 32)), ((3, 4, 1, 32), (3, 2, 1, 32))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shapes", PAIR_SHAPES)
@pytest.mark.parametrize("ref_impl", ["xla", "interpret"])
def test_pair_torch_ref_matches_reference(shapes, dtype, ref_impl):
    """The pair op's plain version is the reference's RMSNorm on q and on
    k, each with its own weight."""
    if ref_impl == "interpret" and not ref_compat.has_pallas_tpu():
        pytest.skip("Pallas TPU module not importable: the reference's "
                    "interpret entry would fall back to xla_ref")
    (q, wq), (k, wk) = _inputs(shapes[0], seed=1), _inputs(shapes[1], seed=2)
    outs = rmsnorm_pair(_port(q, dtype), torch.from_numpy(wq),
                        _port(k, dtype), torch.from_numpy(wk), eps=1e-6,
                        impl="torch_ref")
    tol = TOL[dtype]
    for out, x, w in zip(outs, (q, k), (wq, wk)):
        ref = ref_rmsnorm.rmsnorm(jnp.asarray(x).astype(getattr(jnp, dtype)),
                                  jnp.asarray(w), eps=1e-6, impl=ref_impl,
                                  block_rows=8)
        assert out.dtype == getattr(torch, dtype) and out.shape == x.shape
        np.testing.assert_allclose(np.asarray(ref, np.float32),
                                   out.to(torch.float32).numpy(),
                                   rtol=tol, atol=tol)


def test_pair_cuda_on_cpu_tensor_degrades_counted():
    """The pair op asked for the kernel with host tensors runs its plain
    version (two plain calls) and counts one fallback under its own name."""
    (q, wq), (k, wk) = _inputs((4, 2, 16), seed=3), _inputs((4, 1, 16),
                                                            seed=4)
    key = ("rmsnorm_pair", "cuda")
    before = registry.default_registry.fallback_counts.get(key, 0)
    args = [torch.from_numpy(a) for a in (q, wq, k, wk)]
    oq, ok = rmsnorm_pair(*args, impl="cuda")
    assert registry.default_registry.fallback_counts[key] == before + 1
    torch.testing.assert_close(oq, ops.ref.rmsnorm(args[0], args[1]))
    torch.testing.assert_close(ok, ops.ref.rmsnorm(args[2], args[3]))


def test_row_dense_accepts_permutations_of_contiguous_tensors():
    """The kernel takes rows in storage order: a permuted einsum output
    qualifies, a transpose of the last dimension or a strided slice does
    not."""
    x = torch.randn(2, 6, 4, 8)
    assert kernel.row_dense(x)
    assert kernel.row_dense(x.permute(0, 2, 1, 3))
    assert kernel.row_dense(torch.einsum("bsd,dhk->bhsk", torch.randn(1, 5, 6),
                                         torch.randn(6, 3, 8)))
    assert not kernel.row_dense(x.transpose(-1, -2))
    assert not kernel.row_dense(x[:, ::2])
    assert not kernel.row_dense(x[..., :4])


def test_pair_wrapper_refuses_host_tensors():
    x, w = (torch.from_numpy(a) for a in _inputs((4, 32)))
    before = kernel.launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernel.rmsnorm_pair_cuda(x, w, x, w)
    assert kernel.launches == before
