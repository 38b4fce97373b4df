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
from repro_torch.kernels.rmsnorm import rmsnorm  # noqa: E402

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
    """The guard decides by device alone: a CUDA tensor the kernel cannot
    take (here fp16) reaches the kernel entry, whose error propagates, and
    no fallback is counted."""
    reg = registry.KernelRegistry()
    reg.register("fam", "torch_ref")(
        lambda x, w, **kw: ops._rmsnorm_torch_ref(x, w, **kw))

    def refuse(x, w, **_kw):
        raise TypeError(f"kernel takes float32 or bfloat16, got {x.dtype}")

    reg.register("fam", "cuda", guard=ops._guard, available=lambda: True,
                 supports_grad=False)(refuse)
    on_card = type("OnCard", (), {"device": torch.device("cuda", 0),
                                  "dtype": torch.float16})()
    assert ops._guard(on_card, torch.ones(32))
    with pytest.raises(TypeError, match="float16"):
        reg.dispatch("fam", "cuda", on_card, torch.ones(32), eps=1e-6)
    assert reg.fallback_counts == {}


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
