"""The blocked matmul of the PyTorch port against the JAX reference: the
port's plain version (``torch_ref``) against the reference op through its
plain entry (``xla``) and through its Pallas kernel in interpret mode, at
the cases of ``tests/test_kernels.py:28-55`` (the padded path included);
the ``cuda`` guard, which decides by device, where the reference's also
sends a shape the tiles do not divide to its plain version; and
the handler scenarios of ``tests/test_kernel_registry.py:120-201``
(``matmul_impl`` choices, replay of an unavailable or legacy name, a
typo'd name raising), each run through both runtimes.

Tolerances are the reference's: 1e-5 in fp32, 3e-2 in bf16 (both round
the fp32 product once to bf16).
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import compat as ref_compat  # noqa: E402
from repro.core import IridescentRuntime as RefRuntime  # noqa: E402
from repro.kernels import matmul as ref_matmul  # noqa: E402
from repro.kernels import registry as ref_registry  # noqa: E402
from repro.kernels.matmul import ref as ref_oracle  # noqa: E402
from repro_torch import compat  # noqa: E402
from repro_torch.core import (ChangeDetector, ExhaustiveSweep,  # noqa: E402
                              Explorer, IridescentRuntime, Phase)
from repro_torch.kernels import impl_point, registry  # noqa: E402
from repro_torch.kernels import common  # noqa: E402
from repro_torch.kernels.common import cdiv, pad_to_multiple  # noqa: E402
from repro_torch.kernels.matmul import kernel, matmul, ops, ref  # noqa: E402

TOL = {"float32": 1e-5, "bfloat16": 3e-2}

#: (m, k, n) of tests/test_kernels.py:28-29, tiles (32, 16, 8)
SHAPES = [(32, 32, 32), (64, 96, 48), (128, 64, 128), (96, 72, 80)]
#: tiles of tests/test_kernels.py:41 (assume_divisible, 64 x 64)
SWEEP_TILES = [(16, 16, 16), (32, 64, 32), (64, 32, 8)]


def _rand(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _pair(m, k, n, dtype, seed=0):
    """The same inputs for both packages, cast to ``dtype`` in each."""
    x, y = _rand((m, k), seed), _rand((k, n), seed + 1)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    return ((torch.from_numpy(x).to(tdt), torch.from_numpy(y).to(tdt)),
            (jnp.asarray(x).astype(jdt), jnp.asarray(y).astype(jdt)))


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


def _interpret(xj, yj, **kw):
    """The reference's Pallas kernel in interpret mode; fails if it fell
    back to xla_ref (which would make the comparison vacuous)."""
    if not ref_compat.has_pallas_tpu():
        pytest.skip("the reference's Pallas TPU module is not importable")
    key = ("matmul", "pallas_interpret")
    before = ref_registry.default_registry.fallback_counts.get(key, 0)
    out = ref_matmul.matmul(xj, yj, impl="interpret", **kw)
    assert ref_registry.default_registry.fallback_counts.get(key, 0) \
        == before, "the interpret entry fell back"
    return out


@pytest.mark.parametrize("m,k,n", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_torch_ref_matches_reference(m, k, n, dtype):
    """tests/test_kernels.py::test_matmul_shapes: against the reference's
    oracle and its kernel (tiles (32, 16, 8), padded where ragged)."""
    (xt, yt), (xj, yj) = _pair(m, k, n, dtype)
    out = matmul(xt, yt, bm=32, bn=16, bk=8, impl="torch_ref")
    assert out.shape == (m, n) and out.dtype == xt.dtype
    tol = TOL[dtype]
    np.testing.assert_allclose(_np(out), _np(ref_oracle.matmul(xj, yj)),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(
        _np(out), _np(_interpret(xj, yj, bm=32, bn=16, bk=8)),
        rtol=tol, atol=tol)


@pytest.mark.parametrize("bm,bn,bk", SWEEP_TILES)
def test_block_sweep_matches_reference(bm, bn, bk):
    """tests/test_kernels.py::test_matmul_block_sweep (assume_divisible)."""
    (xt, yt), (xj, yj) = _pair(64, 64, 64, "float32", seed=2)
    out = matmul(xt, yt, bm=bm, bn=bn, bk=bk, impl="torch_ref",
                 assume_divisible=True)
    ref_out = _interpret(xj, yj, bm=bm, bn=bn, bk=bk, assume_divisible=True)
    np.testing.assert_allclose(_np(out), _np(ref_out), rtol=1e-5, atol=1e-5)


def test_padding_path_matches_reference():
    """tests/test_kernels.py::test_matmul_padding_guard: (50, 30) x
    (30, 70) over 16-tiles; the reference pads, the port's kernel masks."""
    (xt, yt), (xj, yj) = _pair(50, 30, 70, "float32", seed=4)
    out = matmul(xt, yt, bm=16, bn=16, bk=16, impl="torch_ref")
    ref_out = _interpret(xj, yj, bm=16, bn=16, bk=16)
    np.testing.assert_allclose(_np(out), _np(ref_out), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_out_dtype_matches_reference(out_dtype):
    (xt, yt), (xj, yj) = _pair(32, 48, 16, "bfloat16", seed=6)
    out = matmul(xt, yt, out_dtype=out_dtype, impl="torch_ref")
    ref_out = ref_oracle.matmul(xj, yj, out_dtype=getattr(
        jnp, str(out_dtype).removeprefix("torch.")))
    assert out.dtype == out_dtype
    np.testing.assert_allclose(_np(out), _np(ref_out), rtol=3e-2, atol=3e-2)


def test_torch_ref_turns_tf32_off_for_its_product():
    """The oracle multiplies in full fp32 even where the caller allowed
    TF32, and restores the caller's setting."""
    torch.set_float32_matmul_precision("high")
    try:
        x, y = torch.ones(4, 8), torch.ones(8, 4)
        ref.matmul(x, y)
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision("highest")


def test_common_tiling_helpers():
    assert cdiv(50, 16) == 4 and cdiv(64, 16) == 4 and cdiv(0, 8) == 0
    x = torch.from_numpy(_rand((50, 30), 8))
    for axis, shape in ((0, (64, 30)), (1, (50, 32)), (-1, (50, 32))):
        padded, n = pad_to_multiple(x, 16, axis)
        assert padded.shape == shape and n == x.shape[axis]
        torch.testing.assert_close(padded[:50, :30], x)
        assert float(padded.abs().sum()) == pytest.approx(
            float(x.abs().sum()))
    same, n = pad_to_multiple(x, 10, 0)
    assert same is x and n == 50
    assert common.canonical_name("xla") == "torch_ref"
    assert common.canonical_name("pallas_tpu") == "cuda"


class _OnCard:
    """Stands in for a CUDA tensor: the host tensor's attributes (shape,
    dtype, strides, ...) with a CUDA device.  The guards read attributes
    only, so they see a call on the card."""

    device = torch.device("cuda", 0)
    is_cuda = True

    def __init__(self, t):
        self._t = t

    def __getattr__(self, name):
        return getattr(self._t, name)

    def get_device(self):
        return 0


def test_guard_sends_cuda_calls_to_the_kernel_unless_divisibility_fails():
    """The guard is the card and the reference's precondition (2-D float
    operands of one inner dim) without its divisibility: every such CUDA
    call reaches the kernel's entry, divisible or not (a non-divisible
    shape under ``assume_divisible`` runs the edge-masked instantiation
    there), and one the kernel cannot take (fp64, a tile triple it lacks)
    raises there.  A host tensor misses the guard, and so do integer
    operands, which the reference's guard refuses too."""
    x, y = torch.zeros(50, 30), torch.zeros(30, 70)
    tiles = dict(bm=16, bn=16, bk=16)
    assert ops._guard(_OnCard(x), _OnCard(y), **tiles)
    assert ops._guard(_OnCard(x), _OnCard(y), assume_divisible=True, **tiles)
    x, y = torch.zeros(64, 32), torch.zeros(32, 48)
    assert ops._guard(_OnCard(x), _OnCard(y), assume_divisible=True, **tiles)
    assert not ops._guard(x, y, **tiles)                 # a host tensor
    # fp16 and mixed operands reach the kernel; calls it lacks (fp64, a
    # tile triple) reach the wrapper, which raises there
    assert ops._guard(_OnCard(x.half()), _OnCard(y.half()), **tiles)
    assert kernel.unsupported(x.half(), y.half(), **tiles) is None
    assert kernel.unsupported(x, y.bfloat16(), out_dtype=torch.float16,
                              **tiles) is None
    assert ops._guard(_OnCard(x.double()), _OnCard(y.double()), **tiles)
    assert isinstance(kernel.unsupported(x.double(), y.double(), **tiles),
                      TypeError)
    assert ops._guard(_OnCard(x), _OnCard(y), bm=256, bn=256, bk=128)
    assert isinstance(kernel.unsupported(x, y, bm=256, bn=256, bk=128),
                      ValueError)
    assert kernel.unsupported(x, y, assume_divisible=True, **tiles) is None
    assert not ops._guard(_OnCard(x.int()), _OnCard(y.int()), **tiles)
    assert not ref_matmul.ops._guard(jnp.zeros((64, 32), jnp.int32),
                                     jnp.zeros((32, 48), jnp.int32))
    assert not ops._guard(_OnCard(x), _OnCard(y.t()), **tiles)


def test_assume_divisible_miss_runs_the_masked_kernel(
        monkeypatch):
    """A non-divisible shape asked to assume divisibility: the reference's
    guard sends it to its plain version and counts one fallback; the
    port's ``cuda`` entry takes it, runs the edge-masked instantiation
    (``assume_divisible`` dropped) and counts none.  Both products agree.
    A divisible shape keeps the unmasked instantiation."""
    calls = []

    def stand_in(x, y, *, bm, bn, bk, out_dtype, assume_divisible):
        calls.append(assume_divisible)
        return ref.matmul(x, y, out_dtype=out_dtype)

    monkeypatch.setattr(ops.kernel, "matmul_cuda", stand_in)
    reg = registry.KernelRegistry()
    reg.register("matmul", "torch_ref")(ops._matmul_torch_ref)
    reg.register("matmul", "cuda", available=lambda: True,
                 supports_grad=False,
                 guard=lambda x, y, **kw: ops._guard(_OnCard(x), _OnCard(y),
                                                      **kw))(ops._matmul_cuda)
    (xt, yt), (xj, yj) = _pair(50, 30, 70, "float32", seed=10)
    tiles = dict(bm=16, bn=16, bk=16)
    out = reg.dispatch("matmul", "cuda", xt, yt, out_dtype=None,
                       assume_divisible=True, **tiles)
    assert calls == [False] and reg.fallback_counts == {}
    (xd, yd), _ = _pair(64, 32, 48, "float32", seed=11)
    reg.dispatch("matmul", "cuda", xd, yd, out_dtype=None,
                 assume_divisible=True, **tiles)
    assert calls == [False, True] and reg.fallback_counts == {}

    if not ref_compat.has_pallas_tpu():
        pytest.skip("the reference's Pallas TPU module is not importable")
    key = ("matmul", "pallas_interpret")
    before = ref_registry.default_registry.fallback_counts.get(key, 0)
    ref_out = ref_matmul.matmul(xj, yj, impl="interpret",
                                assume_divisible=True, **tiles)
    assert ref_registry.default_registry.fallback_counts[key] == before + 1
    np.testing.assert_allclose(_np(out), _np(ref_out), rtol=1e-5, atol=1e-5)


def test_unavailable_cuda_on_host_degrades_like_reference():
    """``impl="cuda"`` without a Hopper card runs torch_ref and counts one
    fallback, as the reference does for ``pallas_tpu`` off a TPU."""
    if compat.has_hopper() or ref_compat.on_tpu():
        pytest.skip("the kernel entries are available here")
    (xt, yt), (xj, yj) = _pair(32, 32, 32, "float32", seed=12)
    port_key, ref_key = ("matmul", "cuda"), ("matmul", "pallas_tpu")
    port_before = registry.default_registry.fallback_counts.get(port_key, 0)
    ref_before = ref_registry.default_registry.fallback_counts.get(ref_key, 0)
    out = matmul(xt, yt, bm=16, bn=16, bk=16, impl="cuda")
    ref_out = ref_matmul.matmul(xj, yj, bm=16, bn=16, bk=16,
                                impl="pallas_tpu")
    np.testing.assert_allclose(_np(out), _np(ref_out), rtol=1e-5, atol=1e-5)
    assert registry.default_registry.fallback_counts[port_key] \
        == port_before + 1
    assert ref_registry.default_registry.fallback_counts[ref_key] \
        == ref_before + 1


def test_kernel_wrapper_refuses_host_tensors_and_missing_tiles():
    x, y = torch.zeros(32, 32), torch.zeros(32, 32)
    before = kernel.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernel.matmul_cuda(x, y)
    assert kernel.launches == before
    assert kernel.DEFAULT_TILES in kernel.TILES
    assert set(kernel.TEST_TILES) >= {(32, 16, 8), *SWEEP_TILES}
    for bm, bn, bk in kernel.TEST_TILES:
        # the simt body: the register tile and the statically staged
        # inputs fit (see kernel.py)
        assert bm * bn <= 128 * 128 and (bm + bn) * bk * 4 <= 48 * 1024
    for bm, bn, bk in kernel.CARD_TILES:
        # the fp32 body: an 8 x 8 register tile a thread, at most 512
        # threads, two stages of (bm, bk + 4) and (bk, bn) fp32 in 227 KB;
        # the wgmma body: 64-row warpgroups, 16-deep steps, at most 128
        # fp32 accumulators a thread
        assert bm % 32 == 0 and bn % 64 == 0 and bm * bn // 64 <= 512
        assert 2 * 4 * (bm * (bk + 4) + bk * bn) <= 227 * 1024
        assert bm % 64 == 0 and bk % 16 == 0 and bk <= 64 and bn <= 256


def test_cuda_choices_follow_the_host():
    assert ("cuda" in registry.choices("matmul")) == compat.has_hopper()
    assert registry.choices("matmul")[-1] == "torch_ref"
    assert not registry.get("matmul", "cuda").supports_grad
    assert registry.choices("matmul", require_grad=True) == ("torch_ref",)


# -- spec-point integration (tests/test_kernel_registry.py:120-201) ---------------

def _port_builder(spec):
    impl = impl_point(spec, "matmul", default="xla")

    def handler(x, y):
        return matmul(x, y, bm=16, bn=16, bk=16, impl=impl)

    return handler


def _ref_builder(spec):
    impl = ref_registry.impl_point(spec, "matmul", default="xla")

    def handler(x, y):
        return ref_matmul.matmul(x, y, bm=16, bn=16, bk=16, impl=impl)

    return handler


def test_impl_point_roundtrip_through_handler_specialize():
    rt = IridescentRuntime(async_compile=False)
    h = rt.register("mm", _port_builder)
    rrt = RefRuntime(async_compile=False)
    rh = rrt.register("mm", _ref_builder)

    space = h.spec_space()
    assert "matmul_impl" in space
    assert set(space["matmul_impl"].choices) == set(registry.choices("matmul"))

    (xt, yt), (xj, yj) = _pair(32, 32, 32, "float32", seed=3)
    ref_out = np.asarray(rh(xj, yj))                   # reference, generic
    out = h(xt, yt).numpy()
    np.testing.assert_allclose(out, ref_out, rtol=1e-5, atol=1e-5)

    for name in registry.choices("matmul"):
        h.specialize({"matmul_impl": name}, wait=True)
        assert h.active_config() == {"matmul_impl": name}
        np.testing.assert_allclose(h(xt, yt).numpy(), ref_out,
                                   rtol=1e-4, atol=1e-4)
    h.despecialize()
    assert h.active_config() == {}
    rt.shutdown()
    rrt.shutdown()


def test_explorer_selects_torch_ref_on_cpu():
    """The sweep over the impl point settles, on a host without the card,
    on torch_ref: the only entry that runs here (the reference's own test
    settles on its plain entry over its slower interpreter)."""
    if compat.has_hopper():
        pytest.skip("the kernel entry is available here")
    rt = IridescentRuntime(async_compile=False)
    h = rt.register("mm_explore", _port_builder)
    xt, yt = _pair(128, 128, 128, "float32", seed=5)[0]
    h(xt, yt)
    ex = Explorer(h, ExhaustiveSweep.from_space(h.spec_space(),
                                                ["matmul_impl"]),
                  dwell=5, change_detector=ChangeDetector(threshold=5.0))
    for _ in range(10 * len(registry.choices("matmul")) + 10):
        h(xt, yt)
        ex.step()
    assert ex.phase is Phase.EXPLOIT
    assert h.active_config()["matmul_impl"] == registry.FALLBACK_IMPL
    rt.shutdown()


def test_tuned_config_replays_on_cpu_like_reference():
    """A config naming an impl unavailable here (the card's, or the
    reference's TPU one) specializes and degrades to torch_ref at dispatch;
    a legacy alias replays; a typo'd name is refused — in both packages."""
    rt = IridescentRuntime(async_compile=False)
    h = rt.register("mm_replay", _port_builder)
    rrt = RefRuntime(async_compile=False)
    rh = rrt.register("mm_replay", _ref_builder)
    (xt, yt), (xj, yj) = _pair(32, 32, 32, "float32", seed=7)
    expect = np.asarray(rh(xj, yj))

    for name in ("cuda", "pallas_tpu", "interpret"):
        h.specialize({"matmul_impl": name}, wait=True)
        np.testing.assert_allclose(h(xt, yt).numpy(), expect, rtol=1e-5,
                                   atol=1e-5)
    for name in ("pallas_tpu", "interpret"):
        rh.specialize({"matmul_impl": name}, wait=True)
        np.testing.assert_allclose(np.asarray(rh(xj, yj)), expect,
                                   rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError):
        h.specialize({"matmul_impl": "not_an_impl"}, wait=True)
    with pytest.raises(ValueError):
        rh.specialize({"matmul_impl": "not_an_impl"}, wait=True)
    rt.shutdown()
    rrt.shutdown()
