"""The port's CUDA RMSNorm against its plain version, on a Hopper GPU.

Needs no JAX, so it runs on the machine with the card:

    PYTHONPATH=src python -m pytest -q -m requires_h100 tests/test_torch_rmsnorm_cuda.py

Elsewhere every case skips.
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch import compat  # noqa: E402
from repro_torch.kernels import registry  # noqa: E402
from repro_torch.kernels.rmsnorm import (kernel, rmsnorm,  # noqa: E402
                                         rmsnorm_pair)

#: the shapes the full-width serve path gives the kernel at batch buckets
#: B = 1, 2, 4, 8: norm1/norm2/final (B, 1024), q-norm (16B, 128), k-norm
#: (8B, 128); then those of a (1, 4096) prefill through the full-sequence
#: forward; then the reference's rmsnorm test shapes; then widths that
#: take the kernel's scalar path (d = 1020 is a whole number of fp32
#: vectors but not of bf16 or fp16 ones; d = 65 of neither)
SHAPES = sorted({s for b in (1, 2, 4, 8)
                 for s in ((b, 1024), (16 * b, 128), (8 * b, 128))}) + [
    (4096, 1024), (65536, 128), (32768, 128),
    (32, 128), (100, 64), (256, 256), (2, 17, 64), (5, 1020), (3, 65)]
TOL = {"float32": 1e-5, "bfloat16": 3e-2, "float16": 3e-2}
DTYPES = list(TOL)


@pytest.fixture
def hopper():
    if not compat.has_hopper():
        pytest.skip("needs a CUDA device of capability (9, 0)")
    return torch.device("cuda")


def _check(x, w, block_rows=kernel.DEFAULT_BLOCK_ROWS):
    before = kernel.launches
    out = rmsnorm(x, w, impl="cuda", block_rows=block_rows)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert out.dtype == x.dtype and out.shape == x.shape
    ref = rmsnorm(x, w, impl="torch_ref")
    tol = TOL[str(x.dtype).removeprefix("torch.")]
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)


@pytest.mark.requires_h100
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("block_rows", kernel.BLOCK_ROWS)
@pytest.mark.parametrize("shape", SHAPES)
def test_cuda_kernel_matches_torch_ref(hopper, shape, dtype, block_rows):
    rs = np.random.RandomState(0)
    x = torch.from_numpy(rs.randn(*shape).astype(np.float32)).to(
        getattr(torch, dtype)).to(hopper)
    w = torch.from_numpy(rs.randn(shape[-1]).astype(np.float32)).to(hopper)
    _check(x, w, block_rows)


@pytest.mark.requires_h100
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_kernel_on_a_misaligned_view(hopper, dtype):
    """A contiguous view one element into its storage: its pointer is not
    16-byte aligned, so the kernel takes its scalar path."""
    rs = np.random.RandomState(1)
    rows, d = 8, 1024
    flat = torch.from_numpy(rs.randn(rows * d + 1).astype(np.float32)).to(
        getattr(torch, dtype)).to(hopper)
    x = flat[1:].view(rows, d)
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    w = torch.from_numpy(rs.randn(d).astype(np.float32)).to(hopper)
    _check(x, w)


@pytest.mark.requires_h100
def test_cuda_entry_raises_on_what_the_kernel_does_not_take(hopper):
    """A CUDA tensor that meets the reference's precondition launches the
    kernel or raises; it never runs the plain version: fp16 rows launch it
    (one launch, within TOL of the plain version), fp64 rows raise.
    Integer rows miss the guard, as they miss the reference's, and run the
    plain version with one fallback counted."""
    x = torch.randn(4, 64, device=hopper)
    w = torch.ones(64, device=hopper)
    counts = dict(registry.default_registry.fallback_counts)
    _check(x.half(), w)
    before = kernel.launches
    with pytest.raises(TypeError):
        rmsnorm(x.double(), w, impl="cuda")
    with pytest.raises(ValueError):
        rmsnorm(x, w.cpu(), impl="cuda")
    assert registry.default_registry.fallback_counts == counts
    assert kernel.launches == before
    xi = (10 * x).int()
    out = rmsnorm(xi, w, impl="cuda")
    torch.testing.assert_close(out, rmsnorm(xi, w, impl="torch_ref"))
    key = ("rmsnorm", "cuda")
    assert registry.default_registry.fallback_counts[key] == \
        counts.get(key, 0) + 1
    assert kernel.launches == before


@pytest.mark.requires_h100
def test_wrapper_rejects_what_the_kernel_does_not_take(hopper):
    x = torch.randn(4, 64, device=hopper)
    w = torch.ones(64, device=hopper)
    with pytest.raises(TypeError, match="float64"):
        kernel.rmsnorm_cuda(x.double(), w)
    with pytest.raises(ValueError):
        kernel.rmsnorm_cuda(x.t(), torch.ones(4, device=hopper))
    with pytest.raises(ValueError):
        kernel.rmsnorm_cuda(x, w, block_rows=3)


def _rand(shape, dtype, device, seed):
    rs = np.random.RandomState(seed)
    return torch.from_numpy(rs.randn(*shape).astype(np.float32)).to(
        getattr(torch, dtype)).to(device)


@pytest.mark.requires_h100
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", [64, 128, 1024, 2048])
@pytest.mark.parametrize("rows", [1, 7, 333])
def test_register_body_at_the_port_widths(hopper, rows, d, dtype):
    """The widths the port runs take the body that reads each row once,
    row counts that leave a block's last groups idle included."""
    x = _rand((rows, d), dtype, hopper, seed=rows + d)
    w = _rand((d,), "float32", hopper, seed=1)
    assert kernel.uses_registers(x, w)
    _check(x, w)


@pytest.mark.requires_h100
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", [1020, 65, 256])
def test_general_body_at_other_widths(hopper, d, dtype):
    x = _rand((9, d), dtype, hopper, seed=d)
    w = _rand((d,), "float32", hopper, seed=2)
    assert not kernel.uses_registers(x, w)
    _check(x, w)


@pytest.mark.requires_h100
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("layout", ["decode", "prefill", "general"])
def test_pair_is_one_launch_of_two_norms(hopper, layout, dtype):
    """q-norm and k-norm in one launch against two plain calls: the decode
    step's contiguous (B, H, 1, dh), the prefill's permuted einsum output
    (taken in storage order, no copy: the outputs keep its strides), and a
    width that takes the general body."""
    if layout == "decode":
        q = _rand((8, 16, 1, 128), dtype, hopper, seed=3)
        k = _rand((8, 8, 1, 128), dtype, hopper, seed=4)
    elif layout == "prefill":
        q = _rand((1, 300, 16, 128), dtype, hopper, seed=3).permute(0, 2, 1, 3)
        k = _rand((1, 300, 8, 128), dtype, hopper, seed=4).permute(0, 2, 1, 3)
        assert not q.is_contiguous() and kernel.row_dense(q)
    else:
        q = _rand((5, 3, 65), dtype, hopper, seed=3)
        k = _rand((2, 65), dtype, hopper, seed=4)
    d = q.shape[-1]
    wq = _rand((d,), "float32", hopper, seed=5)
    wk = _rand((d,), "float32", hopper, seed=6)
    before = kernel.launches
    oq, ok = rmsnorm_pair(q, wq, k, wk, impl="cuda")
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    tol = TOL[dtype]
    for out, x, w in ((oq, q, wq), (ok, k, wk)):
        assert out.shape == x.shape and out.dtype == x.dtype
        assert out.stride() == x.stride()
        ref = rmsnorm(x, w, impl="torch_ref")
        torch.testing.assert_close(out.float(), ref.float(), rtol=tol,
                                   atol=tol)


@pytest.mark.requires_h100
def test_pair_refuses_two_widths_or_dtypes(hopper):
    q = torch.randn(4, 128, device=hopper)
    w = torch.ones(128, device=hopper)
    with pytest.raises(ValueError, match="one dtype and width"):
        kernel.rmsnorm_pair_cuda(q, w, torch.randn(4, 64, device=hopper),
                                 torch.ones(64, device=hopper))
    with pytest.raises(ValueError, match="one dtype and width"):
        kernel.rmsnorm_pair_cuda(q, w, q.bfloat16(), w)
