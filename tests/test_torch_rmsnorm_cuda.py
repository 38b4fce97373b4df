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
from repro_torch.kernels.rmsnorm import kernel, rmsnorm  # noqa: E402

#: the shapes the full-width serve path gives the kernel at batch buckets
#: B = 1, 2, 4, 8: norm1/norm2/final (B, 1024), q-norm (16B, 128), k-norm
#: (8B, 128); then the reference's rmsnorm test shapes; then widths that
#: take the kernel's scalar path (d = 1020 is a whole number of fp32
#: vectors but not of bf16 ones; d = 65 of neither)
SHAPES = sorted({s for b in (1, 2, 4, 8)
                 for s in ((b, 1024), (16 * b, 128), (8 * b, 128))}) + [
    (32, 128), (100, 64), (256, 256), (2, 17, 64), (5, 1020), (3, 65)]
TOL = {"float32": 1e-5, "bfloat16": 3e-2}


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
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("block_rows", kernel.BLOCK_ROWS)
@pytest.mark.parametrize("shape", SHAPES)
def test_cuda_kernel_matches_torch_ref(hopper, shape, dtype, block_rows):
    rs = np.random.RandomState(0)
    x = torch.from_numpy(rs.randn(*shape).astype(np.float32)).to(
        getattr(torch, dtype)).to(hopper)
    w = torch.from_numpy(rs.randn(shape[-1]).astype(np.float32)).to(hopper)
    _check(x, w, block_rows)


@pytest.mark.requires_h100
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
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
    """A CUDA tensor that asks for ``cuda`` launches the kernel or raises;
    it never runs the plain version."""
    x = torch.randn(4, 64, device=hopper)
    w = torch.ones(64, device=hopper)
    counts = dict(registry.default_registry.fallback_counts)
    before = kernel.launches
    with pytest.raises(TypeError):
        rmsnorm(x.half(), w, impl="cuda")
    with pytest.raises(ValueError):
        rmsnorm(x, torch.ones(32, device=hopper), impl="cuda")
    with pytest.raises(ValueError):
        rmsnorm(x, w.cpu(), impl="cuda")
    assert registry.default_registry.fallback_counts == counts
    assert kernel.launches == before


@pytest.mark.requires_h100
def test_wrapper_rejects_what_the_kernel_does_not_take(hopper):
    x = torch.randn(4, 64, device=hopper)
    w = torch.ones(64, device=hopper)
    with pytest.raises(TypeError):
        kernel.rmsnorm_cuda(x.half(), w)
    with pytest.raises(ValueError):
        kernel.rmsnorm_cuda(x.t(), torch.ones(4, device=hopper))
    with pytest.raises(ValueError):
        kernel.rmsnorm_cuda(x, w, block_rows=3)
