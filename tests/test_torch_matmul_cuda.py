"""The port's CUDA blocked matmul against its plain version, on a Hopper
GPU.

Needs no JAX, so it runs on the machine with the card:

    PYTHONPATH=src python -m pytest -q -m requires_h100 tests/test_torch_matmul_cuda.py

Elsewhere every case skips.  Tolerances: at the reference's test shapes
(``tests/test_kernels.py:28-55``) the reference's, 1e-5 in fp32 and 3e-2
in bf16 and fp16.  At the card's shapes (K up to 4096) a limit scaled to
each element, as ``chip_smoke.py`` holds them: the kernel and cuBLAS each
sum K fp32 products in their own order, so they may differ by about
sqrt(K) * 2^-24 * sum_k |x||y| (allowed 8x that), plus, for a half output,
one ulp of it (2^-7 of the value in bf16, 2^-10 in fp16) where the two
fp32 sums round to neighbouring half numbers.
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch import compat  # noqa: E402
from repro_torch.kernels import registry  # noqa: E402
from repro_torch.kernels.matmul import kernel, matmul  # noqa: E402

TOL = {torch.float32: 1e-5, torch.bfloat16: 3e-2, torch.float16: 3e-2}
#: one ulp of a half output, relative
ULP = {torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -10}
HALF = [torch.bfloat16, torch.float16]

#: (m, k, n) of tests/test_kernels.py:28-55, ragged ones included
TEST_SHAPES = [(32, 32, 32), (64, 96, 48), (128, 64, 128), (96, 72, 80),
               (64, 64, 64), (50, 30, 70)]
#: Table 1's square sizes, a ragged product, and qwen3-0.6b's widest layer
#: product (the MLP's up projection at a (1, 4096) prefill)
CARD_SHAPES = [(256, 256, 256), (1024, 1024, 1024), (4095, 1000, 3001),
               (4096, 1024, 3072)]


@pytest.fixture
def hopper():
    if not compat.has_hopper():
        pytest.skip("needs a CUDA device of capability (9, 0)")
    compat.resolve_device("cuda")            # TF32 off for the plain version
    return torch.device("cuda")


def _inputs(m, k, n, dtype, device, seed=0):
    rs = np.random.RandomState(seed)
    x = torch.from_numpy(rs.randn(m, k).astype(np.float32))
    y = torch.from_numpy(rs.randn(k, n).astype(np.float32))
    return x.to(device=device, dtype=dtype), y.to(device=device, dtype=dtype)


def _scaled_check(out, ref, x, y):
    k = x.shape[1]
    mag = x.float().abs() @ y.float().abs()
    limit = 8 * k ** 0.5 * 2.0 ** -24 * mag + 1e-6
    if out.dtype in ULP:
        limit = limit + ULP[out.dtype] * ref.float().abs()
    diff = (out.float() - ref.float()).abs()
    assert bool((diff <= limit).all()), (
        f"max excess {(diff - limit).max().item():.3e}")


@pytest.mark.requires_h100
@pytest.mark.parametrize("tiles", kernel.TILES)
@pytest.mark.parametrize("dtype", [torch.float32, *HALF])
@pytest.mark.parametrize("shape", TEST_SHAPES)
def test_cuda_kernel_matches_torch_ref_at_test_shapes(hopper, shape, dtype,
                                                      tiles):
    m, k, n = shape
    x, y = _inputs(m, k, n, dtype, hopper)
    bm, bn, bk = tiles
    ref = matmul(x, y, impl="torch_ref")
    divisible = m % bm == 0 and n % bn == 0 and k % bk == 0
    for assume in (False, True) if divisible else (False,):
        before = kernel.launches
        out = matmul(x, y, bm=bm, bn=bn, bk=bk, impl="cuda",
                     assume_divisible=assume)
        torch.cuda.synchronize()
        assert kernel.launches == before + 1
        assert out.shape == ref.shape and out.dtype == ref.dtype
        tol = TOL[dtype]
        torch.testing.assert_close(out.float(), ref.float(), rtol=tol,
                                   atol=tol)
        _scaled_check(out, ref, x, y)


@pytest.mark.requires_h100
@pytest.mark.parametrize("tiles", kernel.CARD_TILES)
@pytest.mark.parametrize("dtype", [torch.float32, *HALF])
@pytest.mark.parametrize("shape", CARD_SHAPES)
def test_cuda_kernel_matches_torch_ref_at_card_shapes(hopper, shape, dtype,
                                                      tiles):
    m, k, n = shape
    x, y = _inputs(m, k, n, dtype, hopper, seed=1)
    bm, bn, bk = tiles
    out = matmul(x, y, bm=bm, bn=bn, bk=bk, impl="cuda")
    ref = matmul(x, y, impl="torch_ref")
    torch.cuda.synchronize()
    _scaled_check(out, ref, x, y)


@pytest.mark.requires_h100
def test_bf16_product_may_write_fp32(hopper):
    x, y = _inputs(96, 72, 80, torch.bfloat16, hopper)
    out = matmul(x, y, bm=32, bn=16, bk=8, out_dtype=torch.float32,
                 impl="cuda")
    ref = matmul(x, y, out_dtype=torch.float32, impl="torch_ref")
    assert out.dtype == torch.float32
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.requires_h100
def test_assume_divisible_miss_falls_back_counted(hopper):
    """A shape that is not a multiple of the tiles, asked to assume it is:
    where the reference runs its plain version and counts a fallback, the
    port launches the kernel's edge-masked instantiation and counts no
    fallback."""
    x, y = _inputs(50, 30, 70, torch.float32, hopper)
    counts = registry.default_registry.fallback_counts
    before = dict(counts)
    launches = kernel.launches
    out = matmul(x, y, bm=16, bn=16, bk=16, impl="cuda",
                 assume_divisible=True)
    assert dict(counts) == before
    assert kernel.launches == launches + 1
    torch.testing.assert_close(out, matmul(x, y, impl="torch_ref"),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.requires_h100
def test_cuda_calls_the_kernel_lacks_raise(hopper):
    """A CUDA call with a tile triple the library lacks, or asserting a
    divisibility the shape lacks, raises in the wrapper; the registry
    counts no fallback.  fp16 operands and an fp32 product into bf16,
    which the wrapper refused before, launch the kernel once."""
    x, y = _inputs(64, 64, 64, torch.float32, hopper)
    counts = registry.default_registry.fallback_counts
    before = dict(counts)
    with pytest.raises(ValueError, match="not instantiated"):
        matmul(x, y, bm=256, bn=256, bk=128, impl="cuda")
    with pytest.raises(ValueError, match="assume_divisible"):
        kernel.matmul_cuda(x[:50].contiguous(), y, bm=16, bn=16, bk=16,
                           assume_divisible=True)
    for a, b, kw in ((x.half(), y.half(), dict(bm=16, bn=16, bk=16)),
                     (x, y, dict(out_dtype=torch.bfloat16))):
        launches = kernel.launches
        out = matmul(a, b, impl="cuda", **kw)
        torch.cuda.synchronize()
        assert kernel.launches == launches + 1
        ref = matmul(a, b, impl="torch_ref", **kw)
        assert out.dtype == ref.dtype
        torch.testing.assert_close(out.float(), ref.float(), rtol=3e-2,
                                   atol=3e-2)
    assert dict(counts) == before


@pytest.mark.requires_h100
def test_wrapper_refuses_non_contiguous(hopper):
    x, y = _inputs(64, 64, 64, torch.float32, hopper)
    with pytest.raises(ValueError, match="contiguous"):
        kernel.matmul_cuda(x.t(), y)


#: every output of a half product
OUTS = [torch.bfloat16, torch.float16, torch.float32]


@pytest.mark.requires_h100
@pytest.mark.parametrize("out_dtype", OUTS)
@pytest.mark.parametrize("in_dtype", HALF)
@pytest.mark.parametrize("tiles", kernel.CARD_TILES)
@pytest.mark.parametrize("shape", TEST_SHAPES)
def test_wgmma_body_at_test_shapes(hopper, shape, tiles, in_dtype,
                                   out_dtype):
    """bf16 and fp16 at every card tile run the wgmma body where TMA takes
    the operands (k and n multiples of 8), the simt body otherwise; both
    within the reference's half tolerance, into each output."""
    m, k, n = shape
    x, y = _inputs(m, k, n, in_dtype, hopper, seed=2)
    bm, bn, bk = tiles
    want = "wgmma" if k % 8 == 0 and n % 8 == 0 else "simt"
    assert kernel.body(x, y, bm=bm, bn=bn, bk=bk,
                       out_dtype=out_dtype) == want
    ref = matmul(x, y, out_dtype=out_dtype, impl="torch_ref")
    divisible = m % bm == 0 and n % bn == 0 and k % bk == 0
    for assume in (False, True) if divisible else (False,):
        before = kernel.launches
        out = matmul(x, y, bm=bm, bn=bn, bk=bk, out_dtype=out_dtype,
                     impl="cuda", assume_divisible=assume)
        torch.cuda.synchronize()
        assert kernel.launches == before + 1
        assert out.dtype == out_dtype and out.shape == (m, n)
        torch.testing.assert_close(out.float(), ref.float(), rtol=3e-2,
                                   atol=3e-2)
        _scaled_check(out, ref, x, y)


@pytest.mark.requires_h100
@pytest.mark.parametrize("out_dtype", OUTS)
@pytest.mark.parametrize("in_dtype", HALF)
@pytest.mark.parametrize("tiles", kernel.CARD_TILES)
@pytest.mark.parametrize("shape", [(1024, 1024, 1024), (4096, 1024, 3072),
                                   (1000, 520, 776)])
def test_wgmma_body_at_card_shapes(hopper, shape, tiles, in_dtype,
                                   out_dtype):
    """The wgmma body at the card's shapes, ragged edges (1000, 520, 776:
    no tile divides m, k or n, each a multiple of 8) included."""
    m, k, n = shape
    x, y = _inputs(m, k, n, in_dtype, hopper, seed=3)
    bm, bn, bk = tiles
    assert kernel.body(x, y, bm=bm, bn=bn, bk=bk,
                       out_dtype=out_dtype) == "wgmma"
    divisible = m % bm == 0 and n % bn == 0 and k % bk == 0
    out = matmul(x, y, bm=bm, bn=bn, bk=bk, out_dtype=out_dtype,
                 impl="cuda", assume_divisible=divisible)
    ref = matmul(x, y, out_dtype=out_dtype, impl="torch_ref")
    torch.cuda.synchronize()
    assert out.dtype == out_dtype
    _scaled_check(out, ref, x, y)


@pytest.mark.requires_h100
@pytest.mark.parametrize("out_dtype", [None, *OUTS])
@pytest.mark.parametrize("dtypes", [(torch.float32, torch.bfloat16),
                                    (torch.bfloat16, torch.float16),
                                    (torch.float16, torch.float32)])
@pytest.mark.parametrize("tiles", [(16, 16, 16), (128, 64, 16),
                                   (128, 256, 64)])
@pytest.mark.parametrize("shape", [(96, 72, 80), (1000, 520, 776)])
def test_operands_of_two_dtypes_launch_once(hopper, shape, tiles, dtypes,
                                            out_dtype):
    """x and y of two dtypes: widened to fp32 in the wrapper, one launch of
    the fp32 bodies, the output in ``out_dtype`` (x's by default), within
    the scaled limit of the plain version (whose fp32 products are the
    same)."""
    m, k, n = shape
    x, _ = _inputs(m, k, n, dtypes[0], hopper, seed=7)
    _, y = _inputs(m, k, n, dtypes[1], hopper, seed=8)
    bm, bn, bk = tiles
    want = "simt" if tiles in kernel.TEST_TILES else "fp32_cp_async16"
    assert kernel.body(x, y, bm=bm, bn=bn, bk=bk,
                       out_dtype=out_dtype) == want
    before = kernel.launches
    out = matmul(x, y, bm=bm, bn=bn, bk=bk, out_dtype=out_dtype,
                 impl="cuda")
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert out.dtype == (out_dtype or dtypes[0])
    _scaled_check(out, matmul(x, y, out_dtype=out_dtype, impl="torch_ref"),
                  x, y)


@pytest.mark.requires_h100
@pytest.mark.parametrize("out_dtype", HALF)
@pytest.mark.parametrize("tiles", kernel.CARD_TILES)
def test_fp32_body_writes_half(hopper, tiles, out_dtype):
    """An fp32 product into bf16 or fp16 on the cp.async body, masked (a
    ragged shape) and unmasked."""
    bm, bn, bk = tiles
    for (m, k, n), assume in (((2 * bm, 4 * bk, 3 * bn), True),
                              ((2 * bm - 3, 4 * bk + 4, 3 * bn - 4), False)):
        x, y = _inputs(m, k, n, torch.float32, hopper, seed=9)
        assert kernel.body(x, y, bm=bm, bn=bn, bk=bk,
                           out_dtype=out_dtype) == "fp32_cp_async16"
        out = matmul(x, y, bm=bm, bn=bn, bk=bk, out_dtype=out_dtype,
                     impl="cuda", assume_divisible=assume)
        torch.cuda.synchronize()
        assert out.dtype == out_dtype
        _scaled_check(out, matmul(x, y, out_dtype=out_dtype,
                                  impl="torch_ref"), x, y)


@pytest.mark.requires_h100
@pytest.mark.parametrize("assume", [False, True])
@pytest.mark.parametrize("tiles", kernel.CARD_TILES)
def test_fp32_pipelined_body_at_every_card_tile(hopper, tiles, assume):
    """fp32 at every card tile runs the cp.async body, masked and (on a
    shape the tiles divide) unmasked.  K reaches 4 bk (256), beyond the
    reference's test shapes, so the limit is the scaled one."""
    bm, bn, bk = tiles
    m, k, n = (2 * bm, 4 * bk, 3 * bn) if assume else (2 * bm - 3,
                                                       4 * bk + 4,
                                                       3 * bn - 4)
    x, y = _inputs(m, k, n, torch.float32, hopper, seed=4)
    assert kernel.body(x, y, bm=bm, bn=bn, bk=bk) == "fp32_cp_async16"
    before = kernel.launches
    out = matmul(x, y, bm=bm, bn=bn, bk=bk, impl="cuda",
                 assume_divisible=assume)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    _scaled_check(out, matmul(x, y, impl="torch_ref"), x, y)


@pytest.mark.requires_h100
@pytest.mark.parametrize("dtype", [torch.float32, *HALF])
@pytest.mark.parametrize("tiles", kernel.CARD_TILES)
@pytest.mark.parametrize("k", [8, 16, 48, 72])
def test_short_contractions_drain_the_ring(hopper, k, tiles, dtype):
    """k below stages x bk (one k-tile, or a partial one) and k not a
    multiple of bk: the ring drains and the tail is zero-filled."""
    bm, bn, bk = tiles
    x, y = _inputs(96, k, 136, dtype, hopper, seed=k)
    before = kernel.launches
    out = matmul(x, y, bm=bm, bn=bn, bk=bk, impl="cuda")
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    ref = matmul(x, y, impl="torch_ref")
    tol = TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
    _scaled_check(out, ref, x, y)


@pytest.mark.requires_h100
@pytest.mark.parametrize("dtype", [torch.float32, *HALF])
@pytest.mark.parametrize("tiles", kernel.CARD_TILES)
def test_misaligned_and_ragged_operands_launch_the_kernel(hopper, tiles,
                                                          dtype):
    """A contiguous view one element into its storage, and n = 3001 (rows
    of y and out not 16-byte aligned): each launches the kernel once (the
    fp32 body with 4-byte copies, or the simt body for bf16 and fp16),
    counts no fallback and matches the plain version."""
    bm, bn, bk = tiles
    rs = np.random.RandomState(5)
    flat = torch.from_numpy(rs.randn(300 * 200 + 1).astype(np.float32)).to(
        device=hopper, dtype=dtype)
    xv = flat[1:].view(300, 200)
    assert xv.is_contiguous() and xv.data_ptr() % 16 != 0
    yv = torch.from_numpy(rs.randn(200, 264).astype(np.float32)).to(
        device=hopper, dtype=dtype)
    xr, yr = _inputs(257, 200, 3001, dtype, hopper, seed=6)
    want = "fp32_cp_async4" if dtype == torch.float32 else "simt"
    counts = registry.default_registry.fallback_counts
    for x, y in ((xv, yv), (xr, yr)):
        assert kernel.body(x, y, bm=bm, bn=bn, bk=bk) == want
        before, fallbacks = kernel.launches, dict(counts)
        out = matmul(x, y, bm=bm, bn=bn, bk=bk, impl="cuda")
        torch.cuda.synchronize()
        assert kernel.launches == before + 1
        assert dict(counts) == fallbacks
        ref = matmul(x, y, impl="torch_ref")
        _scaled_check(out, ref, x, y)
