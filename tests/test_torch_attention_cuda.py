"""The port's CUDA flash attention against its plain version, on a Hopper
GPU.

Needs no JAX, so it runs on the machine with the card:

    PYTHONPATH=src python -m pytest -q -m requires_h100 tests/test_torch_attention_cuda.py

Elsewhere every case skips.  Tolerances are the reference's, fp32 2e-4
and bf16 and fp16 3e-2, and a second limit scaled to each element
(``SCALED_TOL``, :func:`_scaled`): the kernel and the plain version both
accumulate in fp32 and round once to the output's dtype, so they differ
by at most one ulp of it (bf16 2^-7, fp16 2^-10 of the value) and in fp32
by the summation order.  In bf16 and fp16 the kernel also rounds each
probability to the input dtype before the P.V product, as the reference's
Pallas kernel rounds it to v's dtype (the plain version keeps it in fp32):
that moves an output by at most half an ulp (bf16 2^-8, fp16 2^-11) of
sum_c p_c |v_c| / l, the plain attention over |v|, so both are held to
one ulp of |ref| plus that attention (``tests/test_torch_half.py`` holds
the reference's own kernel to the same limit).  q, k and v of mixed
dtypes (``MIXED``, "q-k-v") run on the ring body in fp32, with P rounded
to v's dtype and the output stored in q's: one ulp of q's dtype of |ref|
plus one ulp of v's dtype of that attention, 3e-2 where any input is half.
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch import compat  # noqa: E402
from repro_torch.kernels import registry  # noqa: E402
from repro_torch.kernels.attention import attention, kernel  # noqa: E402

TOL = {"float32": 2e-4, "bfloat16": 3e-2, "float16": 3e-2}
#: (rtol, atol) of |out - ref| <= atol + rtol |ref| (fp16: + rtol times
#: the plain attention over |v|, see :func:`_scaled`)
SCALED_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2 ** -7, 1e-5),
              "float16": (2 ** -10, 1e-5)}
#: mixed (q, k, v) dtypes, as "q-k-v"
MIXED = ["bfloat16-bfloat16-float16", "float32-bfloat16-bfloat16",
         "float16-bfloat16-float32"]
DTYPES = list(TOL) + MIXED
TILES = [(bq, bkv) for bq in kernel.BLOCK_Q for bkv in kernel.BLOCK_KV]


def _tol(dtype):
    """The reference's tolerance of ``dtype``, the loosest of "q-k-v"."""
    return max(TOL[dt] for dt in dtype.split("-"))

#: (q shape, k shape, v shape, causal, window): the reference's test cases
#: (tests/test_kernels.py:60-108), then the full-width qwen3-0.6b prefill
#: shapes (16 query / 8 kv heads, head dim 128) at two lengths and a
#: ragged one, queries at an offset into their keys, a window without the
#: causal mask, MLA's head dims (q/k 192, v 128) with and without GQA and
#: a window, d < dv, and a head dim that is no whole number of 16-byte
#: vectors (the ring body's 4-byte copies); then the widest heads the
#: kernel takes (256: Gemma's), with d and dv apart and a window
CASES = {
    **{f"gqa{h}/{hk}-{tag}": ((2, h, 64, 32), (2, hk, 64, 32),
                               (2, hk, 64, 32), causal, window)
       for h, hk in [(4, 4), (4, 2), (8, 1)]
       for tag, causal, window in [("causal", True, None),
                                   ("window16", True, 16),
                                   ("full", False, None)]},
    "dv_neq_d": ((2, 2, 32, 24), (2, 2, 32, 24), (2, 2, 32, 16), True,
                 None),
    "q_offset": ((1, 2, 16, 16), (1, 2, 64, 16), (1, 2, 64, 16), True,
                 None),
    "small": ((1, 2, 32, 16),) * 3 + (True, None),
    **{f"prefill{s}": ((1, 16, s, 128), (1, 8, s, 128), (1, 8, s, 128),
                       True, None) for s in (512, 1000, 2048)},
    "prefill-q_offset": ((1, 16, 100, 128), (1, 8, 612, 128),
                         (1, 8, 612, 128), True, None),
    "window-full": ((1, 4, 200, 128), (1, 2, 200, 128), (1, 2, 200, 128),
                    False, 48),
    "mla": ((1, 4, 300, 192), (1, 4, 300, 192), (1, 4, 300, 128), True,
            None),
    "mla-gqa-window": ((1, 8, 257, 192), (1, 2, 257, 192), (1, 2, 257, 128),
                       True, 64),
    "d_lt_dv": ((1, 4, 130, 64), (1, 2, 130, 64), (1, 2, 130, 128), True,
                None),
    "d18": ((2, 2, 70, 18), (2, 2, 70, 18), (2, 2, 70, 10), True, None),
    # hymba-1.5b's prefill heads (25 query / 5 kv, head dim 64) and window,
    # and MLA's head dims with GQA and a long window
    "hymba-window1024": ((1, 25, 2048, 64), (1, 5, 2048, 64),
                         (1, 5, 2048, 64), True, 1024),
    "mla-gqa-window512": ((1, 16, 1500, 192), (1, 4, 1500, 192),
                          (1, 4, 1500, 128), True, 512),
    "wide256": ((1, 4, 300, 256), (1, 2, 300, 256), (1, 2, 300, 256), True,
                None),
    "wide128-256": ((1, 4, 300, 128), (1, 2, 300, 128), (1, 2, 300, 256),
                    True, None),
    "wide256-128-window": ((1, 4, 257, 256), (1, 2, 257, 256),
                           (1, 2, 257, 128), True, 64),
}


@pytest.fixture
def hopper():
    if not compat.has_hopper():
        pytest.skip("needs a CUDA device of capability (9, 0)")
    return torch.device("cuda")


def _inputs(shapes, dtype, device, seed=0, misaligned=False):
    """Inputs from numpy, of ``dtype`` or of the dtypes "q-k-v";
    ``misaligned`` puts each one element into its storage (contiguous, but
    its rows off 16-byte alignment)."""
    rs = np.random.RandomState(seed)
    dtypes = dtype.split("-") if "-" in dtype else [dtype] * len(shapes)
    out = []
    for s, dt in zip(shapes, dtypes):
        x = torch.from_numpy(rs.randn(*s).astype(np.float32)).to(
            getattr(torch, dt)).to(device)
        if misaligned:
            buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=device)
            buf[1:] = x.reshape(-1)
            x = buf[1:].view(s)
        out.append(x)
    return out


def _scaled(out, ref, q, k, v, **kw):
    """Hold ``out`` to ``ref`` within ``SCALED_TOL`` of each element; in
    bf16 and fp16 the limit also takes rtol times the plain attention over
    |v| (rounding P to the input dtype moves an output by at most half of
    that)."""
    rtol, atol = SCALED_TOL[str(ref.dtype).removeprefix("torch.")]
    limit = atol + rtol * ref.float().abs()
    if v.dtype in (torch.bfloat16, torch.float16):
        # P is rounded to v's dtype
        limit += SCALED_TOL[str(v.dtype).removeprefix("torch.")][0] * (
            attention(q.float(), k.float(), v.float().abs(),
                      impl="torch_ref", **kw))
    excess = (out.float() - ref.float()).abs() - limit
    assert excess.max() <= 0, float((out.float() - ref.float()).abs().max())


@pytest.mark.requires_h100
@pytest.mark.parametrize("tiles", TILES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", sorted(CASES))
def test_cuda_kernel_matches_torch_ref(hopper, case, dtype, tiles):
    q_s, k_s, v_s, causal, window = CASES[case]
    q, k, v = _inputs((q_s, k_s, v_s), dtype, hopper)
    before = kernel.launches
    out = attention(q, k, v, causal=causal, window=window, impl="cuda",
                    block_q=tiles[0], block_kv=tiles[1])
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert out.dtype == q.dtype and out.shape == q_s[:3] + v_s[3:]
    ref = attention(q, k, v, causal=causal, window=window, impl="torch_ref")
    tol = _tol(dtype)
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
    _scaled(out, ref, q, k, v, causal=causal, window=window)


@pytest.mark.requires_h100
@pytest.mark.parametrize("tiles", TILES)
def test_cuda_kernel_matches_torch_ref_on_rows_of_a_long_prefill(hopper,
                                                                  tiles):
    """The long prefill call's shape, (1, 16 q / 8 kv heads, 16384, 128)
    fp32: the kernel runs on the whole sequence; 512 rows at its start,
    middle and end are held to the plain version of those rows."""
    s, rows = 16384, 512
    q, k, v = _inputs(((1, 16, s, 128), (1, 8, s, 128), (1, 8, s, 128)),
                      "float32", hopper)
    out = attention(q, k, v, impl="cuda", block_q=tiles[0],
                    block_kv=tiles[1])
    for a in (0, s // 2, s - rows):
        ref = attention(q[:, :, a:a + rows], k, v, q_offset=a,
                        impl="torch_ref")
        got = out[:, :, a:a + rows]
        torch.testing.assert_close(got, ref, rtol=TOL["float32"],
                                   atol=TOL["float32"])
        rtol, atol = SCALED_TOL["float32"]
        torch.testing.assert_close(got, ref, rtol=rtol, atol=atol)


@pytest.mark.requires_h100
@pytest.mark.parametrize("tiles", TILES)
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_half_kernel_matches_torch_ref_on_rows_of_a_long_prefill(
        hopper, dtype, tiles):
    """The long prefill call's shape in half precision, (1, 16 q / 8 kv
    heads, 16384, 128): the wgmma body runs on the whole sequence; 512 rows
    at its start, middle and end are held to the plain version of those
    rows, within the reference's 3e-2 and the scaled limit."""
    s, rows = 16384, 512
    q, k, v = _inputs(((1, 16, s, 128), (1, 8, s, 128), (1, 8, s, 128)),
                      dtype, hopper)
    before = kernel.launches
    out = attention(q, k, v, impl="cuda", block_q=tiles[0],
                    block_kv=tiles[1])
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    for a in (0, s // 2, s - rows):
        ref = attention(q[:, :, a:a + rows], k, v, q_offset=a,
                        impl="torch_ref")
        got = out[:, :, a:a + rows]
        torch.testing.assert_close(got.float(), ref.float(), rtol=TOL[dtype],
                                   atol=TOL[dtype])
        _scaled(got, ref, q[:, :, a:a + rows], k, v, q_offset=a)


@pytest.mark.requires_h100
@pytest.mark.parametrize("tiles", TILES)
@pytest.mark.parametrize("dtype", DTYPES[:3])
@pytest.mark.parametrize("window", [None, 0, -5])
@pytest.mark.parametrize("d,dv", [(32, 32), (128, 128), (192, 128),
                                  (256, 256)])
def test_rows_with_no_valid_column_are_zero(hopper, d, dv, window, dtype,
                                            tiles):
    """With q_offset < 0 the first rows see no column, and with a window
    <= 0 (column c of row r kept where c > r - window) none does under the
    causal mask and the last rows none without it: the kernel writes 0
    there, as the reference's Pallas kernel does (the plain version writes
    the mean of v, as the reference's oracle does); every other row
    agrees."""
    q, k, v = _inputs(((1, 2, 150, d), (1, 2, 100, d), (1, 2, 100, dv)),
                      dtype, hopper)
    tol = TOL[dtype]
    for causal in (True, False):
        kw = dict(causal=causal, window=window, q_offset=-40)
        out = attention(q, k, v, impl="cuda", block_q=tiles[0],
                        block_kv=tiles[1], **kw)
        ref = attention(q, k, v, impl="torch_ref", **kw)
        torch.cuda.synchronize()
        pos = torch.arange(150, device=hopper) - 40
        hi = pos.clamp(max=99) if causal else torch.full_like(pos, 99)
        lo = (pos - window + 1).clamp(min=0) if window is not None \
            else torch.zeros_like(pos)
        rows = hi >= lo
        assert rows.any() == (window is None or not causal)
        assert not out[:, :, ~rows].any()
        torch.testing.assert_close(out[:, :, rows].float(),
                                   ref[:, :, rows].float(), rtol=tol,
                                   atol=tol)


@pytest.mark.requires_h100
@pytest.mark.parametrize("tiles", TILES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("scale", [-0.3, 0.0])
def test_scale_that_is_not_positive(hopper, scale, dtype, tiles):
    """A negative or zero softmax scale (the reference takes any float;
    the ring body folds it into q, the wgmma body into the scores): causal
    with a window, GQA, a ragged length, within the reference's tolerance
    and the scaled limit."""
    shapes = ((1, 4, 200, 128), (1, 2, 200, 128), (1, 2, 200, 128))
    q, k, v = _inputs(shapes, dtype, hopper)
    kw = dict(causal=True, window=48, scale=scale)
    out = attention(q, k, v, impl="cuda", block_q=tiles[0],
                    block_kv=tiles[1], **kw)
    ref = attention(q, k, v, impl="torch_ref", **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), rtol=_tol(dtype),
                               atol=_tol(dtype))
    _scaled(out, ref, q, k, v, **kw)


@pytest.mark.requires_h100
@pytest.mark.parametrize("tiles", TILES)
def test_misaligned_rows_take_the_four_byte_copies(hopper, tiles):
    """Inputs one element into their storage (contiguous, rows off 16-byte
    alignment) take the ring body's 4-byte copies; they agree with the
    plain version at the prefill width and at MLA's."""
    for q_s, k_s, v_s in [((1, 16, 300, 128), (1, 8, 300, 128),
                           (1, 8, 300, 128)),
                          ((1, 4, 200, 192), (1, 2, 200, 192),
                           (1, 2, 200, 128))]:
        q, k, v = _inputs((q_s, k_s, v_s), "float32", hopper,
                          misaligned=True)
        assert q.data_ptr() % 16 != 0
        before = kernel.launches
        out = attention(q, k, v, impl="cuda", block_q=tiles[0],
                        block_kv=tiles[1])
        ref = attention(q, k, v, impl="torch_ref")
        torch.cuda.synchronize()
        assert kernel.launches == before + 1
        torch.testing.assert_close(out, ref, rtol=TOL["float32"],
                                   atol=TOL["float32"])
        rtol, atol = SCALED_TOL["float32"]
        torch.testing.assert_close(out, ref, rtol=rtol, atol=atol)


@pytest.mark.requires_h100
@pytest.mark.parametrize("tiles", TILES)
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_half_rows_tma_cannot_take_go_through_the_copies(hopper, dtype,
                                                         tiles):
    """Half-precision inputs whose rows TMA cannot read (one element into
    their storage: 2-byte aligned; head dims 18 / 10: 36- and 20-byte
    rows) are copied into the same swizzled tiles by the producer warp's
    lanes instead; they agree with the plain version at the prefill width,
    at MLA's and at the narrow heads."""
    for q_s, k_s, v_s, misaligned in [
            ((1, 16, 300, 128), (1, 8, 300, 128), (1, 8, 300, 128), True),
            ((1, 4, 200, 192), (1, 2, 200, 192), (1, 2, 200, 128), True),
            ((2, 2, 70, 18), (2, 2, 70, 18), (2, 2, 70, 10), False)]:
        q, k, v = _inputs((q_s, k_s, v_s), dtype, hopper,
                          misaligned=misaligned)
        before = kernel.launches
        out = attention(q, k, v, impl="cuda", block_q=tiles[0],
                        block_kv=tiles[1])
        ref = attention(q, k, v, impl="torch_ref")
        torch.cuda.synchronize()
        assert kernel.launches == before + 1
        torch.testing.assert_close(out.float(), ref.float(), rtol=TOL[dtype],
                                   atol=TOL[dtype])
        _scaled(out, ref, q, k, v)


@pytest.mark.requires_h100
@pytest.mark.parametrize("tiles", TILES)
@pytest.mark.parametrize("d,dv", [(64, 64), (128, 128), (192, 128),
                                  (24, 16), (160, 96), (256, 256),
                                  (128, 256), (256, 128), (200, 136)])
def test_every_tile_pair_fits_shared_memory(hopper, d, dv, tiles):
    """Every instantiated tile pair takes every head dim up to (256, 256)
    within the 227 KB a block may use: fp32 on the ring body with at least
    two chunk stages, bf16 and fp16 on the wgmma body with at least two
    K/V stages."""
    ring = kernel.body(torch.float32, d, dv, block_q=tiles[0],
                       block_kv=tiles[1])
    assert ring["body"] == "ring" and ring["stages"] >= 2
    assert 0 < ring["smem_bytes"] <= 232448
    for dtype in (torch.bfloat16, torch.float16):
        wgmma = kernel.body(dtype, d, dv, block_q=tiles[0],
                            block_kv=tiles[1])
        assert wgmma["body"] == "wgmma" and wgmma["stages"] >= 2
        assert 0 < wgmma["smem_bytes"] <= 232448


@pytest.mark.requires_h100
def test_cuda_entry_raises_on_what_the_kernel_does_not_take(hopper):
    """A CUDA tensor that asks for ``cuda`` launches the kernel or raises;
    it never runs the plain version: fp16 and q, k and v of mixed dtypes
    launch it (one launch, within the tolerances of the plain version),
    head dims past the kernel's raise."""
    q, k, v = _inputs(((1, 2, 32, 16),) * 3, "float32", hopper)
    counts = dict(registry.default_registry.fallback_counts)
    before = kernel.launches
    half = (q.half(), k.half(), v.half())
    out = attention(*half, impl="cuda")
    torch.cuda.synchronize()
    assert kernel.launches == before + 1 and out.dtype == torch.float16
    ref = attention(*half, impl="torch_ref")
    torch.testing.assert_close(out.float(), ref.float(),
                               rtol=TOL["float16"], atol=TOL["float16"])
    _scaled(out, ref, *half)
    before = kernel.launches
    mixed = (q.half(), k, v.half())
    out = attention(*mixed, impl="cuda")
    torch.cuda.synchronize()
    assert kernel.launches == before + 1 and out.dtype == torch.float16
    ref = attention(*mixed, impl="torch_ref")
    torch.testing.assert_close(out.float(), ref.float(),
                               rtol=TOL["float16"], atol=TOL["float16"])
    _scaled(out, ref, *mixed)
    before = kernel.launches
    with pytest.raises(TypeError):
        attention(q.double(), k, v, impl="cuda")
    with pytest.raises(ValueError):
        attention(q, k.cpu(), v, impl="cuda")
    with pytest.raises(ValueError):
        attention(q, k, v, impl="cuda", block_q=256)
    # dv = 272 is beyond the kernel's 256; d = 264 beyond 256
    wide = _inputs(((1, 2, 32, 160), (1, 2, 32, 160), (1, 2, 32, 272)),
                   "float32", hopper)
    with pytest.raises(ValueError, match="head dims"):
        attention(*wide, impl="cuda")
    deep = _inputs(((1, 2, 32, 264), (1, 2, 32, 264), (1, 2, 32, 128)),
                   "float32", hopper)
    with pytest.raises(ValueError, match="head dims"):
        attention(*deep, impl="cuda")
    assert registry.default_registry.fallback_counts == counts
    assert kernel.launches == before
    legal = _inputs(((1, 2, 32, 256), (1, 2, 32, 256), (1, 2, 32, 160)),
                    "float32", hopper)
    attention(*legal, impl="cuda")
    assert kernel.launches == before + 1


@pytest.mark.requires_h100
def test_wrapper_rejects_what_the_kernel_does_not_take(hopper):
    q, k, v = _inputs(((2, 32, 16),) * 3, "float32", hopper)
    with pytest.raises(ValueError, match="contiguous"):
        kernel.flash_attention_cuda(q.transpose(1, 2), k, v)
    with pytest.raises(ValueError, match="group"):
        kernel.flash_attention_cuda(q, k[:0].reshape(0, 32, 16), v[:0])
    with pytest.raises(ValueError, match="block"):
        kernel.flash_attention_cuda(q, k, v, block_kv=128)
    with pytest.raises(TypeError):
        kernel.flash_attention_cuda(q, k.double(), v)
