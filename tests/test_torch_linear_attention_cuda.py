"""The port's CUDA chunked linear attention against its plain version, on a
Hopper GPU.

Needs no JAX, so it runs on the machine with the card:

    PYTHONPATH=src python -m pytest -q -m requires_h100 tests/test_torch_linear_attention_cuda.py

Elsewhere every case skips.  Tolerance is the reference's, 5e-4 for fp32
(tests/test_linear_attention_kernel.py: the kernel and the plain version
sum the chunk products and fold the chunk states in different orders), 3e-2
for bf16, and a second limit scaled to each element (``SCALED_TOL``, as
``chip_smoke.py``'s): in fp32, ``la = cumsum(log w)`` reaches 64 in
magnitude at chunk 64, so its rounding (64 x 2^-24, ~4e-6) enters every
e^{+-la} factor as a relative error of that size; an output sums ~128
such terms of magnitude up to ~8, so one that nearly cancels still
carries ~2e-4 of absolute error; in bf16 and fp16 (3e-2 also for fp16)
both round the same fp32 value once, so they differ by at most one ulp
(2^-7 of the value in bf16, 2^-10 in fp16) beyond that.  q, k and v of
mixed dtypes (``MIXED``) run in fp32 on the same values in both and round
once to v's dtype: the fp32 limits plus one ulp of v's dtype, 3e-2 where
any input is half.
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch import compat  # noqa: E402
from repro_torch.kernels import registry  # noqa: E402
from repro_torch.kernels.linear_attention import (  # noqa: E402
    kernel, linear_attention)

TOL = {"float32": 5e-4, "bfloat16": 3e-2, "float16": 3e-2}
#: (rtol, atol) of |out - ref| <= atol + rtol |ref|
SCALED_TOL = {"float32": (5e-5, 2e-4), "bfloat16": (2 ** -7, 2e-4),
              "float16": (2 ** -10 + 5e-5, 2e-4)}
#: mixed (q, k, v) dtypes, as "q-k-v"
MIXED = ["float16-float32-bfloat16", "bfloat16-bfloat16-float32"]
DTYPES = list(TOL) + MIXED

#: (bh, T, dk, dv, inclusive, bonus, scalar decay): the reference's test
#: cases (tests/test_linear_attention_kernel.py:28-55), a ragged length,
#: a hymba-like inclusive scalar-decay head (dk 16, dv 64) and rwkv6-1.6b
#: heads (dk = dv = 64) at a prefill length; then wide heads (128), head
#: dims that are no whole number of 16-byte vectors (4-byte copies), an
#: inclusive ragged length and one shorter than every chunk; last the
#: widest the kernel takes, GLA-1.3B's (dk 256, dv 512), and dims between
#: its key chunks and value slices
CASES = {
    **{f"t{t}-dv{dv}-{'incl' if inc else 'excl'}": (2, t, 8, dv, inc, False,
                                                     False)
       for t in (32, 64) for dv in (8, 16) for inc in (False, True)},
    "bonus": (3, 64, 8, 8, False, True, False),
    "scalar_decay": (2, 32, 8, 12, True, False, True),
    "ragged": (4, 1000, 64, 64, False, True, False),
    "hymba_like": (25, 512, 16, 64, True, False, True),
    "rwkv6_heads": (32, 1024, 64, 64, False, True, False),
    "wide": (4, 300, 128, 128, False, True, False),
    "odd_dims": (3, 100, 10, 6, False, True, False),
    "incl_ragged": (4, 1000, 16, 64, True, False, True),
    "short": (2, 9, 64, 64, False, True, False),
    "gla_heads": (4, 300, 256, 512, False, True, False),
    "gla_incl": (2, 200, 256, 512, True, False, False),
    "wide_odd": (2, 130, 200, 136, True, False, False),
    # dk past one key chunk with dv in one 64-column pass
    "wide_keys_narrow_v": (4, 300, 256, 64, False, True, False),
    "wide_keys_odd": (2, 130, 136, 8, True, False, False),
}


@pytest.fixture
def hopper():
    if not compat.has_hopper():
        pytest.skip("needs a CUDA device of capability (9, 0)")
    return torch.device("cuda")


def _inputs(case, dtype, device, seed=0, misaligned=False):
    """Inputs from numpy; ``misaligned`` puts q, k, v and log_w each one
    element into its storage (contiguous, rows off 16-byte alignment)."""
    bh, t, dk, dv, _, use_bonus, scalar = CASES[case]
    rs = np.random.RandomState(seed)
    q, k = (rs.randn(bh, t, dk).astype(np.float32) for _ in range(2))
    v = rs.randn(bh, t, dv).astype(np.float32)
    lw = -np.clip(rs.rand(bh, t, 1 if scalar else dk), 1e-4, 1.0).astype(
        np.float32)
    u = rs.randn(bh, dk).astype(np.float32) if use_bonus else None
    dts = [getattr(torch, d) for d in dtype.split("-")] * (
        3 if "-" not in dtype else 1)

    def cast(a, dt=torch.float32):
        x = torch.from_numpy(a).to(dt).to(device)
        if misaligned:
            buf = torch.empty(x.numel() + 1, dtype=dt, device=device)
            buf[1:] = x.reshape(-1)
            x = buf[1:].view(x.shape)
        return x
    return (cast(q, dts[0]), cast(k, dts[1]), cast(v, dts[2]),
            cast(lw, dts[0] if "-" not in dtype else torch.float32),
            torch.from_numpy(u).to(device) if u is not None else None)


def _check(out, ref, dtype):
    assert out.shape == ref.shape and out.dtype == ref.dtype
    if "-" in dtype:
        # every product in fp32 on both sides, one rounding to v's dtype
        tol = max(TOL[d] for d in dtype.split("-"))
        rtol, atol = SCALED_TOL[str(ref.dtype).removeprefix("torch.")]
        rtol += SCALED_TOL["float32"][0] * (ref.dtype != torch.float32)
    else:
        tol = TOL[dtype]
        rtol, atol = SCALED_TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(out.float(), ref.float(), rtol=rtol,
                               atol=atol)


@pytest.mark.requires_h100
@pytest.mark.parametrize("chunk", kernel.CHUNKS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", sorted(CASES))
def test_cuda_kernel_matches_torch_ref(hopper, case, dtype, chunk):
    q, k, v, lw, u = _inputs(case, dtype, hopper)
    inclusive = CASES[case][4]
    before = kernel.launches
    out = linear_attention(q, k, v, lw, bonus=u, inclusive=inclusive,
                           chunk=chunk, impl="cuda")
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    ref = linear_attention(q, k, v, lw, bonus=u, inclusive=inclusive,
                           chunk=chunk, impl="torch_ref")
    _check(out, ref, dtype)


@pytest.mark.requires_h100
@pytest.mark.parametrize("chunk", kernel.CHUNKS)
@pytest.mark.parametrize("inclusive", [False, True])
def test_long_prefill_whole(hopper, inclusive, chunk):
    """rwkv6-1.6b's 32 heads of 64 at the long prefill call's length, T =
    16384, compared whole: exclusive with the bonus (RWKV6) and inclusive
    without it (the SSM form), fp32."""
    rs = np.random.RandomState(3)
    bh, t, d = 32, 16384, 64
    q, k, v = (torch.from_numpy(rs.randn(bh, t, d).astype(np.float32)).to(
        hopper) for _ in range(3))
    lw = torch.from_numpy(-np.clip(rs.rand(bh, t, d), 1e-4, 1.0).astype(
        np.float32)).to(hopper)
    u = None if inclusive else torch.from_numpy(
        rs.randn(bh, d).astype(np.float32)).to(hopper)
    before = kernel.launches
    out = linear_attention(q, k, v, lw, bonus=u, inclusive=inclusive,
                           chunk=chunk, impl="cuda")
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    ref = linear_attention(q, k, v, lw, bonus=u, inclusive=inclusive,
                           chunk=chunk, impl="torch_ref")
    _check(out, ref, "float32")


@pytest.mark.requires_h100
@pytest.mark.parametrize("chunk", kernel.CHUNKS)
@pytest.mark.parametrize("case", ["ragged", "incl_ragged", "wide"])
def test_misaligned_rows_take_the_four_byte_copies(hopper, case, chunk):
    """fp32 inputs one element into their storage take the 4-byte copies
    and agree with the plain version."""
    q, k, v, lw, u = _inputs(case, "float32", hopper, misaligned=True)
    assert q.data_ptr() % 16 != 0
    inclusive = CASES[case][4]
    out = linear_attention(q, k, v, lw, bonus=u, inclusive=inclusive,
                           chunk=chunk, impl="cuda")
    ref = linear_attention(q, k, v, lw, bonus=u, inclusive=inclusive,
                           chunk=chunk, impl="torch_ref")
    _check(out, ref, "float32")


@pytest.mark.requires_h100
@pytest.mark.parametrize("t", [8, 20, 40])
def test_short_sequence_spans_one_chunk(hopper, t):
    """The models pass ``min(chunk_len, T)``: a short input asks for a
    chunk of ``T``, which the kernel computes in the smallest instantiated
    chunk that spans it (masked)."""
    q, k, v, lw, u = _inputs("rwkv6_heads", "float32", hopper)
    q, k, v, lw = (x[:, :t] for x in (q, k, v, lw))
    out = linear_attention(q, k, v, lw, bonus=u, chunk=t, impl="cuda")
    ref = linear_attention(q, k, v, lw, bonus=u, chunk=t, impl="torch_ref")
    _check(out, ref, "float32")


@pytest.mark.requires_h100
def test_cuda_tensors_never_fall_back(hopper):
    """A CUDA input the kernel cannot take raises from the wrapper; the
    registry counts no fallback.  fp16 inputs launch the kernel, and so do
    mixed ones."""
    q, k, v, lw, u = _inputs("bonus", "float32", hopper)
    counts = registry.default_registry.fallback_counts
    before = dict(counts)
    with pytest.raises(ValueError, match="exclusive"):
        linear_attention(q, k, v, lw, bonus=u, inclusive=True, impl="cuda")
    with pytest.raises(ValueError, match="chunk"):
        linear_attention(q, k, v, lw, chunk=48, impl="cuda")
    with pytest.raises(TypeError, match="float64"):
        linear_attention(q.double(), k, v, lw, impl="cuda")
    wide = torch.zeros((2, 16, 264), device=hopper)
    with pytest.raises(ValueError, match="head dims"):
        linear_attention(wide, wide, wide, wide, impl="cuda")
    deep = torch.zeros((*q.shape[:2], 520), device=hopper)
    with pytest.raises(ValueError, match="head dims"):
        linear_attention(q, k, deep, lw, impl="cuda")
    assert dict(counts) == before
    launched = kernel.launches
    mixed = (q.half(), k, v.half(), lw)
    out = linear_attention(*mixed, bonus=u, impl="cuda")
    torch.cuda.synchronize()
    assert kernel.launches == launched + 1 and out.dtype == torch.float16
    _check(out, linear_attention(*mixed, bonus=u, impl="torch_ref"),
           "float16-float32-float16")
    launched = kernel.launches
    half = (q.half(), k.half(), v.half(), lw)
    out = linear_attention(*half, bonus=u, impl="cuda")
    torch.cuda.synchronize()
    assert kernel.launches == launched + 1 and dict(counts) == before
    _check(out, linear_attention(*half, bonus=u, impl="torch_ref"),
           "float16")


@pytest.mark.requires_h100
def test_wrapper_refuses_non_contiguous(hopper):
    q, k, v, lw, _ = _inputs("t32-dv8-excl", "float32", hopper)
    with pytest.raises(ValueError, match="contiguous"):
        kernel.linear_attention_cuda(q.transpose(0, 1).contiguous()
                                     .transpose(0, 1), k, v, lw)
