"""The port's CUDA fast-path matcher against its plain version, on a
Hopper GPU, and the fast path built on it.

Needs no JAX, so it runs on the machine with the card:

    PYTHONPATH=src python -m pytest -q -m requires_h100 tests/test_torch_fastpath_cuda.py

Elsewhere every case skips.  Exact for integer values; 1e-6 for float
values (the reference's tolerance: the kernel and the plain version's
product both add the matching rows in fp32).
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch import compat  # noqa: E402
from repro_torch.core import fastpath as fp  # noqa: E402
from repro_torch.kernels import registry  # noqa: E402
from repro_torch.kernels.fastpath import kernel, lookup  # noqa: E402

#: (B, N, K, V): the reference's cases (tests/test_kernels.py:136-137),
#: then the router's shapes (K = 1) at fig 9's table sizes and the
#: generator's hot pool, a ragged batch, a wide key and many values
CASES = [(64, 8, 3, 16), (100, 4, 1, 8), (256, 32, 2, 4),
         *[(8192, n, 1, 1) for n in (1, 4, 16, 256, 4096)],
         (65536, 4096, 1, 16), (1000, 300, 12, 40), (37, 5, 2, 0)]
VALUE_DTYPES = [torch.float32, torch.bfloat16, torch.int32, torch.int64]


@pytest.fixture
def hopper():
    if not compat.has_hopper():
        pytest.skip("needs a CUDA device of capability (9, 0)")
    compat.resolve_device("cuda")
    return torch.device("cuda")


def _inputs(b, n, kk, v, vdtype, kdtype, device, seed=0, hot=0.5):
    """Queries of which about ``hot`` are drawn from the keys; keys from a
    small range, so some repeat."""
    rs = np.random.RandomState(seed)
    keys = rs.randint(0, max(2, n // 2), (n, kk))
    x = rs.randint(0, max(2, n), (b, kk))
    if n:
        pick = rs.rand(b) < hot
        x[pick] = keys[rs.randint(0, n, pick.sum())]
    if vdtype.is_floating_point:
        vals = torch.from_numpy(rs.randn(n, v).astype(np.float32))
    else:
        vals = torch.from_numpy(rs.randint(-2 ** 30, 2 ** 30, (n, v)))
    cast = lambda a: torch.from_numpy(a).to(device=device, dtype=kdtype)
    return cast(x), cast(keys), vals.to(device=device, dtype=vdtype)


def _check(out, hit, ref_out, ref_hit):
    assert out.shape == ref_out.shape and out.dtype == ref_out.dtype
    assert hit.dtype == torch.bool
    assert torch.equal(hit, ref_hit)
    if out.dtype.is_floating_point:
        torch.testing.assert_close(out.float(), ref_out.float(), rtol=1e-6,
                                   atol=1e-6)
    else:
        assert torch.equal(out, ref_out)


@pytest.mark.requires_h100
@pytest.mark.parametrize("block_b", kernel.BLOCK_B)
@pytest.mark.parametrize("kdtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("vdtype", VALUE_DTYPES)
@pytest.mark.parametrize("case", CASES)
def test_cuda_kernel_matches_torch_ref(hopper, case, vdtype, kdtype,
                                       block_b):
    x, keys, vals = _inputs(*case, vdtype, kdtype, hopper)
    before = kernel.launches
    out, hit = lookup(x, keys, vals, block_b=block_b, impl="cuda")
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    _check(out, hit, *lookup(x, keys, vals, impl="torch_ref"))


@pytest.mark.requires_h100
def test_exact_integer_sums(hopper):
    """2^25 + 1 and int64 sums that a float product would round."""
    x = torch.tensor([[1], [2], [5], [4]], dtype=torch.int32, device=hopper)
    keys = torch.tensor([[1], [2], [4], [4]], dtype=torch.int32,
                        device=hopper)
    vals = torch.tensor([[7], [2 ** 25 + 1], [2 ** 40 + 1], [2 ** 40 + 3]],
                        dtype=torch.int64, device=hopper)
    out, hit = lookup(x, keys, vals, impl="cuda")
    assert out.cpu().tolist() == [[7], [2 ** 25 + 1], [0], [2 ** 41 + 4]]
    assert hit.cpu().tolist() == [True, True, False, True]
    out32, _ = lookup(x[:2], keys[:2], vals[:2].int(), impl="cuda")
    assert out32.cpu().tolist() == [[7], [2 ** 25 + 1]]


@pytest.mark.requires_h100
@pytest.mark.parametrize("vdtype", [torch.float32, torch.int32])
def test_empty_table_and_all_miss(hopper, vdtype):
    x = torch.arange(300, dtype=torch.int32, device=hopper)[:, None]
    for n in (0, 7):
        keys = torch.full((n, 1), -1, dtype=torch.int32, device=hopper)
        vals = torch.ones((n, 3), dtype=vdtype, device=hopper)
        out, hit = lookup(x, keys, vals, impl="cuda")
        assert not hit.any() and not out.any() and out.shape == (300, 3)


@pytest.mark.requires_h100
def test_cuda_calls_the_kernel_lacks_raise(hopper):
    x = torch.zeros((8, 1), dtype=torch.int32, device=hopper)
    counts = registry.default_registry.fallback_counts
    before = dict(counts)
    with pytest.raises(ValueError, match="block_b"):
        lookup(x, x, torch.zeros((8, 2), device=hopper), block_b=64,
               impl="cuda")
    with pytest.raises(TypeError, match="values"):
        lookup(x, x, torch.zeros((8, 2), device=hopper).half(), impl="cuda")
    wide = torch.zeros((8, 33), dtype=torch.int32, device=hopper)
    with pytest.raises(ValueError, match="key width"):
        lookup(wide, wide, torch.zeros((8, 2), device=hopper), impl="cuda")
    with pytest.raises(TypeError, match="integer"):
        lookup(x.float(), x.float(), torch.ones((8, 2), device=hopper),
               impl="cuda")
    assert dict(counts) == before


@pytest.mark.requires_h100
@pytest.mark.parametrize("skip", [True, False])
def test_make_fastpath_on_the_card(hopper, skip):
    """The fast path over a generic with duplicate table keys: the output
    equals the generic's on hits and misses, through the kernel."""
    def generic(xb):
        return (xb.to(torch.float32) ** 2).sum(-1, keepdim=True) + 1.0

    keys = np.array([[3, 1], [5, 2], [3, 1], [9, 9]], np.int32)
    table = fp.FastPathTable.from_arrays(
        keys, generic(torch.from_numpy(keys)).numpy())
    f = fp.make_fastpath(generic, table, skip_generic_when_all_hit=skip)
    rs = np.random.RandomState(0)
    for batch in (keys[rs.randint(0, 4, 5000)],
                  rs.randint(0, 10, (5000, 2)).astype(np.int32)):
        xb = torch.from_numpy(batch).to(hopper)
        before = kernel.launches
        out = f(xb)
        assert kernel.launches == before + 1
        torch.testing.assert_close(out, generic(xb), rtol=1e-6, atol=1e-6)
