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
        lookup(x, x.float(), torch.ones((8, 2), device=hopper), impl="cuda")
    assert dict(counts) == before
    # float queries miss the guard, as they miss the reference's: the plain
    # version answers, one fallback counted
    vals = torch.ones((8, 2), device=hopper)
    out, hit = lookup(x.float(), x.float(), vals, impl="cuda")
    ref_out, ref_hit = lookup(x.float(), x.float(), vals, impl="torch_ref")
    torch.testing.assert_close(out, ref_out)
    assert torch.equal(hit, ref_hit)
    key = ("fastpath", "cuda")
    assert counts[key] == before.get(key, 0) + 1


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


# -- the prepared table: both bodies, the miss count, the specialized call -------------

@pytest.mark.requires_h100
@pytest.mark.parametrize("body", kernel.BODIES)
@pytest.mark.parametrize("kdtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("vdtype", VALUE_DTYPES)
@pytest.mark.parametrize("case", CASES)
def test_prepared_bodies_match_torch_ref(hopper, case, vdtype, kdtype, body):
    """Each body on a prepared table, at the reference's cases, the
    router's and the 4096-key shapes; its miss count equals the plain
    version's misses."""
    x, keys, vals = _inputs(*case, vdtype, kdtype, hopper)
    table = kernel.prepare_table(keys, vals)
    readback = kernel.MissReadback()
    before = kernel.launches
    out, hit = kernel.fastpath_cuda_prepared(x, table, body=body,
                                             readback=readback)
    assert kernel.launches == before + 1
    ref_out, ref_hit = lookup(x, keys, vals, impl="torch_ref")
    _check(out, hit, ref_out, ref_hit)
    assert readback.misses == int((~ref_hit).sum())


@pytest.mark.requires_h100
@pytest.mark.parametrize("case", CASES)
def test_raw_miss_count_and_readback(hopper, case):
    """The raw wrapper's miss count, written to a mapped host word (the
    call then waits on the stream), equals ``(~hit).sum()``, and a launch
    without the word leaves it alone; the op with a prepared table runs the
    body ``kernel.body`` names."""
    x, keys, vals = _inputs(*case, torch.float32, torch.int32, hopper)
    readback = kernel.MissReadback()
    assert readback.device_address
    out, hit = kernel.fastpath_cuda(x, keys, vals, readback=readback)
    assert readback.misses == int((~hit).sum())
    readback._word.value = -1
    kernel.fastpath_cuda(x, keys, vals)
    torch.cuda.synchronize()
    assert readback.misses == -1
    table = kernel.prepare_table(keys, vals)
    assert kernel.body(table) == ("hashed" if case[1] >= kernel.hash_min_keys()
                                  else "dense")
    out3, hit3 = lookup(x, keys, vals, impl="cuda", prepared=table)
    _check(out3, hit3, out, hit)


@pytest.mark.requires_h100
def test_hash_of_the_library_is_pinned(hopper):
    """The .cu's hash on the CPU tests' pinned key vector
    (tests/test_torch_fastpath.py::HASH_KEYS, HASH_PINNED)."""
    keys = np.array([[0], [1], [-1], [2 ** 31 - 1], [-2 ** 31],
                     [2 ** 40 + 12345]], np.int64)
    pinned = [16294208416658607535, 16490336266968443936,
              15999695513772384452, 13807218343701425311,
              547167690438560762, 1117476736002829374]
    out = np.zeros(len(keys), np.uint64)
    kernel.load_library().fastpath_hash(keys.ctypes.data, len(keys), 1,
                                        out.ctypes.data)
    assert out.tolist() == pinned == kernel.hash_keys(keys).tolist()


@pytest.mark.requires_h100
@pytest.mark.parametrize("body", kernel.BODIES)
def test_probe_chain_and_high_bit_keys(hopper, body):
    """A table whose keys share one probe chain, queried with its keys and
    absent keys of the same slot; int64 keys apart only in their high 32
    bits."""
    n, size = 128, 256
    cand = np.arange(8 * n * size, dtype=np.int64)[:, None]
    slot = kernel.hash_keys(cand) & np.uint64(size - 1)
    same = cand[slot == np.bincount(slot.astype(np.int64)).argmax()]
    keys = torch.as_tensor(same[:n].astype(np.int32), device=hopper)
    x = torch.as_tensor(np.concatenate([same[:2 * n], same[:n]])
                        .astype(np.int32), device=hopper)
    vals = torch.randn((n, 16), device=hopper)
    high = ((torch.arange(1, 65, dtype=torch.int64, device=hopper) << 32)
            | 77)[:, None].contiguous()
    hx = torch.cat([high, high + (1000 << 32), high & 0xFFFFFFFF])
    hvals = torch.arange(64, dtype=torch.int64, device=hopper)[:, None] + 1
    readback = kernel.MissReadback()
    for q, k, v in ((x, keys, vals), (hx, high, hvals)):
        table = kernel.prepare_table(k, v)
        out, hit = kernel.fastpath_cuda_prepared(q, table, body=body,
                                                 readback=readback)
        _check(out, hit, *lookup(q, k, v, impl="torch_ref"))
        assert readback.misses == int((~hit).sum()) > 0
    assert int(hit.sum()) == 64


@pytest.mark.requires_h100
@pytest.mark.parametrize("body", kernel.BODIES)
def test_launches_replay_in_a_cuda_graph(hopper, body):
    """Captured launches replay with the right outputs, and leave the
    stream's scratch word at 0: a launch on the capture stream after the
    replays counts its misses right."""
    x, keys, vals = _inputs(8192, 256, 1, 1, torch.int32, torch.int32,
                            hopper)
    table = kernel.prepare_table(keys, vals)
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        kernel.fastpath_cuda_prepared(x, table, body=body)   # warm the stream
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        results = [kernel.fastpath_cuda_prepared(x, table, body=body)
                   for _ in range(3)]
    ref_out, ref_hit = lookup(x, keys, vals, impl="torch_ref")
    readback = kernel.MissReadback()
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        for out, hit in results:
            _check(out, hit, ref_out, ref_hit)
        with torch.cuda.stream(side):
            kernel.fastpath_cuda_prepared(x, table, body=body,
                                          readback=readback)
        assert readback.misses == int((~ref_hit).sum())


@pytest.mark.requires_h100
def test_prepared_table_of_another_device_or_dtype_raises(hopper):
    x, keys, vals = _inputs(64, 8, 2, 3, torch.float32, torch.int32, hopper)
    table = kernel.prepare_table(keys, vals)
    host = kernel.prepare_table(keys.cpu(), vals.cpu())
    before = kernel.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernel.fastpath_cuda_prepared(x, host)
    with pytest.raises(TypeError, match="one dtype"):
        kernel.fastpath_cuda_prepared(x.long(), table)
    with pytest.raises(TypeError, match="one dtype"):
        lookup(x.long(), keys, vals, impl="cuda", prepared=table)
    with pytest.raises(ValueError, match="body"):
        kernel.fastpath_cuda_prepared(x, table, body="sorted")
    assert kernel.launches == before


@pytest.mark.requires_h100
@pytest.mark.parametrize("m", [1, 16, 256])
def test_make_fastpath_all_hit_is_one_launch(hopper, m):
    """An all-hit call of the specialized function makes one K5 launch and
    nothing else on the card (by ``kernel.launches`` and the profiler): no
    reduction, no copy; its output equals the generic's, and a batch with
    misses still backfills through the generic."""
    from torch.profiler import ProfilerActivity, profile

    def generic(xb):
        return (xb.to(torch.int64) * 7 + 3).to(torch.int32)

    rs = np.random.RandomState(m)
    hot = rs.choice(2 ** 30, m, replace=False).astype(np.int32)[:, None]
    table = fp.FastPathTable.from_arrays(hot, generic(torch.from_numpy(hot))
                                         .numpy())
    f = fp.make_fastpath(generic, table)
    xb = torch.as_tensor(hot[rs.randint(0, m, 8192)], device=hopper)
    f(xb)
    torch.cuda.synchronize()
    calls = 20
    before = kernel.launches
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        outs = [f(xb) for _ in range(calls)]
        torch.cuda.synchronize()
    assert kernel.launches == before + calls
    # The profiler may drop the first activities of a short window, so it
    # decides what ran, and kernel.launches how often.
    ops_ = [(e.key, e.count) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(ops_) == 1 and 0 < ops_[0][1] <= calls, ops_
    assert ("dense_kernel" if m < kernel.hash_min_keys()
            else "hashed_kernel") in ops_[0][0]
    assert all(torch.equal(out, generic(xb)) for out in outs)
    mixed = xb.clone()
    mixed[::3] = 2 ** 30 + 5
    assert torch.equal(f(mixed), generic(mixed))
