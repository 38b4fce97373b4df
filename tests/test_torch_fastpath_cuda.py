"""The port's CUDA fast-path matcher against its plain version, on a
Hopper GPU, and the fast path built on it.

Needs no JAX, so it runs on the machine with the card:

    PYTHONPATH=src python -m pytest -q -m requires_h100 tests/test_torch_fastpath_cuda.py

Elsewhere every case skips.  Exact for integer values; 1e-6 for float
values (the reference's tolerance: the kernel and the plain version's
product both add the matching rows in fp32), and one ulp of an fp16
output (both round an fp32 sum once, added in their own orders).
"""
import time

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
VALUE_DTYPES = [torch.float32, torch.bfloat16, torch.float16, torch.int32,
                torch.int64]
#: queries' and keys' dtypes of the parametrized cases (one dtype each)
KEY_DTYPES = [torch.int32, torch.int64, torch.int8]
#: rows per block of the parametrized cases: the reference's tests' 32, 128
#: and its default 256 (any positive block_b: test_any_block_b)
BLOCK_B = (32, 128, 256)
#: fp16 values: one ulp of the output, relative (fp32 and bf16: 1e-6)
FP16_ULP = 2.0 ** -10


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
        rtol = FP16_ULP if out.dtype == torch.float16 else 1e-6
        torch.testing.assert_close(out.float(), ref_out.float(), rtol=rtol,
                                   atol=1e-6)
    else:
        assert torch.equal(out, ref_out)


@pytest.mark.requires_h100
@pytest.mark.parametrize("block_b", BLOCK_B)
@pytest.mark.parametrize("kdtype", KEY_DTYPES)
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
    """The calls the wrapper refused before (a block_b of 64, fp16 values,
    keys 33 wide, float keys) each launch the kernel once, with no
    fallback, and agree with the plain version; float queries miss the
    guard, as they miss the reference's: the plain version answers, one
    fallback counted."""
    x = torch.arange(8, dtype=torch.int32, device=hopper)[:, None] % 5
    counts = registry.default_registry.fallback_counts
    before = dict(counts)
    wide = torch.arange(8 * 33, dtype=torch.int32,
                        device=hopper).reshape(8, 33) % 3
    vals = torch.arange(16, dtype=torch.float32, device=hopper).reshape(8, 2)
    for args, kw in (((x, x, vals), {"block_b": 64}),
                     ((x, x, vals.half()), {}),
                     ((wide, wide, vals), {}),
                     ((x, x.float(), vals), {})):
        launches = kernel.launches
        out, hit = lookup(*args, impl="cuda", **kw)
        torch.cuda.synchronize()
        assert kernel.launches == launches + 1
        _check(out, hit, *lookup(*args, impl="torch_ref"))
    assert dict(counts) == before
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
@pytest.mark.parametrize("kdtype", KEY_DTYPES)
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
    """A prepared table of another device raises (as does a body the
    kernel lacks); queries of another integer dtype than the table's keys
    launch, and compare in the wider dtype."""
    x, keys, vals = _inputs(64, 8, 2, 3, torch.float32, torch.int32, hopper)
    table = kernel.prepare_table(keys, vals)
    host = kernel.prepare_table(keys.cpu(), vals.cpu())
    before = kernel.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernel.fastpath_cuda_prepared(x, host)
    with pytest.raises(ValueError, match="body"):
        kernel.fastpath_cuda_prepared(x, table, body="sorted")
    assert kernel.launches == before
    ref = lookup(x, keys, vals, impl="torch_ref")
    for q in (x.long(), x.to(torch.int8), x.to(torch.uint8)):
        _check(*kernel.fastpath_cuda_prepared(q, table), *ref)
        _check(*lookup(q, keys, vals, impl="cuda", prepared=table), *ref)
    assert kernel.launches == before + 6


# -- the wider domain: float keys, every integer dtype, wide keys, block_b ---------

#: float keys and int32 queries that show ``==``'s rounding of the query to
#: the keys' dtype (tests/test_torch_matmul_fastpath_domain.py)
FLOAT_KEYS = [16777216.0, float("nan"), -0.0, 2.5, 2048.0, 256.0,
              float("inf"), -7.0, 300.0, 2.0 ** 31]
EDGE_QUERIES = [16777217, 16777216, 16777215, 0, 2, 3, 2049, 2050, 257,
                258, 70000, 65519, 65520, -7, 5, -70000, 300, 301,
                2 ** 31 - 1, -2 ** 31]


def _all_paths(x, keys, vals, block_b=256):
    """The raw op (dense body) and the prepared table on each body, each
    one launch, against the plain version, with the miss count."""
    ref_out, ref_hit = lookup(x, keys, vals, impl="torch_ref")
    before = kernel.launches
    _check(*lookup(x, keys, vals, block_b=block_b, impl="cuda"), ref_out,
           ref_hit)
    table = kernel.prepare_table(keys, vals)
    readback = kernel.MissReadback()
    for body in kernel.BODIES:
        out, hit = kernel.fastpath_cuda_prepared(
            x, table, block_b=block_b, body=body, readback=readback)
        _check(out, hit, ref_out, ref_hit)
        assert readback.misses == int((~ref_hit).sum())
    assert kernel.launches == before + 3
    return ref_hit


@pytest.mark.requires_h100
@pytest.mark.parametrize("vdtype", [torch.float16, torch.int32])
@pytest.mark.parametrize("kdtype", [torch.float32, torch.bfloat16,
                                    torch.float16])
def test_float_keys(hopper, kdtype, vdtype):
    """Integer queries of each integer dtype against float keys with the
    edge cases: 2^24 + 1, 2049, 257 and 70000 rounding onto a key, a NaN
    key, a -0.0 key, a key that is not integral."""
    keys = torch.tensor(FLOAT_KEYS, device=hopper)[:, None].to(kdtype)
    vals = torch.arange(2 * len(FLOAT_KEYS), device=hopper).reshape(
        -1, 2).to(vdtype)
    q = torch.tensor(EDGE_QUERIES, device=hopper)[:, None]
    for qd in (torch.int32, torch.int64):
        hit = _all_paths(q.to(qd), keys, vals)
        assert hit.any() and not hit.all()
    small = q.clamp(0, 120)
    for qd in (torch.int8, torch.int16, torch.uint8):
        _all_paths(small.to(qd), keys, vals)


@pytest.mark.requires_h100
@pytest.mark.parametrize("kdtype", [torch.int8, torch.int16, torch.uint8,
                                    torch.int32, torch.int64])
@pytest.mark.parametrize("qdtype", [torch.int8, torch.int16, torch.uint8,
                                    torch.int32, torch.int64])
def test_integer_queries_and_keys_of_any_dtype(hopper, qdtype, kdtype):
    """Queries and keys of every pair of integer dtypes, compared as values
    (an int8 -1 and a uint8 255 differ), on every path."""
    rs = np.random.RandomState(3)
    raw = rs.randint(-5, 260, (40, 2))
    q = rs.randint(-5, 260, (3000, 2))
    q[::2] = raw[rs.randint(0, 40, 1500)]
    cast = lambda a, dt: torch.from_numpy(  # noqa: E731
        a.astype(np.int64)).to(hopper).to(dt)
    vals = torch.from_numpy(rs.randint(-100, 100, (40, 3))).to(
        device=hopper, dtype=torch.int32)
    _all_paths(cast(q, qdtype), cast(raw, kdtype), vals)


@pytest.mark.requires_h100
@pytest.mark.parametrize("kdtype", [torch.int32, torch.int64, torch.float32])
@pytest.mark.parametrize("kw", [33, 64, 100])
def test_wide_keys(hopper, kw, kdtype):
    """Keys wider than 32 integers on every path, queries apart only in
    their last integer, a staged table and one too large to stage."""
    rs = np.random.RandomState(kw)
    for n in (64, 2000):
        keys = torch.from_numpy(rs.randint(0, 3, (n, kw))).to(hopper)
        x = torch.from_numpy(rs.randint(0, 3, (4000, kw))).to(hopper)
        pick = torch.from_numpy(rs.randint(0, n, 2000)).to(hopper)
        x[::2] = keys[pick]
        x[1::4, -1] = 7
        vals = torch.randn((n, 5), device=hopper)
        hit = _all_paths(x.to(torch.int32), keys.to(kdtype), vals)
        assert hit[::2].all() and not hit[1::4].any()


@pytest.mark.requires_h100
@pytest.mark.parametrize("block_b", [1, 7, 64, 100, 512, 1024])
def test_any_block_b(hopper, block_b):
    """Any positive block_b: whole warps, at most 256 rows a block; the
    answer does not depend on it."""
    x, keys, vals = _inputs(5000, 16, 1, 2, torch.float16, torch.int32,
                            hopper)
    _all_paths(x, keys, vals, block_b=block_b)
    x, keys, vals = _inputs(37, 5, 2, 3, torch.int64, torch.int32, hopper)
    _all_paths(x, keys, vals, block_b=block_b)


@pytest.mark.requires_h100
@pytest.mark.parametrize("key_dtype", [torch.int8, torch.float32])
def test_make_fastpath_wide_keys_and_fp16_values(hopper, key_dtype):
    """``make_fastpath`` on the card with an (8, 8) key shape and fp16
    values: int8 keys run the kernel, one launch a call; float32 keys cast
    the queries to float, which miss the guard (``torch_ref``, one
    fallback a call), as in the reference.  Both answer as the generic."""
    def generic(xb):
        return (xb.reshape(xb.shape[0], -1).float().sum(
            -1, keepdim=True) * 0.25).half()

    rs = np.random.RandomState(5)
    keys = rs.randint(0, 4, (6, 8, 8)).astype(np.int32)
    table = fp.FastPathTable.from_arrays(keys, generic(
        torch.from_numpy(keys)).float().numpy())
    f = fp.make_fastpath(generic, table, key_dtype=key_dtype,
                         value_dtype=torch.float16)
    q = rs.randint(0, 4, (200, 8, 8)).astype(np.int32)
    q[::2] = keys[rs.randint(0, 6, 100)]
    counts = registry.default_registry.fallback_counts
    key = ("fastpath", "cuda")
    for batch in (q, q[::2]):
        xb = torch.from_numpy(batch).to(hopper)
        launches, fallbacks = kernel.launches, counts.get(key, 0)
        out = f(xb)
        torch.cuda.synchronize()
        on_kernel = key_dtype == torch.int8
        assert kernel.launches == launches + on_kernel
        assert counts.get(key, 0) == fallbacks + (not on_kernel)
        assert out.dtype == torch.float16
        torch.testing.assert_close(out, generic(xb), rtol=0, atol=0)


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
        # idle host on each side: the profiler keeps only device
        # activities timed inside the host's window (chip_smoke.py's
        # PROFILE_PAD_S)
        time.sleep(0.05)
        outs = [f(xb) for _ in range(calls)]
        torch.cuda.synchronize()
        time.sleep(0.05)
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
