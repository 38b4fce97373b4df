"""K3's and K5's wider domain against the JAX reference, on the CPU.

K3 (the blocked matmul): operands and outputs of fp32, bf16 and fp16 in
every combination, x and y of two dtypes included.  K5 (the hot-key
matcher): float keys against integer queries (``==`` rounds the query to
the keys' dtype), queries and keys of every integer dtype, fp16 values,
keys wider than 32 integers and any positive ``block_b``.

The reference's Pallas kernels take all of these
(``src/repro/kernels/matmul/kernel.py``,
``src/repro/kernels/fastpath/kernel.py``), so the port's kernels take them
too: ``kernel.unsupported`` returns None, and ``ops._guard`` sends such a
call on the card to the kernel.  Here the port's plain versions, which the
card holds the kernels to (``tests/test_torch_*_cuda.py``,
``chip_smoke.py``), run the same inputs as the reference's Pallas kernels
under the interpreter; K5's hashed form, built on the host, is probed by
its plain probe (``ref.lookup_prepared``), and ``make_fastpath`` is held
to the reference's.

Tolerances (ROADMAP's oracle tolerances): K3 fp32 outputs within 1e-5,
half outputs within 3e-2, as ``|port - ref| <= tol (1 + |ref|)``.  K5:
hits exact, integer values exact, float values within 1e-6 and half ones
within one ulp of the output (both add the matching rows in fp32 and round
once, the reference in its one-hot product).
"""
import itertools

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from test_torch_matmul import _OnCard  # noqa: E402

from repro import compat as ref_compat  # noqa: E402
from repro.core import fastpath as ref_core_fp  # noqa: E402
from repro.kernels import fastpath as ref_fastpath  # noqa: E402
from repro.kernels import matmul as ref_matmul  # noqa: E402
from repro.kernels import registry as ref_registry  # noqa: E402
from repro.kernels.fastpath import ref as ref_oracle  # noqa: E402
from repro_torch.core import fastpath as core_fp  # noqa: E402
from repro_torch.kernels.fastpath import kernel as fp_kernel  # noqa: E402
from repro_torch.kernels.fastpath import ops as fp_ops  # noqa: E402
from repro_torch.kernels.fastpath import ref as fp_ref  # noqa: E402
from repro_torch.kernels.matmul import kernel as mm_kernel  # noqa: E402
from repro_torch.kernels.matmul import ops as mm_ops  # noqa: E402

pytestmark = pytest.mark.skipif(
    not ref_compat.has_pallas_tpu(),
    reason="Pallas TPU module not importable: no interpret-mode kernels")

FLOATS = ("float32", "bfloat16", "float16")
INTS = ("int8", "int16", "uint8", "int32")
MM_TOL = {"float32": 1e-5, "bfloat16": 3e-2, "float16": 3e-2}
#: one ulp of a K5 output, relative (fp32: the reference's 1e-6)
FP_ULP = {"float32": 1e-6, "bfloat16": 2 ** -7, "float16": 2 ** -10}
#: a divisible and a ragged (m, k, n) at the test tile (16, 16, 16)
MM_SHAPES = [(32, 48, 64), (50, 30, 70)]
MM_TILES = (16, 16, 16)


def _interpreted(op, registry_family, impl, *args, **kw):
    """The reference's op under ``impl``, with no fallback counted."""
    key = (registry_family, impl)
    before = ref_registry.default_registry.fallback_counts.get(key, 0)
    out = op(*args, impl=impl, **kw)
    assert ref_registry.default_registry.fallback_counts.get(key, 0) \
        == before, "the interpret entry fell back"
    return out


# -- K3 ----------------------------------------------------------------------------

@pytest.mark.parametrize("shape", MM_SHAPES, ids=["divisible", "ragged"])
@pytest.mark.parametrize("xd,yd,od", list(itertools.product(FLOATS, repeat=3)))
def test_matmul_dtypes_match_the_interpreted_kernel(xd, yd, od, shape):
    """x, y and the output of each of fp32, bf16 and fp16: the port's plain
    version against the reference's Pallas kernel under the interpreter
    (operands of two dtypes promoted, as ``jnp.dot`` promotes them); the
    kernel takes the call and the guard sends it there."""
    m, k, n = shape
    rs = np.random.RandomState(m + k + n)
    xa, ya = rs.randn(m, k).astype(np.float32), rs.randn(k, n).astype(
        np.float32)
    x = torch.from_numpy(xa).to(getattr(torch, xd))
    y = torch.from_numpy(ya).to(getattr(torch, yd))
    jx = jnp.asarray(xa).astype(getattr(jnp, xd))
    jy = jnp.asarray(ya).astype(getattr(jnp, yd))
    out_dtype = getattr(torch, od)
    bm, bn, bk = MM_TILES
    assert mm_kernel.unsupported(x, y, bm=bm, bn=bn, bk=bk,
                                 out_dtype=out_dtype) is None
    assert mm_ops._guard(_OnCard(x), _OnCard(y), bm=bm, bn=bn, bk=bk)
    port = mm_ops.matmul(x, y, bm=bm, bn=bn, bk=bk, out_dtype=out_dtype,
                         impl="torch_ref")
    ref = _interpreted(ref_matmul.matmul, "matmul", "pallas_interpret", jx,
                       jy, bm=bm, bn=bn, bk=bk,
                       out_dtype=getattr(jnp, od))
    assert port.dtype == out_dtype and str(ref.dtype) == od
    assert port.shape == ref.shape == (m, n)
    r = np.asarray(ref.astype(jnp.float32), np.float64)
    p = port.double().numpy()
    tol = MM_TOL[od]
    assert np.all(np.abs(p - r) <= tol * (1 + np.abs(r))), \
        float(np.max(np.abs(p - r)))


@pytest.mark.parametrize("xd,yd", [("float32", "bfloat16"),
                                   ("bfloat16", "float16"),
                                   ("float16", "float32")])
def test_matmul_of_two_dtypes_writes_x_dtype(xd, yd):
    """``out_dtype`` None: x's dtype, in both packages."""
    rs = np.random.RandomState(3)
    xa, ya = rs.randn(32, 16).astype(np.float32), rs.randn(16, 48).astype(
        np.float32)
    port = mm_ops.matmul(torch.from_numpy(xa).to(getattr(torch, xd)),
                         torch.from_numpy(ya).to(getattr(torch, yd)),
                         bm=16, bn=16, bk=16, impl="torch_ref")
    ref = _interpreted(ref_matmul.matmul, "matmul", "pallas_interpret",
                       jnp.asarray(xa).astype(getattr(jnp, xd)),
                       jnp.asarray(ya).astype(getattr(jnp, yd)),
                       bm=16, bn=16, bk=16)
    assert port.dtype == getattr(torch, xd) and str(ref.dtype) == xd
    r = np.asarray(ref.astype(jnp.float32), np.float64)
    assert np.all(np.abs(port.double().numpy() - r)
                  <= MM_TOL[xd] * (1 + np.abs(r)))


def test_matmul_unsupported_keeps_only_the_remaining_gaps():
    """None for every class the wrapper used to refuse; an error for a
    tile triple outside ``TILES``, fp64 operands or output, and the
    32-bit limits (meta tensors: shapes without storage)."""
    f32, bf16, f16, f64 = (torch.float32, torch.bfloat16, torch.float16,
                           torch.float64)

    def t(m, n, dtype, device="cpu"):
        return torch.empty((m, n), dtype=dtype, device=device)

    for xd, yd, od in [(f16, f16, f16), (f16, f16, f32), (f32, bf16, None),
                       (bf16, f16, None), (f32, f32, bf16), (f32, f32, f16),
                       (bf16, bf16, f16), (f16, f16, bf16)]:
        assert mm_kernel.unsupported(t(8, 8, xd), t(8, 8, yd),
                                     out_dtype=od) is None, (xd, yd, od)
    assert isinstance(mm_kernel.unsupported(t(8, 8, f32), t(8, 8, f32),
                                            bm=256, bn=256, bk=128),
                      ValueError)
    assert isinstance(mm_kernel.unsupported(t(8, 8, f64), t(8, 8, f64)),
                      TypeError)
    assert isinstance(mm_kernel.unsupported(t(8, 8, f32), t(8, 8, f64)),
                      TypeError)
    assert isinstance(mm_kernel.unsupported(t(8, 8, f32), t(8, 8, f32),
                                            out_dtype=f64), TypeError)
    assert isinstance(mm_kernel.unsupported(
        t(2 ** 31, 8, f16, "meta"), t(8, 8, f16, "meta")), ValueError)


# -- K5 ----------------------------------------------------------------------------

#: float keys that show how ``==`` rounds an integer query to their dtype:
#: 2^24 (an fp32 key 16777217 rounds to), NaN (matches nothing), -0.0
#: (matches 0), 2.5 (not integral: matches nothing), 2048 (fp16 and bf16
#: round 2049 to it), 256 (bf16 rounds 257 to it), inf (fp16 rounds 70000
#: and 16777217 to it),
#: -7, 300, and 2^31 (2^31 - 1 rounds to it in each float dtype)
FLOAT_KEYS = [16777216.0, float("nan"), -0.0, 2.5, 2048.0, 256.0,
              float("inf"), -7.0, 300.0, 2.0 ** 31]
EDGE_QUERIES = [16777217, 16777216, 16777215, 0, 2, 3, 2049, 2050, 257,
                258, 70000, 65519, 65520, -7, 5, -70000, 300, 301,
                2 ** 31 - 1, -2 ** 31]


def _fp_check(x, keys, vals, jx, jk, jv, block_b=32, prepared=True):
    """The port's plain lookup (and the plain probe of its hashed form)
    against the reference's oracle and its interpreted kernel."""
    out, hit = fp_ops.lookup(x, keys, vals, impl="torch_ref")
    oracles = [ref_oracle.lookup(jx, jk, jv),
               _interpreted(ref_fastpath.lookup, "fastpath",
                            "pallas_interpret", jx, jk, jv, block_b=block_b)]
    ports = [(out, hit)]
    if prepared:
        table = fp_kernel.prepare_table(keys, vals)
        ports.append(fp_ref.lookup_prepared(x, table))
    vd = str(vals.dtype).removeprefix("torch.")
    for (o, h), (o_ref, h_ref) in itertools.product(ports, oracles):
        np.testing.assert_array_equal(h.numpy(), np.asarray(h_ref))
        assert o.dtype == vals.dtype and o.shape == tuple(o_ref.shape)
        if vals.dtype.is_floating_point:
            r = np.asarray(o_ref.astype(jnp.float32), np.float64)
            p = o.double().numpy()
            assert np.all(np.abs(p - r) <= FP_ULP[vd] * (1 + np.abs(r))), \
                float(np.max(np.abs(p - r)))
        else:
            np.testing.assert_array_equal(o.numpy(), np.asarray(o_ref))
    return hit


@pytest.mark.parametrize("vd", ["float16", "float32"])
@pytest.mark.parametrize("kd", FLOATS)
def test_float_keys_match_the_interpreted_kernel(kd, vd):
    """int32 queries against float keys with every edge case: each query
    rounds to the keys' dtype, a NaN key matches nothing, -0.0 matches 0,
    a key that is not integral matches nothing; fp16 and fp32 values; the
    hashed form of the float keys agrees."""
    rs = np.random.RandomState(len(kd) + len(vd))
    keys_np = np.array(FLOAT_KEYS, np.float32)[:, None]
    q = np.array(EDGE_QUERIES, np.int64)[:, None].astype(np.int32)
    vals_np = (rs.randint(1, 8, (len(FLOAT_KEYS), 3)) / 4).astype(np.float32)
    keys = torch.from_numpy(keys_np).to(getattr(torch, kd))
    vals = torch.from_numpy(vals_np).to(getattr(torch, vd))
    x = torch.from_numpy(q)
    assert fp_kernel.unsupported(x, keys, vals) is None
    assert fp_ops._guard(_OnCard(x), _OnCard(keys), _OnCard(vals))
    hit = _fp_check(x, keys, vals, jnp.asarray(q),
                    jnp.asarray(keys_np).astype(getattr(jnp, kd)),
                    jnp.asarray(vals_np).astype(getattr(jnp, vd)))
    by_query = dict(zip(EDGE_QUERIES, hit.tolist()))
    assert by_query[16777217] and by_query[0] and by_query[-7]
    assert not by_query[5] and not by_query[3]
    assert by_query[2049] == (kd != "float32")     # rounds to 2048
    assert by_query[257] == (kd == "bfloat16")     # rounds to 256
    assert by_query[70000] == (kd == "float16")    # rounds to inf
    assert by_query[2 ** 31 - 1]                   # rounds to 2^31


@pytest.mark.parametrize("qd", ["int8", "int16", "uint8"])
@pytest.mark.parametrize("kd", FLOATS)
def test_narrow_queries_against_float_keys(kd, qd):
    """Narrow integer queries against float keys, some of them not
    integral or negative."""
    rs = np.random.RandomState(7)
    keys_np = np.concatenate([rs.randint(-20, 120, (12, 2)),
                              [[0.5, 3], [-0.0, 1]]]).astype(np.float32)
    q = rs.randint(-20, 120, (64, 2))
    q[::3] = keys_np[rs.randint(0, 12, len(q[::3]))]
    q = q.astype(getattr(np, qd))
    vals_np = rs.randn(len(keys_np), 2).astype(np.float32)
    keys = torch.from_numpy(keys_np).to(getattr(torch, kd))
    x, vals = torch.from_numpy(q), torch.from_numpy(vals_np)
    assert fp_kernel.unsupported(x, keys, vals) is None
    _fp_check(x, keys, vals, jnp.asarray(q),
              jnp.asarray(keys_np).astype(getattr(jnp, kd)),
              jnp.asarray(vals_np))


@pytest.mark.parametrize("qd,kd", list(itertools.product(INTS, repeat=2)))
def test_integer_dtypes_match_the_interpreted_kernel(qd, kd):
    """Queries and keys of every integer dtype (JAX's, with 64-bit types
    off), compared as values in their promoted dtype: an int8 -1 and a
    uint8 255 differ.  Raw and through the hashed form."""
    rs = np.random.RandomState(INTS.index(qd) * 4 + INTS.index(kd))
    raw_keys = rs.randint(-5, 260, (30, 2))
    keys_np = raw_keys.astype(getattr(np, kd))
    q = rs.randint(-5, 260, (120, 2))
    q[::2] = raw_keys[rs.randint(0, 30, 60)]
    q = q.astype(getattr(np, qd))
    vals_np = rs.randint(-1000, 1000, (30, 3)).astype(np.int32)
    x, keys = torch.from_numpy(q), torch.from_numpy(keys_np)
    vals = torch.from_numpy(vals_np)
    assert fp_kernel.unsupported(x, keys, vals) is None
    hit = _fp_check(x, keys, vals, jnp.asarray(q), jnp.asarray(keys_np),
                    jnp.asarray(vals_np))
    assert hit.any()


@pytest.mark.parametrize("kd", ["int8", "int16", "uint8", "int32", "int64",
                                "float32", "bfloat16", "float16"])
def test_prepared_table_of_each_key_dtype(kd):
    """``prepare_table`` takes keys of each dtype the kernel takes; its
    hashed form (canonical keys), probed with queries of every integer
    dtype, agrees with the plain lookup, duplicates and wide int64
    queries included."""
    rs = np.random.RandomState(11)
    keys_np = rs.randint(0, 100, (40, 3))
    vals = torch.from_numpy(rs.randn(40, 2).astype(np.float32)).half()
    keys = torch.from_numpy(keys_np).to(getattr(torch, kd))
    table = fp_kernel.prepare_table(keys, vals)
    assert table.hkeys.dtype == (torch.int64 if kd == "int64"
                                 else torch.int32)
    q = rs.randint(0, 120, (200, 3))
    q[::2] = keys_np[rs.randint(0, 40, 100)]
    for qd in ("int8", "int16", "uint8", "int32", "int64"):
        x = torch.from_numpy(q.astype(getattr(np, qd)))
        out, hit = fp_ref.lookup_prepared(x, table)
        o_ref, h_ref = fp_ops.lookup(x, keys, vals, impl="torch_ref")
        assert torch.equal(hit, h_ref) and hit.any()
        torch.testing.assert_close(out, o_ref, rtol=2 ** -10, atol=0)
    # an int64 query beyond the int32 range matches no int32 key
    x = torch.tensor([[5 + 2 ** 32, 1, 1], list(keys_np[0])],
                     dtype=torch.int64)
    _, hit = fp_ref.lookup_prepared(x, table)
    assert hit.tolist() == [False, True]


@pytest.mark.parametrize("kw", [33, 64, 100])
def test_wide_keys_match_the_interpreted_kernel(kw):
    """Keys wider than 32 integers, some queries apart only in their last
    integer; raw and through the hashed form."""
    rs = np.random.RandomState(kw)
    keys_np = rs.randint(0, 3, (24, kw)).astype(np.int32)
    q = rs.randint(0, 3, (96, kw)).astype(np.int32)
    q[::2] = keys_np[rs.randint(0, 24, 48)]
    q[1::4] = keys_np[rs.randint(0, 24, 24)]
    q[1::4, -1] += 5
    vals_np = rs.randn(24, 4).astype(np.float32)
    x, keys = torch.from_numpy(q), torch.from_numpy(keys_np)
    vals = torch.from_numpy(vals_np)
    assert fp_kernel.unsupported(x, keys, vals) is None
    hit = _fp_check(x, keys, vals, jnp.asarray(q), jnp.asarray(keys_np),
                    jnp.asarray(vals_np))
    assert hit[::2].all() and not hit[1::4].any()


@pytest.mark.parametrize("block_b", [1, 7, 64, 100, 512])
def test_block_b_matches_the_interpreted_kernel(block_b):
    """Any positive ``block_b``: the reference pads the batch to min(block_b,
    B) rows and tiles it; the answer does not depend on it."""
    rs = np.random.RandomState(block_b)
    keys_np = rs.randint(0, 20, (10, 2)).astype(np.int32)
    q = rs.randint(0, 20, (100, 2)).astype(np.int32)
    vals_np = rs.randn(10, 3).astype(np.float32)
    x, keys = torch.from_numpy(q), torch.from_numpy(keys_np)
    vals = torch.from_numpy(vals_np)
    assert fp_kernel.unsupported(x, keys, vals, block_b=block_b) is None
    _fp_check(x, keys, vals, jnp.asarray(q), jnp.asarray(keys_np),
              jnp.asarray(vals_np), block_b=block_b, prepared=False)


def test_fastpath_unsupported_keeps_only_the_remaining_gaps():
    """None for every class of the former gaps; an error for sizes past
    32-bit indices (meta tensors), a ``block_b`` below 1, float queries
    (the guard sends them to ``torch_ref``) and value dtypes the library
    lacks."""
    def t(b, k, dtype, device="cpu"):
        return torch.zeros((b, k), dtype=dtype, device=device)

    i32, i8 = torch.int32, torch.int8
    for x, keys, vals, kw in [
            (t(8, 1, i32), t(4, 1, torch.float32), t(4, 2, torch.float32), {}),
            (t(8, 1, i8), t(4, 1, i8), t(4, 2, torch.float32), {}),
            (t(8, 1, i32), t(4, 1, i32), t(4, 2, torch.float16), {}),
            (t(8, 40, i32), t(4, 40, i32), t(4, 2, torch.float32), {}),
            (t(8, 1, i32), t(4, 1, i32), t(4, 2, torch.float32),
             {"block_b": 64}),
            (t(8, 1, i32), t(4, 1, i32), t(4, 2, torch.float32),
             {"block_b": 7}),
            (t(8, 1, torch.uint8), t(4, 1, torch.bfloat16),
             t(4, 2, torch.int64), {"block_b": 1024})]:
        assert fp_kernel.unsupported(x, keys, vals, **kw) is None
    x, keys, vals = t(8, 1, i32), t(4, 1, i32), t(4, 2, torch.float32)
    assert isinstance(fp_kernel.unsupported(x, keys, vals, block_b=0),
                      ValueError)
    assert isinstance(fp_kernel.unsupported(x.float(), keys, vals),
                      TypeError)
    assert isinstance(fp_kernel.unsupported(x, keys, vals.double()),
                      TypeError)
    assert isinstance(fp_kernel.unsupported(
        t(2 ** 30, 4, i32, "meta"), t(4, 4, i32, "meta"),
        t(4, 2, torch.float32, "meta")), ValueError)


@pytest.mark.parametrize("key_dtype", ["int8", "int32", "float32"])
def test_make_fastpath_wide_keys_and_fp16_values_match_reference(key_dtype):
    """``make_fastpath`` with an (8, 8) key shape, fp16 values and int8,
    int32 and float32 keys, against the reference's on hits and misses
    (float32 keys cast the queries to float, which miss the matcher's
    guard in both packages)."""
    rs = np.random.RandomState(5)
    keys = rs.randint(0, 4, (6, 8, 8)).astype(np.int32)

    def generic_t(xb):                       # fp16, as the table's values
        return (xb.reshape(xb.shape[0], -1).to(torch.float32).sum(
            -1, keepdim=True) * 0.25).half()

    def generic_j(xb):
        return (xb.reshape(xb.shape[0], -1).astype(jnp.float32).sum(
            -1, keepdims=True) * 0.25).astype(jnp.float16)

    vals = np.asarray(generic_j(jnp.asarray(keys)))
    port = core_fp.make_fastpath(
        generic_t, core_fp.FastPathTable.from_arrays(keys, vals),
        key_dtype=getattr(torch, key_dtype), value_dtype=torch.float16,
        device="cpu")
    ref = ref_core_fp.make_fastpath(
        generic_j, ref_core_fp.FastPathTable.from_arrays(keys, vals),
        key_dtype=getattr(jnp, key_dtype), value_dtype=jnp.float16)
    q = rs.randint(0, 4, (20, 8, 8)).astype(np.int32)
    q[::2] = keys[rs.randint(0, 6, 10)]
    for batch in (q, q[::2]):                     # mixed, then all hit
        out = port(torch.from_numpy(batch))
        expect = np.asarray(ref(jnp.asarray(batch)))
        assert out.shape == expect.shape and out.dtype == torch.float16
        np.testing.assert_allclose(out.float().numpy(),
                                   expect.astype(np.float32), rtol=2 ** -10)
