"""K2's and K4's wider domain against the JAX reference, on the CPU: head
dims up to 256 (K2, both q/k and v; K4's keys) and 512 (K4's values), q,
k and v of mixed dtypes, and any integer attention window.

The reference's Pallas kernels take all of these
(``src/repro/kernels/attention/kernel.py``,
``src/repro/kernels/linear_attention/kernel.py``), so the port's kernels
take them too (``kernel.unsupported`` returns None, and ``ops._guard``
sends such a call on the card to the kernel).  Here the port's plain
versions, which the card holds the kernels to
(``tests/test_torch_*_cuda.py``, ``chip_smoke.py``), run the same inputs
as the reference's Pallas kernels under the interpreter.

Tolerances are tests/test_kernels.py's: 2e-4 when every input is fp32
(5e-4 for linear attention, tests/test_linear_attention_kernel.py), 3e-2
when any is half, as ``|port - ref| <= tol (1 + |ref|)``.  The Pallas
flash kernel rounds each probability to v's dtype before P.V and the plain
version does not, which moves an output by at most half an ulp of v's
dtype times the plain attention over |v| (the spread): where v is half
the limit takes one ulp of it (2^-7 bf16, 2^-10 fp16) times the spread
(tests/test_torch_half.py).  A row that the masks leave no column (a
window <= 0) is 0 in the Pallas kernel and the mean of v in the plain
version (ROADMAP "Faults", item 4): those rows are held to 0 in the
reference and left out of the comparison.
"""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from test_torch_matmul import _OnCard  # noqa: E402

from repro import compat as ref_compat  # noqa: E402
from repro.kernels import attention as ref_attention  # noqa: E402
from repro.kernels import linear_attention as ref_la  # noqa: E402
from repro_torch.kernels.attention import attention  # noqa: E402
from repro_torch.kernels.attention import kernel as attn_kernel  # noqa: E402
from repro_torch.kernels.attention import ops as attn_ops  # noqa: E402
from repro_torch.kernels.linear_attention import (  # noqa: E402
    kernel as la_kernel, linear_attention, ops as la_ops)

pytestmark = pytest.mark.skipif(
    not ref_compat.has_pallas_tpu(),
    reason="Pallas TPU module not importable: no interpret-mode kernels")

TOL = {"float32": 2e-4, "half": 3e-2}
LINATT_TOL = {"float32": 5e-4, "half": 3e-2}
#: one ulp of v's dtype: the P-rounding term's rtol where v is half
P_ROUND = {"float32": 0.0, "bfloat16": 2 ** -7, "float16": 2 ** -10}
F32, BF16, F16 = "float32", "bfloat16", "float16"
#: the (d, dv) pairs past the previous (192, 128)
WIDE_DIMS = [(256, 256), (128, 256), (256, 128)]
#: mixed (q, k, v) dtypes: half q/k with a v of the other half dtype, an
#: fp32 q over half k/v, and all three dtypes in one call
MIXED = [(BF16, BF16, F16), (F32, BF16, BF16), (F16, BF16, F32)]


def _both(a, dtype):
    """The same values as a torch and a jax array of ``dtype``."""
    return (torch.from_numpy(a).to(getattr(torch, dtype)),
            jnp.asarray(a).astype(getattr(jnp, dtype)))


def _tol(*dtypes, table=TOL):
    return table["float32" if set(dtypes) == {F32} else "half"]


def _valid_rows(sq, skv, causal, window):
    """Rows (q_offset = skv - sq) that the masks leave at least one
    column."""
    pos = skv - sq + np.arange(sq)
    hi = np.minimum(pos, skv - 1) if causal else np.full(sq, skv - 1)
    lo = np.maximum(pos - window + 1, 0) if window is not None \
        else np.zeros(sq, np.int64)
    return hi >= lo


def _attention_pair(dtypes, shapes, causal=True, window=None, seed=0):
    """The reference's Pallas kernel (interpret mode, tiles 32) and the
    port's plain version on the same inputs; the spread (the plain
    attention over |v|, fp32)."""
    rs = np.random.RandomState(seed)
    (q, jq), (k, jk), (v, jv) = (_both(rs.randn(*s).astype(np.float32), dt)
                                 for s, dt in zip(shapes, dtypes))
    flat = [t.flatten(0, 1) for t in (q, k, v)]
    assert attn_kernel.unsupported(*flat, window=window) is None
    assert attn_ops._guard(*(_OnCard(t) for t in (q, k, v)))
    ref = jax.jit(functools.partial(
        ref_attention.attention, causal=causal, window=window, block_q=32,
        block_kv=32, impl="pallas_interpret"))(jq, jk, jv)
    out = attention(q, k, v, causal=causal, window=window, impl="torch_ref")
    spread = attention(q.float(), k.float(), v.float().abs(), causal=causal,
                       window=window, impl="torch_ref")
    assert str(out.dtype) == f"torch.{ref.dtype}" == f"torch.{dtypes[0]}"
    return (np.asarray(ref, np.float32), out.float().numpy(),
            spread.numpy())


def _hold(ref, out, spread, dtypes, rows=None):
    """|out - ref| <= tol (1 + |ref|) + one ulp of v's dtype x spread, on
    ``rows`` (all by default)."""
    if rows is not None:
        ref, out, spread = (x[..., rows, :] for x in (ref, out, spread))
    tol = _tol(*dtypes)
    limit = tol + tol * np.abs(ref) + P_ROUND[dtypes[2]] * spread
    assert np.isfinite(out).all()
    assert (np.abs(out - ref) <= limit).all(), np.abs(out - ref).max()


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("dims", WIDE_DIMS, ids=str)
def test_attention_wide_head_dims(dims, dtype):
    """(256, 256), (128, 256) and (256, 128), GQA 4/2, causal."""
    d, dv = dims
    shapes = ((1, 4, 64, d), (1, 2, 64, d), (1, 2, 64, dv))
    ref, out, spread = _attention_pair((dtype,) * 3, shapes)
    _hold(ref, out, spread, (dtype,) * 3)


@pytest.mark.parametrize("dtypes", MIXED, ids="-".join)
def test_attention_mixed_dtypes(dtypes):
    """S in fp32 from the promoted inputs, P rounded to v's dtype, the
    output in q's dtype; a window and a wide head in the first."""
    shapes = ((1, 2, 96, 64), (1, 1, 96, 64), (1, 1, 96, 64))
    ref, out, spread = _attention_pair(dtypes, shapes, window=40, seed=1)
    _hold(ref, out, spread, dtypes)
    if dtypes == MIXED[0]:
        shapes = ((1, 2, 64, 256), (1, 2, 64, 256), (1, 2, 64, 256))
        _hold(*_attention_pair(dtypes, shapes, seed=2), dtypes)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [0, -5, 3])
def test_attention_any_window(window, causal):
    """Column c of row r is kept where c > r - window, for a window <= 0
    too; rows the masks leave no column are 0 in the Pallas kernel."""
    sq = skv = 96
    shapes = ((1, 2, sq, 32), (1, 2, skv, 32), (1, 2, skv, 32))
    ref, out, spread = _attention_pair((F32,) * 3, shapes, causal=causal,
                                       window=window, seed=3)
    rows = _valid_rows(sq, skv, causal, window)
    assert (ref[..., ~rows, :] == 0).all()
    assert rows.any() == (window > 0 or not causal)
    if rows.any():
        _hold(ref, out, spread, (F32,) * 3, rows)


def _linatt_pair(dtypes, bh, t, dk, dv, inclusive, bonus, seed=0):
    rs = np.random.RandomState(seed)
    (q, jq), (k, jk) = (_both(0.3 * rs.randn(bh, t, dk).astype(np.float32),
                              dt) for dt in dtypes[:2])
    v, jv = _both(rs.randn(bh, t, dv).astype(np.float32), dtypes[2])
    lw = -rs.uniform(0.01, 1.0, (bh, t, dk)).astype(np.float32)
    u = rs.randn(bh, dk).astype(np.float32) if bonus else None
    lw_t = torch.from_numpy(lw)
    u_t = None if u is None else torch.from_numpy(u)
    assert la_kernel.unsupported(q, k, v, lw_t, u_t, inclusive=inclusive,
                                 chunk=16) is None
    assert la_ops._guard(*(_OnCard(t) for t in (q, k, v, lw_t)))
    ref = jax.jit(functools.partial(
        ref_la.linear_attention, inclusive=inclusive, chunk=16,
        impl="pallas_interpret"))(
        jq, jk, jv, jnp.asarray(lw),
        bonus=None if u is None else jnp.asarray(u))
    out = linear_attention(q, k, v, lw_t, bonus=u_t, inclusive=inclusive,
                           chunk=16, impl="torch_ref")
    assert str(out.dtype) == f"torch.{ref.dtype}" == f"torch.{dtypes[2]}"
    ref = np.asarray(ref, np.float32)
    tol = _tol(*dtypes, table=LINATT_TOL)
    diff = np.abs(out.float().numpy() - ref)
    assert (diff <= tol + tol * np.abs(ref)).all(), diff.max()


@pytest.mark.parametrize("inclusive,bonus", [(False, True), (True, False)])
def test_linear_attention_wide_heads(inclusive, bonus):
    """GLA-1.3B's head dims, dk 256 and dv 512: RWKV6's exclusive
    recurrence with the bonus and the SSM heads' inclusive one."""
    _linatt_pair((F32,) * 3, 1, 64, 256, 512, inclusive, bonus)


@pytest.mark.parametrize("dtypes", [(F16, F32, BF16), (BF16, BF16, F32)],
                         ids="-".join)
def test_linear_attention_mixed_dtypes(dtypes):
    """Each input cast to fp32 on its own, the output in v's dtype."""
    _linatt_pair(dtypes, 2, 64, 32, 48, False, True, seed=1)


def _z(*shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype)


def test_unsupported_takes_the_new_classes_and_names_each_gap():
    """``kernel.unsupported`` returns None for every newly taken class
    and still returns an error for each remaining gap (PERF.md §6)."""
    f32, bf16, f16 = torch.float32, torch.bfloat16, torch.float16
    for d, dv in WIDE_DIMS + [(200, 16), (16, 160), (8, 255)]:
        for dt in (f32, bf16, f16):
            assert attn_kernel.unsupported(
                _z(4, 8, d, dtype=dt), _z(2, 8, d, dtype=dt),
                _z(2, 8, dv, dtype=dt)) is None
    for dts in MIXED:
        q, k, v = (_z(2, 8, 64, dtype=getattr(torch, dt)) for dt in dts)
        assert attn_kernel.unsupported(q, k, v) is None
    for window in (0, -5, 3, -2 ** 40, 2 ** 40):
        assert attn_kernel.unsupported(_z(2, 8, 16), _z(2, 8, 16),
                                       _z(2, 8, 16), window=window) is None
    attn_gaps = {
        "d 264": ((_z(2, 8, 264), _z(2, 8, 264), _z(2, 8, 16)), {}),
        "dv 264": ((_z(2, 8, 16), _z(2, 8, 16), _z(2, 8, 264)), {}),
        "tiles (256, 64)": ((_z(2, 8, 16),) * 3, {"block_q": 256}),
        "tiles (64, 128)": ((_z(2, 8, 16),) * 3, {"block_kv": 128}),
        "65536 heads": ((_z(65536, 1, 1),) * 3, {}),
    }
    for label, (args, kw) in attn_gaps.items():
        assert isinstance(attn_kernel.unsupported(*args, **kw),
                          ValueError), label

    for dk, dv in [(256, 512), (136, 8), (8, 300), (256, 1)]:
        for dt in (f32, bf16, f16):
            assert la_kernel.unsupported(
                _z(2, 16, dk, dtype=dt), _z(2, 16, dk, dtype=dt),
                _z(2, 16, dv, dtype=dt), _z(2, 16, dk), _z(2, dk)) is None
    for dts in [(f16, f32, bf16), (bf16, bf16, f32), (f32, f16, f16)]:
        q, k, v = (_z(2, 16, 8, dtype=dt) for dt in dts)
        assert la_kernel.unsupported(q, k, v, _z(2, 16, 8)) is None
    la_gaps = {
        "dk 264": ((264, 8), {}),
        "dv 520": ((8, 520), {}),
        "chunk 48": ((8, 8), {"chunk": 48}),
        "inclusive + bonus": ((8, 8), {"inclusive": True}),
    }
    for label, ((dk, dv), kw) in la_gaps.items():
        err = la_kernel.unsupported(_z(2, 16, dk), _z(2, 16, dk),
                                    _z(2, 16, dv), _z(2, 16, dk),
                                    _z(2, dk), **kw)
        assert isinstance(err, ValueError), label
    # log_w and the bonus stay fp32, as the ops layer passes them
    assert isinstance(la_kernel.unsupported(
        _z(2, 16, 8), _z(2, 16, 8), _z(2, 16, 8),
        _z(2, 16, 8, dtype=torch.float16)), TypeError)
