"""The ``cuda`` entries' guards, as properties over dtypes, shapes and
tiles, on the CPU.

Each family's entry is registered in a private registry whose guard sees
the call's tensors through ``_OnCard`` (``tests/test_torch_matmul.py``):
their own shapes, dtypes and strides on a CUDA device.  The entry itself
is the port's (``ops._*_cuda``, with its copies and casts); the kernel
wrapper it calls is replaced by a stand-in that raises what the wrapper
raises on exactly the arguments it gets (``kernel.unsupported``) and
counts a launch otherwise.  For every drawn call:

* the guard is the card and the reference's precondition: it is True on
  the stand-in card exactly where the test's expression of that
  precondition says (tile, chunk and ``assume_divisible`` divisibility
  left out: the kernels mask their edges);
* guard True => one launch and no fallback, or, for a call the kernel
  does not take although the reference's kernel does (a domain gap, ROADMAP
  "Kernel work"), an error from the entry or the wrapper, with no launch
  and no fallback: it never runs the plain version on the card;
* guard False => ``dispatch`` returns ``torch_ref``'s answer, with one
  fallback counted and no launch;
* on the host the guard misses, and wherever the reference's registry
  returns a value for the same numpy input on the CPU, the port's returns
  one too and never raises: the plain version's answer, within the
  family's tolerance of the reference's.
"""
import contextlib

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from hypothesis import given, settings, strategies as st  # noqa: E402
from test_torch_matmul import _OnCard  # noqa: E402

from repro.kernels import attention as ref_attention  # noqa: E402
from repro.kernels import fastpath as ref_fastpath  # noqa: E402
from repro.kernels import linear_attention as ref_la  # noqa: E402
from repro.kernels import matmul as ref_matmul  # noqa: E402
from repro.kernels import rmsnorm as ref_rmsnorm  # noqa: E402
from repro_torch.kernels import registry  # noqa: E402
from repro_torch.kernels.attention import kernel as attn_kernel  # noqa: E402
from repro_torch.kernels.attention import ops as attn_ops  # noqa: E402
from repro_torch.kernels.fastpath import kernel as fp_kernel  # noqa: E402
from repro_torch.kernels.fastpath import ops as fp_ops  # noqa: E402
from repro_torch.kernels.linear_attention import (  # noqa: E402
    kernel as la_kernel, ops as la_ops)
from repro_torch.kernels.matmul import kernel as mm_kernel  # noqa: E402
from repro_torch.kernels.matmul import ops as mm_ops  # noqa: E402
from repro_torch.kernels.rmsnorm import kernel as rms_kernel  # noqa: E402
from repro_torch.kernels.rmsnorm import ops as rms_ops  # noqa: E402

FLOATS = ("float32", "bfloat16", "float16")
#: the reference's tolerances (tests/test_kernels.py,
#: tests/test_linear_attention_kernel.py) in fp32, and the low-precision
#: one; compared as |port - ref| <= tol (1 + |ref|)
TOL = {"rmsnorm": 1e-5, "attention": 2e-4, "matmul": 1e-5,
       "linear_attention": 5e-4, "fastpath": 1e-6}
LOW_TOL = 3e-2
#: each property's examples (fixed: derandomized); few distinct shapes, so
#: the reference's eager ops compile each shape once
PROPS = dict(max_examples=16, deadline=None, derandomize=True,
             database=None)

#: family -> (the guard, the kernel module, the wrapper's name, the
#: ``cuda`` entry, the ``torch_ref`` entry)
FAMILIES = {
    "rmsnorm": (rms_ops._guard, rms_kernel, "rmsnorm_cuda",
                rms_ops._rmsnorm_cuda, rms_ops._rmsnorm_torch_ref),
    "rmsnorm_pair": (rms_ops._pair_guard, rms_kernel, "rmsnorm_pair_cuda",
                     rms_ops._rmsnorm_pair_cuda,
                     rms_ops._rmsnorm_pair_torch_ref),
    "attention": (attn_ops._guard, attn_kernel, "flash_attention_cuda",
                  attn_ops._attention_cuda, attn_ops._attention_torch_ref),
    "matmul": (mm_ops._guard, mm_kernel, "matmul_cuda", mm_ops._matmul_cuda,
               mm_ops._matmul_torch_ref),
    "linear_attention": (la_ops._guard, la_kernel, "linear_attention_cuda",
                         la_ops._linatt_cuda, la_ops._linatt_torch_ref),
    "fastpath": (fp_ops._guard, fp_kernel, "fastpath_cuda",
                 fp_ops._lookup_cuda, fp_ops._lookup_torch_ref),
}

#: a stand-in wrapper's output: the wrapper's shapes (contents unread)
OUTPUTS = {
    "rmsnorm_cuda": lambda x, w: torch.empty_like(x),
    "rmsnorm_pair_cuda": lambda x0, w0, x1, w1: (torch.empty_like(x0),
                                                 torch.empty_like(x1)),
    "flash_attention_cuda": lambda q, k, v: q.new_zeros(*q.shape[:2],
                                                        v.shape[-1]),
    "matmul_cuda": lambda x, y: x.new_zeros(x.shape[0], y.shape[1]),
    "linear_attention_cuda": lambda q, k, v, lw, u=None: v.new_zeros(
        v.shape),
    "fastpath_cuda": lambda x, k, v: (v.new_zeros(x.shape[0], v.shape[1]),
                                      x.new_zeros(x.shape[0],
                                                  dtype=torch.bool)),
}
#: the wrapper's keywords its ``unsupported`` reads, by wrapper
CHECKED = {
    "rmsnorm_cuda": ("block_rows",),
    "rmsnorm_pair_cuda": ("block_rows",),
    "flash_attention_cuda": ("window", "block_q", "block_kv"),
    "matmul_cuda": ("bm", "bn", "bk", "out_dtype", "assume_divisible"),
    "linear_attention_cuda": ("inclusive", "chunk"),
    "fastpath_cuda": ("block_b",),
}


def _card(a):
    return _OnCard(a) if isinstance(a, torch.Tensor) else a


def _both(a, dtype):
    """A numpy array as the port's tensor of ``dtype`` and the reference's
    array of the same values: rounded to ``dtype``, then held in fp32 for a
    floating ``dtype`` (so the reference compiles each shape once, not once
    a dtype; the low-precision tolerance covers the port's rounding)."""
    t = torch.from_numpy(a).to(getattr(torch, dtype))
    if t.is_floating_point():
        return t, jnp.asarray(t.to(torch.float32).numpy())
    return t, jnp.asarray(a).astype(getattr(jnp, dtype))


@contextlib.contextmanager
def _registry(family, on_card=True):
    """A registry with ``family``'s plain entry and its ``cuda`` entry, on
    a stand-in card (or on the host); yields it, the list of the
    stand-in's launches and the list of the errors it raised."""
    guard, kmod, wrapper, entry, plain = FAMILIES[family]
    launched, gaps = [], []

    def stand_in(*args, **kwargs):
        checked = {k: kwargs[k] for k in CHECKED[wrapper] if k in kwargs}
        if wrapper == "rmsnorm_pair_cuda":
            x0, w0, x1, w1 = args
            err = (kmod.unsupported(x0, w0, **checked)
                   or kmod.unsupported(x1, w1, **checked))
            if err is None and (x1.dtype != x0.dtype
                                or x1.shape[-1] != x0.shape[-1]):
                err = ValueError("one launch normalises one dtype and width")
        else:
            err = kmod.unsupported(*args, **checked)
        if err is not None:
            gaps.append(err)
            raise err
        launched.append(wrapper)
        return OUTPUTS[wrapper](*args)

    wrap = _card if on_card else (lambda a: a)
    reg = registry.KernelRegistry()
    reg.register(family, "torch_ref")(plain)
    reg.register(family, "cuda", available=lambda: True, supports_grad=False,
                 guard=lambda *a, **kw: guard(
                     *map(wrap, a), **{k: wrap(v) for k, v in kw.items()})
                 )(entry)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(kmod, wrapper, stand_in)
        yield reg, launched, gaps


def _close(out, ref, tol):
    outs = out if isinstance(out, tuple) else (out,)
    refs = ref if isinstance(ref, tuple) else (ref,)
    for o, r in zip(outs, refs):
        low = o.dtype in (torch.bfloat16, torch.float16)
        o = o.to(torch.float64).numpy()
        r = np.asarray(jnp.asarray(r).astype(jnp.float32), np.float64)
        assert o.shape == r.shape
        t = LOW_TOL if low else tol
        assert np.all(np.abs(o - r) <= t * (1 + np.abs(r))), \
            float(np.max(np.abs(o - r)))


def _same(out, plain):
    for o, p in zip(out if isinstance(out, tuple) else (out,),
                    plain if isinstance(plain, tuple) else (plain,)):
        torch.testing.assert_close(o, p, rtol=0, atol=0)


def _run(family, args, kwargs, ref_fn, tol_family=None):
    """Dispatch ``family`` with ``impl="cuda"`` on the host and on the
    stand-in card and check the properties (module docstring).  Returns
    whether the guard took the call on the card, and whether the call
    raised there (a domain gap)."""
    try:
        ref = ref_fn()
    except Exception:        # the reference answers nothing: no claim
        ref = None
    plain = None
    with _registry(family, on_card=False) as (reg, launched, _):
        try:
            plain = reg.dispatch(family, "cuda", *args, **kwargs)
        except Exception:
            if ref is not None:
                raise
        assert not launched and reg.fallback_counts == {(family, "cuda"): 1}
    if ref is not None:
        _close(plain, ref, TOL[tol_family or family])
    with _registry(family) as (reg, launched, gaps):
        took = FAMILIES[family][0](*map(_card, args), **{
            k: _card(v) for k, v in kwargs.items()})
        try:
            out = reg.dispatch(family, "cuda", *args, **kwargs)
        except Exception as err:
            assert not launched
            if not took:     # a miss that the plain version refuses
                assert plain is None
                assert reg.fallback_counts == {(family, "cuda"): 1}
                return took, False
            assert reg.fallback_counts == {}
            assert not gaps or err is gaps[0]
            return took, True
        if took:
            assert launched == [FAMILIES[family][2]]
            assert reg.fallback_counts == {}
        else:
            assert not launched
            assert reg.fallback_counts == {(family, "cuda"): 1}
            _same(out, plain)
    return took, False


@settings(**PROPS)
@given(dtype=st.sampled_from(FLOATS + ("float64",)),
       rows=st.sampled_from([3, 6]), lead=st.booleans(),
       d=st.sampled_from([8, 33, 64]), transposed=st.booleans(),
       block_rows=st.sampled_from([4, 4, 8]), seed=st.integers(0, 999))
def test_rmsnorm(dtype, rows, lead, d, transposed, block_rows,
                 seed):
    rs = np.random.RandomState(seed)
    shape = (2, rows, d) if lead else (rows, d)
    x, jx = _both(rs.randn(*shape).astype(np.float32), dtype)
    if transposed:
        x = x.transpose(-1, -2).contiguous().transpose(-1, -2)
    w = rs.randn(d).astype(np.float32)
    took, gap = _run("rmsnorm", (x, torch.from_numpy(w)),
                dict(eps=1e-6, block_rows=block_rows),
                lambda: ref_rmsnorm.rmsnorm(jx, jnp.asarray(w), impl="xla"))
    assert took
    assert gap == (getattr(torch, dtype) not in rms_kernel._DTYPE_CODES
                   or block_rows not in rms_kernel.BLOCK_ROWS)


@settings(**PROPS)
@given(dtypes=st.sampled_from([("float32", "float32"),
                               ("bfloat16", "bfloat16"),
                               ("float16", "float16"),
                               ("float32", "bfloat16")]),
       heads=st.sampled_from([(4, 2), (2, 2)]), widths=st.booleans(),
       seed=st.integers(0, 999))
def test_rmsnorm_pair(dtypes, heads, widths, seed):
    rs = np.random.RandomState(seed)
    d1 = 32 if widths else 16
    q, jq = _both(rs.randn(2, heads[0], 3, 32).astype(np.float32), dtypes[0])
    k, jk = _both(rs.randn(2, heads[1], 3, d1).astype(np.float32), dtypes[1])
    wq, wk = rs.randn(32).astype(np.float32), rs.randn(d1).astype(np.float32)
    took, gap = _run("rmsnorm_pair",
                (q, torch.from_numpy(wq), k, torch.from_numpy(wk)),
                dict(eps=1e-6),
                lambda: (ref_rmsnorm.rmsnorm(jq, jnp.asarray(wq), impl="xla"),
                         ref_rmsnorm.rmsnorm(jk, jnp.asarray(wk),
                                             impl="xla")),
                tol_family="rmsnorm")
    assert took
    assert gap == (not widths or dtypes[0] != dtypes[1]
                   or getattr(torch, dtypes[0]) not in rms_kernel._DTYPE_CODES)


@settings(**PROPS)
@given(dtype=st.sampled_from(FLOATS), b=st.integers(1, 2),
       hk=st.integers(1, 2), group=st.integers(1, 2),
       sq=st.sampled_from([5, 16]), extra_kv=st.sampled_from([0, 3]),
       dims=st.sampled_from([(16, 16), (8, 16), (200, 16), (16, 160),
                             (256, 256), (264, 16), (16, 272)]),
       tiles=st.sampled_from([(64, 64), (128, 32), (256, 64), (64, 128)]),
       causal=st.booleans(),
       window=st.sampled_from([None, None, 4, 0, -3]),
       seed=st.integers(0, 999))
def test_attention(dtype, b, hk, group, sq, extra_kv, dims,
                   tiles, causal, window, seed):
    rs = np.random.RandomState(seed)
    d, dv = dims
    skv = sq + extra_kv
    q, jq = _both(rs.randn(b, hk * group, sq, d).astype(np.float32), dtype)
    k, jk = _both(rs.randn(b, hk, skv, d).astype(np.float32), dtype)
    v, jv = _both(rs.randn(b, hk, skv, dv).astype(np.float32), dtype)
    kw = dict(causal=causal, window=window, scale=None, q_offset=None,
              block_q=tiles[0], block_kv=tiles[1], swa_impl="full")
    took, gap = _run("attention", (q, k, v), kw,
                lambda: ref_attention.attention(jq, jk, jv, impl="xla_ref",
                                                **kw))
    assert took
    assert gap == (getattr(torch, dtype) not in attn_kernel._DTYPE_CODES
                   or d > attn_kernel.MAX_HEAD_DIM
                   or dv > attn_kernel.MAX_VALUE_HEAD_DIM
                   or tiles[0] not in attn_kernel.BLOCK_Q
                   or tiles[1] not in attn_kernel.BLOCK_KV)


@settings(**PROPS)
@given(dtype=st.sampled_from(FLOATS + ("int32",)),
       y_dtype=st.sampled_from((None,) + FLOATS), m=st.integers(1, 40),
       k=st.integers(1, 40), n=st.integers(1, 40),
       tiles=st.sampled_from(list(mm_kernel.TILES[:4])
                             + [(256, 256, 128), (48, 48, 48)]),
       out=st.sampled_from((None,) + FLOATS), assume=st.booleans(),
       seed=st.integers(0, 999))
def test_matmul(dtype, y_dtype, m, k, n, tiles, out, assume, seed):
    """Every float operand pair (y's dtype x's when None) into every
    float output (x's when None)."""
    rs = np.random.RandomState(seed)
    y_dtype = y_dtype if y_dtype and dtype != "int32" else dtype
    x, jx = _both(rs.randn(m, k).astype(np.float32), dtype)
    y, jy = _both(rs.randn(k, n).astype(np.float32), y_dtype)
    bm, bn, bk = tiles
    out_dtype = getattr(torch, out) if out else None
    took, gap = _run("matmul", (x, y),
                dict(bm=bm, bn=bn, bk=bk, out_dtype=out_dtype,
                     assume_divisible=assume),
                lambda: ref_matmul.matmul(
                    jx, jy, bm=bm, bn=bn, bk=bk, impl="xla_ref",
                    out_dtype=getattr(jnp, out) if out else None,
                    assume_divisible=assume))
    assert took == (dtype != "int32")
    assert gap == (took and tiles not in mm_kernel.TILES)


@settings(**dict(PROPS, max_examples=10))
@given(dtype=st.sampled_from(FLOATS), bh=st.sampled_from([2]),
       t=st.sampled_from([64]), dk=st.sampled_from([8, 136, 264]),
       dv=st.sampled_from([8, 520]),
       chunk=st.sampled_from([16, 32, 48, 64]),
       inclusive=st.booleans(), bonus=st.booleans(), scalar=st.booleans(),
       seed=st.integers(0, 999))
def test_linear_attention(dtype, bh, t, dk, dv, chunk,
                          inclusive, bonus, scalar, seed):
    rs = np.random.RandomState(seed)
    q, jq = _both(0.3 * rs.randn(bh, t, dk).astype(np.float32), dtype)
    k, jk = _both(0.3 * rs.randn(bh, t, dk).astype(np.float32), dtype)
    v, jv = _both(rs.randn(bh, t, dv).astype(np.float32), dtype)
    lw = -rs.uniform(0.01, 1.0, (bh, t, 1 if scalar else dk)).astype(
        np.float32)
    u = rs.randn(bh, dk).astype(np.float32) if bonus else None
    lw_t = torch.from_numpy(lw).expand(bh, t, dk)
    kw = dict(bonus=None if u is None else torch.from_numpy(u),
              inclusive=inclusive, chunk=chunk)
    took, gap = _run("linear_attention", (q, k, v, lw_t), kw,
                lambda: ref_la.linear_attention(
                    jq, jk, jv, jnp.broadcast_to(jnp.asarray(lw), (bh, t, dk)),
                    bonus=None if u is None else jnp.asarray(u),
                    inclusive=inclusive, chunk=chunk, impl="xla_ref"))
    fits = chunk in la_kernel.CHUNKS or chunk >= t
    assert took
    assert gap == (getattr(torch, dtype) not in la_kernel._DTYPE_CODES
                   or dk > la_kernel.MAX_HEAD_DIM
                   or dv > la_kernel.MAX_VALUE_HEAD_DIM
                   or not fits or (bonus and inclusive))


@settings(**PROPS)
@given(x_dtype=st.sampled_from(["int32", "int64", "int8", "uint8",
                                "float32"]),
       key_dtype=st.sampled_from(["int32", "int64", "int16", "uint8",
                                  "float32", "float16"]),
       value_dtype=st.sampled_from(["float32", "bfloat16", "float16",
                                    "int32"]),
       b=st.sampled_from([5, 20]), n=st.sampled_from([0, 7]),
       width=st.sampled_from([1, 2, 33]),
       block_b=st.sampled_from([1, 7, 32, 64, 256, 512]),
       seed=st.integers(0, 999))
def test_fastpath(x_dtype, key_dtype, value_dtype, b, n, width,
                  block_b, seed):
    rs = np.random.RandomState(seed)
    keys = rs.randint(0, 5, (n, width))
    x = np.concatenate([keys[rs.randint(0, n, b // 2)] if n else
                        np.zeros((0, width), np.int64),
                        rs.randint(0, 5, (b - (b // 2 if n else 0), width))])
    vals = rs.randint(-3, 4, (n, 2)).astype(np.float32)
    xt, jx = _both(x.astype(np.float32 if x_dtype == "float32" else
                            getattr(np, x_dtype)), x_dtype)
    kt, jk = _both(keys.astype(np.float32 if key_dtype.startswith("float")
                               else getattr(np, key_dtype)), key_dtype)
    vt, jv = _both(vals, value_dtype)
    jv = jv.astype(getattr(jnp, value_dtype))       # the sums' dtype
    took, gap = _run("fastpath", (xt, kt, vt),
                dict(block_b=block_b),
                lambda: ref_fastpath.lookup(jx, jk, jv, impl="xla_ref"))
    assert took == (x_dtype != "float32")
    assert not gap
