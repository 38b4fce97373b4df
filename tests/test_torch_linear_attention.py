"""Chunked linear attention of the PyTorch port against the JAX reference:
the port's plain version (``torch_ref``) against the reference op through
its plain entry (``xla``) and through its Pallas kernel in interpret mode,
at the cases of ``tests/test_linear_attention_kernel.py``; the port's
chunk math against the reference's (``tests/test_chunk_scan.py``: chunked
vs per-step, a step chain, state chained across calls); a ragged length;
and how the port's ``cuda`` entry treats host tensors.

Tolerance 5e-4, the reference's: the two sum the chunk products and
compose the chunk states in different orders (an associative scan there,
a loop here), with e^{+-la} factors up to e^{64}.
"""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import compat as ref_compat  # noqa: E402
from repro import configs as ref_configs  # noqa: E402
from repro.kernels.linear_attention import (  # noqa: E402
    linear_attention as ref_linear_attention)
from repro.models import chunk_scan as ref_chunk  # noqa: E402
from repro_torch.kernels import registry  # noqa: E402
from repro_torch.kernels.linear_attention import (  # noqa: E402
    kernel, linear_attention, ops)
from repro_torch.models import chunk_scan  # noqa: E402

TOL = 5e-4

#: (bh, T, dk, dv, chunk, inclusive, bonus, scalar decay): the cases of
#: tests/test_linear_attention_kernel.py:28-55
CASES = {
    **{f"t{t}c{c}-dv{dv}-{'incl' if inc else 'excl'}": (2, t, 8, dv, c, inc,
                                                         False, False)
       for t, c in [(32, 8), (64, 16), (64, 64)] for dv in (8, 16)
       for inc in (False, True)},
    "bonus": (3, 64, 8, 8, 16, False, True, False),
    "scalar_decay": (2, 32, 8, 12, 8, True, False, True),
}


def _arrays(bh, t, dk, dv, *, bonus=False, scalar=False, seed=2):
    rs = np.random.RandomState(seed)
    q, k = (rs.randn(bh, t, dk).astype(np.float32) for _ in range(2))
    v = rs.randn(bh, t, dv).astype(np.float32)
    lw = -np.clip(rs.rand(bh, t, 1 if scalar else dk), 1e-4, 1.0).astype(
        np.float32)
    u = rs.randn(bh, dk).astype(np.float32) if bonus else None
    return q, k, v, lw, u


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


def _ref_op(q, k, v, lw, u, **kw):
    """The reference op, jitted whole (one compile instead of one per
    primitive)."""
    return jax.jit(functools.partial(ref_linear_attention, **kw))(
        q, k, v, lw, bonus=u)


def _close(out, ref_out, tol=TOL):
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_out),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("case,ref_impl", [
    (case, impl) for case in sorted(CASES) for impl in ("xla", "interpret")])
def test_torch_ref_matches_reference(case, ref_impl):
    bh, t, dk, dv, chunk, inclusive, use_bonus, scalar = CASES[case]
    if ref_impl == "interpret" and not ref_compat.has_pallas_tpu():
        pytest.skip("Pallas TPU module not importable: the reference's "
                    "interpret entry would fall back to xla_ref")
    q, k, v, lw, u = _arrays(bh, t, dk, dv, bonus=use_bonus, scalar=scalar)
    ref_out = _ref_op(*map(_j, (q, k, v, lw, u)), inclusive=inclusive,
                      chunk=chunk, impl=ref_impl)
    out = linear_attention(*map(_t, (q, k, v, lw)), bonus=_t(u),
                           inclusive=inclusive, chunk=chunk,
                           impl="torch_ref")
    assert out.shape == (bh, t, dv) and out.dtype == torch.float32
    _close(out, ref_out)


@pytest.mark.parametrize("t,chunk", [(50, 16), (200, 64)])
def test_ragged_length(t, chunk):
    """A length that is no multiple of the chunk: the plain version clamps
    the chunk to a divisor of T, as the reference's plain entry does."""
    q, k, v, lw, u = _arrays(2, t, 8, 12, bonus=True)
    ref_out = _ref_op(*map(_j, (q, k, v, lw, u)), chunk=chunk, impl="xla")
    out = linear_attention(*map(_t, (q, k, v, lw)), bonus=_t(u),
                           chunk=chunk, impl="torch_ref")
    _close(out, ref_out)


def test_bf16_inputs_return_bf16():
    q, k, v, lw, u = _arrays(2, 32, 8, 8, bonus=True)
    args = [_t(a).to(torch.bfloat16) for a in (q, k, v, lw)]
    out = linear_attention(*args, bonus=_t(u), chunk=16, impl="torch_ref")
    ref_out = linear_attention(*(a.float() for a in args), bonus=_t(u),
                               chunk=16, impl="torch_ref")
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out.float(), ref_out, rtol=3e-2, atol=3e-2)


# -- the chunk math (tests/test_chunk_scan.py) ------------------------------------

@pytest.mark.parametrize("t,c,dk,dv,inclusive,use_bonus,scalar", [
    (16, 4, 4, 4, False, False, False), (32, 8, 8, 12, False, True, False),
    (64, 16, 4, 12, True, False, False), (128, 8, 8, 4, True, False, True),
    (64, 64, 8, 4, False, True, True), (128, 16, 4, 4, False, False, True)])
def test_chunked_equals_naive_and_reference(t, c, dk, dv, inclusive,
                                            use_bonus, scalar):
    rs = np.random.RandomState(1)
    q, k = (rs.randn(t, dk).astype(np.float32) for _ in range(2))
    v = rs.randn(t, dv).astype(np.float32)
    lw = -np.clip(rs.rand(t, 1 if scalar else dk), 1e-4, 1.0).astype(
        np.float32)
    u = rs.randn(dk).astype(np.float32) if use_bonus else None
    s0 = (rs.randn(dk, dv) * 0.1).astype(np.float32)
    kw = lambda conv: dict(bonus=conv(u), inclusive=inclusive,
                           init_state=conv(s0), return_state=True)
    arrays = (q, k, v, lw)
    o1, f1 = chunk_scan.chunked_linear_attention(*map(_t, arrays), chunk=c,
                                                 **kw(_t))
    o2, f2 = chunk_scan.naive_linear_attention(*map(_t, arrays), **kw(_t))
    ro, rf = jax.jit(functools.partial(
        ref_chunk.chunked_linear_attention, chunk=c, inclusive=inclusive,
        return_state=True))(*map(_j, arrays), bonus=_j(u),
                            init_state=_j(s0))
    _close(o1, o2)
    _close(f1, f2)
    _close(o1, ro)
    _close(f1, rf)


def test_step_chain_matches_reference():
    t, dk, dv = 12, 6, 5
    rs = np.random.RandomState(1)
    q, k = (rs.randn(t, dk).astype(np.float32) for _ in range(2))
    v = rs.randn(t, dv).astype(np.float32)
    lw = -np.clip(rs.rand(t, dk), 1e-4, 1.0).astype(np.float32)
    u = rs.randn(dk).astype(np.float32)
    state = torch.zeros((dk, dv))
    outs = []
    for i in range(t):
        o, state = chunk_scan.step_linear_attention(
            *(torch.from_numpy(a[i]) for a in (q, k, v, lw)), state,
            bonus=torch.from_numpy(u))
        outs.append(o)
    ref = ref_chunk.naive_linear_attention(*map(_j, (q, k, v, lw)),
                                           bonus=_j(u))
    _close(torch.stack(outs), ref, 1e-5)


def test_state_chaining_across_calls():
    """Splitting a sequence across two chunked calls == one call."""
    t, dk, dv, c = 64, 8, 8, 8
    rs = np.random.RandomState(1)
    q, k, v = (torch.from_numpy(rs.randn(t, d).astype(np.float32))
               for d in (dk, dk, dv))
    lw = torch.from_numpy(-np.clip(rs.rand(t, dk), 1e-4, 1.0)
                          .astype(np.float32))
    o_full = chunk_scan.chunked_linear_attention(q, k, v, lw, chunk=c,
                                                 inclusive=True)
    h = t // 2
    o1, s = chunk_scan.chunked_linear_attention(
        q[:h], k[:h], v[:h], lw[:h], chunk=c, inclusive=True,
        return_state=True)
    o2 = chunk_scan.chunked_linear_attention(
        q[h:], k[h:], v[h:], lw[h:], chunk=c, inclusive=True, init_state=s)
    _close(torch.cat([o1, o2]), o_full.numpy())


def test_leading_dims_are_independent_heads():
    """The batched form equals the one-head form on each head (the
    reference vmaps the one-head form)."""
    q, k, v, lw, u = map(_t, _arrays(3, 32, 8, 4, bonus=True))
    out = chunk_scan.chunked_linear_attention(q, k, v, lw, bonus=u, chunk=8)
    for i in range(3):
        torch.testing.assert_close(out[i], chunk_scan.chunked_linear_attention(
            q[i], k[i], v[i], lw[i], bonus=u[i], chunk=8))


@pytest.mark.parametrize("inclusive", [False, True])
def test_float64_inputs_compute_in_float64(inclusive):
    """float64 inputs are carried through in float64 (a witness of the fp32
    rounding): chunked == per-step to float64 rounding, and both equal the
    fp32 computation of the same inputs to its tolerance."""
    q, k, v, lw, u = (None if a is None else torch.from_numpy(a).double()
                      for a in _arrays(2, 64, 8, 12, bonus=not inclusive))
    o, s = chunk_scan.chunked_linear_attention(
        q, k, v, lw, bonus=u, inclusive=inclusive, chunk=16,
        return_state=True)
    o_naive, s_naive = chunk_scan.naive_linear_attention(
        q, k, v, lw, bonus=u, inclusive=inclusive, return_state=True)
    assert o.dtype == s.dtype == o_naive.dtype == s_naive.dtype \
        == torch.float64
    torch.testing.assert_close(o, o_naive, rtol=1e-11, atol=1e-11)
    torch.testing.assert_close(s, s_naive, rtol=1e-11, atol=1e-11)
    o32 = linear_attention(q.float(), k.float(), v.float(), lw.float(),
                           bonus=None if u is None else u.float(),
                           inclusive=inclusive, chunk=16, impl="torch_ref")
    o64 = linear_attention(q, k, v, lw, bonus=u, inclusive=inclusive,
                           chunk=16, impl="torch_ref")
    assert o64.dtype == torch.float64
    _close(o32, o64.numpy())


# -- the cuda entry on the host ---------------------------------------------------

def test_cuda_on_host_tensors_runs_torch_ref():
    """Host tensors asking for ``cuda`` miss the guard: ``torch_ref`` runs,
    one fallback is counted, and nothing launches."""
    q, k, v, lw, u = map(_t, _arrays(2, 32, 8, 8, bonus=True))
    counts = registry.default_registry.fallback_counts
    before = counts.get(("linear_attention", "cuda"), 0)
    launches = kernel.launches
    out = linear_attention(q, k, v, lw, bonus=u, chunk=16, impl="cuda")
    torch.testing.assert_close(out, linear_attention(
        q, k, v, lw, bonus=u, chunk=16, impl="torch_ref"))
    assert counts[("linear_attention", "cuda")] == before + 1
    assert kernel.launches == launches


@pytest.mark.parametrize("chunk,t,want", [
    (64, 4096, 64), (16, 100, 16), (8, 8, 16), (20, 20, 32), (40, 40, 64),
    (48, 96, 48), (128, 100, 128)])
def test_kernel_chunk_spans_short_sequences(chunk, t, want):
    """A chunk the library lacks is mapped to an instantiated one only
    where a single chunk spans the whole sequence (an exact change);
    otherwise it reaches the wrapper, which raises."""
    assert ops._kernel_chunk(chunk, t) == want


def test_wrapper_refuses_host_tensors():
    q, k, v, lw, _ = map(_t, _arrays(2, 32, 8, 8))
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernel.linear_attention_cuda(q, k, v, lw)


#: the reference's full-width configs whose mixer runs the linear attention
LINEAR_ARCHS = [a for a in ref_configs.ARCHS
                if ref_configs.get_config(a).mixer in ("rwkv6", "hymba")]


@pytest.mark.parametrize("arch", LINEAR_ARCHS)
def test_kernel_head_dims_take_every_reference_config(arch):
    """The kernel's head-dim limit takes the linear attention call of every
    full-width reference config: RWKV6 heads of rwkv_head_size, hymba's
    SSM heads (dk = ssm_state, dv = d_head; src/repro/models/ssm.py:87-99)."""
    cfg = ref_configs.get_config(arch)
    if cfg.mixer == "rwkv6":
        dk = dv = cfg.rwkv_head_size
    else:
        dk, dv = cfg.ssm_state, cfg.d_head
    assert max(dk, dv) <= kernel.MAX_HEAD_DIM


@pytest.mark.parametrize("bh,t,dk,dv,chunk", [
    (2, 128, 8, 8, 64), (3, 100, 8, 12, 16), (2, 90, 4, 8, 32),
    (1, 64, 16, 4, 16)])
def test_workspace_holds_each_chunk_state_and_decay(bh, t, dk, dv, chunk):
    """The wrapper's workspace has room for exactly what the chunk-parallel
    form keeps between its launches, as the plain version computes it: the
    state entering every chunk (a ragged tail is a chunk of its own) and
    every chunk's total log decay.  Those states, folded chunk by chunk with
    the plain version's chunk math, are the per-step recurrence's state at
    each chunk's first token."""
    rng = np.random.default_rng(7)
    q, k = (torch.from_numpy(rng.standard_normal((bh, t, dk),
                                                 dtype=np.float32))
            for _ in range(2))
    v = torch.from_numpy(rng.standard_normal((bh, t, dv), dtype=np.float32))
    lw = torch.from_numpy(-rng.uniform(1e-4, 1.0, (bh, t, dk))
                          .astype(np.float32))
    entering, totals = [], []
    state = torch.zeros(bh, dk, dv)
    for a in range(0, t, chunk):
        e = min(a + chunk, t)
        entering.append(state)
        totals.append(lw[:, a:e].sum(1))
        _, state = chunk_scan.chunked_linear_attention(
            q[:, a:e], k[:, a:e], v[:, a:e], lw[:, a:e], chunk=e - a,
            init_state=state, return_state=True)
    s_enter, la_tot = torch.stack(entering, 1), torch.stack(totals, 1)
    assert kernel.workspace_floats(bh, t, dk, dv, chunk) == (
        s_enter.numel() + la_tot.numel())

    step = torch.zeros(bh, dk, dv)
    for i in range(t):
        if i % chunk == 0:
            torch.testing.assert_close(s_enter[:, i // chunk], step,
                                       rtol=TOL, atol=TOL)
        _, step = chunk_scan.step_linear_attention(
            q[:, i], k[:, i], v[:, i], lw[:, i], step)
