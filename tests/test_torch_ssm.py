"""The port's SSM heads (``models/ssm.py``) against the JAX reference at
reduced hymba-1.5b, in fp32, from the same parameters: the parameter and
cache layouts, the causal conv and the gates, the full-sequence
``apply_ssm`` at every chunk, a chain of ``decode_ssm`` steps (state and
conv written in place), and the linear attention as the SSM calls it
(inclusive, no bonus, a ``(BH, T, 1)`` decay) through the port's plain
version against the reference's plain entry and its Pallas kernel in
interpret mode.

Tolerance 1e-4, as tests/test_torch_rwkv6.py: the two frameworks sum the
matrix products and the chunk states in different orders.
"""
import dataclasses
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
from repro.models import KernelOptions as RefKernelOptions  # noqa: E402
from repro.models import ssm as ref_ssm  # noqa: E402
from repro_torch import compat, configs  # noqa: E402
from repro_torch.kernels.linear_attention import linear_attention  # noqa: E402
from repro_torch.models import KernelOptions, params_from_numpy  # noqa: E402
from repro_torch.models import ssm  # noqa: E402

TOL = 1e-4
B, S = 2, 32
ARCH = "hymba-1.5b"


@pytest.fixture(scope="module")
def setup():
    ref_cfg = ref_configs.get_reduced(ARCH).replace(compute_dtype="float32")
    cfg = configs.get_reduced(ARCH).replace(compute_dtype="float32")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
    ref_params = ref_ssm.init_ssm(jax.random.PRNGKey(0), ref_cfg)
    # Non-trivial gates: the reference draws dt_bias and a_log as zeros
    # and skip_d as ones; random values reach every term.
    rs = np.random.RandomState(3)
    h = cfg.ssm_heads
    np_params = dict(jax.tree_util.tree_map(np.asarray, ref_params),
                     dt_bias=rs.randn(h).astype(np.float32),
                     a_log=(rs.randn(h) * 0.5).astype(np.float32),
                     skip_d=rs.randn(h).astype(np.float32))
    x = rs.randn(B, S, cfg.d_model).astype(np.float32)
    return dict(ref_cfg=ref_cfg, cfg=cfg,
                ref_params=jax.tree_util.tree_map(jnp.asarray, np_params),
                params=params_from_numpy(np_params, "cpu"), x=x)


def _close(out, ref_out, tol=TOL):
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_out),
                               rtol=tol, atol=tol)


def test_param_and_cache_layout_match_reference(setup):
    s = setup
    fresh = ssm.init_ssm(torch.Generator().manual_seed(0), s["cfg"])
    assert {k: tuple(v.shape) for k, v in fresh.items()} == {
        k: tuple(v.shape) for k, v in s["ref_params"].items()}
    assert all(v.dtype == torch.float32 for v in fresh.values())
    assert ssm.ssm_axes(s["cfg"]) == ref_ssm.ssm_axes(s["ref_cfg"])
    assert ssm.ssm_cache_axes(s["cfg"]) == ref_ssm.ssm_cache_axes(
        s["ref_cfg"])
    for dtype, ref_dtype in ((torch.float32, jnp.float32),
                             (torch.bfloat16, jnp.bfloat16)):
        cache = ssm.init_ssm_cache(s["cfg"], B, dtype=dtype, device="cpu")
        ref_cache = ref_ssm.init_ssm_cache(s["ref_cfg"], B, dtype=ref_dtype)
        assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
                for k, v in cache.items()} == {
            k: (tuple(v.shape), str(v.dtype)) for k, v in ref_cache.items()}
        assert not any(v.any() for v in cache.values())
    assert ssm.LOG_A_MIN == ref_ssm.LOG_A_MIN
    assert ssm._CONV_K == ref_ssm._CONV_K


@pytest.mark.parametrize("with_state", [False, True])
def test_conv_causal_matches_reference(setup, with_state):
    rs = np.random.RandomState(4)
    di = ssm._d_inner(setup["cfg"])
    xi = rs.randn(B, 7, di).astype(np.float32)
    kern = rs.randn(ssm._CONV_K, di).astype(np.float32)
    state = (rs.randn(B, ssm._CONV_K - 1, di).astype(np.float32)
             if with_state else None)
    ref_out = ref_ssm._conv_causal(jnp.asarray(xi), jnp.asarray(kern),
                                   None if state is None
                                   else jnp.asarray(state))
    out = ssm._conv_causal(torch.from_numpy(xi), torch.from_numpy(kern),
                           None if state is None else torch.from_numpy(state))
    _close(out, ref_out)


def test_gates_match_reference(setup):
    s = setup
    ref_out = ref_ssm._gates(s["ref_params"], jnp.asarray(s["x"]))
    out = ssm._gates(s["params"], torch.from_numpy(s["x"]))
    for o, r in zip(out, ref_out):
        assert tuple(o.shape) == r.shape
        _close(o, r)
    log_a = out[3]
    assert log_a.min() >= ssm.LOG_A_MIN and log_a.max() <= -1e-4


@pytest.mark.parametrize("chunk_len", [8, 16, 64])
def test_apply_ssm_matches_reference(setup, chunk_len):
    s = setup
    ref_out = jax.jit(functools.partial(
        ref_ssm.apply_ssm, cfg=s["ref_cfg"],
        opts=RefKernelOptions(impl="xla", chunk_len=chunk_len)))(
        s["ref_params"], jnp.asarray(s["x"]))
    out = ssm.apply_ssm(s["params"], torch.from_numpy(s["x"]), s["cfg"],
                        KernelOptions(impl="torch_ref", chunk_len=chunk_len))
    assert tuple(out.shape) == (B, S, s["cfg"].d_model)
    _close(out, ref_out)


def test_decode_ssm_chain_matches_reference(setup):
    """Six decode steps from a random state and conv ring: the output and
    both cache leaves after every step; the port writes them in place."""
    s = setup
    cfg = s["cfg"]
    rs = np.random.RandomState(5)
    np_cache = {
        "state": (rs.randn(B, cfg.ssm_heads, cfg.ssm_state, cfg.d_head)
                  * 0.1).astype(np.float32),
        "conv": rs.randn(B, ssm._CONV_K - 1, ssm._d_inner(cfg)).astype(
            np.float32)}
    ref_cache = jax.tree_util.tree_map(jnp.asarray, np_cache)
    cache = compat.tree_map(lambda a: torch.from_numpy(a.copy()), np_cache)
    ref_step = jax.jit(functools.partial(
        ref_ssm.decode_ssm, cfg=s["ref_cfg"],
        opts=RefKernelOptions(impl="xla")))
    opts = KernelOptions(impl="torch_ref")
    for t in range(6):
        xt = s["x"][:, t:t + 1]
        ref_y, ref_cache = ref_step(s["ref_params"], ref_cache,
                                    jnp.asarray(xt), pos=jnp.int32(t))
        y, out_cache = ssm.decode_ssm(s["params"], cache,
                                      torch.from_numpy(xt), t, cfg, opts)
        assert out_cache is cache and tuple(y.shape) == (B, 1, cfg.d_model)
        _close(y, ref_y)
        for name in cache:
            _close(cache[name], ref_cache[name])


def test_decode_chain_matches_forward(setup):
    """A chain of decode steps from an empty cache gives the full-sequence
    forward's outputs (the per-step against the chunked recurrence)."""
    s = setup
    cfg = s["cfg"]
    opts = KernelOptions(impl="torch_ref", chunk_len=16)
    x = torch.from_numpy(s["x"])
    full = ssm.apply_ssm(s["params"], x, cfg, opts)
    cache = ssm.init_ssm_cache(cfg, B, device="cpu")
    outs = [ssm.decode_ssm(s["params"], cache, x[:, t:t + 1], t, cfg,
                           opts)[0] for t in range(S)]
    torch.testing.assert_close(torch.cat(outs, 1), full, rtol=TOL, atol=TOL)


#: (bh, T, dk = ssm_state, dv = d_head, chunk): the SSM's call shape at the
#: reduced config and wider, the kernel's chunks
LINATT_CASES = [(8, 32, 8, 16, 8), (8, 64, 8, 16, 16), (4, 64, 16, 64, 64),
                (6, 96, 16, 32, 32)]


@pytest.mark.parametrize("ref_impl", ["xla", "interpret"])
@pytest.mark.parametrize("bh,t,dk,dv,chunk", LINATT_CASES)
def test_inclusive_scalar_decay_matches_reference(bh, t, dk, dv, chunk,
                                                  ref_impl):
    """The linear attention as the SSM calls it: inclusive, no bonus, one
    log decay per (head, step) as ``(BH, T, 1)``, q and k each one row of
    N broadcast over the heads of a batch row."""
    if ref_impl == "interpret" and not ref_compat.has_pallas_tpu():
        pytest.skip("Pallas TPU module not importable: the reference's "
                    "interpret entry would fall back to xla_ref")
    rs = np.random.RandomState(bh * t + chunk)
    heads = 2
    q, k = (np.repeat(rs.randn(bh // heads, 1, t, dk), heads, 1).reshape(
        bh, t, dk).astype(np.float32) for _ in range(2))
    v = rs.randn(bh, t, dv).astype(np.float32)
    lw = np.clip(-rs.rand(bh, t, 1), ssm.LOG_A_MIN, -1e-4).astype(np.float32)
    ref_out = jax.jit(functools.partial(
        ref_linear_attention, inclusive=True, chunk=chunk, impl=ref_impl))(
        *map(jnp.asarray, (q, k, v, lw)))
    out = linear_attention(*map(torch.from_numpy, (q, k, v, lw)),
                           inclusive=True, chunk=chunk, impl="torch_ref")
    assert tuple(out.shape) == (bh, t, dv)
    _close(out, ref_out)
