"""Half precision (fp16) through the port against the JAX reference, on the
CPU: the kernels' fp16 domain and the reduced models' fp16 forwards.

The port's K1, K2 and K4 take fp16 as the reference's Pallas kernels do
(``kernel.unsupported`` returns None for fp16 inputs within their other
limits); their plain versions are the oracle the card holds the kernels to
(``tests/test_torch_*_cuda.py``, ``chip_smoke.py``).  Here each plain
version runs fp16 inputs against the reference's Pallas kernel under the
interpreter, within the low-precision tolerance of tests/test_kernels.py
(3e-2).

Model level: reduced qwen3-0.6b, rwkv6-1.6b, hymba-1.5b and deepseek-v2-236b
run one fp16 forward through the port's plain versions and through the
reference's Pallas kernels under the interpreter, from the same numpy
weights and tokens.  fp16 moves every logit away from the fp32 forward;
the reference's own move, ``max |ref_fp16 - ref_fp32|``, is the yardstick:
the port's fp16 logits lie within 1.5 times it of the reference's fp32
logits and of its fp16 logits (``chip_smoke.py`` reads the same rule on
the card against its plain fp32 path).

The scaled limit the card holds K2 to in bf16 and fp16
(``SCALED_RTOL``): the reference's Pallas kernel rounds each probability
to v's dtype before the P.V product, which moves an output by at most one
ulp of that dtype times the plain attention over |v| (the spread), so
``|out - ref| <= rtol (|ref| + spread) + 1e-5``.  Here the reference's own
kernel, in interpret mode, meets that limit against the port's plain
version in both dtypes.
"""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import compat as ref_compat  # noqa: E402
from repro import configs as ref_configs  # noqa: E402
from repro.kernels.attention import kernel as ref_attn_kernel  # noqa: E402
from repro.kernels import attention as ref_attention  # noqa: E402
from repro.kernels import linear_attention as ref_la  # noqa: E402
from repro.kernels import rmsnorm as ref_rmsnorm  # noqa: E402
from repro.models import KernelOptions as RefKernelOptions  # noqa: E402
from repro.models import transformer as ref_model  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.kernels.attention import attention  # noqa: E402
from repro_torch.kernels.attention import kernel as attn_kernel  # noqa: E402
from repro_torch.kernels.linear_attention import (  # noqa: E402
    kernel as la_kernel, linear_attention)
from repro_torch.kernels.rmsnorm import kernel as rms_kernel  # noqa: E402
from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_pair  # noqa: E402
from repro_torch.models import KernelOptions, params_from_numpy  # noqa: E402
from repro_torch.models import transformer as model  # noqa: E402

#: the low-precision tolerance of tests/test_kernels.py
TOL = 3e-2
#: the port's fp16 logits may move from the reference's by this many times
#: the reference's own fp16 move from its fp32 logits
SPREAD = 1.5
ARCHS = ("qwen3-0.6b", "rwkv6-1.6b", "hymba-1.5b", "deepseek-v2-236b")
#: the forward's input, and the reference kernels' tiles: blocks that
#: divide it, so every call reaches the Pallas kernel
TOKENS = (2, 64)
REF_KERNELS = dict(impl="pallas_interpret", block_q=32, block_kv=32,
                   norm_block_rows=8, chunk_len=16)


def _half(a):
    """A numpy fp32 array as the port's fp16 tensor and the reference's
    fp16 array of the same values."""
    return torch.from_numpy(a).half(), jnp.asarray(a, jnp.float16)


def _close(out, ref):
    assert out.dtype == torch.float16
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("case", ["rows", "pair"])
def test_rmsnorm_fp16(case):
    rs = np.random.RandomState(0)
    shapes = [(2, 17, 64)] if case == "rows" else [(2, 4, 33, 64),
                                                   (2, 2, 33, 64)]
    xs = [_half(rs.randn(*s).astype(np.float32)) for s in shapes]
    ws = [rs.randn(64).astype(np.float32) for _ in shapes]
    for (x, _), w in zip(xs, ws):
        assert rms_kernel.unsupported(x, torch.from_numpy(w)) is None
    refs = [ref_rmsnorm.rmsnorm(jx, jnp.asarray(w), impl="pallas_interpret",
                                block_rows=8)
            for (_, jx), w in zip(xs, ws)]
    if case == "rows":
        outs = [rmsnorm(xs[0][0], torch.from_numpy(ws[0]),
                        impl="torch_ref")]
    else:
        outs = rmsnorm_pair(xs[0][0], torch.from_numpy(ws[0]), xs[1][0],
                            torch.from_numpy(ws[1]), impl="torch_ref")
    for out, ref in zip(outs, refs):
        _close(out, ref)


#: (q, k, v shapes, causal, window): causal, windowed, GQA
ATTENTION_CASES = {
    "causal": (((2, 4, 64, 32),) * 3, True, None),
    "window": (((1, 4, 64, 32),) * 3, True, 16),
    "gqa": (((2, 8, 64, 32), (2, 2, 64, 32), (2, 2, 64, 32)), True, None),
}


@pytest.mark.parametrize("case", sorted(ATTENTION_CASES))
def test_attention_fp16(case):
    shapes, causal, window = ATTENTION_CASES[case]
    rs = np.random.RandomState(1)
    (q, jq), (k, jk), (v, jv) = (_half(rs.randn(*s).astype(np.float32))
                                 for s in shapes)
    assert attn_kernel.unsupported(*(t.flatten(0, 1) for t in (q, k, v)),
                                   window=window) is None
    ref = jax.jit(functools.partial(
        ref_attention.attention, causal=causal, window=window,
        block_q=32, block_kv=32, impl="pallas_interpret"))(jq, jk, jv)
    out = attention(q, k, v, causal=causal, window=window, impl="torch_ref")
    _close(out, ref)


#: (rtol, atol) of the card's scaled limit on K2 in each half dtype
#: (tests/test_torch_attention_cuda.py, chip_smoke.py): one ulp of the dtype
#: (2^-7 bf16, 2^-10 fp16) of |ref| plus the plain attention over |v|
SCALED_RTOL = {"bfloat16": (2 ** -7, 1e-5), "float16": (2 ** -10, 1e-5)}
#: (H, Hk, S, d, dv, window), tiles 64 x 64: qwen3's head dim with GQA,
#: MLA's head dims, and a windowed call at head dim 64
ROUNDING_CASES = {"gqa": (4, 2, 256, 128, 128, None),
                  "mla": (4, 4, 256, 192, 128, None),
                  "window": (4, 2, 256, 64, 64, 64)}


@pytest.mark.parametrize("case", sorted(ROUNDING_CASES))
@pytest.mark.parametrize("dtype", sorted(SCALED_RTOL))
def test_pallas_kernel_meets_the_scaled_limit(dtype, case):
    """The reference's ``flash_attention_pallas`` (interpret mode), which
    rounds P to v's dtype, against the port's ``torch_ref`` (fp32 P): within
    the reference's 3e-2 and within the scaled limit the card holds the
    port's kernel to."""
    if not ref_compat.has_pallas_tpu():
        pytest.skip("Pallas TPU module not importable: no interpret-mode "
                    "flash_attention_pallas")
    h, hk, s, d, dv, window = ROUNDING_CASES[case]
    rs = np.random.RandomState(3)
    arrays = [rs.randn(*shape).astype(np.float32)
              for shape in ((h, s, d), (hk, s, d), (hk, s, dv))]
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    ref = np.asarray(ref_attn_kernel.flash_attention_pallas(
        *(jnp.asarray(a, jdt) for a in arrays), causal=True, window=window,
        block_q=64, block_kv=64, group=h // hk, interpret=True), np.float32)
    q, k, v = (torch.from_numpy(a).to(tdt)[None] for a in arrays)
    plain = attention(q, k, v, causal=True, window=window,
                      impl="torch_ref")[0].float()
    spread = attention(q.float(), k.float(), v.float().abs(), causal=True,
                       window=window, impl="torch_ref")[0]
    diff = (torch.from_numpy(ref) - plain).abs()
    assert diff.max() <= TOL
    rtol, atol = SCALED_RTOL[dtype]
    assert (diff - (atol + rtol * (plain.abs() + spread))).max() <= 0
    if dtype == "bfloat16":
        # without the spread term the limit is one the reference misses
        assert (diff - (atol + rtol * plain.abs())).max() > 0


#: (bh, T, dk, dv, inclusive, bonus, scalar decay): RWKV6's exclusive
#: recurrence with the bonus, and the SSM heads' inclusive one
LINATT_CASES = {"exclusive_bonus": (4, 64, 16, 16, False, True, False),
                "inclusive": (4, 64, 8, 16, True, False, True)}


@pytest.mark.parametrize("case", sorted(LINATT_CASES))
def test_linear_attention_fp16(case):
    bh, t, dk, dv, inclusive, bonus, scalar = LINATT_CASES[case]
    rs = np.random.RandomState(2)
    (q, jq), (k, jk) = (_half(0.5 * rs.randn(bh, t, dk).astype(np.float32))
                        for _ in range(2))
    v, jv = _half(rs.randn(bh, t, dv).astype(np.float32))
    lw = -rs.uniform(0.01, 1.0, (bh, t, 1 if scalar else dk)).astype(
        np.float32)
    u = rs.randn(bh, dk).astype(np.float32) if bonus else None
    lw_t = torch.from_numpy(lw).expand(bh, t, dk)
    u_t = None if u is None else torch.from_numpy(u)
    assert la_kernel.unsupported(q, k, v, lw_t, u_t, inclusive=inclusive,
                                 chunk=16) is None
    ref = jax.jit(functools.partial(
        ref_la.linear_attention, inclusive=inclusive, chunk=16,
        impl="pallas_interpret"))(
        jq, jk, jv, jnp.asarray(lw), bonus=None if u is None
        else jnp.asarray(u))
    out = linear_attention(q, k, v, torch.from_numpy(lw), bonus=u_t,
                           inclusive=inclusive, chunk=16, impl="torch_ref")
    _close(out, ref)


def _ref_logits(ref_cfg, ref_params, tokens, dtype):
    cfg = ref_cfg.replace(compute_dtype=dtype)
    opts = ref_model.RunOptions(kernels=RefKernelOptions(**REF_KERNELS))
    logits = jax.jit(lambda p, t: ref_model.apply(p, cfg, opts,
                                                  tokens=t)[0])(
        ref_params, jnp.asarray(tokens))
    return np.asarray(logits, np.float64)


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_forward_fp16_within_the_reference_spread(arch):
    ref_cfg = ref_configs.get_reduced(arch)
    ref_params = ref_model.init_params(jax.random.PRNGKey(0), ref_cfg)
    np_params = jax.tree_util.tree_map(np.asarray, ref_params)
    tokens = np.random.RandomState(0).randint(
        0, ref_cfg.vocab_size, size=TOKENS).astype(np.int32)
    ref32 = _ref_logits(ref_cfg, ref_params, tokens, "float32")
    ref16 = _ref_logits(ref_cfg, ref_params, tokens, "float16")

    cfg = configs.get_reduced(arch).replace(compute_dtype="float16")
    opts = model.RunOptions(kernels=KernelOptions(impl="torch_ref",
                                                  chunk_len=16))
    logits, _ = model.apply(params_from_numpy(np_params, "cpu"), cfg, opts,
                            tokens=torch.from_numpy(tokens))
    port16 = logits.double().numpy()
    assert port16.shape == ref16.shape and np.isfinite(port16).all()

    spread = np.abs(ref16 - ref32).max()
    assert 0 < spread < 0.1 * np.abs(ref32).max()
    assert np.abs(port16 - ref32).max() <= SPREAD * spread
    assert np.abs(port16 - ref16).max() <= SPREAD * spread
