"""Attention of the PyTorch port against the JAX reference: the port's
plain version (``torch_ref``) against the reference op through its plain
entry (``xla``) and through its Pallas kernel in interpret mode, at the
cases of ``tests/test_kernels.py``; the banded sliding-window variant; and
how the port's ``cuda`` entry treats host tensors.

Tolerances are the reference's: fp32 2e-4, bf16 3e-2.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import compat as ref_compat  # noqa: E402
from repro import configs as ref_configs  # noqa: E402
from repro.kernels import attention as ref_attention  # noqa: E402
from repro.kernels.attention import ref as ref_ref  # noqa: E402
from repro_torch import compat  # noqa: E402
from repro_torch.kernels import registry  # noqa: E402
from repro_torch.kernels.attention import attention, kernel, ops  # noqa: E402
from repro_torch.kernels.attention import ref  # noqa: E402

TOL = {"float32": 2e-4, "bfloat16": 3e-2}

#: (q shape, k shape, v shape, causal, window, dtype) — the cases of
#: tests/test_kernels.py:60-108, one ragged length, then MLA's head dims
#: (deepseek-v2 / kimi-k2: q and k nope + rope = 192, v 128;
#: src/repro/models/mla.py:90-98), causal, with and without GQA and a window
CASES = {
    **{f"gqa{h}/{hk}-{tag}": ((2, h, 64, 32), (2, hk, 64, 32),
                               (2, hk, 64, 32), causal, window, "float32")
       for h, hk in [(4, 4), (4, 2), (8, 1)]
       for tag, causal, window in [("causal", True, None),
                                   ("window16", True, 16),
                                   ("full", False, None)]},
    "dv_neq_d": ((2, 2, 32, 24), (2, 2, 32, 24), (2, 2, 32, 16), True,
                 None, "float32"),
    "q_offset": ((1, 2, 16, 16), (1, 2, 64, 16), (1, 2, 64, 16), True,
                 None, "float32"),
    "float32": ((1, 2, 32, 16),) * 3 + (True, None, "float32"),
    "bfloat16": ((1, 2, 32, 16),) * 3 + (True, None, "bfloat16"),
    "ragged": ((1, 4, 50, 32), (1, 2, 50, 32), (1, 2, 50, 32), True, 16,
               "float32"),
    "mla-causal": ((1, 2, 32, 192), (1, 2, 32, 192), (1, 2, 32, 128), True,
                   None, "float32"),
    "mla-gqa": ((1, 4, 32, 192), (1, 2, 32, 192), (1, 2, 32, 128), True,
                None, "float32"),
    "mla-gqa-window": ((1, 4, 48, 192), (1, 2, 48, 192), (1, 2, 48, 128),
                       True, 16, "float32"),
    "mla-bfloat16": ((1, 2, 32, 192), (1, 2, 32, 192), (1, 2, 32, 128),
                     True, None, "bfloat16"),
}


def _inputs(shapes, seed=0):
    rs = np.random.RandomState(seed)
    return [rs.randn(*s).astype(np.float32) for s in shapes]


def _close(out, ref_out, dtype):
    tol = TOL[dtype]
    np.testing.assert_allclose(out.to(torch.float32).numpy(),
                               np.asarray(ref_out, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("case,ref_impl", [
    (case, impl) for case in sorted(CASES) for impl in ("xla", "interpret")
    # the reference's Pallas kernel needs lengths that are a multiple of
    # its tiles (its guard sends the others to xla_ref)
    if impl == "xla" or case != "ragged"])
def test_torch_ref_matches_reference(case, ref_impl):
    q_s, k_s, v_s, causal, window, dtype = CASES[case]
    if ref_impl == "interpret" and not ref_compat.has_pallas_tpu():
        pytest.skip("Pallas TPU module not importable: the reference's "
                    "interpret entry would fall back to xla_ref")
    arrays = _inputs((q_s, k_s, v_s))
    ref_out = ref_attention.attention(
        *(jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrays),
        causal=causal, window=window, block_q=16, block_kv=16,
        impl=ref_impl)
    out = attention(*(torch.from_numpy(a).to(getattr(torch, dtype))
                      for a in arrays),
                    causal=causal, window=window, impl="torch_ref")
    assert out.dtype == getattr(torch, dtype)
    assert out.shape == q_s[:3] + v_s[3:]
    _close(out, ref_out, dtype)


@pytest.mark.parametrize("group", [1, 2])
@pytest.mark.parametrize("s,w", [(64, 16), (128, 32), (96, 32)])
def test_banded_matches_reference(s, w, group):
    """The port's banded variant against the reference's, and against the
    port's full masked version (tests/test_kernels.py:150-161)."""
    b, h, d = 2, 4, 16
    q, k, v = _inputs(((b, h, s, d), (b, h // group, s, d),
                       (b, h // group, s, d)))
    ref_band = ref_ref.banded_attention(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), window=w)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    band = ref.banded_attention(tq, tk, tv, window=w)
    _close(band, ref_band, "float32")
    full = ref.attention(tq, tk, tv, causal=True, window=w)
    torch.testing.assert_close(band, full, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("swa_impl", ["banded", "full"])
def test_swa_impl_routing_matches_reference(swa_impl):
    """The op takes the banded variant under the reference's conditions
    (tests/test_kernels.py:164-173)."""
    q, k, v = _inputs(((1, 2, 64, 16),) * 3)
    ref_out = ref_attention.attention(
        *(jnp.asarray(a) for a in (q, k, v)), causal=True, window=16,
        impl="xla", swa_impl=swa_impl)
    out = attention(*(torch.from_numpy(a) for a in (q, k, v)), causal=True,
                    window=16, impl="torch_ref", swa_impl=swa_impl)
    _close(out, ref_out, "float32")


def test_cuda_on_cpu_tensor_degrades_like_reference():
    """Asking for the kernel with host tensors runs the plain version and
    counts one fallback, as the reference registry does for pallas_tpu."""
    if ref_compat.on_tpu():
        pytest.skip("the reference's pallas_tpu entry is available here")
    q, k, v = _inputs(((1, 4, 32, 16), (1, 2, 32, 16), (1, 2, 32, 16)))
    port_key, ref_key = ("attention", "cuda"), ("attention", "pallas_tpu")
    counts = registry.default_registry.fallback_counts
    port_before = counts.get(port_key, 0)
    out = attention(*(torch.from_numpy(a) for a in (q, k, v)), impl="cuda")
    ref_out = ref_attention.attention(*(jnp.asarray(a) for a in (q, k, v)),
                                      impl="pallas_tpu")
    _close(out, ref_out, "float32")
    assert counts[port_key] == port_before + 1
    from repro.kernels import registry as ref_registry
    assert ref_registry.default_registry.fallback_counts[ref_key] >= 1


def test_guard_sends_every_cuda_tensor_to_the_kernel():
    """The guard is the card and the reference's precondition without its
    tile divisibility: every CUDA call of 4-D float tensors whose kv heads
    group the query heads reaches the kernel entry (ragged lengths
    included), fp16 as fp32 and bf16, head dims up to 256 and mixed
    dtypes.  One the kernel cannot take (a q/k or v head dim over 256,
    both of which the reference's kernel takes) raises there, and no
    fallback is counted.
    Heads that do not group and integer inputs miss the guard, as they
    miss the reference's."""
    from test_torch_matmul import _OnCard

    reg = registry.KernelRegistry()
    reg.register("fam", "torch_ref")(ops._attention_torch_ref)
    launched = []

    def entry(q, k, v, *, block_q, block_kv, **_kw):
        err = kernel.unsupported(*(t.flatten(0, 1) for t in (q, k, v)),
                                 block_q=block_q, block_kv=block_kv)
        if err is not None:
            raise err
        launched.append(q)

    reg.register("fam", "cuda", guard=ops._guard, available=lambda: True,
                 supports_grad=False)(entry)
    kw = dict(causal=True, window=None, scale=None, q_offset=None,
              block_q=64, block_kv=64, swa_impl="full")

    def on_card(shapes, dtype=torch.float32):
        return [_OnCard(torch.from_numpy(a).to(dtype))
                for a in _inputs(shapes)]

    reg.dispatch("fam", "cuda", *on_card(((1, 4, 40, 16), (1, 2, 40, 16),
                                          (1, 2, 40, 16))), **kw)
    for dtype in (torch.bfloat16, torch.float16):
        reg.dispatch("fam", "cuda", *on_card(((2, 2, 32, 16),) * 3, dtype),
                     **kw)
    wq, wk, wv = (torch.from_numpy(a) for a in _inputs(((1, 2, 8, 256),)
                                                       * 3))
    reg.dispatch("fam", "cuda", _OnCard(wq.half()), _OnCard(wk),
                 _OnCard(wv.bfloat16()), **kw)
    assert len(launched) == 4 and reg.fallback_counts == {}
    assert ref_attention.ops._guard(
        *(jnp.asarray(a, jnp.float16) for a in _inputs(((2, 2, 32, 16),)
                                                       * 3)),
        block_q=64, block_kv=64)
    for shapes in (((1, 2, 8, 264),) * 3,
                   ((1, 2, 8, 16), (1, 2, 8, 16), (1, 2, 8, 272))):
        assert ref_attention.ops._guard(
            *(jnp.asarray(a) for a in _inputs(shapes)), block_q=64,
            block_kv=64)
        with pytest.raises(ValueError, match="head dims"):
            reg.dispatch("fam", "cuda", *on_card(shapes), **kw)
    assert len(launched) == 4 and reg.fallback_counts == {}
    ungrouped = ((1, 3, 32, 16), (1, 2, 32, 16), (1, 2, 32, 16))
    assert not ops._guard(*on_card(ungrouped))
    assert not ref_attention.ops._guard(
        *(jnp.asarray(a) for a in _inputs(ungrouped)))
    assert not ops._guard(*on_card(((1, 2, 32, 16),) * 3, torch.int32))
    assert not ref_attention.ops._guard(
        *(jnp.zeros((1, 2, 32, 16), jnp.int32),) * 3)
    assert not ops._guard(*(torch.zeros(1, 2, 32, 16),) * 3)  # host


def test_kernel_wrapper_refuses_host_tensors():
    q, k, v = (torch.from_numpy(a) for a in _inputs(((4, 32, 16),) * 3))
    before = kernel.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernel.flash_attention_cuda(q, k, v)
    assert kernel.launches == before


def test_cuda_choices_follow_the_host():
    assert ("cuda" in registry.choices("attention")) == compat.has_hopper()
    assert registry.choices("attention")[-1] == "torch_ref"
    assert not registry.get("attention", "cuda").supports_grad
    assert registry.choices("attention", require_grad=True) == ("torch_ref",)
    assert registry.get("attention", "pallas_tpu").name == "cuda"


#: the reference's full-width configs that attend (every mixer but rwkv6)
ATTENDING_ARCHS = [a for a in ref_configs.ARCHS
                   if ref_configs.get_config(a).mixer != "rwkv6"]


@pytest.mark.parametrize("arch", ATTENDING_ARCHS)
def test_kernel_head_dims_take_every_reference_config(arch):
    """The kernel's limits take the attention call of every full-width
    reference config: q/k head dim nope + rope and v head dim d_head under
    MLA (src/repro/models/mla.py:90-98; deepseek-v2: 192 and 128), d_head
    for both otherwise."""
    cfg = ref_configs.get_config(arch)
    if cfg.attn_kind == "mla":
        d, dv = cfg.nope_head_dim + cfg.rope_head_dim, cfg.d_head
    else:
        d = dv = cfg.d_head
    assert d <= kernel.MAX_HEAD_DIM and dv <= kernel.MAX_VALUE_HEAD_DIM


def test_attention_opens_its_profiler_range():
    """Under an active profiler every call is the range
    ``ops.PROFILE_RANGE`` (every mixer's attention goes through it, so a
    profile can classify the plain version's ops), and the result is the
    same."""
    from torch.profiler import ProfilerActivity, profile

    q = torch.from_numpy(np.random.RandomState(0).standard_normal(
        (1, 2, 8, 16)).astype(np.float32))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = attention(q, q, q, impl="torch_ref")
    names = [e.name for e in prof.events()]
    assert names.count(ops.PROFILE_RANGE) == 1
    torch.testing.assert_close(out, attention(q, q, q, impl="torch_ref"))
