"""The port's Multi-head Latent Attention (``repro_torch.models.mla``)
against the JAX reference's at reduced deepseek-v2-236b, in fp32, from the
same parameters and inputs (numpy from a seed): ``apply_mla`` through the
plain attention against the reference's ``xla`` path and its Pallas
flash-attention kernel in interpret mode, the absorbed decode with a
scalar and with a ``(B,)`` position, and the latent cache's layout.

Tolerances: 2e-4 for the prefill path (tests/test_kernels.py's attention
tolerance: the kernel's online softmax against a masked softmax), 1e-5
for the decode (the same math in both packages, summed in other orders).
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import compat as ref_compat  # noqa: E402
from repro import configs as ref_configs  # noqa: E402
from repro.kernels import registry as ref_registry  # noqa: E402
from repro.models import KernelOptions as RefKernelOptions  # noqa: E402
from repro.models import mla as ref_mla  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import (KernelOptions, mla,  # noqa: E402
                                params_from_numpy)

ARCH = "deepseek-v2-236b"
PREFILL_TOL = 2e-4
DECODE_TOL = 1e-5
B, S, W = 2, 32, 16
OPTS = KernelOptions(impl="torch_ref")


@pytest.fixture(scope="module")
def setup():
    ref_cfg = ref_configs.get_reduced(ARCH).replace(compute_dtype="float32")
    cfg = configs.get_reduced(ARCH).replace(compute_dtype="float32")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
    ref_p = ref_mla.init_mla(jax.random.PRNGKey(0), ref_cfg)
    rs = np.random.RandomState(11)
    # norm weights away from 1, so that a swapped norm would show
    np_p = {k: np.asarray(v) * (1 + 0.1 * rs.randn(*v.shape)).astype(
        np.float32) if k.endswith("norm") else np.asarray(v)
        for k, v in ref_p.items()}
    return dict(ref_cfg=ref_cfg, cfg=cfg,
                ref_p=jax.tree_util.tree_map(jnp.asarray, np_p),
                p=params_from_numpy(np_p, "cpu"),
                x=rs.randn(B, S, cfg.d_model).astype(np.float32))


def _close(out, ref_out, tol):
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_out),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("ref_impl,window", [
    ("xla", None), ("xla", 8), ("pallas_interpret", None)])
def test_apply_mla_matches_reference(setup, ref_impl, window):
    """The port's plain path against the reference's plain path and its
    Pallas kernel (interpret mode; tiles of 16 divide S, so its guard
    keeps the kernel)."""
    s = setup
    if ref_impl == "pallas_interpret" and not ref_compat.has_pallas_tpu():
        pytest.skip("Pallas TPU module not importable: the reference's "
                    "interpret entry would fall back to xla_ref")
    counts = ref_registry.default_registry.fallback_counts
    before = dict(counts)
    ref_opts = RefKernelOptions(impl="xla", attention_impl=ref_impl,
                                block_q=16, block_kv=16)
    ref_out = ref_mla.apply_mla(s["ref_p"], jnp.asarray(s["x"]),
                                s["ref_cfg"], ref_opts, window=window)
    assert dict(counts) == before          # no guard miss: the kernel ran
    out = mla.apply_mla(s["p"], torch.from_numpy(s["x"]), s["cfg"], OPTS,
                        window=window)
    assert tuple(out.shape) == (B, S, s["cfg"].d_model)
    _close(out, ref_out, PREFILL_TOL)


def test_apply_mla_positions_match_reference(setup):
    s = setup
    positions = np.arange(5, 5 + S, dtype=np.int32)
    ref_out = ref_mla.apply_mla(
        s["ref_p"], jnp.asarray(s["x"]), s["ref_cfg"],
        RefKernelOptions(impl="xla"), positions=jnp.asarray(positions))
    out = mla.apply_mla(s["p"], torch.from_numpy(s["x"]), s["cfg"], OPTS,
                        positions=torch.from_numpy(positions))
    _close(out, ref_out, PREFILL_TOL)


def test_cache_layout_matches_reference(setup):
    s = setup
    for window in (None, 8):
        ref_cache = ref_mla.init_mla_cache(s["ref_cfg"], B, W, window=window,
                                           dtype=jnp.float32)
        cache = mla.init_mla_cache(s["cfg"], B, W, window=window,
                                   dtype=torch.float32, device="cpu")
        assert sorted(cache) == sorted(ref_cache)
        for k, v in cache.items():
            assert tuple(v.shape) == ref_cache[k].shape
            np.testing.assert_array_equal(v.numpy(), np.asarray(ref_cache[k]))
    assert cache["ckv"].shape == (B, 8, s["cfg"].kv_lora_rank)
    assert cache["k_rope"].shape == (B, 8, s["cfg"].rope_head_dim)
    assert mla.mla_cache_axes(s["cfg"]) == ref_mla.mla_cache_axes(
        s["ref_cfg"])
    assert mla.mla_axes(s["cfg"]) == ref_mla.mla_axes(s["ref_cfg"])
    fresh = mla.init_mla(torch.Generator().manual_seed(0), s["cfg"])
    assert {k: tuple(v.shape) for k, v in fresh.items()} == {
        k: v.shape for k, v in s["ref_p"].items()}


def _random_cache(cfg, seed, window=None):
    rs = np.random.RandomState(seed)
    w = min(window, W) if window else W
    return {"ckv": rs.randn(B, w, cfg.kv_lora_rank).astype(np.float32),
            "k_rope": rs.randn(B, w, cfg.rope_head_dim).astype(np.float32),
            "slot_pos": np.full((w,), -1, np.int32)}


def _both(np_cache):
    ref = {k: jnp.asarray(v) for k, v in np_cache.items()}
    port = {k: torch.from_numpy(v.copy()) for k, v in np_cache.items()}
    return ref, port


@pytest.mark.parametrize("window", [None, 4])
def test_decode_scalar_pos_matches_reference(setup, window):
    """A chain of shared-ring steps past the ring's end (window 4: the
    slots wrap); the cache is written in place."""
    s = setup
    ref_cache, cache = _both(_random_cache(s["cfg"], 3, window))
    ref_opts = RefKernelOptions(impl="xla")
    rs = np.random.RandomState(5)
    for t in range(6):
        x = rs.randn(B, 1, s["cfg"].d_model).astype(np.float32)
        ref_y, ref_cache = ref_mla.decode_mla(
            s["ref_p"], ref_cache, jnp.asarray(x), jnp.int32(t),
            s["ref_cfg"], ref_opts, window=window)
        y, out = mla.decode_mla(s["p"], cache, torch.from_numpy(x),
                                torch.tensor(t, dtype=torch.int32),
                                s["cfg"], OPTS, window=window)
        assert all(out[k] is cache[k] for k in cache)
        _close(y, ref_y, DECODE_TOL)
        for k in cache:
            _close(cache[k], ref_cache[k], DECODE_TOL)


@pytest.mark.parametrize("window", [None, 6])
def test_decode_vector_pos_matches_reference(setup, window):
    """Per-row positions over a filled cache; a row past the cache writes
    nothing (the port's idle rows of a chunked prefill)."""
    s = setup
    np_cache = _random_cache(s["cfg"], 4)
    ref_cache, cache = _both(np_cache)
    x = np.random.RandomState(6).randn(B, 1, s["cfg"].d_model).astype(
        np.float32)
    for pos in (np.array([3, 11], np.int32), np.array([0, W], np.int32)):
        ref_y, ref_out = ref_mla.decode_mla(
            s["ref_p"], ref_cache, jnp.asarray(x), jnp.asarray(pos),
            s["ref_cfg"], RefKernelOptions(impl="xla"), window=window)
        y, _ = mla.decode_mla(s["p"], cache, torch.from_numpy(x),
                              torch.from_numpy(pos), s["cfg"], OPTS,
                              window=window)
        valid = pos < W
        _close(y[valid], np.asarray(ref_y)[valid], DECODE_TOL)
        for k in cache:
            _close(cache[k], ref_out[k], DECODE_TOL)
        ref_cache = ref_out
    # row 1 wrote slot 11, then nothing: the slots after it are as filled
    np.testing.assert_array_equal(cache["ckv"][1, 12:].numpy(),
                                  np_cache["ckv"][1, 12:])


def test_latent_norms_reach_the_rmsnorm_op(setup, monkeypatch):
    """``q_norm`` and ``kv_norm`` go through the RMSNorm op (K1 under
    ``rmsnorm_impl=cuda``), at widths q_lora and kv_lora."""
    from repro_torch.models import common

    widths = []
    inner = common.rmsnorm_kernel.rmsnorm

    def spy(x, w, **kw):
        widths.append(x.shape[-1])
        return inner(x, w, **kw)

    monkeypatch.setattr(common.rmsnorm_kernel, "rmsnorm", spy)
    s = setup
    mla.apply_mla(s["p"], torch.from_numpy(s["x"]), s["cfg"], OPTS)
    assert widths == [s["cfg"].q_lora_rank, s["cfg"].kv_lora_rank]


def test_paged_kv_pages_the_latent_cache():
    """``PagedKV`` classifies cache leaves by their ``seq_kv`` axis, so it
    pages MLA's ``ckv`` and ``k_rope`` (seq at axis 1 of a layer, 2 of the
    stack) and passes ``slot_pos`` through, with no MLA code of its own:
    two requests prefilled through pages hold what a dense cache holds."""
    from repro_torch.models import transformer as model
    from repro_torch.serve.kv import PagedKV

    cfg = configs.get_reduced(ARCH).replace(compute_dtype="float32")
    opts = model.RunOptions(kernels=OPTS, decode_cache_dtype="float32")
    params = model.init_params(torch.Generator().manual_seed(0), cfg)
    kv = PagedKV(model.init_cache(cfg, 1, W, opts, device="cpu"),
                 model.cache_axes(cfg), max_len=W, capacity_tokens=4 * W,
                 page_size=4, device="cpu")
    assert len(kv._paged_idx) == 2 and not kv._row_idx
    tokens = torch.from_numpy(np.random.RandomState(8).randint(
        0, cfg.vocab_size, size=(2, 6)).astype(np.int32))
    n_new = torch.tensor([6, 3], dtype=torch.int32)
    for rid in ("a", "b"):
        kv.join(rid)
    cache, lengths = kv.materialize(["a", "b"], 2)
    logits, cache = model.prefill_chunk(params, cache, tokens,
                                        torch.from_numpy(lengths), n_new,
                                        cfg, opts)
    kv.harvest(["a", "b"], cache, n_new.tolist())
    dense = model.init_cache(cfg, 2, W, opts, device="cpu")
    dense_logits, dense = model.prefill_chunk(
        params, dense, tokens, torch.zeros(2, dtype=torch.int32), n_new, cfg,
        opts)
    torch.testing.assert_close(logits, dense_logits, rtol=0, atol=0)
    paged, lengths = kv.materialize(["a", "b"], 2)
    assert lengths.tolist() == [6, 3]
    for name in ("ckv", "k_rope"):
        for row, n in enumerate(lengths):
            assert torch.equal(paged[name][:, row, :n],
                               dense[name][:, row, :n])
            assert not paged[name][:, row, n:].any()
    assert torch.equal(paged["slot_pos"], dense["slot_pos"])
