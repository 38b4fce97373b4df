"""The port's decode path against the JAX reference at reduced qwen3-0.6b:
``decode_step`` (scalar and vector ``pos``) and ``prefill_chunk``, from the
same parameters and the same cache contents.

Tolerance 1e-4 in fp32: the two frameworks sum the matrix products and
the softmax in different orders, compounded over the layers.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.models import KernelOptions as RefKernelOptions  # noqa: E402
from repro.models import transformer as ref_model  # noqa: E402
from repro_torch import compat, configs  # noqa: E402
from repro_torch.models import KernelOptions, params_from_numpy  # noqa: E402
from repro_torch.models import transformer as model  # noqa: E402

TOL = 1e-4
B, MAX_LEN = 4, 24


@pytest.fixture(scope="module")
def setup():
    ref_cfg = ref_configs.get_reduced("qwen3-0.6b").replace(
        compute_dtype="float32")
    cfg = configs.get_reduced("qwen3-0.6b").replace(compute_dtype="float32")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
    ref_params = ref_model.init_params(jax.random.PRNGKey(0), ref_cfg)
    np_params = jax.tree_util.tree_map(np.asarray, ref_params)
    ref_opts = ref_model.RunOptions(kernels=RefKernelOptions(impl="xla"),
                                    decode_cache_dtype="float32")
    opts = model.RunOptions(kernels=KernelOptions(impl="torch_ref"),
                            decode_cache_dtype="float32")
    return dict(ref_cfg=ref_cfg, cfg=cfg, ref_params=ref_params,
                params=params_from_numpy(np_params, "cpu"),
                ref_opts=ref_opts, opts=opts)


def _random_cache(cfg, seed):
    """A cache filled with random k/v (numpy), as both packages hold it."""
    rs = np.random.RandomState(seed)
    shape = (cfg.n_layers, B, cfg.n_kv_heads, MAX_LEN, cfg.d_head)
    return {"k": rs.randn(*shape).astype(np.float32),
            "v": rs.randn(*shape).astype(np.float32),
            "slot_pos": np.full((cfg.n_layers, MAX_LEN), -1, np.int32)}


def _both_caches(np_cache):
    ref = jax.tree_util.tree_map(jnp.asarray, np_cache)
    port = compat.tree_map(lambda a: torch.from_numpy(a.copy()), np_cache)
    return ref, port


def _check(ref_out, out):
    ref_logits, ref_cache = ref_out
    logits, cache = out
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits),
                               rtol=TOL, atol=TOL)
    assert sorted(cache) == sorted(ref_cache)
    for name in cache:
        np.testing.assert_allclose(cache[name].numpy(),
                                   np.asarray(ref_cache[name]),
                                   rtol=TOL, atol=TOL)


def test_param_layout_matches_reference(setup):
    ref_leaves = jax.tree_util.tree_flatten_with_path(setup["ref_params"])[0]
    ref_shapes = {jax.tree_util.keystr(p): tuple(a.shape)
                  for p, a in ref_leaves}
    gen = torch.Generator().manual_seed(0)
    fresh = model.init_params(gen, setup["cfg"])
    port_shapes = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{prefix}['{k}']")
        else:
            port_shapes[prefix] = tuple(node.shape)

    walk(fresh, "")
    assert port_shapes == ref_shapes


def test_decode_step_scalar_pos(setup):
    """Four shared-ring decode steps from an empty cache."""
    s = setup
    empty = jax.tree_util.tree_map(
        np.asarray, ref_model.init_cache(s["ref_cfg"], B, MAX_LEN,
                                         s["ref_opts"]))
    ref_cache, cache = _both_caches(empty)
    rs = np.random.RandomState(1)
    for step in range(4):
        tokens = rs.randint(0, s["cfg"].vocab_size, size=(B,)).astype(
            np.int32)
        ref_out = ref_model.decode_step(
            s["ref_params"], ref_cache, jnp.asarray(tokens),
            jnp.int32(step), s["ref_cfg"], s["ref_opts"])
        out = model.decode_step(
            s["params"], cache, torch.from_numpy(tokens),
            torch.tensor(step, dtype=torch.int32), s["cfg"], s["opts"])
        _check(ref_out, out)
        ref_cache, cache = ref_out[1], out[1]


def test_decode_step_vector_pos(setup):
    """Per-row positions over a filled cache, one row out of range."""
    s = setup
    ref_cache, cache = _both_caches(_random_cache(s["cfg"], 2))
    tokens = np.array([3, 17, 250, 511], np.int32)
    pos = np.array([0, 9, MAX_LEN - 1, MAX_LEN], np.int32)
    ref_out = ref_model.decode_step(
        s["ref_params"], ref_cache, jnp.asarray(tokens), jnp.asarray(pos),
        s["ref_cfg"], s["ref_opts"])
    out = model.decode_step(
        s["params"], cache, torch.from_numpy(tokens), torch.from_numpy(pos),
        s["cfg"], s["opts"])
    _check(ref_out, out)


def test_prefill_chunk(setup):
    """A chunk of 6 tokens with ragged per-row counts, one row idle."""
    s = setup
    ref_cache, cache = _both_caches(_random_cache(s["cfg"], 3))
    rs = np.random.RandomState(4)
    tokens = rs.randint(0, s["cfg"].vocab_size, size=(B, 6)).astype(np.int32)
    pos = np.array([0, 5, 16, 2], np.int32)
    n_new = np.array([6, 3, 6, 0], np.int32)
    ref_out = ref_model.prefill_chunk(
        s["ref_params"], ref_cache, jnp.asarray(tokens), jnp.asarray(pos),
        jnp.asarray(n_new), s["ref_cfg"], s["ref_opts"])
    out = model.prefill_chunk(
        s["params"], cache, torch.from_numpy(tokens), torch.from_numpy(pos),
        torch.from_numpy(n_new), s["cfg"], s["opts"])
    _check(ref_out, out)
    assert not out[0][3].any()                # idle row: zero logits


def test_unported_families_raise():
    cfg = configs.get_reduced("qwen3-0.6b")
    with pytest.raises(NotImplementedError, match="M7"):
        model.cache_axes(cfg.replace(mixer="rwkv6"))
    with pytest.raises(NotImplementedError, match="M7"):
        model.cache_axes(cfg.replace(n_experts=4, top_k=2, moe_d_ff=32))
    with pytest.raises(KeyError, match="M7"):
        configs.get_config("yi-6b")
