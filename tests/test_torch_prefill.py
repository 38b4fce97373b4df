"""The port's full-sequence forward and its prefill and decode handlers
against the JAX reference at reduced qwen3-0.6b, in fp32, from the same
parameters: ``transformer.apply`` (logits, ``return_hidden``, ``embeds``
input, a sliding-window override), ``make_prefill_builder`` and
``make_decode_builder`` through each package's ``IridescentRuntime``, the
forward against a loop of decode steps, and the handlers' spec spaces.

Tolerance 1e-4 in fp32, as tests/test_torch_model.py: the two frameworks
sum the matrix products and the softmax in different orders, compounded
over the layers.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.core import IridescentRuntime as RefRuntime  # noqa: E402
from repro.core.specializer import discover_space as ref_discover  # noqa: E402
from repro.models import KernelOptions as RefKernelOptions  # noqa: E402
from repro.models import transformer as ref_model  # noqa: E402
from repro.training import steps as ref_steps  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core import IridescentRuntime  # noqa: E402
from repro_torch.core.specializer import discover_space  # noqa: E402
from repro_torch.kernels import registry  # noqa: E402
from repro_torch.kernels.attention import kernel as attn_kernel  # noqa: E402
from repro_torch.models import KernelOptions, params_from_numpy  # noqa: E402
from repro_torch.models import transformer as model  # noqa: E402
from repro_torch.training import steps  # noqa: E402

TOL = 1e-4
B, S = 2, 16


@pytest.fixture(scope="module")
def setup():
    ref_cfg = ref_configs.get_reduced("qwen3-0.6b").replace(
        compute_dtype="float32")
    cfg = configs.get_reduced("qwen3-0.6b").replace(compute_dtype="float32")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
    ref_params = ref_model.init_params(jax.random.PRNGKey(0), ref_cfg)
    np_params = jax.tree_util.tree_map(np.asarray, ref_params)
    tokens = np.random.RandomState(7).randint(
        0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    return dict(ref_cfg=ref_cfg, cfg=cfg, ref_params=ref_params,
                params=params_from_numpy(np_params, "cpu"), tokens=tokens)


def _close(out, ref_out):
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_out),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("window", [None, 8])
@pytest.mark.parametrize("mode", ["tokens", "embeds", "hidden"])
def test_apply_matches_reference(setup, mode, window):
    s = setup
    ref_opts = ref_model.RunOptions(kernels=RefKernelOptions(impl="xla"),
                                    window=window)
    opts = model.RunOptions(kernels=KernelOptions(impl="torch_ref"),
                            window=window)
    kw, ref_kw = {}, {}
    if mode == "embeds":
        emb = np.random.RandomState(8).randn(
            B, S, s["cfg"].d_model).astype(np.float32)
        kw["embeds"], ref_kw["embeds"] = torch.from_numpy(emb), \
            jnp.asarray(emb)
    else:
        kw["tokens"] = torch.from_numpy(s["tokens"])
        ref_kw["tokens"] = jnp.asarray(s["tokens"])
    hidden = mode == "hidden"
    ref_out, ref_aux = ref_model.apply(s["ref_params"], s["ref_cfg"],
                                       ref_opts, return_hidden=hidden,
                                       **ref_kw)
    out, aux = model.apply(s["params"], s["cfg"], opts,
                           return_hidden=hidden, **kw)
    want = ((B, S, s["cfg"].d_model) if hidden
            else (B, S, s["cfg"].padded_vocab_size))
    assert tuple(out.shape) == want and out.dtype == torch.float32
    _close(out, ref_out)
    assert float(aux) == float(ref_aux) == 0.0


def test_logits_dtype(setup):
    s = setup
    opts = model.RunOptions(kernels=KernelOptions(impl="torch_ref"),
                            logits_dtype="bfloat16")
    out, _ = model.apply(s["params"], s["cfg"], opts,
                         tokens=torch.from_numpy(s["tokens"]))
    assert out.dtype == torch.bfloat16


def test_prefill_handler_matches_reference(setup):
    s = setup
    ref_rt, rt = RefRuntime(max_compile_workers=1), \
        IridescentRuntime(max_compile_workers=1)
    try:
        ref_h = ref_rt.register("prefill_step", ref_steps.make_prefill_builder(
            s["ref_cfg"], kernel_impl="xla"))
        h = rt.register("prefill_step", steps.make_prefill_builder(
            s["cfg"], kernel_impl="torch_ref"))
        ref_logits = ref_h(s["ref_params"],
                           {"tokens": jnp.asarray(s["tokens"])})
        logits = h(s["params"], {"tokens": torch.from_numpy(s["tokens"])})
        _close(logits, ref_logits)
        # The kernel's tiles are spec points: re-specializing to another
        # pair changes nothing in the plain version's numbers.
        h.specialize({"block_q": 128, "block_kv": 32}, wait=True)
        assert h.active_config()["block_q"] == 128
        _close(h(s["params"], {"tokens": torch.from_numpy(s["tokens"])}),
               ref_logits)
    finally:
        ref_rt.shutdown()
        rt.shutdown()


def test_decode_handler_matches_reference(setup):
    s = setup
    max_len = S
    ref_rt, rt = RefRuntime(max_compile_workers=1), \
        IridescentRuntime(max_compile_workers=1)
    try:
        ref_h = ref_rt.register("serve_step", ref_steps.make_decode_builder(
            s["ref_cfg"], kernel_impl="xla"))
        h = rt.register("serve_step", steps.make_decode_builder(
            s["cfg"], kernel_impl="torch_ref"))
        for handler in (ref_h, h):
            handler.specialize({"cache_dtype": "float32"}, wait=True)
        ref_cache = ref_model.init_cache(
            s["ref_cfg"], B, max_len,
            ref_model.RunOptions(decode_cache_dtype="float32"))
        cache = model.init_cache(
            s["cfg"], B, max_len,
            model.RunOptions(decode_cache_dtype="float32"), device="cpu")
        for t in range(4):
            toks = s["tokens"][:, t]
            ref_logits, ref_cache = ref_h(s["ref_params"], ref_cache,
                                          jnp.asarray(toks), jnp.int32(t))
            logits, cache = h(s["params"], cache, torch.from_numpy(toks),
                              torch.tensor(t, dtype=torch.int32))
            _close(logits, ref_logits)
            for name in cache:
                _close(cache[name], ref_cache[name])
    finally:
        ref_rt.shutdown()
        rt.shutdown()


def test_apply_matches_decode_loop(setup):
    """The forward's logits at every position equal a loop of decode
    steps over the same tokens (the port's counterpart of
    tests/test_models.py::test_decode_matches_forward)."""
    s = setup
    opts = model.RunOptions(kernels=KernelOptions(impl="torch_ref"),
                            decode_cache_dtype="float32")
    toks = torch.from_numpy(s["tokens"])
    logits, _ = model.apply(s["params"], s["cfg"], opts, tokens=toks)
    cache = model.init_cache(s["cfg"], B, S, opts, device="cpu")
    outs = []
    for t in range(S):
        lg, cache = model.decode_step(s["params"], cache, toks[:, t],
                                      torch.tensor(t, dtype=torch.int32),
                                      s["cfg"], opts)
        outs.append(lg)
    torch.testing.assert_close(torch.stack(outs, 1),
                               logits[:, :, : s["cfg"].vocab_size],
                               rtol=TOL, atol=TOL)


def test_prefill_space_offers_the_kernel_tiles(setup):
    space = discover_space(steps.make_prefill_builder(setup["cfg"]))
    assert space["attention_impl"].candidates() == tuple(
        registry.choices("attention"))
    assert tuple(space["block_q"].candidates()) == attn_kernel.BLOCK_Q
    assert tuple(space["block_kv"].candidates()) == attn_kernel.BLOCK_KV
    assert space["block_q"].default == attn_kernel.DEFAULT_BLOCK_Q
    assert space["block_kv"].default == attn_kernel.DEFAULT_BLOCK_KV


@pytest.mark.parametrize("name,window", [
    ("make_prefill_builder", None), ("make_prefill_builder", 8),
    ("make_decode_builder", None), ("make_decode_builder", 8),
    ("make_serve_builder", None)])
def test_builders_declare_the_reference_labels(setup, name, window):
    """Each builder declares the reference builder's spec labels, so the
    reference's tuned configurations name points the port has."""
    kw = {"window": window} if window else {}
    ref_space = ref_discover(getattr(ref_steps, name)(
        setup["ref_cfg"], kernel_impl="xla", **kw))
    space = discover_space(getattr(steps, name)(setup["cfg"], **kw))
    assert space.labels() == ref_space.labels()


def test_builders_refuse_unported_mixers(setup):
    """The prefill builder takes MLA and MoE now: its space for reduced
    deepseek-v2 and kimi-k2 is the reference's, label for label with the
    same candidates and defaults.  A mixer the port does not have is still
    refused."""
    for arch in ("deepseek-v2-236b", "kimi-k2-1t-a32b"):
        ref_space = ref_discover(ref_steps.make_prefill_builder(
            ref_configs.get_reduced(arch), kernel_impl="xla"))
        space = discover_space(steps.make_prefill_builder(
            configs.get_reduced(arch)))
        assert space.labels() == ref_space.labels()
        for label in ("moe_impl", "capacity_factor", "moe_group",
                      "moe_ranking", "logits_dtype", "sharding_profile"):
            assert space[label].default == ref_space[label].default
            assert tuple(space[label].candidates()) == \
                tuple(ref_space[label].candidates())
    with pytest.raises(NotImplementedError, match="mamba"):
        discover_space(steps.make_prefill_builder(
            setup["cfg"].replace(mixer="mamba")))


def test_cpu_tensors_never_launch_the_kernel(setup):
    """Asking the forward for the kernel with host tensors runs the plain
    version (counted as fallbacks) and launches nothing."""
    s = setup
    counts = registry.default_registry.fallback_counts
    before = counts.get(("attention", "cuda"), 0)
    launches = attn_kernel.launches
    opts = model.RunOptions(kernels=KernelOptions(impl="torch_ref",
                                                  attention_impl="cuda"))
    out, _ = model.apply(s["params"], s["cfg"], opts,
                         tokens=torch.from_numpy(s["tokens"]))
    ref_out, _ = model.apply(s["params"], s["cfg"], model.RunOptions(
        kernels=KernelOptions(impl="torch_ref")),
        tokens=torch.from_numpy(s["tokens"]))
    torch.testing.assert_close(out, ref_out)
    assert counts[("attention", "cuda")] == before + s["cfg"].n_layers
    assert attn_kernel.launches == launches
