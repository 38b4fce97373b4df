"""The dense, stub-frontend, hybrid and MoE families of the port against the
JAX reference, at each family's reduced config in fp32, from the same
parameters: deepseek-7b (MHA), yi-6b and minitron-4b (GQA), internvl2-2b
(vision stub) and musicgen-medium (audio stub), which take precomputed
``embeds``, hymba-1.5b (sliding-window attention beside SSM heads), and
the MoE models deepseek-v2-236b (MLA) and kimi-k2-1t-a32b (GQA), each a
dense first layer then MoE layers.

For each: the configs field for field, ``param_count``, the parameter and
cache layouts, the full-sequence logits (tokens, and ``embeds`` for the two
frontends), a chain of decode steps, a chunked prefill with ragged rows
and an idle one, the prefill handler through each package's
``IridescentRuntime``, and the builders' spec labels (a MoE model's
dispatch points with their candidates and defaults).  Then greedy serving
through each package's ``build_engine`` for reduced yi-6b, hymba-1.5b (at
``--max-len 16``, its window) and deepseek-v2-236b.  These are the port's
counterparts of the dense, vlm, audio, hymba and moe cases of
tests/test_models.py; the forward, decode and chunked prefill run at
capacity factor 4.0 as those do (tests/test_models.py:14-17: a decode
step routes other tokens than the forward, so parity between the two
holds only where capacity does not bind), the handlers at the builders'
default 1.25, where both packages drop the same slots.

Tolerance 1e-4 in fp32, as tests/test_torch_model.py: the two frameworks
sum the matrix products, the softmax and the chunk states in different
orders, compounded over the layers.
"""
import argparse
import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.core import Controller as RefController  # noqa: E402
from repro.core import ExhaustiveSweep as RefSweep  # noqa: E402
from repro.core import IridescentRuntime as RefRuntime  # noqa: E402
from repro.core.specializer import discover_space as ref_discover  # noqa: E402
from repro.launch import serve as ref_serve  # noqa: E402
from repro.models import KernelOptions as RefKernelOptions  # noqa: E402
from repro.models import MoEOptions as RefMoEOptions  # noqa: E402
from repro.models import transformer as ref_model  # noqa: E402
from repro.serve import OpenLoopSource as RefSource  # noqa: E402
from repro.serve import Request as RefRequest  # noqa: E402
from repro.training import steps as ref_steps  # noqa: E402
from repro_torch import compat, configs  # noqa: E402
from repro_torch.core import Controller, ExhaustiveSweep  # noqa: E402
from repro_torch.core import IridescentRuntime  # noqa: E402
from repro_torch.core.specializer import discover_space  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import KernelOptions, params_from_numpy  # noqa: E402
from repro_torch.models import transformer as model  # noqa: E402
from repro_torch.models.moe import MoEOptions  # noqa: E402
from repro_torch.serve import OpenLoopSource, Request  # noqa: E402
from repro_torch.training import steps  # noqa: E402

TOL = 1e-4
B, S = 2, 16
#: decode cache length: hymba's reduced window, so every family's paged
#: per-row decode sees its whole cache
MAX_LEN = 16
CHUNK_LEN = 16

ARCHS = ("deepseek-7b", "yi-6b", "minitron-4b", "internvl2-2b",
         "musicgen-medium", "hymba-1.5b", "deepseek-v2-236b",
         "kimi-k2-1t-a32b")
MOE_ARCHS = ("deepseek-v2-236b", "kimi-k2-1t-a32b")
#: the reference's MoE dispatch points: label -> (default, candidates)
MOE_POINTS = {"moe_impl": ("einsum", ("einsum", "gather", "shard")),
              "capacity_factor": (1.25, (1.0, 1.25, 1.5, 2.0)),
              "moe_group": (0, (0, 1024, 4096)),
              "moe_ranking": ("cumsum", ("cumsum", "sort"))}
FRONTENDS = ("internvl2-2b", "musicgen-medium")


@pytest.fixture(scope="module", params=ARCHS)
def setup(request):
    arch = request.param
    ref_cfg = ref_configs.get_reduced(arch).replace(compute_dtype="float32")
    cfg = configs.get_reduced(arch).replace(compute_dtype="float32")
    ref_params = ref_model.init_params(jax.random.PRNGKey(0), ref_cfg)
    np_params = jax.tree_util.tree_map(np.asarray, ref_params)
    rs = np.random.RandomState(7)
    tokens = rs.randint(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    embeds = rs.randn(B, S, cfg.d_model).astype(np.float32)
    ref_opts = ref_model.RunOptions(
        kernels=RefKernelOptions(impl="xla", chunk_len=CHUNK_LEN),
        moe=RefMoEOptions(capacity_factor=4.0), decode_cache_dtype="float32")
    opts = model.RunOptions(
        kernels=KernelOptions(impl="torch_ref", chunk_len=CHUNK_LEN),
        moe=MoEOptions(capacity_factor=4.0), decode_cache_dtype="float32")
    return dict(arch=arch, ref_cfg=ref_cfg, cfg=cfg, ref_params=ref_params,
                params=params_from_numpy(np_params, "cpu"), tokens=tokens,
                embeds=embeds, ref_opts=ref_opts, opts=opts)


def _close(out, ref_out, tol=TOL):
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_out),
                               rtol=tol, atol=tol)


def _close_tree(tree, ref_tree):
    leaves, ref_leaves = compat.tree_leaves(tree), \
        jax.tree_util.tree_leaves(ref_tree)
    assert len(leaves) == len(ref_leaves)
    for leaf, ref_leaf in zip(leaves, ref_leaves):
        assert tuple(leaf.shape) == ref_leaf.shape
        _close(leaf, ref_leaf)


def _shapes_by_path(tree) -> dict:
    return {jax.tree_util.keystr(p): tuple(a.shape) for p, a in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


# -- configs -------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_reference(arch):
    assert dataclasses.asdict(configs.get_config(arch)) == \
        dataclasses.asdict(ref_configs.get_config(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_matches_reference(arch):
    assert dataclasses.asdict(configs.get_reduced(arch)) == \
        dataclasses.asdict(ref_configs.get_reduced(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_param_count_matches_reference(arch):
    cfg, ref_cfg = configs.get_config(arch), ref_configs.get_config(arch)
    assert cfg.param_count() == ref_cfg.param_count()
    assert cfg.active_param_count() == ref_cfg.active_param_count()
    # the analytic count is the port's tree less the vocab padding, the
    # final norm and MLA's two latent norms (which the count leaves out,
    # as the reference's does)
    small = configs.get_reduced(arch)
    fresh = model.init_params(torch.Generator().manual_seed(0), small)
    pad = (small.padded_vocab_size - small.vocab_size) * small.d_model * (
        1 if small.tie_embeddings else 2)
    latent_norms = small.n_layers * (small.q_lora_rank + small.kv_lora_rank)
    assert sum(a.numel() for a in compat.tree_leaves(fresh)) == \
        small.param_count() + pad + small.d_model + latent_norms


# -- layouts --------------------------------------------------------------------

def test_param_and_cache_layout_match_reference(setup):
    s = setup
    fresh = model.init_params(torch.Generator().manual_seed(0), s["cfg"])
    port_shapes = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{prefix}['{k}']")
        else:
            port_shapes[prefix] = tuple(node.shape)

    walk(fresh, "")
    assert port_shapes == _shapes_by_path(s["ref_params"])
    assert model.param_axes(s["cfg"]) == ref_model.param_axes(s["ref_cfg"])
    assert model.cache_axes(s["cfg"]) == ref_model.cache_axes(s["ref_cfg"])
    cache = model.init_cache(s["cfg"], B, MAX_LEN, s["opts"], device="cpu")
    ref_cache = ref_model.init_cache(s["ref_cfg"], B, MAX_LEN, s["ref_opts"])
    assert _shapes_by_path(ref_cache) == _shapes_by_path(
        compat.tree_map(lambda t: np.zeros(t.shape), cache))


# -- the full-sequence forward and the prefill handler ---------------------------

@pytest.mark.parametrize("mode", ["tokens", "embeds"])
def test_apply_matches_reference(setup, mode):
    s = setup
    if mode == "embeds":
        kw = {"embeds": torch.from_numpy(s["embeds"])}
        ref_kw = {"embeds": jnp.asarray(s["embeds"])}
    else:
        kw = {"tokens": torch.from_numpy(s["tokens"])}
        ref_kw = {"tokens": jnp.asarray(s["tokens"])}
    ref_out, ref_aux = ref_model.apply(s["ref_params"], s["ref_cfg"],
                                       s["ref_opts"], **ref_kw)
    out, aux = model.apply(s["params"], s["cfg"], s["opts"], **kw)
    assert tuple(out.shape) == (B, S, s["cfg"].padded_vocab_size)
    assert out.dtype == torch.float32 and aux.dtype == torch.float32
    assert (float(aux) > 0.0) == s["cfg"].is_moe     # the MoE layers' aux
    _close(out, ref_out)
    _close(aux, ref_aux)


def test_prefill_handler_matches_reference(setup):
    """The prefill handler of each package on the family's own input:
    ``embeds`` for the stub frontends, ``tokens`` for the others."""
    s = setup
    if s["arch"] in FRONTENDS:
        batch = {"embeds": torch.from_numpy(s["embeds"])}
        ref_batch = {"embeds": jnp.asarray(s["embeds"])}
    else:
        batch = {"tokens": torch.from_numpy(s["tokens"])}
        ref_batch = {"tokens": jnp.asarray(s["tokens"])}
    ref_rt, rt = RefRuntime(max_compile_workers=1), \
        IridescentRuntime(max_compile_workers=1)
    try:
        ref_h = ref_rt.register("prefill_step", ref_steps.make_prefill_builder(
            s["ref_cfg"], kernel_impl="xla"))
        h = rt.register("prefill_step", steps.make_prefill_builder(
            s["cfg"], kernel_impl="torch_ref"))
        if s["cfg"].mixer == "hymba":
            for handler in (ref_h, h):
                handler.specialize({"chunk_len": CHUNK_LEN}, wait=True)
        _close(h(s["params"], batch), ref_h(s["ref_params"], ref_batch))
    finally:
        ref_rt.shutdown()
        rt.shutdown()


@pytest.mark.parametrize("name", ["make_prefill_builder",
                                  "make_decode_builder",
                                  "make_serve_builder"])
def test_builders_declare_the_reference_labels(setup, name):
    """Each builder declares the reference builder's spec labels (hymba:
    both kernel families, ``chunk_len`` and ``swa_impl``)."""
    ref_space = ref_discover(getattr(ref_steps, name)(
        setup["ref_cfg"], kernel_impl="xla"))
    space = discover_space(getattr(steps, name)(setup["cfg"]))
    assert space.labels() == ref_space.labels()
    if setup["cfg"].mixer == "hymba":
        assert {"attention_impl", "linear_attention_impl", "chunk_len",
                "swa_impl"} <= set(space.labels())
    if setup["cfg"].is_moe:
        for label, (default, candidates) in MOE_POINTS.items():
            for sp in (space, ref_space):
                assert sp[label].default == default
                assert tuple(sp[label].candidates()) == candidates


# -- decode ---------------------------------------------------------------------

def test_decode_chain_matches_reference(setup):
    """Four shared-ring decode steps from an empty cache: logits and every
    cache leaf."""
    s = setup
    ref_step = jax.jit(functools.partial(ref_model.decode_step,
                                         cfg=s["ref_cfg"], opts=s["ref_opts"]))
    ref_cache = ref_model.init_cache(s["ref_cfg"], B, MAX_LEN, s["ref_opts"])
    cache = model.init_cache(s["cfg"], B, MAX_LEN, s["opts"], device="cpu")
    for t in range(4):
        toks = s["tokens"][:, t]
        ref_logits, ref_cache = ref_step(s["ref_params"], ref_cache,
                                         jnp.asarray(toks), jnp.int32(t))
        logits, out_cache = model.decode_step(
            s["params"], cache, torch.from_numpy(toks),
            torch.tensor(t, dtype=torch.int32), s["cfg"], s["opts"])
        assert out_cache is cache
        assert tuple(logits.shape) == (B, s["cfg"].vocab_size)
        _close(logits, ref_logits)
        _close_tree(cache, ref_cache)


def _random_cache(ref_cfg, ref_opts, b, seed):
    """The reference's empty cache with every float leaf filled at random
    (numpy); the shared ``slot_pos`` stays as it is."""
    rs = np.random.RandomState(seed)
    empty = ref_model.init_cache(ref_cfg, b, MAX_LEN, ref_opts)
    return jax.tree_util.tree_map(
        lambda a: (rs.randn(*a.shape) * 0.5).astype(np.float32)
        if jnp.issubdtype(a.dtype, jnp.floating) else np.asarray(a), empty)


def test_prefill_chunk_ragged_rows(setup):
    """A chunk of 6 tokens over a filled cache with per-row positions and
    counts and one idle row: logits and every cache leaf match the
    reference's; the idle row's logits are zero and its row state (hymba's
    SSM state and conv inputs) does not advance."""
    s = setup
    b = 4
    np_cache = _random_cache(s["ref_cfg"], s["ref_opts"], b, 3)
    ref_cache = jax.tree_util.tree_map(jnp.asarray, np_cache)
    cache = compat.tree_map(lambda a: torch.from_numpy(a.copy()), np_cache)
    rs = np.random.RandomState(4)
    tokens = rs.randint(0, s["cfg"].vocab_size, size=(b, 6)).astype(np.int32)
    pos = np.array([0, 5, 10, 2], np.int32)
    n_new = np.array([6, 3, 1, 0], np.int32)
    ref_logits, ref_cache = jax.jit(functools.partial(
        ref_model.prefill_chunk, cfg=s["ref_cfg"], opts=s["ref_opts"]))(
        s["ref_params"], ref_cache, jnp.asarray(tokens), jnp.asarray(pos),
        jnp.asarray(n_new))
    logits, out_cache = model.prefill_chunk(
        s["params"], cache, torch.from_numpy(tokens), torch.from_numpy(pos),
        torch.from_numpy(n_new), s["cfg"], s["opts"])
    assert out_cache is cache
    _close(logits, ref_logits)
    _close_tree(cache, ref_cache)
    assert not logits[3].any()
    if s["cfg"].mixer == "hymba":
        for name in ("state", "conv"):
            np.testing.assert_array_equal(cache["ssm"][name][:, 3].numpy(),
                                          np_cache["ssm"][name][:, 3])


def test_hymba_window_override_matches_reference():
    """A window override narrower than hymba's own reaches its attention
    branch in the forward and bounds its decode ring."""
    arch = "hymba-1.5b"
    ref_cfg = ref_configs.get_reduced(arch).replace(compute_dtype="float32")
    cfg = configs.get_reduced(arch).replace(compute_dtype="float32")
    ref_params = ref_model.init_params(jax.random.PRNGKey(1), ref_cfg)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                      ref_params), "cpu")
    tokens = np.random.RandomState(9).randint(
        0, cfg.vocab_size, size=(B, 24)).astype(np.int32)
    ref_opts = ref_model.RunOptions(kernels=RefKernelOptions(impl="xla"),
                                    window=8)
    opts = model.RunOptions(kernels=KernelOptions(impl="torch_ref"),
                            window=8)
    ref_out, _ = ref_model.apply(ref_params, ref_cfg, ref_opts,
                                 tokens=jnp.asarray(tokens))
    out, _ = model.apply(params, cfg, opts, tokens=torch.from_numpy(tokens))
    _close(out, ref_out)
    wide, _ = model.apply(params, cfg, model.RunOptions(
        kernels=KernelOptions(impl="torch_ref")),
        tokens=torch.from_numpy(tokens))
    assert (wide - out).abs().max() > 1e-3        # the override took effect
    cache = model.init_cache(cfg, B, 24, opts, device="cpu")
    assert cache["attn"]["k"].shape[3] == 8


# -- serving ---------------------------------------------------------------------

#: (prompt tokens, new tokens) per request, all arriving at once; every
#: request fits in hymba's reduced window of 16
WORKLOAD = [(5, 4), (9, 3), (3, 5), (7, 2)]


def _args(add_engine_args, arch, extra=()):
    ap = argparse.ArgumentParser()
    add_engine_args(ap)
    return ap.parse_args(
        ["--arch", arch, "--batch", "2", "--max-len", "16",
         "--prefill-chunk", "4", "--bucket-dwell", "100000",
         "--kv-dwell", "100000", "--compile-workers", "1", "--no-safety"]
        + list(extra))


def _serve(built, controller_cls, sweep_cls, source_cls, request_cls,
           pinned):
    built.engine.controller = controller_cls(
        built.handler, lambda: sweep_cls([dict(pinned)]), dwell=1000,
        wait_compiles=True, prefetch=0)
    reqs = [request_cls(rid=1000 + i, prompt_tokens=p, max_new_tokens=m)
            for i, (p, m) in enumerate(WORKLOAD)]
    built.engine.run(source=source_cls(built.engine.queue,
                                       [(0.0, r) for r in reqs]),
                     max_steps=200)
    assert built.engine.drain(timeout_s=60.0)
    built.engine.shutdown()
    return {r.rid: list(r.payload) for r in reqs}


@pytest.mark.parametrize("arch", ["yi-6b", "hymba-1.5b", "deepseek-v2-236b"])
def test_served_tokens_match_reference(arch):
    """Both engines serve the same requests from the same weights with
    every context pinned (fp32 cache, plain rmsnorm; chunk 16 for hymba):
    greedy decoding gives the same tokens per request, through chunked
    prefill (ragged prompts: hymba's row-state select) and decode."""
    ref_built = ref_serve.build_engine(_args(ref_serve.add_engine_args,
                                             arch))
    np_params = jax.tree_util.tree_map(np.asarray,
                                       ref_built.engine.executor.params)
    built = serve.build_engine(_args(serve.add_engine_args, arch,
                                     ["--device", "cpu"]),
                               params=params_from_numpy(np_params, "cpu"))
    assert built.cfg.name == arch
    extra = {"chunk_len": 16} if built.cfg.mixer == "hymba" else {}
    ref_tokens = _serve(ref_built, RefController, RefSweep, RefSource,
                        RefRequest, {"cache_dtype": "float32",
                                     "rmsnorm_impl": "xla_ref", **extra})
    tokens = _serve(built, Controller, ExhaustiveSweep, OpenLoopSource,
                    Request, {"cache_dtype": "float32",
                              "rmsnorm_impl": "torch_ref", **extra})
    assert [len(t) for t in tokens.values()] == [m for _, m in WORKLOAD]
    assert tokens == ref_tokens


def test_hymba_refuses_a_cache_longer_than_its_window():
    """As in the reference, a windowed cache shorter than ``max_len`` is not
    pageable per request: hymba serves with ``--max-len`` <= its window."""
    cfg = configs.get_reduced("hymba-1.5b").replace(compute_dtype="float32")
    with pytest.raises(ValueError, match="windowed"):
        serve.build_engine(_args(serve.add_engine_args, "hymba-1.5b",
                                 ["--device", "cpu", "--max-len", "32"]),
                           cfg=cfg)


@pytest.mark.parametrize("max_len", [16, 48, 256])
def test_synthetic_workload_fits_the_cache(max_len):
    """With ``max_len`` every request fits the cache; a request that
    already fits is kept as drawn."""
    drawn = serve.synthetic_workload(40, 5.0, seed=3)
    fitted = serve.synthetic_workload(40, 5.0, seed=3, max_len=max_len)
    assert [t for t, _ in fitted] == [t for t, _ in drawn]
    for (_, a), (_, b) in zip(drawn, fitted):
        assert 0 < b.prompt_tokens and 0 < b.max_new_tokens
        assert b.prompt_tokens + b.max_new_tokens <= max_len
        if a.prompt_tokens + a.max_new_tokens <= max_len:
            assert (b.prompt_tokens, b.max_new_tokens) == (
                a.prompt_tokens, a.max_new_tokens)


@pytest.mark.parametrize("arch,max_len", [("hymba-1.5b", "16"),
                                          ("musicgen-medium", "256"),
                                          ("deepseek-v2-236b", "256")])
def test_cli_serves_the_family(capsys, arch, max_len):
    serve.main(["--device", "cpu", "--arch", arch, "--max-len", max_len,
                "--steps", "80", "--requests", "4", "--dwell", "3",
                "--compile-workers", "1"])
    out = capsys.readouterr().out
    assert "served 4 requests" in out
