"""The port's RWKV6 family against the JAX reference at reduced rwkv6-1.6b,
in fp32, from the same parameters: the full-sequence forward ``apply``, a
chain of decode steps, a chunked prefill with ragged per-row counts (an
idle row's state must not advance), the prefill handler through each
package's ``IridescentRuntime``, the builders' spec labels, and the tokens
each package's serve engine generates.

Tolerances: 1e-4 where the two compute the same sums (the forward, one
decode step, the prefill handler), as tests/test_torch_prefill.py; 2e-3
for a decode chain against the chunked forward, as
tests/test_models.py:68-84 (the chunked and the per-step recurrence round
differently, compounded over the layers).
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
from repro.models import transformer as ref_model  # noqa: E402
from repro.serve import OpenLoopSource as RefSource  # noqa: E402
from repro.serve import Request as RefRequest  # noqa: E402
from repro.training import steps as ref_steps  # noqa: E402
from repro_torch import compat, configs  # noqa: E402
from repro_torch.core import Controller, ExhaustiveSweep  # noqa: E402
from repro_torch.core import IridescentRuntime  # noqa: E402
from repro_torch.core.specializer import discover_space  # noqa: E402
from repro_torch.kernels import registry  # noqa: E402
from repro_torch.kernels.linear_attention import kernel as la_kernel  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import KernelOptions, params_from_numpy  # noqa: E402
from repro_torch.models import transformer as model  # noqa: E402
from repro_torch.serve import OpenLoopSource, Request  # noqa: E402
from repro_torch.training import steps  # noqa: E402

TOL = 1e-4
CHAIN_TOL = 2e-3
B, S = 2, 32
ARCH = "rwkv6-1.6b"


@pytest.fixture(scope="module")
def setup():
    ref_cfg = ref_configs.get_reduced(ARCH).replace(compute_dtype="float32")
    cfg = configs.get_reduced(ARCH).replace(compute_dtype="float32")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
    ref_params = ref_model.init_params(jax.random.PRNGKey(0), ref_cfg)
    np_params = jax.tree_util.tree_map(np.asarray, ref_params)
    tokens = np.random.RandomState(7).randint(
        0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    return dict(ref_cfg=ref_cfg, cfg=cfg, ref_params=ref_params,
                params=params_from_numpy(np_params, "cpu"), tokens=tokens)


def _opts(chunk_len=16):
    ref = ref_model.RunOptions(
        kernels=RefKernelOptions(impl="xla", chunk_len=chunk_len),
        decode_cache_dtype="float32")
    port = model.RunOptions(
        kernels=KernelOptions(impl="torch_ref", chunk_len=chunk_len),
        decode_cache_dtype="float32")
    return ref, port


def _close(out, ref_out, tol=TOL):
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_out),
                               rtol=tol, atol=tol)


def _close_cache(cache, ref_cache, tol=TOL):
    assert sorted(cache) == sorted(ref_cache)
    for name in cache:
        _close(cache[name], ref_cache[name], tol)


def test_param_and_cache_layout_match_reference(setup):
    ref_shapes = {jax.tree_util.keystr(p): tuple(a.shape) for p, a in
                  jax.tree_util.tree_flatten_with_path(setup["ref_params"])[0]}
    fresh = model.init_params(torch.Generator().manual_seed(0), setup["cfg"])
    leaves = compat.tree_leaves(fresh)
    assert sorted(tuple(a.shape) for a in leaves) == sorted(
        ref_shapes.values())
    assert "lm_head" in fresh and "ffn" not in fresh["dense_layers"]
    assert model.cache_axes(setup["cfg"]) == ref_model.cache_axes(
        setup["ref_cfg"])
    ref_cache = ref_model.init_cache(setup["ref_cfg"], B, S, _opts()[0])
    cache = model.init_cache(setup["cfg"], B, S, _opts()[1], device="cpu")
    assert {k: tuple(v.shape) for k, v in cache.items()} == {
        k: tuple(v.shape) for k, v in ref_cache.items()}


@pytest.mark.parametrize("chunk_len", [8, 16, 64])
@pytest.mark.parametrize("hidden", [False, True])
def test_apply_matches_reference(setup, chunk_len, hidden):
    s = setup
    ref_opts, opts = _opts(chunk_len)
    ref_out, _ = ref_model.apply(s["ref_params"], s["ref_cfg"], ref_opts,
                                 tokens=jnp.asarray(s["tokens"]),
                                 return_hidden=hidden)
    out, aux = model.apply(s["params"], s["cfg"], opts,
                           tokens=torch.from_numpy(s["tokens"]),
                           return_hidden=hidden)
    want = s["cfg"].d_model if hidden else s["cfg"].padded_vocab_size
    assert tuple(out.shape) == (B, S, want) and float(aux) == 0.0
    _close(out, ref_out)


def test_float64_forward_witnesses_the_fp32_one(setup):
    """The plain forward in float64 (the same parameters, widened) computes
    in float64 end to end and agrees with the fp32 forward: the witness the
    full-width parity check holds both fp32 paths to."""
    s = setup
    opts = _opts()[1]
    tokens = torch.from_numpy(s["tokens"])
    out32, _ = model.apply(s["params"], s["cfg"], opts, tokens=tokens)
    params64 = compat.tree_map(lambda a: a.double(), s["params"])
    out64, _ = model.apply(params64, s["cfg"].replace(compute_dtype="float64"),
                           dataclasses.replace(opts, logits_dtype="float64"),
                           tokens=tokens)
    assert out64.dtype == torch.float64
    torch.testing.assert_close(out32.double(), out64, rtol=TOL, atol=TOL)
    # the fp32 rounding is visible against it: not a float32 computation
    assert (out32.double() - out64).abs().max() > 0


def test_decode_chain_matches_reference_and_forward(setup):
    """Decode steps from an empty cache against the reference's, step by
    step for the first four (1e-4), and all against the chunked forward's
    logits (2e-3)."""
    s = setup
    ref_opts, opts = _opts()
    ref_step = jax.jit(functools.partial(ref_model.decode_step,
                                         cfg=s["ref_cfg"], opts=ref_opts))
    ref_cache = ref_model.init_cache(s["ref_cfg"], B, S, ref_opts)
    cache = model.init_cache(s["cfg"], B, S, opts, device="cpu")
    outs = []
    for t in range(S):
        toks = s["tokens"][:, t]
        logits, out_cache = model.decode_step(
            s["params"], cache, torch.from_numpy(toks),
            torch.tensor(t, dtype=torch.int32), s["cfg"], opts)
        assert out_cache is cache              # updated in place
        if t < 4:
            ref_logits, ref_cache = ref_step(
                s["ref_params"], ref_cache, jnp.asarray(toks), jnp.int32(t))
            _close(logits, ref_logits)
            _close_cache(cache, ref_cache)
        outs.append(logits)
    full, _ = model.apply(s["params"], s["cfg"], opts,
                          tokens=torch.from_numpy(s["tokens"]))
    torch.testing.assert_close(torch.stack(outs, 1),
                               full[:, :, : s["cfg"].vocab_size],
                               rtol=CHAIN_TOL, atol=CHAIN_TOL)


def test_prefill_chunk_ragged_rows(setup):
    """A chunk of 6 tokens over a cache in mid-sequence, with ragged
    per-row counts and one idle row: logits and every state leaf match the
    reference's, and the idle row's state does not advance."""
    s = setup
    ref_opts, opts = _opts()
    rs = np.random.RandomState(3)
    b = 4
    np_cache = {
        "state": (rs.randn(s["cfg"].n_layers, b, s["cfg"].rwkv_heads,
                           s["cfg"].rwkv_head_size, s["cfg"].rwkv_head_size)
                  * 0.1).astype(np.float32),
        "x_tm": rs.randn(s["cfg"].n_layers, b, s["cfg"].d_model).astype(
            np.float32),
        "x_cm": rs.randn(s["cfg"].n_layers, b, s["cfg"].d_model).astype(
            np.float32)}
    ref_cache = jax.tree_util.tree_map(jnp.asarray, np_cache)
    cache = {k: torch.from_numpy(v.copy()) for k, v in np_cache.items()}
    tokens = rs.randint(0, s["cfg"].vocab_size, size=(b, 6)).astype(np.int32)
    pos = np.array([0, 5, 16, 2], np.int32)
    n_new = np.array([6, 3, 1, 0], np.int32)
    ref_logits, ref_cache = ref_model.prefill_chunk(
        s["ref_params"], ref_cache, jnp.asarray(tokens), jnp.asarray(pos),
        jnp.asarray(n_new), s["ref_cfg"], ref_opts)
    logits, out_cache = model.prefill_chunk(
        s["params"], cache, torch.from_numpy(tokens), torch.from_numpy(pos),
        torch.from_numpy(n_new), s["cfg"], opts)
    assert out_cache is cache
    _close(logits, ref_logits)
    _close_cache(cache, ref_cache)
    assert not logits[3].any()                 # idle row: zero logits
    for name in cache:                         # ... and its state kept
        np.testing.assert_array_equal(cache[name][:, 3].numpy(),
                                      np_cache[name][:, 3])


def test_prefill_handler_matches_reference(setup):
    s = setup
    ref_rt, rt = RefRuntime(max_compile_workers=1), \
        IridescentRuntime(max_compile_workers=1)
    try:
        ref_h = ref_rt.register("prefill_step", ref_steps.make_prefill_builder(
            s["ref_cfg"], kernel_impl="xla"))
        h = rt.register("prefill_step", steps.make_prefill_builder(
            s["cfg"], kernel_impl="torch_ref"))
        for chunk_len in (64, 16):
            for handler in (ref_h, h):
                handler.specialize({"chunk_len": chunk_len}, wait=True)
            ref_logits = ref_h(s["ref_params"],
                               {"tokens": jnp.asarray(s["tokens"])})
            logits = h(s["params"], {"tokens": torch.from_numpy(s["tokens"])})
            assert h.active_config()["chunk_len"] == chunk_len
            _close(logits, ref_logits)
    finally:
        ref_rt.shutdown()
        rt.shutdown()


@pytest.mark.parametrize("name", ["make_prefill_builder",
                                  "make_decode_builder",
                                  "make_serve_builder"])
def test_builders_declare_the_reference_labels(setup, name):
    """Each builder declares the reference builder's spec labels for rwkv6
    (``linear_attention_impl`` and ``chunk_len``, no ``attention_impl``),
    with the reference's chunk candidates."""
    ref_space = ref_discover(getattr(ref_steps, name)(
        setup["ref_cfg"], kernel_impl="xla"))
    space = discover_space(getattr(steps, name)(setup["cfg"]))
    assert space.labels() == ref_space.labels()
    assert "attention_impl" not in space.labels()
    assert space["linear_attention_impl"].candidates() == tuple(
        registry.choices("linear_attention"))
    assert tuple(space["chunk_len"].candidates()) == tuple(
        ref_space["chunk_len"].candidates()) == la_kernel.CHUNKS


def test_cpu_tensors_never_launch_the_kernel(setup):
    """Asking the forward for the kernel with host tensors runs the plain
    version (one fallback per layer) and launches nothing."""
    s = setup
    counts = registry.default_registry.fallback_counts
    before = counts.get(("linear_attention", "cuda"), 0)
    launches = la_kernel.launches
    opts = model.RunOptions(kernels=KernelOptions(
        impl="torch_ref", linear_attention_impl="cuda", chunk_len=16))
    out, _ = model.apply(s["params"], s["cfg"], opts,
                         tokens=torch.from_numpy(s["tokens"]))
    ref_out, _ = model.apply(s["params"], s["cfg"], _opts()[1],
                             tokens=torch.from_numpy(s["tokens"]))
    torch.testing.assert_close(out, ref_out)
    assert counts[("linear_attention", "cuda")] == before + s["cfg"].n_layers
    assert la_kernel.launches == launches


#: (prompt tokens, new tokens) per request, all arriving at once
WORKLOAD = [(5, 4), (9, 3), (3, 5), (7, 2)]
ENGINE_ARGS = ["--arch", ARCH, "--batch", "2", "--max-len", "32",
               "--prefill-chunk", "4", "--bucket-dwell", "100000",
               "--kv-dwell", "100000", "--compile-workers", "1",
               "--no-safety"]


def _args(add_engine_args, extra=()):
    ap = argparse.ArgumentParser()
    add_engine_args(ap)
    return ap.parse_args(ENGINE_ARGS + list(extra))


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


def test_served_tokens_match_reference():
    """Both engines serve the same requests from the same weights with
    every context pinned (fp32 cache, plain rmsnorm, chunk 16): greedy
    decoding gives the same tokens per request, through chunked prefill
    (ragged prompts: the row-state select) and decode."""
    ref_built = ref_serve.build_engine(_args(ref_serve.add_engine_args))
    np_params = jax.tree_util.tree_map(np.asarray,
                                       ref_built.engine.executor.params)
    built = serve.build_engine(_args(serve.add_engine_args,
                                     ["--device", "cpu"]),
                               params=params_from_numpy(np_params, "cpu"))
    assert built.cfg.mixer == "rwkv6"
    ref_tokens = _serve(ref_built, RefController, RefSweep, RefSource,
                        RefRequest, {"cache_dtype": "float32",
                                     "rmsnorm_impl": "xla_ref",
                                     "chunk_len": 16})
    tokens = _serve(built, Controller, ExhaustiveSweep, OpenLoopSource,
                    Request, {"cache_dtype": "float32",
                              "rmsnorm_impl": "torch_ref", "chunk_len": 16})
    assert [len(t) for t in tokens.values()] == [m for _, m in WORKLOAD]
    assert tokens == ref_tokens
