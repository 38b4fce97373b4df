"""The port's train builder and AdamW against the JAX reference, at reduced
yi-6b in fp32: the nine cases of tests/test_steps_and_optim.py run on the
port (spec space, microbatch, remat, logits layout and loss-chunk
equivalence, CE masking, the cosine schedule, clipping, int8 error
feedback), then the optimizer against the reference's on identical
gradients (within 1e-6, fp32 with both packages rounding each operation
alike), its weight-decay rule on the stacked norms, its out-of-place
contract, the int8 quantizer's rounding, the losses against the
reference's, and the spec space of the builder against the reference's.
For every architecture the builder's options reach only gradient-safe
entries, and every kernel wrapper refuses a tensor that requires grad.
"""
import types

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro import optim as ref_optim  # noqa: E402
from repro.core.specializer import discover_space as ref_discover  # noqa: E402
from repro.training import steps as ref_steps  # noqa: E402
from repro_torch import compat, configs  # noqa: E402
from repro_torch.core.specializer import (discover_space,  # noqa: E402
                                          specialize_builder)
from repro_torch.kernels import registry  # noqa: E402
from repro_torch.kernels.attention import kernel as attn_kernel  # noqa: E402
from repro_torch.kernels.fastpath import kernel as fp_kernel  # noqa: E402
from repro_torch.kernels.linear_attention import \
    kernel as la_kernel  # noqa: E402
from repro_torch.kernels.matmul import kernel as mm_kernel  # noqa: E402
from repro_torch.kernels.rmsnorm import kernel as rms_kernel  # noqa: E402
from repro_torch.models import transformer as model  # noqa: E402
from repro_torch.optim import (OptConfig, apply_updates,  # noqa: E402
                               cosine_lr, init_opt_state)
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.training import (chunked_cross_entropy,  # noqa: E402
                                  cross_entropy, make_train_builder, steps)

CFG = configs.get_reduced("yi-6b").replace(compute_dtype="float32")
OPT = OptConfig(lr=1e-2, warmup_steps=1, total_steps=100)
REF_OPT = ref_optim.OptConfig(lr=1e-2, warmup_steps=1, total_steps=100)
#: identical gradients through both optimizers: fp32, each operation
#: rounded alike, so only the order of the norm's sum differs
OPT_TOL = 1e-6
#: the same step in two frameworks: the products and the softmax sum in
#: other orders (tests/test_torch_model.py's 1e-4 for logits)
LOSS_TOL = 1e-5
#: the port's tile candidates, documented in repro_torch/training/steps.py
PORT_TILES = ("block_q", "block_kv", "norm_block_rows")


def _state_and_batch(cfg=CFG, b=4, s=16):
    params = model.init_params(torch.Generator().manual_seed(0), cfg)
    state = {"params": params, "opt": init_opt_state(params, OPT)}
    rs = np.random.RandomState(7)
    toks = torch.from_numpy(
        rs.randint(0, cfg.vocab_size, (b, s + 1)).astype(np.int32))
    return state, {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _step(config):
    return specialize_builder(make_train_builder(CFG, OPT), config).fn


def _first_leaf(state):
    return compat.tree_leaves(state["params"])[0]


def test_spec_space_discovered():
    space = discover_space(make_train_builder(CFG, OPT))
    labels = set(space.labels())
    assert {"remat", "microbatch", "block_q", "block_kv", "logits_layout",
            "sharding_profile", "logits_dtype"} <= labels


@pytest.mark.parametrize("arch", ["yi-6b", "rwkv6-1.6b", "hymba-1.5b",
                                  "deepseek-v2-236b"])
def test_spec_space_is_the_references(arch):
    """Labels, candidates and defaults as the reference's, but for the
    port's documented tile candidates; every impl point offers only
    gradient-safe entries (torch_ref here)."""
    cfg = configs.get_reduced(arch).replace(compute_dtype="float32")
    ref_cfg = ref_configs.get_reduced(arch).replace(compute_dtype="float32")
    space = discover_space(make_train_builder(cfg, OPT))
    ref_space = ref_discover(ref_steps.make_train_builder(
        ref_cfg, REF_OPT, kernel_impl="xla"))
    assert space.labels() == ref_space.labels()
    for label in space.labels():
        p, rp = space.points[label], ref_space.points[label]
        if label.endswith("_impl") and label not in ("moe_impl", "swa_impl"):
            assert list(p.choices) == ["torch_ref"], label
            assert p.default == "torch_ref"
        elif label not in PORT_TILES:
            assert (p.default, tuple(p.choices)) == \
                (rp.default, tuple(rp.choices)), label


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_train_opts_reach_only_grad_safe_entries(arch, monkeypatch):
    """Every kernel family the train step can reach resolves to a
    gradient-safe entry through the builder's options, the step-wide
    ``impl`` included (MLA's attention has no point of its own and falls
    through to it): none is left to the registry's automatic pick, which
    would be the card's kernel on an H100."""
    seen = []
    real = steps.run_options_from_spec

    def spy(*args, **kwargs):
        seen.append(real(*args, **kwargs))
        return seen[-1]

    monkeypatch.setattr(steps, "run_options_from_spec", spy)
    cfg = configs.get_reduced(arch).replace(compute_dtype="float32")
    specialize_builder(make_train_builder(cfg, OPT), {})
    (opts,) = seen
    for family in registry.families():
        name = opts.kernels.impl_for(family)
        assert name is not None, family
        assert registry.get(family, name).supports_grad, (family, name)


def _requires_grad(*shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype, requires_grad=True)


@pytest.mark.parametrize("wrapper", [
    "rmsnorm", "rmsnorm_pair", "attention", "linear_attention", "matmul",
    "fastpath", "fastpath_prepared"])
def test_kernel_wrappers_refuse_autograd(wrapper):
    """No kernel has a backward: its wrapper raises on a tensor that
    requires grad under autograd instead of returning an output with no
    ``grad_fn``.  The check comes before the device's, so it runs here."""
    x = _requires_grad(4, 8)
    keys = torch.zeros((4, 1), dtype=torch.int32)
    calls = {
        "rmsnorm": lambda: rms_kernel.rmsnorm_cuda(x, torch.ones(8)),
        "rmsnorm_pair": lambda: rms_kernel.rmsnorm_pair_cuda(
            x, torch.ones(8), x, torch.ones(8)),
        "attention": lambda: attn_kernel.flash_attention_cuda(
            _requires_grad(2, 4, 8), _requires_grad(2, 4, 8),
            _requires_grad(2, 4, 8)),
        "linear_attention": lambda: la_kernel.linear_attention_cuda(
            _requires_grad(2, 4, 8), _requires_grad(2, 4, 8),
            _requires_grad(2, 4, 8), torch.zeros(2, 4, 8)),
        "matmul": lambda: mm_kernel.matmul_cuda(x, _requires_grad(8, 4)),
        "fastpath": lambda: fp_kernel.fastpath_cuda(keys, keys, x),
        "fastpath_prepared": lambda: fp_kernel.fastpath_cuda_prepared(
            keys, types.SimpleNamespace(values=x)),
    }
    with pytest.raises(RuntimeError, match="has no backward"):
        calls[wrapper]()
    with torch.no_grad(), pytest.raises(Exception) as err:
        calls[wrapper]()            # past the check: the host tensors fail
    assert "has no backward" not in str(err.value)


def test_microbatch_equivalence():
    """Grad accumulation (microbatch spec point) must not change the math."""
    state, batch = _state_and_batch()
    outs = {}
    for m in (1, 2, 4):
        s2, metrics = _step({"microbatch": m})(state, batch)
        outs[m] = (float(metrics["loss"]), _first_leaf(s2).numpy())
    for m in (2, 4):
        assert abs(outs[m][0] - outs[1][0]) < 1e-4
        np.testing.assert_allclose(outs[m][1], outs[1][1], rtol=2e-4,
                                   atol=2e-4)


def test_remat_equivalence():
    """Remat policies change memory, never the result."""
    state, batch = _state_and_batch()
    ref = None
    for remat in ("none", "dots", "full"):
        _, metrics = _step({"remat": remat})(state, batch)
        if ref is None:
            ref = float(metrics["loss"])
        else:
            assert abs(float(metrics["loss"]) - ref) < 1e-4


def test_logits_layout_equivalence():
    state, batch = _state_and_batch()
    losses = []
    for layout in ("sharded", "gathered"):
        _, m = _step({"logits_layout": layout})(state, batch)
        losses.append(float(m["loss"]))
    assert abs(losses[0] - losses[1]) < 1e-5


def test_cross_entropy_masking():
    logits = torch.zeros((1, 4, 8))
    labels = torch.tensor([[1, 2, -1, -1]])
    loss = cross_entropy(logits, labels)
    np.testing.assert_allclose(float(loss), np.log(8), rtol=1e-5)


def test_cosine_schedule_monotone_warmup():
    lrs = [float(cosine_lr(OPT, torch.tensor(float(s)))) for s in range(5)]
    assert lrs[0] <= lrs[1]
    assert abs(lrs[1] - OPT.lr) < 1e-6   # warmup_steps=1
    late = float(cosine_lr(OPT, torch.tensor(float(OPT.total_steps))))
    assert late < 1e-4


def test_clip_norm_bounds_update():
    cfg = OptConfig(lr=1.0, warmup_steps=0, total_steps=10, clip_norm=1e-3,
                    weight_decay=0.0)
    params = {"w": torch.zeros(4)}
    st = init_opt_state(params, cfg)
    g = {"w": torch.full((4,), 1e6)}
    p2, _ = apply_updates(params, g, st, cfg)
    # clipped: first Adam step is bounded by lr regardless of raw grad
    assert float(p2["w"].abs().max()) <= 1.1 * cfg.lr


def test_int8_ef_error_feedback_accumulates():
    cfg = OptConfig(compress="int8_ef")
    params = {"w": torch.zeros(3)}
    st = init_opt_state(params, cfg)
    assert "ef" in st
    g = {"w": torch.tensor([1e-9, 1.0, -1.0])}   # tiny grad lost to quant
    _, st2 = apply_updates(params, g, st, cfg)
    assert float(st2["ef"]["w"][0].abs()) > 0  # error retained for later


def test_chunked_ce_equals_full():
    """loss_chunk spec point: identical loss & params (never materializes
    the (B,S,V) fp32 logits)."""
    state, batch = _state_and_batch()
    outs = {}
    for lc in (0, 16):
        s2, m = _step({"loss_chunk": lc} if lc else {})(state, batch)
        outs[lc] = (float(m["loss"]), _first_leaf(s2).numpy())
    assert abs(outs[0][0] - outs[16][0]) < 1e-5
    np.testing.assert_allclose(outs[0][1], outs[16][1], rtol=2e-4, atol=2e-4)


def test_chunked_ce_needs_a_dividing_chunk():
    hidden = torch.zeros((1, 12, 4))
    with pytest.raises(ValueError, match="does not divide"):
        chunked_cross_entropy(hidden, torch.zeros((4, 8)),
                              torch.zeros((1, 12), dtype=torch.int32), 8)


@pytest.mark.parametrize("chunk", [0, 4])
def test_cross_entropy_against_reference(chunk):
    rs = np.random.RandomState(3)
    hidden = rs.randn(2, 8, 16).astype(np.float32)
    head = rs.randn(16, 40).astype(np.float32)
    labels = rs.randint(-1, 40, (2, 8)).astype(np.int32)
    if chunk:
        want = ref_steps.chunked_cross_entropy(hidden, head, labels, chunk)
        got = chunked_cross_entropy(torch.from_numpy(hidden),
                                    torch.from_numpy(head),
                                    torch.from_numpy(labels), chunk)
    else:
        want = ref_steps.cross_entropy(jnp.asarray(hidden @ head), labels)
        got = cross_entropy(torch.from_numpy(hidden @ head),
                            torch.from_numpy(labels))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


# -- the optimizer against the reference's, on identical gradients ---------------

def _tree(rs, scale=1.0):
    """A params-shaped tree: a stacked (L, d) norm, a matrix, a 1-D
    final norm, a 3-D stack."""
    return {"final_norm": (rs.randn(8) * scale).astype(np.float32),
            "layers": {"norm1": (rs.randn(2, 8) * scale).astype(np.float32),
                       "wq": (rs.randn(2, 8, 4) * scale).astype(np.float32)},
            "lm_head": (rs.randn(8, 16) * scale).astype(np.float32)}


def _to_port(tree):
    return compat.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


@pytest.mark.parametrize("compress", ["none", "int8_ef"])
@pytest.mark.parametrize("clip_norm", [1.0, 1e3])
def test_apply_updates_matches_reference(compress, clip_norm):
    """Three steps on the same gradients (clipped and unclipped), through
    the warmup and into the decay: params, m, v, count and ef agree."""
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=6, clip_norm=clip_norm,
              compress=compress)
    cfg, ref_cfg = OptConfig(**kw), ref_optim.OptConfig(**kw)
    rs = np.random.RandomState(0)
    params = _tree(rs)
    ref_p, p = jax.tree_util.tree_map(jnp.asarray, params), _to_port(params)
    ref_st = ref_optim.init_opt_state(ref_p, ref_cfg)
    st = init_opt_state(p, cfg)
    for _ in range(3):
        g = _tree(rs, scale=0.1)
        ref_p, ref_st = ref_optim.apply_updates(
            ref_p, jax.tree_util.tree_map(jnp.asarray, g), ref_st, ref_cfg)
        p, st = apply_updates(p, _to_port(g), st, cfg)
    assert st["count"].dtype == torch.int32 and int(st["count"]) == 3
    for want, got in zip(jax.tree_util.tree_leaves((ref_p, ref_st)),
                         compat.tree_leaves((p, st))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=OPT_TOL, atol=OPT_TOL)


def test_weight_decay_on_stacked_norms_not_final_norm():
    """With zero gradients the update is decay alone: leaves of >= 2 dims
    (the stacked (L, d) norm weights too) shrink, the 1-D final norm does
    not."""
    cfg = OptConfig(lr=0.5, warmup_steps=0, total_steps=10)
    params = _to_port(_tree(np.random.RandomState(1)))
    zeros = compat.tree_map(torch.zeros_like, params)
    p2, _ = apply_updates(params, zeros, init_opt_state(params, cfg), cfg)
    torch.testing.assert_close(p2["final_norm"], params["final_norm"],
                               rtol=0, atol=0)
    lr = float(cosine_lr(cfg, torch.tensor(1.0)))
    for name in ("norm1", "wq"):
        torch.testing.assert_close(
            p2["layers"][name],
            params["layers"][name] * (1 - lr * cfg.weight_decay))


def test_apply_updates_leaves_its_inputs_unchanged():
    cfg = OptConfig(compress="int8_ef")
    rs = np.random.RandomState(2)
    params = _to_port(_tree(rs))
    grads = _to_port(_tree(rs))
    state = init_opt_state(params, cfg)
    before = compat.tree_map(torch.clone, (params, grads, state))
    p2, st2 = apply_updates(params, grads, state, cfg)
    for a, b in zip(compat.tree_leaves(before),
                    compat.tree_leaves((params, grads, state))):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert all(x.data_ptr() != y.data_ptr() for x, y in zip(
        compat.tree_leaves((p2, st2["m"], st2["v"])),
        compat.tree_leaves((params, state["m"], state["v"]))))


def test_quantize_int8_divides_and_rounds_half_to_even():
    """round(x / scale): 2.5 and 3.5 steps round to 2 and 4, as
    ``jnp.round``; and the reference's codes on random data."""
    x = torch.tensor([2.5, -3.5, 127.0, 0.5])
    q, scale = adamw._quantize_int8(x)
    assert float(scale) == 1.0
    assert q.tolist() == [2, -4, 127, 0]
    rs = np.random.RandomState(4)
    v = (rs.randn(1000) * 3).astype(np.float32)
    ref_q, ref_scale = ref_optim.adamw._quantize_int8(jnp.asarray(v))
    q, scale = adamw._quantize_int8(torch.from_numpy(v))
    assert float(scale) == float(ref_scale)
    np.testing.assert_array_equal(q.numpy(), np.asarray(ref_q))


def test_losses_match_reference_step():
    """The default variant's loss against the reference's jitted step, for
    two steps (the second from each package's own updated state)."""
    ref_cfg = ref_configs.get_reduced("yi-6b").replace(
        compute_dtype="float32")
    ref_params = ref_steps.model.init_params(jax.random.PRNGKey(0), ref_cfg)
    ref_state = {"params": ref_params,
                 "opt": ref_optim.init_opt_state(ref_params, REF_OPT)}
    state = {"params": _to_port(
        jax.tree_util.tree_map(np.asarray, ref_params)),
        "opt": init_opt_state(_to_port(jax.tree_util.tree_map(
            np.asarray, ref_params)), OPT)}
    _, batch = _state_and_batch()
    ref_batch = {k: v.numpy() for k, v in batch.items()}
    from repro.core.specializer import specialize_builder as ref_specialize
    ref_step = jax.jit(ref_specialize(ref_steps.make_train_builder(
        ref_cfg, REF_OPT, kernel_impl="xla"), {}).fn)
    step = _step({})
    for _ in range(2):
        ref_state, rm = ref_step(ref_state, ref_batch)
        state, m = step(state, batch)
        assert abs(float(m["loss"]) - float(rm["loss"])) < LOSS_TOL
