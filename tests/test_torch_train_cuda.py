"""The train step on a Hopper GPU: one step of reduced qwen3-0.6b and
deepseek-v2-236b (MLA, whose attention has no point of its own and takes
the step-wide implementation) on the card against the same step of the
port on the CPU, both through the train builder's options (the loss
within 1e-5 relative; every gradient leaf within 1e-4 of that leaf's
largest: fp32 products summed in other orders, and the embedding gather's
backward accumulating with atomics on the card); no kernel launch and no
registry fallback under a train step (its implementations are pinned to
the gradient-safe ``torch_ref`` by declaration); and the ``remat``
policies giving equal losses with peak memory falling from ``none`` to
``dots`` to ``full``.

Needs no JAX, so it runs on the machine with the card:

    PYTHONPATH=src python -m pytest -q -m requires_h100 tests/test_torch_train_cuda.py

Elsewhere every case skips.
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch import compat, configs  # noqa: E402
from repro_torch.core.specializer import specialize_builder  # noqa: E402
from repro_torch.kernels import registry  # noqa: E402
from repro_torch.kernels.attention import kernel as attn_kernel  # noqa: E402
from repro_torch.kernels.fastpath import kernel as fp_kernel  # noqa: E402
from repro_torch.kernels.linear_attention import \
    kernel as la_kernel  # noqa: E402
from repro_torch.kernels.matmul import kernel as mm_kernel  # noqa: E402
from repro_torch.kernels.rmsnorm import kernel as rms_kernel  # noqa: E402
from repro_torch.models import transformer as model  # noqa: E402
from repro_torch.optim import OptConfig, init_opt_state  # noqa: E402
from repro_torch.training import (cross_entropy,  # noqa: E402
                                  make_train_builder, steps)
from repro_torch.training.steps import _value_and_grad  # noqa: E402

LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
OPT = OptConfig(lr=1e-2, warmup_steps=1, total_steps=100)
KERNELS = (rms_kernel, attn_kernel, la_kernel, mm_kernel, fp_kernel)


@pytest.fixture
def hopper():
    if not compat.has_hopper():
        pytest.skip("needs a CUDA device of capability (9, 0)")
    compat.resolve_device("cuda")           # fp32 products: TF32 off
    return torch.device("cuda")


def _setup(arch="qwen3-0.6b", b=4, s=64):
    cfg = configs.get_reduced(arch).replace(compute_dtype="float32")
    params = model.init_params(torch.Generator().manual_seed(0), cfg)
    rs = np.random.RandomState(7)
    toks = torch.from_numpy(
        rs.randint(0, cfg.vocab_size, (b, s + 1)).astype(np.int32))
    return cfg, params, {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _to(tree, device):
    return compat.tree_map(lambda t: t.to(device), tree)


def _builder_opts(cfg, monkeypatch):
    """The RunOptions the train builder's generic variant closes over."""
    seen = []
    real = steps.run_options_from_spec

    def spy(*args, **kwargs):
        seen.append(real(*args, **kwargs))
        return seen[-1]

    monkeypatch.setattr(steps, "run_options_from_spec", spy)
    specialize_builder(make_train_builder(cfg, OPT), {})
    monkeypatch.undo()
    return seen[0]


@pytest.mark.requires_h100
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "deepseek-v2-236b"])
def test_train_step_on_the_card_matches_the_host(hopper, arch, monkeypatch):
    cfg, params, batch = _setup(arch)
    opts = _builder_opts(cfg, monkeypatch)

    def loss(p, b):
        lg, aux = model.apply(p, cfg, opts, tokens=b["tokens"])
        return cross_entropy(lg, b["labels"]) + aux

    host_loss, host_grads = _value_and_grad(loss, params, batch)
    card_loss, card_grads = _value_and_grad(loss, _to(params, hopper),
                                            _to(batch, hopper))
    assert abs(float(card_loss) - float(host_loss)) \
        <= LOSS_RTOL * abs(float(host_loss))
    for want, got in zip(host_grads, card_grads):
        scale = max(float(want.abs().max()), 1e-30)
        assert float((got.cpu() - want).abs().max()) / scale < GRAD_TOL
    # and the whole step through the builder
    step = specialize_builder(make_train_builder(cfg, OPT), {}).fn
    state = {"params": params, "opt": init_opt_state(params, OPT)}
    _, m_host = step(state, batch)
    _, m_card = step(_to(state, hopper), _to(batch, hopper))
    assert abs(float(m_card["loss"]) - float(m_host["loss"])) \
        <= LOSS_RTOL * abs(float(m_host["loss"]))


@pytest.mark.requires_h100
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "hymba-1.5b",
                                  "deepseek-v2-236b"])
def test_train_step_launches_no_kernel_and_counts_no_fallback(hopper, arch):
    cfg, params, batch = _setup(arch)
    params, batch = _to(params, hopper), _to(batch, hopper)
    step = specialize_builder(make_train_builder(cfg, OPT), {}).fn
    state = {"params": params, "opt": init_opt_state(params, OPT)}
    for k in KERNELS:
        k.reset_launches()
    fallbacks = dict(registry.default_registry.fallback_counts)
    for _ in range(2):
        state, m = step(state, batch)
    torch.cuda.synchronize()
    assert np.isfinite(float(m["loss"]))
    assert [k.launches for k in KERNELS] == [0] * len(KERNELS)
    assert dict(registry.default_registry.fallback_counts) == fallbacks


@pytest.mark.requires_h100
def test_remat_equal_losses_falling_peak_memory(hopper):
    cfg = configs.get_reduced("qwen3-0.6b").replace(
        compute_dtype="float32", n_layers=8, d_model=256, n_heads=4,
        n_kv_heads=2, d_head=64, d_ff=1024)
    params = _to(model.init_params(torch.Generator().manual_seed(0), cfg),
                 hopper)
    rs = np.random.RandomState(3)
    toks = torch.from_numpy(rs.randint(
        0, cfg.vocab_size, (8, 513)).astype(np.int32)).to(hopper)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    state = {"params": params, "opt": init_opt_state(params, OPT)}
    losses, peaks = {}, {}
    for remat in ("none", "dots", "full"):
        step = specialize_builder(make_train_builder(cfg, OPT),
                                  {"remat": remat}).fn
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        _, m = step(state, batch)
        losses[remat] = float(m["loss"])
        peaks[remat] = torch.cuda.max_memory_allocated() - base
        del m
    for remat in ("dots", "full"):
        assert abs(losses[remat] - losses["none"]) < 1e-4, losses
    assert peaks["none"] > peaks["dots"] > peaks["full"], peaks
