"""The port's train step against the JAX reference's, at reduced configs in
fp32, from the same parameters (the reference's draw, converted through
numpy) and the same batches (the gradients, leaf by leaf:
tests/test_torch_train_grads.py):

* one step's loss against the reference's jitted step within 1e-5, and
  five steps' losses within 1e-4 (AdamW's first step moves a parameter by
  about ``lr * sign(g)``, so a gradient near 0 whose sign the frameworks
  round differently moves it by 2 lr: rwkv6's losses part by 5e-2 over
  five steps at lr 1e-2, while its gradients agree within 4e-5 — so the
  families are held by their gradients, the whole step by qwen3 and
  deepseek-v2);
* tests/test_models.py::test_train_step_runs_and_reduces_loss over every
  architecture, on the port;
* what each ``remat`` policy recomputes, and the registry pinning a
  gradient-safe entry (tests/test_kernel_registry.py's case).
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro import optim as ref_optim  # noqa: E402
from repro.core.specializer import specialize_builder as ref_specialize  # noqa: E402
from repro.models import transformer as ref_model  # noqa: E402
from repro.training import steps as ref_steps  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core.specializer import SpecCtx, specialize_builder  # noqa: E402
from repro_torch.kernels import registry  # noqa: E402
from repro_torch.kernels import rmsnorm  # noqa: E402
from repro_torch.models import (KernelOptions,  # noqa: E402
                                train_state_from_numpy)
from repro_torch.models import transformer as model  # noqa: E402
from repro_torch.optim import OptConfig, init_opt_state  # noqa: E402
from repro_torch.training import cross_entropy, make_train_builder  # noqa: E402
from repro_torch.training.steps import _value_and_grad  # noqa: E402

LOSS_TOL = 1e-5
STEPS_TOL = 1e-4
B, S = 4, 16
OPT_KW = dict(lr=1e-2, warmup_steps=1, total_steps=100)


def _configs(arch):
    ref_cfg = ref_configs.get_reduced(arch).replace(compute_dtype="float32")
    cfg = configs.get_reduced(arch).replace(compute_dtype="float32")
    return ref_cfg, cfg


def _batch(cfg, seed=7):
    rs = np.random.RandomState(seed)
    toks = rs.randint(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    batch = {"labels": toks[:, 1:]}
    if cfg.frontend is not None:
        batch["embeds"] = (rs.randn(B, S, cfg.d_model) * 0.1).astype(
            np.float32)
    else:
        batch["tokens"] = toks[:, :-1]
    return batch


def _port_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _both_steps(arch, n_steps, config=None):
    """``n_steps`` train steps of each package from the same state and
    batch: the (reference, port) losses."""
    ref_cfg, cfg = _configs(arch)
    ref_opt = ref_optim.OptConfig(**OPT_KW)
    ref_params = ref_model.init_params(jax.random.PRNGKey(0), ref_cfg)
    ref_state = {"params": ref_params,
                 "opt": ref_optim.init_opt_state(ref_params, ref_opt)}
    state = train_state_from_numpy(
        jax.tree_util.tree_map(np.asarray, ref_state), "cpu")
    ref_step = jax.jit(ref_specialize(ref_steps.make_train_builder(
        ref_cfg, ref_opt, kernel_impl="xla"), config or {}).fn)
    step = specialize_builder(make_train_builder(cfg, OptConfig(**OPT_KW)),
                              config or {}).fn
    batch = _batch(cfg)
    ref_losses, losses = [], []
    for _ in range(n_steps):
        ref_state, rm = ref_step(ref_state, batch)
        state, m = step(state, _port_batch(batch))
        ref_losses.append(float(rm["loss"]))
        losses.append(float(m["loss"]))
    return ref_losses, losses


def test_one_step_loss_matches_reference():
    (want,), (got,) = _both_steps("qwen3-0.6b", 1)
    assert abs(got - want) < LOSS_TOL


@pytest.mark.parametrize("arch,config", [
    ("qwen3-0.6b", {}),
    ("qwen3-0.6b", {"remat": "dots", "microbatch": 2, "loss_chunk": 16}),
    ("deepseek-v2-236b", {"moe_impl": "gather"})])
def test_five_steps_losses_match_reference(arch, config):
    want, got = _both_steps(arch, 5, config)
    np.testing.assert_allclose(got, want, rtol=0, atol=STEPS_TOL)


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_train_step_runs_and_reduces_loss(arch):
    cfg = configs.get_reduced(arch).replace(compute_dtype="float32")
    opt_cfg = OptConfig(**OPT_KW)
    step = specialize_builder(
        make_train_builder(cfg, opt_cfg),
        {"capacity_factor": 2.0} if cfg.is_moe else {}).fn
    params = model.init_params(torch.Generator().manual_seed(0), cfg)
    state = {"params": params, "opt": init_opt_state(params, opt_cfg)}
    batch = _port_batch(_batch(cfg, seed=2))
    losses = []
    for _ in range(5):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    assert all(np.isfinite(losses)), losses
    assert losses[-1] < losses[0], losses       # memorizes a fixed batch


class _OpCount(torch.utils._python_dispatch.TorchDispatchMode):
    """Counts the aten ops a region runs (forward, backward, recompute)."""

    def __init__(self):
        super().__init__()
        self.counts = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        self.counts[name] = self.counts.get(name, 0) + 1
        return func(*args, **(kwargs or {}))


def test_remat_policies_recompute_what_they_drop():
    """``none`` recomputes nothing; ``dots`` recomputes the elementwise
    work but no 2-D product (their outputs are saved); ``full`` recomputes
    the layers' products too.  Same gradients in all three."""
    cfg = configs.get_reduced("yi-6b").replace(compute_dtype="float32")
    params = model.init_params(torch.Generator().manual_seed(0), cfg)
    batch = _port_batch(_batch(cfg))
    counts, grads = {}, {}
    for remat in ("none", "dots", "full"):
        opts = model.RunOptions(kernels=KernelOptions(impl="torch_ref"),
                                remat=remat)

        def loss(p, b):
            lg, aux = model.apply(p, cfg, opts, tokens=b["tokens"])
            return cross_entropy(lg, b["labels"]) + aux

        with _OpCount() as mode:
            _, grads[remat] = _value_and_grad(loss, params, batch)
        counts[remat] = mode.counts
    none, dots, full = counts["none"], counts["dots"], counts["full"]
    assert dots["mm"] == none["mm"] < full["mm"]
    assert none["silu"] < dots["silu"] == full["silu"]
    for remat in ("dots", "full"):
        for a, b in zip(grads["none"], grads[remat]):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def test_require_grad_pins_concrete_grad_safe_impl():
    """Differentiated builders must never leave the impl on auto: dispatch
    cannot know a call sits under autograd, so impl_point(require_grad=True)
    returns a concrete grad-safe name even when the point is disabled or
    the default is a non-differentiable kernel."""
    for default in (None, "torch_ref", "xla", "cuda", "pallas_tpu"):
        spec = SpecCtx({})                       # point disabled -> default
        value = registry.impl_point(spec, "matmul", default=default,
                                    require_grad=True)
        assert value is not None
        assert registry.get("matmul", value).supports_grad, (default, value)
    # grad actually flows through the pinned choice
    spec = SpecCtx({})
    impl = registry.impl_point(spec, "rmsnorm", default="cuda",
                               require_grad=True)
    x = torch.ones((4, 8), requires_grad=True)
    w = torch.ones((8,))
    (g,) = torch.autograd.grad(rmsnorm.rmsnorm(x, w, impl=impl).sum(), x)
    assert bool(torch.isfinite(g).all())
