"""Gradients of the port's train loss against ``jax.grad`` of the
reference's, at reduced configs in fp32, from the same parameters (the
reference's draw, converted through numpy) and the same batch: every leaf
within 1e-4 of that leaf's largest gradient (fp32 products and softmax
summed in other orders, then through the backward), for qwen3 (GQA, tied
embeddings), rwkv6 (the chunked linear attention's backward), hymba
(window + SSM heads), deepseek-v2 (MLA + MoE under einsum and gather:
autograd through the dispatch's index writes) and kimi-k2 (GQA + MoE).
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.models import KernelOptions as RefKernelOptions  # noqa: E402
from repro.models import MoEOptions as RefMoEOptions  # noqa: E402
from repro.models import transformer as ref_model  # noqa: E402
from repro.training import steps as ref_steps  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import KernelOptions, params_from_numpy  # noqa: E402
from repro_torch.models import transformer as model  # noqa: E402
from repro_torch.models.moe import MoEOptions  # noqa: E402
from repro_torch.training import cross_entropy  # noqa: E402
from repro_torch.training.steps import _value_and_grad  # noqa: E402

GRAD_TOL = 1e-4
LOSS_TOL = 1e-5
B, S = 4, 16


def _configs(arch):
    ref_cfg = ref_configs.get_reduced(arch).replace(compute_dtype="float32")
    cfg = configs.get_reduced(arch).replace(compute_dtype="float32")
    return ref_cfg, cfg


def _batch(cfg, seed=7):
    rs = np.random.RandomState(seed)
    toks = rs.randint(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _port_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("arch,moe_impl", [
    ("qwen3-0.6b", None), ("rwkv6-1.6b", None), ("hymba-1.5b", None),
    ("deepseek-v2-236b", "einsum"), ("deepseek-v2-236b", "gather"),
    ("kimi-k2-1t-a32b", "einsum"), ("kimi-k2-1t-a32b", "gather")])
def test_gradients_match_jax_grad(arch, moe_impl):
    ref_cfg, cfg = _configs(arch)
    ref_params = ref_model.init_params(jax.random.PRNGKey(0), ref_cfg)
    batch = _batch(cfg)
    ref_opts = ref_model.RunOptions(
        kernels=RefKernelOptions(impl="xla"),
        moe=RefMoEOptions(impl=moe_impl or "einsum"))
    opts = model.RunOptions(
        kernels=KernelOptions(impl="torch_ref", rmsnorm_impl="torch_ref",
                              attention_impl="torch_ref",
                              linear_attention_impl="torch_ref"),
        moe=MoEOptions(impl=moe_impl or "einsum"))

    def ref_loss(p):
        lg, aux = ref_model.apply(p, ref_cfg, ref_opts,
                                  tokens=batch["tokens"])
        return ref_steps.cross_entropy(lg, batch["labels"]) + aux

    def loss(p, b):
        lg, aux = model.apply(p, cfg, opts, tokens=b["tokens"])
        return cross_entropy(lg, b["labels"]) + aux

    want_loss, want = jax.jit(jax.value_and_grad(ref_loss))(ref_params)
    params = params_from_numpy(
        jax.tree_util.tree_map(np.asarray, ref_params), "cpu")
    got_loss, got = _value_and_grad(loss, params, _port_batch(batch))
    assert abs(float(got_loss) - float(want_loss)) < LOSS_TOL
    paths = [jax.tree_util.keystr(k) for k, _ in
             jax.tree_util.tree_flatten_with_path(want)[0]]
    for path, w, g in zip(paths, jax.tree_util.tree_leaves(want), got):
        w = np.asarray(w)
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(g.numpy() - w).max()) / scale
        assert err < GRAD_TOL, (path, err)
