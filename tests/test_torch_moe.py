"""The port's MoE FFN (``repro_torch.models.moe``) against the JAX
reference's, scenario by scenario as tests/test_moe.py runs the reference,
on the same parameters and inputs (numpy from a seed): the dispatch
implementations against the dense oracle when capacity does not bind,
gather against einsum under drops, the two rankings, capacity drops and
rounding, and ``assign_experts``, ``_capacity`` and ``apply_moe`` against
the reference's.

Tolerance 1e-5 in fp32, as tests/test_moe.py's 2e-5 for one framework's
impls against each other: the expert products sum in other orders.
Routing (expert ids, positions, keep) is compared exactly.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import moe as ref_moe  # noqa: E402
from repro.models.config import ModelConfig as RefModelConfig  # noqa: E402
from repro_torch.models import moe, params_from_numpy  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402

TOL = 1e-5
FIELDS = dict(name="t", family="moe", n_layers=2, d_model=32, n_heads=4,
              n_kv_heads=2, d_ff=64, vocab_size=100, n_experts=8, top_k=2,
              moe_d_ff=48, n_shared_experts=2)
REF_CFG = RefModelConfig(**FIELDS)
CFG = ModelConfig(**FIELDS)
REF_P = ref_moe.init_moe(jax.random.PRNGKey(0), REF_CFG)
P = params_from_numpy(jax.tree_util.tree_map(np.asarray, REF_P), "cpu")
X_NP = np.random.RandomState(1).randn(2, 32, 32).astype(np.float32)


def _x():
    return torch.from_numpy(X_NP)


def _close(out, ref_out, tol=TOL):
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_out),
                               rtol=tol, atol=tol)


def _both(impl="gather", **kw):
    """apply_moe of the port and of the reference on the same inputs."""
    out, aux = moe.apply_moe(P, _x(), CFG, moe.MoEOptions(impl=impl, **kw))
    ref_out, ref_aux = ref_moe.apply_moe(
        REF_P, jnp.asarray(X_NP), REF_CFG, ref_moe.MoEOptions(impl=impl,
                                                              **kw))
    return out, aux, ref_out, ref_aux


def test_impls_agree_with_dense_oracle_when_unbounded():
    o_dense, aux_d, ref_dense, ref_aux_d = _both("dense")
    _close(o_dense, ref_dense)
    _close(aux_d, ref_aux_d)
    for impl in ("gather", "einsum"):
        for ranking in ("cumsum", "sort"):
            o, aux = moe.apply_moe(P, _x(), CFG, moe.MoEOptions(
                impl=impl, capacity_factor=100.0, ranking=ranking))
            torch.testing.assert_close(o, o_dense, rtol=2e-5, atol=2e-5)
            torch.testing.assert_close(aux, aux_d, rtol=1e-5, atol=0)


@pytest.mark.parametrize("group_size", [0, 16])
@pytest.mark.parametrize("cf", [1.0, 2.0])
def test_gather_equals_einsum_under_drops(group_size, cf):
    o_g, _, ref_g, _ = _both("gather", capacity_factor=cf,
                             group_size=group_size)
    o_e, _, ref_e, _ = _both("einsum", capacity_factor=cf,
                             group_size=group_size)
    torch.testing.assert_close(o_g, o_e, rtol=2e-5, atol=2e-5)
    _close(o_g, ref_g)
    _close(o_e, ref_e)


def _logits(seed, t=64, e=8):
    return np.random.RandomState(seed).randn(t, e).astype(np.float32)


def test_sort_ranking_equals_cumsum():
    for gs in (0, 16):
        lg = torch.from_numpy(_logits(2))
        a = moe.assign_experts(lg, 2, 8, 16, gs, "cumsum")
        b = moe.assign_experts(lg, 2, 8, 16, gs, "sort")
        assert torch.equal(a["pos"], b["pos"])
        assert torch.equal(a["keep"], b["keep"])


def test_capacity_drops_tokens():
    lg = np.zeros((64, 8), np.float32)              # all route to expert 0/1
    a = moe.assign_experts(torch.from_numpy(lg), 2, 8, capacity=16)
    ref_a = ref_moe.assign_experts(jnp.asarray(lg), 2, 8, capacity=16)
    assert int(a["keep"].sum()) <= 2 * 16 * 8       # bounded by capacity*E
    assert not bool(a["keep"].all())                # some dropped
    np.testing.assert_array_equal(a["idx"].numpy(), np.asarray(ref_a["idx"]))
    np.testing.assert_array_equal(a["keep"].numpy(),
                                  np.asarray(ref_a["keep"]))


def test_positions_are_dense_rank():
    a = moe.assign_experts(torch.from_numpy(_logits(3, t=32)), 2, 8,
                           capacity=1000)
    idx, pos = a["idx"].reshape(-1).numpy(), a["pos"].reshape(-1).numpy()
    for e in range(8):
        ps = np.sort(pos[idx == e])
        np.testing.assert_array_equal(ps, np.arange(len(ps)))


@pytest.mark.parametrize("t,k,e,f", [
    (1_000_000, 8, 384, 1.25), (128, 8, 384, 1.25), (1, 1, 1, 1.0),
    (4096, 6, 160, 1.25), (4, 6, 160, 1.25), (32, 2, 8, 4.0),
    (1024, 2, 8, 2.0)])
def test_capacity_matches_reference(t, k, e, f):
    c = moe._capacity(t, k, e, f)
    assert c == ref_moe._capacity(t, k, e, f)
    assert c >= 1 and c % (512 if c >= 512 else 16) == 0


def test_capacity_at_deepseek_prefill():
    """deepseek-v2's (1, 4096) call: top-6 of 160 at factor 1.25."""
    assert moe._capacity(4096, 6, 160, 1.25) == 192


@pytest.mark.parametrize("group_size", [0, 16])
@pytest.mark.parametrize("ranking", ["cumsum", "sort"])
@pytest.mark.parametrize("capacity", [4, 16])
def test_assign_experts_matches_reference(group_size, ranking, capacity):
    lg = _logits(5)
    a = moe.assign_experts(torch.from_numpy(lg), 2, 8, capacity,
                           group_size, ranking)
    ref_a = ref_moe.assign_experts(jnp.asarray(lg), 2, 8, capacity,
                                   group_size, ranking)
    for name in ("idx", "pos", "keep"):
        np.testing.assert_array_equal(a[name].numpy(),
                                      np.asarray(ref_a[name]))
    assert a["w"].dtype == torch.float32
    _close(a["w"], ref_a["w"])
    _close(a["aux"], ref_a["aux"])


def test_top_k_ties_take_the_lower_expert():
    """Equal probabilities go to the lower expert id first, as the
    reference's ``lax.top_k``."""
    lg = np.zeros((6, 8), np.float32)
    lg[:, 5] = lg[:, 2] = 1.0
    lg[3:, 7] = 1.0
    a = moe.assign_experts(torch.from_numpy(lg), 3, 8, 16)
    ref_a = ref_moe.assign_experts(jnp.asarray(lg), 3, 8, 16)
    np.testing.assert_array_equal(a["idx"].numpy(), np.asarray(ref_a["idx"]))
    assert a["idx"][0].tolist() == [2, 5, 0]


@pytest.mark.parametrize("impl,cf,group_size", [
    (impl, cf, g) for impl in ("einsum", "gather")
    for cf, g in ((1.25, 0), (1.0, 16), (4.0, 0))] + [("dense", 1.25, 0)])
def test_apply_moe_matches_reference(impl, cf, group_size):
    out, aux, ref_out, ref_aux = _both(impl, capacity_factor=cf,
                                       group_size=group_size)
    assert tuple(out.shape) == tuple(X_NP.shape)
    assert aux.dtype == torch.float32 and aux.ndim == 0
    _close(out, ref_out)
    _close(aux, ref_aux)


def test_shard_degrades_to_gather():
    """With no mesh (the port's one device) ``shard`` is ``gather``, as
    the reference's guarded degrade; each call is counted."""
    moe.reset_degrades()
    o_s, aux_s, ref_s, _ = _both("shard", capacity_factor=1.0)
    o_g, aux_g = moe.apply_moe(P, _x(), CFG, moe.MoEOptions(
        impl="gather", capacity_factor=1.0))
    assert moe.degrades == 1
    assert torch.equal(o_s, o_g) and torch.equal(aux_s, aux_g)
    _close(o_s, ref_s)


def test_group_that_does_not_divide_the_tokens_raises():
    with pytest.raises(ValueError, match="moe_group 24 does not divide the "
                                         "64 tokens"):
        moe.apply_moe(P, _x(), CFG, moe.MoEOptions(impl="gather",
                                                   group_size=24))


def test_unknown_impl_raises():
    with pytest.raises(ValueError, match="unknown moe impl"):
        moe.apply_moe(P, _x(), CFG, moe.MoEOptions(impl="ring"))


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("cf", [1.0, 1.25, 2.0])
def test_output_finite_and_matches_reference(seed, cf):
    """tests/test_moe.py's finite-output property at fixed seeds, each
    also held to the reference (gather, sort ranking)."""
    x = np.random.RandomState(100 + seed).randn(1, 16, 32).astype(np.float32)
    opts = dict(impl="gather", capacity_factor=cf, ranking="sort")
    o, aux = moe.apply_moe(P, torch.from_numpy(x), CFG,
                           moe.MoEOptions(**opts))
    ref_o, _ = ref_moe.apply_moe(REF_P, jnp.asarray(x), REF_CFG,
                                 ref_moe.MoEOptions(**opts))
    assert bool(torch.isfinite(o).all()) and bool(torch.isfinite(aux))
    _close(o, ref_o)


def test_layout_matches_reference():
    fresh = moe.init_moe(torch.Generator().manual_seed(0), CFG)
    shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), REF_P)
    assert {k: (tuple(v.shape) if not isinstance(v, dict) else
                {kk: tuple(vv.shape) for kk, vv in v.items()})
            for k, v in fresh.items()} == shapes
    assert moe.moe_axes(CFG) == ref_moe.moe_axes(REF_CFG)
