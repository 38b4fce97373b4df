"""The reference's scenarios of ``tests/test_kernel_registry.py``, held
against the port: each test keeps its name there, with the port's names
for the entries (``torch_ref`` for ``xla_ref``, ``cuda`` for
``pallas_tpu``; the reference's spellings are the port's legacy aliases).
Where a scenario computes a value, the same numpy inputs go through both
packages' registries and the results are compared.

Without a counterpart here:

* ``test_impl_point_roundtrip_through_handler_specialize``,
  ``test_explorer_selects_xla_ref_on_cpu`` and
  ``test_tpu_tuned_config_replays_on_cpu`` (the reference's handler
  scenarios) are ported in ``tests/test_torch_matmul.py`` already
  (``test_impl_point_roundtrip_through_handler_specialize``,
  ``test_explorer_selects_torch_ref_on_cpu``,
  ``test_tuned_config_replays_on_cpu_like_reference``).
* ``test_no_direct_experimental_imports_outside_compat`` checks that
  ``jax.experimental`` is imported only through ``repro.compat``; the port
  imports no JAX at all, which ``tests/test_torch_imports.py`` checks; the
  test of that name here checks the port's source the same way.

The reference's guards of ``linear_attention`` and ``attention`` send a
length the tiles do not divide to the plain version; the port's kernels
mask the ragged tiles, so their guards take it (a tile pair the library
lacks misses the guard instead).  Those two scenarios hold that and the
plain version's answer to the reference's.
"""
import pathlib
import re

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import attention as ref_attention  # noqa: E402
from repro.kernels import linear_attention as ref_la  # noqa: E402
from repro.kernels import matmul as ref_matmul  # noqa: E402
from repro.kernels import registry as ref_registry  # noqa: E402
from repro.kernels import rmsnorm as ref_rmsnorm  # noqa: E402
from repro_torch import compat  # noqa: E402
from repro_torch.kernels import matmul, registry, rmsnorm  # noqa: E402
from repro_torch.kernels.registry import (FALLBACK_IMPL,  # noqa: E402
                                          KernelRegistry, canonical_name,
                                          impl_point)

FAMILIES = ("matmul", "attention", "rmsnorm", "linear_attention", "fastpath")


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _np(a):
    return np.asarray(a.detach() if isinstance(a, torch.Tensor) else a)


# -- listing & availability -------------------------------------------------------

def test_all_families_registered_with_fallback():
    fams = registry.families()
    for family in FAMILIES:
        assert family in fams
        impls = registry.implementations(family)
        assert FALLBACK_IMPL in impls, family
        assert "cuda" in impls, family
        assert family in ref_registry.families()


def test_cpu_availability_filtering():
    # no Hopper card here: the card's entries must be filtered out of the
    # candidate set, torch_ref must always survive.
    if compat.has_hopper():
        pytest.skip("the kernel entries are available here")
    for family in FAMILIES:
        names = registry.choices(family)
        assert FALLBACK_IMPL in names, family
        assert "cuda" not in names, family
    assert registry.get("matmul", "cuda").is_available() is False


def test_auto_resolution_prefers_xla_ref_on_cpu():
    if compat.has_hopper():
        pytest.skip("the kernel entries are available here")
    for family in FAMILIES:
        assert registry.resolve(family, None).name == FALLBACK_IMPL
        assert registry.resolve(family, "auto").name == FALLBACK_IMPL
        assert ref_registry.resolve(family, None).name == "xla_ref"


def test_legacy_alias_names_accepted():
    assert canonical_name("xla") == "torch_ref"
    assert canonical_name("interpret") == "torch_ref"
    assert canonical_name("pallas") == "cuda"
    assert registry.get("rmsnorm", "xla").name == "torch_ref"
    x = np.random.RandomState(0).randn(8, 16).astype(np.float32)
    w = np.random.RandomState(1).randn(16).astype(np.float32)
    out = rmsnorm.rmsnorm(_t(x), _t(w), impl="xla")
    np.testing.assert_allclose(_np(out), _np(rmsnorm.rmsnorm(
        _t(x), _t(w), impl="torch_ref")))
    ref = ref_rmsnorm.rmsnorm(jnp.asarray(x), jnp.asarray(w), impl="xla")
    np.testing.assert_allclose(_np(out), _np(ref), rtol=1e-6, atol=1e-6)


def test_unknown_names_raise():
    with pytest.raises(KeyError):
        registry.get("matmul", "no_such_impl")
    with pytest.raises(KeyError):
        registry.resolve("no_such_family", None)


# -- fallback semantics -----------------------------------------------------------

def test_unavailable_named_impl_falls_back_to_xla_ref():
    # cuda cannot run on this host; dispatch must produce the plain
    # version's result (the reference's, on the same inputs) instead of
    # crashing.
    if compat.has_hopper():
        pytest.skip("the kernel entries are available here")
    x = np.random.RandomState(0).randn(16, 8).astype(np.float32)
    y = np.random.RandomState(1).randn(8, 12).astype(np.float32)
    key = ("matmul", "cuda")
    before = registry.default_registry.fallback_counts.get(key, 0)
    out = matmul.matmul(_t(x), _t(y), impl="pallas_tpu")
    assert registry.default_registry.fallback_counts[key] == before + 1
    np.testing.assert_allclose(_np(out), _np(matmul.matmul(
        _t(x), _t(y), impl="torch_ref")), rtol=1e-6, atol=1e-6)
    ref = ref_matmul.matmul(jnp.asarray(x), jnp.asarray(y), impl="xla_ref")
    np.testing.assert_allclose(_np(out), _np(ref), rtol=1e-6, atol=1e-6)


def test_guard_miss_falls_back_to_xla_ref():
    reg = KernelRegistry()

    @reg.register("toy", "torch_ref")
    def _ref(x):
        return x + 1

    @reg.register("toy", "fancy", priority=10,
                  guard=lambda x: x.shape[0] % 2 == 0)
    def _fancy(x):
        return x * 0 - 999          # wrong on purpose: must not run on odd

    even = torch.ones((4,))
    odd = torch.ones((3,))
    assert float(reg.dispatch("toy", "fancy", even)[0]) == -999.0
    # guard miss: odd batch re-routes this call to torch_ref
    np.testing.assert_allclose(_np(reg.dispatch("toy", "fancy", odd)),
                               _np(odd + 1))
    assert reg.fallback_counts[("toy", "fancy")] == 1
    # auto selection also respects the guard at dispatch time
    np.testing.assert_allclose(_np(reg.dispatch("toy", None, odd)),
                               _np(odd + 1))


def test_real_guard_linear_attention_chunk_divisibility():
    from test_torch_matmul import _OnCard

    from repro_torch.kernels import linear_attention as la
    from repro_torch.kernels.linear_attention import ops as la_ops

    rs = np.random.RandomState(2)
    q, k, v = (rs.randn(2, 20, 4).astype(np.float32) for _ in range(3))
    lw = np.full((2, 20, 4), -0.5, np.float32)   # T=20 % 16 != 0
    # the reference's guard misses (its kernel tiles T); the port's takes
    # the call on the card (the kernel masks the ragged tail)
    assert not ref_la.ops._guard(*map(jnp.asarray, (q, k, v, lw)), chunk=16)
    assert la_ops._guard(*(_OnCard(_t(a)) for a in (q, k, v, lw)), chunk=16)
    out = la.linear_attention(*map(_t, (q, k, v, lw)), chunk=16,
                              impl="torch_ref")
    ref = ref_la.linear_attention(*map(jnp.asarray, (q, k, v, lw)), chunk=4,
                                  impl="xla_ref")
    np.testing.assert_allclose(_np(out), _np(ref), rtol=1e-4, atol=1e-4)


def test_attention_guard_covers_block_divisibility():
    from test_torch_matmul import _OnCard

    from repro_torch.kernels import attention as attn
    from repro_torch.kernels.attention import ops as attn_ops

    rs = np.random.RandomState(9)
    q, k, v = (rs.randn(1, 2, 192, 16).astype(np.float32) for _ in range(3))
    card = [_OnCard(_t(a)) for a in (q, k, v)]
    # 192 % 128 != 0: the reference's guard misses and its plain version
    # answers, counted.  The port's kernel masks the edge tile, so its
    # guard (the card and the reference's precondition) takes the call on
    # the card; 128 kv rows is a tile the library lacks (it instantiates
    # 32 and 64), so the wrapper raises there (a domain gap).  On the host
    # the guard misses and torch_ref answers, counted.
    assert not ref_attention.ops._guard(*map(jnp.asarray, (q, k, v)),
                                        block_q=128, block_kv=128)
    assert attn_ops._guard(*card, block_q=128, block_kv=128)
    assert attn_ops._guard(*card, block_q=128, block_kv=64)
    flat = [_t(a).flatten(0, 1) for a in (q, k, v)]
    assert isinstance(attn_ops.kernel.unsupported(*flat, block_q=128,
                                                  block_kv=128), ValueError)
    assert attn_ops.kernel.unsupported(*flat, block_q=128,
                                       block_kv=64) is None
    key = ("attention", "cuda")
    before = registry.default_registry.fallback_counts.get(key, 0)
    out = attn.attention(*map(_t, (q, k, v)), block_q=128, block_kv=128,
                         impl="cuda")
    assert registry.default_registry.fallback_counts[key] == before + 1
    ref = ref_attention.attention(*map(jnp.asarray, (q, k, v)),
                                  impl="xla_ref")
    np.testing.assert_allclose(_np(out), _np(ref), rtol=2e-4, atol=2e-4)


def test_require_grad_pins_concrete_grad_safe_impl():
    """Differentiated builders must never leave the impl on auto: dispatch
    cannot know a call sits under autograd, so
    impl_point(require_grad=True) returns a concrete grad-safe name even
    when the point is disabled or the default is a kernel without a
    backward; the gradient through it is the reference's ``jax.grad``."""
    from repro_torch.core.specializer import SpecCtx

    for default in (None, "xla", "cuda", "pallas_tpu", "pallas_interpret"):
        spec = SpecCtx({})                       # point disabled -> default
        value = impl_point(spec, "matmul", default=default,
                           require_grad=True)
        assert value is not None
        assert registry.get("matmul", value).supports_grad, (default, value)
    # grad actually flows through the pinned choice
    spec = SpecCtx({})
    impl = impl_point(spec, "rmsnorm", default="cuda", require_grad=True)
    rs = np.random.RandomState(3)
    x, w = rs.randn(4, 8).astype(np.float32), rs.randn(8).astype(np.float32)
    xt = _t(x).requires_grad_()
    rmsnorm.rmsnorm(xt, _t(w), impl=impl).sum().backward()
    assert bool(torch.isfinite(xt.grad).all())
    g = jax.grad(lambda a: ref_rmsnorm.rmsnorm(
        a, jnp.asarray(w), impl="xla").sum())(jnp.asarray(x))
    np.testing.assert_allclose(_np(xt.grad), _np(g), rtol=1e-5, atol=1e-5)


# -- compat layer -----------------------------------------------------------------

def test_compat_surface():
    # the port's shim resolves on this host: tree utils, the device
    # resolution, and the card probe (False without an H100).
    assert compat.tree_map(lambda a: a + 1, {"x": 1}) == {"x": 2}
    assert compat.resolve_device("cpu") == torch.device("cpu")
    assert compat.has_hopper() == (compat.cuda_capability() == (9, 0))
    if not torch.cuda.is_available():
        assert compat.has_hopper() is False


def test_no_direct_experimental_imports_outside_compat():
    """The port's counterpart of the reference's drift firewall: no module
    of ``repro_torch`` imports JAX, experimental or not (the import
    firewall, ``tests/test_torch_imports.py``, reads every import with
    ``ast``)."""
    src_root = pathlib.Path(registry.__file__).resolve().parents[1]
    offenders = [str(path) for path in src_root.rglob("*.py")
                 if re.search(r"^\s*(import jax|from jax)",
                              path.read_text(), re.M)]
    assert not offenders, offenders
