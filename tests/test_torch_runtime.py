"""The port's runtime: a variant's "compile" builds the kernel libraries
its configuration names, a failed build surfaces at the next call, and the
pieces not ported yet refuse loudly."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import EnumPoint, IridescentRuntime  # noqa: E402
from repro_torch.kernels import registry  # noqa: E402

PREPARED: list = []


@dataclasses.dataclass(frozen=True)
class _PreparedPoint(EnumPoint):
    """An enum point with the runtime's compile hook, like ImplPoint."""

    def prepare(self, value):
        if value == "broken":
            raise RuntimeError("library failed to build")
        PREPARED.append(value)


def _builder(spec):
    impl = spec.point(_PreparedPoint("impl", "plain", None, False,
                                     choices=("plain", "fast", "broken")))

    def step(x):
        return x * (2 if impl == "fast" else 1)

    return step


@pytest.fixture
def runtime():
    PREPARED.clear()
    rt = IridescentRuntime(max_compile_workers=1)
    yield rt
    rt.shutdown()


def test_compile_prepares_the_configured_value(runtime):
    h = runtime.register("h", _builder)
    assert PREPARED == ["plain"]                  # the generic variant
    h.specialize({"impl": "fast"}, wait=True)
    assert PREPARED == ["plain", "fast"]
    x = torch.ones(3)
    torch.testing.assert_close(h(x), 2 * x)
    assert h.stats()["compiled"] == 2
    assert runtime.compile_stats()["completed"] >= 1


def test_failed_build_raises_at_next_call(runtime):
    h = runtime.register("h", _builder)
    x = torch.ones(3)
    h(x)
    with pytest.raises(RuntimeError, match="library failed to build"):
        h.specialize({"impl": "broken"}, wait=True)
    with pytest.raises(RuntimeError, match="variant build") as info:
        h(x)
    assert "library failed to build" in str(info.value.__cause__)


def test_arg_specs_record_shape_dtype_device(runtime):
    h = runtime.register("h", _builder)
    h(torch.zeros(2, 5, dtype=torch.bfloat16))
    args, kwargs = h._default.arg_specs
    assert args == (((2, 5), torch.bfloat16, torch.device("cpu")),)
    assert kwargs == {}


def test_variant_cache_not_ported():
    with pytest.raises(NotImplementedError, match="ROADMAP M3"):
        IridescentRuntime(variant_cache="somewhere")


@pytest.mark.parametrize("available", [True, False])
def test_impl_point_prepare_builds_available_kernel_entries(monkeypatch,
                                                            available):
    built = []
    fam = registry.default_registry._families["rmsnorm"]
    monkeypatch.setitem(fam, "cuda", dataclasses.replace(
        fam["cuda"], available=lambda: available,
        prepare=lambda: built.append("cuda")))
    point = registry.ImplPoint("rmsnorm_impl", None, None, False,
                               choices=("torch_ref",), family="rmsnorm")
    point.prepare("torch_ref")
    point.prepare("pallas_tpu")                  # the reference's name
    assert built == (["cuda"] if available else [])


@pytest.mark.parametrize("lo,hi", [(0.0, None), (-2.0, 3.0)])
def test_hist_tap_matches_reference(lo, hi):
    import jax.numpy as jnp
    import numpy as np

    from repro.core.instrumentation import hist_tap as ref_hist_tap
    from repro_torch.core.instrumentation import hist_tap

    values = np.random.RandomState(5).randn(7, 33).astype(np.float32) * 4
    ref = ref_hist_tap(jnp.asarray(values), 12, lo, hi)
    out = hist_tap(torch.from_numpy(values), 12, lo, hi)
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
