"""The port's runtime: a variant's "compile" builds the kernel libraries
its configuration names, a failed build surfaces at the next call, and a
persistent variant cache carries variants across runtimes."""
import dataclasses
import sys

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


def test_failed_build_is_parked_before_the_waiter_returns():
    """The worker wakes a ``wait=True`` caller before it runs the build's
    done-callbacks, so the failure is parked on the waiter's side too:
    the next call raises it however the threads interleave (100 rounds
    with a 1 us switch interval; the callback alone missed ~1 in 150)."""
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for _ in range(100):
            rt = IridescentRuntime(max_compile_workers=1)
            try:
                h = rt.register("h", _builder)
                h(torch.ones(3))
                with pytest.raises(RuntimeError, match="failed to build"):
                    h.specialize({"impl": "broken"}, wait=True)
                with pytest.raises(RuntimeError, match="variant build"):
                    h(torch.ones(3))
            finally:
                rt.shutdown()
    finally:
        sys.setswitchinterval(interval)


def test_arg_specs_record_shape_dtype_device(runtime):
    h = runtime.register("h", _builder)
    h(torch.zeros(2, 5, dtype=torch.bfloat16))
    args, kwargs = h._default.arg_specs
    assert args == (((2, 5), torch.bfloat16, torch.device("cpu")),)
    assert kwargs == {}


def test_variant_cache_keeps_variants_across_runtimes(tmp_path):
    """``IridescentRuntime(variant_cache=DIR)``: a second runtime on the
    same directory finds both variants, prepared with no build counted."""
    for run in range(2):
        PREPARED.clear()
        rt = IridescentRuntime(max_compile_workers=1,
                               variant_cache=str(tmp_path))
        h = rt.register("h", _builder)
        h.specialize({"impl": "fast"}, wait=True)
        torch.testing.assert_close(h(torch.ones(3)), 2 * torch.ones(3))
        stats = rt.compile_stats()
        rt.shutdown()
        assert PREPARED == ["plain", "fast"]      # libraries loaded again
        assert h.stats()["from_cache"] == 2 * run
        assert (stats["xla_compiles"], stats["cache_hits"]) == (
            (2, 0) if run == 0 else (0, 2))


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
